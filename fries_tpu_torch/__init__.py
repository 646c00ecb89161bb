"""fries_tpu_torch: the PyTorch / CUDA port of fries_tpu.

The frisys (HB-PP FCI-FRI, also semistochastic and in a time-reversal
sector), frifull (exact H * v), frimulti (multinomial FRI), FCIQMC (integer
and fp walkers) and subspace-iteration paths on one NVIDIA H100:
determinant bit strings (``dets``), the molecular Hamiltonian, heat-bath
tables, near-uniform and heat-bath excitation samplers and time-reversal
folding (``ops``), systematic and pivotal vector compression and the walker
roundings (``compress``, drawing from the key tree of ``rng``), the sorted
arena and its three hand-written CUDA kernels (``runtime.merge`` /
``runtime.emit`` / ``runtime.merge_multi`` over ``csrc/*.cu``), the
power-iteration core, the frisys, frifull, frimulti, fciqmc and subspace
drivers (``drivers``), linear algebra and Lanczos (``linalg``), the
integral pipeline that builds real molecules from geometry (``basis``,
``sto3g``, ``gto``, ``scf``, ``cisd``, ``real_systems``), and the
``frisys_mol`` / ``frifull_mol`` / ``frimulti_mol`` / ``fciqmc_mol`` /
``fciqmc_fp_mol`` / ``subsp_mol`` command line (``cli``), the flagship
science run against the published rows (``flagship``), the native C++
FCIDUMP and vector reader (``native``, built with g++ at first use) and
profiling hooks (``profiling``).  Determinants take up to sixteen 32-bit
words (256 orbitals) on the card and any width on the CPU.

The package imports torch, numpy and scipy only; ``fries_tpu`` (JAX) is the
reference it is tested against.  Importing builds nothing: the kernels are
compiled with nvcc at first use on the card (``_build``).
"""

__version__ = "0.1.0"
