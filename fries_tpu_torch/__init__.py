"""fries_tpu_torch: the PyTorch / CUDA port of fries_tpu.

The systematic HB-PP frisys main path on one NVIDIA H100: determinant bit
strings (``dets``), the molecular Hamiltonian and heat-bath tables
(``ops``), vector compression (``compress``), the sorted arena and its two
hand-written CUDA kernels (``runtime.merge`` / ``runtime.emit`` over
``csrc/*.cu``), the power-iteration core and the frisys driver
(``drivers``), and the ``frisys_mol`` command line (``cli``).

The package imports torch and numpy only; ``fries_tpu`` (JAX) is the
reference it is tested against.  Importing builds nothing: the kernels are
compiled with nvcc at first use on the card (``_build``).
"""

__version__ = "0.1.0"
