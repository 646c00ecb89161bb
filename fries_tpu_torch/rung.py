"""The configurations the card scripts drive, defined once.

* The 1e6 rung of bench.py's frisys_mol ladder (``FULL_LADDER``) on the
  synthetic N2/cc-pVDZ-sized system ``synth.n2_ccpvdz_like(seed=1)``: eps
  1e-3, vec_nonz = matr_samp = 1e6, arena capacity 2^21, spawn buffer
  1,032,768 (matr_samp plus slack), target_norm 2e6, HF trial vector.
* bench.py's subsp configuration (``bench_subsp_sharded``) on one device:
  the synthetic Ne/aug-cc-pVDZ-sized system ``synth.ne_augccpvdz_like(seed=1)``,
  two states with HF and the single 4 -> 10 as trial vectors, eps 0.02,
  vec_nonz 100,000 and matr_samp 200,000 per state, spawn_cap 300,000 per
  state, restart_int 10, seed 0, the subspace defaults otherwise (pivotal
  vector and Hamiltonian compression).  The arena holds 2^20 rows where
  bench.py gives 2^19: a merged arena holds the compressed rows' union plus
  every new spawned target, up to T * (vec_nonz + matr_samp) = 600,000 rows,
  and at 2^19 the merge overflows at the sixth iteration (bench.py never
  reads the subsp overflow flag).

* ``semistoch``: the 1e6 rung unchanged plus a deterministic space of
  :data:`N_DETERM` determinants, as the published semistochastic runs add
  one to the flagship (tools/flagship.py, "150 largest CISD").  The port has
  no CISD, so the space is HF and the determinants with the largest
  |((H - E_HF) HF)| (ties by key): fixed by the system's seed.  Its dense
  block must leave at least 30% of ``matr_samp`` for sampling; the largest
  space of at most :data:`N_DETERM` that does is taken
  (:func:`determ_space`).
* ``frifull``: bench.py's frifull_mol configuration (``bench_frifull_mol``,
  its synthetic branch): ``synth.make_system(14, 6, seed=1, scale_two=0.1)``,
  eps 0.005, target_nonz 30,000, capacity 2^18, target_norm 60,000, batch
  1024, spawn_rows 49,152 (48 chunks per step), dedup_cap 0; seed 0.
  ``frifull_config(dedup_cap=1 << 19)`` is its real-molecule branch's
  setting of the dedup on the same system.
* ``fciqmc``: bench.py's fciqmc_mol configuration (``bench_fciqmc``, its
  synthetic branch): ``synth.n2_ccpvdz_like(seed=2)`` (28 orbitals, 14
  electrons), eps 1e-3, target_walkers 5e6, attempt_cap 2^23, spawn_cap
  2^22, the heat-bath distribution, integer walkers, init_thresh 3.0,
  shift_damping 1.0, 4e6 walkers on HF at the start, seed 0, with two
  changes, each forced by an overflow that the card measured with
  bench.py's values.  shift_interval 1, not 10: the population grows 12% a
  step from 4e6 walkers and passes the 2^23 attempts at the 8th iteration,
  before bench.py's controller first moves the shift at the 20th; updated
  every step, the deadbeat controller holds it near 5.5e6.  Capacity 2^22,
  not 2^21: at that population the occupied determinants pass 2^21 between
  the 40th and the 45th iteration and still grow at the 65th that bench.py
  runs.
  bench.py's ``attempt_chunk`` (2^20, a workaround for the TPU's memory)
  is not ported: the 2^23 attempts run in one pass.
* ``frimulti``: the 1e6 rung's system and budgets
  (``synth.n2_ccpvdz_like(seed=1)``, eps 1e-3, vec_nonz = matr_samp = 1e6,
  capacity 2^21, target_norm 2e6) with the heat-bath distribution and the
  spawn buffer the command line gives (1.4 matr_samp).  bench.py has no
  frimulti configuration.

* ``frifull_hh``: bench.py's frifull_hh configuration (``bench_frifull_hh``,
  BASELINE.md's required Hubbard-Holstein run): 4 sites, 4 electrons,
  ph_bits 3 (20 bits, one word), U 2, omega 1, g 0.5, t 1; eps 0.01,
  target_nonz 30,000, capacity 2^17, target_norm 60,000, e_ref 0, seed 0;
  20 candidates per determinant, so one merge of 2,621,440 spawns per step.
  The reachable space (147,456 determinants) is larger than the arena, but
  the merged arena holds about 43,000 rows over the 40 steps bench.py runs
  (measured on the card), so bench.py's capacity stands.
* ``frisys_hh``: bench.py has none.  A 12-site open chain at half filling
  with ph_bits 3 (60 bits in two words: the widest lattice one int64 key
  holds at the command line's default ph_bits) and BASELINE's couplings
  (U 2, omega 1, g 0.5, t 1), at the frisys rung's budgets: eps 0.01,
  vec_nonz = matr_samp = 1e6, spawn_cap 1.4e6 (the command line's), capacity
  2^21, target_norm 2e6, init_thresh 0, e_ref 0, seed 0, from one Neel
  determinant.
* ``frisys_hh_wide``: ``frisys_hh``'s couplings and budgets
  (:func:`frisys_hh_config`, unchanged) on a 16-site chain at half filling
  with ph_bits 3: 80 bits in three words, so kernel A merges 128-bit keys
  (the W = 3 instance) and the model works on rows past 64 bits; kernel B
  at K = 2 and K = 1 as in ``frisys_hh``.  The 12-site ``frisys_hh`` stays:
  it runs the one-int64 path of W <= 2.
* ``subsp_lowmem`` and ``multi``: the subsp configuration with
  ``lowmem=True`` or ``compress_mode="multi"``
  (``subspace_config(lowmem=True)``), on its system and trial vectors.
* ``subspfull``: ``exact_h=True`` on the frifull system (14 orbitals, 6
  electrons), T = 2 (HF and its single 2 -> 3), eps 0.005, vec_nonz
  30,000 per vector, capacity 2^18, 1024 rows per spawn-and-merge chunk,
  restart_int 10, pivotal vector compression.

* ``observables`` and ``obs_repl``: the Rayleigh and the replica
  estimator on the frifull system (14 orbitals, 6 electrons, 132,496
  determinants) at frifull's widths: eps 0.005, target_nonz 30,000,
  capacity 2^18 (the whole space fits: no overflow), 1024 source rows per
  exact spawn-and-merge chunk, O = the spin-summed HOMO -> LUMO excitation
  (obs_des 2, obs_cre 3), exponent 0.5; the schedule is cut to burn_in 6,
  n_obs 3, btw_obs 3 (the CLI's 1000 / 100 / 100), so that 6 warm-up and 6
  timed steps hold a period start, a weighted period and a free period.
  The reference has no bench.py configuration of these workloads.
* ``unfused``: the 1e6 rung with ``fuse_ab=False, fuse_cd=False`` (five
  comp_sub rounds, A to E, per step).

* ``ne_qz``: the published Ne/cc-pVQZ frisys_mol run (BASELINE.md:27,
  systematic HB-PP FCI-FRI at 500k vector and matrix nonzeros, n_a = 1) at
  bench.py's 500k rung (``FULL_LADDER``): eps 1e-3, vec_nonz = matr_samp =
  500,000, capacity 2^20, spawn_cap 532,768, init_thresh 1.0, target_norm
  1e6, HF trial vector, fused stages; ``unnorm=True`` is BASELINE.md:46's
  unnormalized run.  The system is ``real_systems.ne_ccpvqz()``: Ne in
  cc-pVQZ (5s4p3d2f1g, 55 functions), RHF, the 1s frozen: 54 active
  orbitals, 8 electrons, D2h irreps :data:`NE_QZ_SYMM`; 108 bits, four
  words.
* ``ne_qz_subsp``: bench.py's subsp configuration (:func:`subspace_config`,
  unchanged) on that system, as bench.py runs it by default
  (``FRIES_SUBSP_SYSTEM=ne_ccpvqz``): HF and bench.py's real-system single,
  the HOMO (orbital 3) to the first virtual of its irrep in the real
  ``symm`` (orbital 6).

* ``ne2_qz``: the neon dimer at full width, no cut in it: Ne2 at r = 5.84
  a0 (3.09 Angstrom, its equilibrium distance), cc-pVQZ on both atoms (110
  spherical functions), both 1s frozen: 108 active orbitals, 16 electrons,
  216 bits, seven words (kernel A on 64-bit limb keys, L = 4).  Built by
  :func:`fries_tpu_torch.scf.build_molecule` from the in-repo cc-pVQZ
  table on the card (:func:`ne2_qz_molecule`); not a system of
  ``real_systems.SYSTEMS``, which mirrors ``tools/real_systems.py``.
  ``ne_qz``'s configuration (:func:`ne_qz_config`, bench.py's 500k rung,
  n_a = 1) unchanged.
* ``ne2_qz_subsp``: bench.py's subsp configuration (:func:`subspace_config`,
  T = 2: HF and bench.py's real-system single, :func:`ne_qz_single`) on
  that system: kernel C at W = 7.

The real molecules of bench.py's default branches, built by
:mod:`fries_tpu_torch.real_systems` on the card (no cache):

* ``rung_real``: the 1e6 rung (:func:`config`, unchanged) on
  ``real_systems.n2_ccpvdz()``: N2 at r = 2.068 a0, cc-pVDZ, 4 frozen
  electrons, 26 active orbitals, 10 electrons (bench.py's default frisys
  branch).
* ``semistoch_cisd``: ``rung_real`` plus the deterministic space of the
  :data:`N_DETERM` = 150 determinants of largest |c| in the CISD ground
  state (tools/flagship.py:182-184, Results.tex:142), the CISD from
  :func:`fries_tpu_torch.cisd.cisd_ground_state` on the same device.
  Spin-flip partners have equal |c|, so a tie can straddle the 150th
  place: |c| is rounded to 1e-10 and ties go in the arena's order
  (:func:`cisd_determ_space`).
* ``frifull_real``: bench.py's frifull real branch: real H2O/cc-pVDZ
  (r = 1.84345 a0, 110.6 degrees, no frozen core) sliced to its first 12
  orbitals, (10e, 12o), FCI dimension 627,264; eps 0.005, target_nonz
  30,000, capacity 2^21, target_norm 60,000, batch 1024, spawn_rows
  49,152 (48 chunks per step), dedup_cap 2^19; seed 0.
* ``fciqmc_real``: bench.py's fciqmc real branch on
  ``real_systems.n2_stretched()`` (r = 4.2 a0, cc-pVDZ, 4 frozen, 26
  orbitals, 10 electrons) with :func:`fciqmc_config` (shift_interval 1,
  capacity 2^22), the two changes the synthetic system forced, kept so
  that the two fciqmc cells differ in their system alone.  The real
  system does not need them: with bench.py's own values
  (``fciqmc_config(bench_values=True)``: shift_interval 10, capacity
  2^21) it ran bench.py's 65 iterations without an overflow on an NVIDIA
  H100 80GB HBM3 at 700 W (the population peaked at 6.6e6 walkers at the
  20th iteration and held 706,595 determinants at the 65th), which
  ``chip_smoke.py`` checks each run.

The hash-sharded configurations (one rank per card, or several ranks on
one card; each rank's capacity as below, budgets global, as the reference
defines a sharded run):

* ``rung_real_sharded``: ``rung_real`` on ``n`` ranks (:func:`config` with
  ``n_shards``; capacity 2^21 per rank; the exchange buffer the reference's
  default, 2 S / n rows per sender for S spawns).
* ``subsp_sharded``: bench.py's ``bench_subsp_sharded`` on real
  Ne/cc-pVQZ (its default system): T = 2 (HF and bench.py's real-system
  single), eps 0.02, vec_nonz 100,000, matr_samp 200,000, spawn_cap
  300,000, exchange_cap 600,000, restart_int 10, capacity 2^20 per rank
  (bench.py's 2^19 overflows, as for ``subsp``).

``chip_smoke.py`` times them and :mod:`fries_tpu_torch.profile_step`
profiles them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fries_tpu_torch import cisd, dets, real_systems, scf, synth
from fries_tpu_torch.drivers import (fciqmc, frifull, frifull_hh, frimulti, frisys,
                                     frisys_hh, observables, power, subspace)
from fries_tpu_torch.ops import hubbard
from fries_tpu_torch.ops import molecule as mol

N_SAMP = 1_000_000
CAPACITY = 1 << 21
SPAWN_CAP = 1_032_768
EPS = 1e-3
N_DETERM = 150
DETERM_MAX_SHARE = 0.7   # of matr_samp, for the dense block's elements


# Ne/cc-pVQZ's D2h irreps in the XOR ids (Ag 0, B1g 1, B2g 2, B3g 3, Au 4,
# B1u 5, B2u 6, B3u 7) of the real RHF orbitals less the frozen 1s, in
# orbital order (degenerate orbitals by ascending id): 2s, 2p, 3p, 3s, 3d,
# ...  s: Ag; p: B1u, B2u, B3u; d: 2 Ag, B1g, B2g, B3g; f: Au, 2 B1u, 2
# B2u, 2 B3u; g: 3 Ag, 2 B1g, 2 B2g, 2 B3g; over 5s4p3d2f1g less the 1s:
# Ag 13, B1u / B2u / B3u 8 each, B1g / B2g / B3g 5 each, Au 2.
NE_QZ_SYMM = (0, 5, 6, 7, 5, 6, 7, 0, 0, 0, 1, 2, 3, 5, 6, 7, 0, 4, 5, 5, 6, 6, 7, 7, 0, 0,
              1, 2, 3, 0, 0, 0, 1, 1, 2, 2, 3, 3, 5, 6, 7, 4, 5, 5, 6, 6, 7, 7, 0, 0, 1, 2,
              3, 0)
NE_QZ_SAMP = 500_000
NE2_R = 5.84             # bohr: Ne2's equilibrium distance (3.09 Angstrom)
NE2_FROZEN = 4           # electrons: both 1s
NE_QZ_CAPACITY = 1 << 20
NE_QZ_SPAWN_CAP = 532_768


def config(**stages) -> frisys.FrisysConfig:
    """The 1e6 rung; ``stages`` sets ``fuse_ab`` / ``fuse_cd`` (the
    ``unfused`` configuration turns both off)."""
    return frisys.FrisysConfig(eps=EPS, vec_nonz=N_SAMP, matr_samp=N_SAMP,
                               capacity=CAPACITY, spawn_cap=SPAWN_CAP,
                               target_norm=2.0 * N_SAMP, **stages)


def estimator_args(aux):
    return (aux["num_keys"], aux["num_vals"], aux["den_keys"], aux["den_vals"],
            aux["ref_key"])


def build(device, seed: int = 0, **stages):
    """The rung's workload on ``device`` (``stages``: :func:`config`).
    Returns (step, state, est, aux): ``step(state, *est)`` advances one
    iteration, and ``aux`` is :func:`fries_tpu_torch.drivers.frisys.build`'s."""
    ham = synth.n2_ccpvdz_like(seed=1, device=device)
    step, _, state, aux = frisys.build(ham, config(**stages), seed=seed)
    return step, state, estimator_args(aux), aux


def determ_space(ham, n_determ: int = N_DETERM, max_elements: float | None = None):
    """HF and the ``n_determ - 1`` determinants with the largest
    |((H - E_HF) HF)|, ties in the arena's order, as (n, W) int64 words; cut to the
    largest prefix whose dense block has fewer than ``max_elements``
    elements when that is given."""
    hf = dets.hf_det(ham.n_orb, ham.n_elec)
    keys, vals = frisys.compute_htrial(ham, hf[None].numpy(), np.ones(1))
    (packed, hf_key), _, _ = dets.order_keys(torch.as_tensor(keys), hf)
    packed = packed.numpy()
    rest = packed != int(hf_key)
    order = np.lexsort((packed[rest], -np.abs(vals[rest])))[:n_determ - 1]
    space = np.concatenate([hf[None].numpy(), keys[rest][order]])
    if max_elements is not None:
        block = frisys.build_determ_block(ham, space)
        per_member = torch.bincount(block["from"], minlength=len(space)).cumsum(0)
        space = space[:max(1, int((per_member < max_elements).sum()))]
    return space


def build_semistoch(device, seed: int = 0):
    """The ``semistoch`` configuration on ``device``.  Returns (step, state,
    est, aux); ``step(state, *est, protected_keys=aux["protected_keys"])``
    advances one iteration; the merge sees ``SPAWN_CAP + aux["n_elements"]``
    spawns."""
    ham = synth.n2_ccpvdz_like(seed=1, device=device)
    space = determ_space(ham, max_elements=DETERM_MAX_SHARE * N_SAMP)
    step, _, state, aux = frisys.build(ham, config(), seed=seed, determ_keys=space)
    return step, state, estimator_args(aux), aux


def frifull_system(device=None):
    return synth.make_system(14, 6, seed=1, scale_two=0.1, device=device)


def frifull_config(dedup_cap: int = 0) -> power.PowerConfig:
    return power.PowerConfig(eps=0.005, target_nonz=30_000, capacity=1 << 18,
                             target_norm=60_000.0, batch=1024, spawn_rows=49_152,
                             dedup_cap=dedup_cap)


def build_frifull(device, dedup_cap: int = 0, seed: int = 0):
    """The ``frifull`` configuration on ``device``.  Returns (step, state,
    est, aux) as :func:`build` does; ``aux["n_excitations"]`` is the
    template's candidates per determinant (a chunk's merge sees
    ``batch * n_excitations`` spawns, or ``dedup_cap``)."""
    ham = frifull_system(device)
    step, _, state, aux = frifull.build(ham, frifull_config(dedup_cap), seed=seed)
    tmpl = mol.ExcitationTemplate.build(ham.n_orb, ham.n_elec)
    aux["n_excitations"] = tmpl.n_doub + tmpl.n_sing
    return step, state, estimator_args(aux), aux


def observables_config(replica: bool = False) -> observables.ObservablesConfig:
    return observables.ObservablesConfig(eps=0.005, target_nonz=30_000, capacity=1 << 18,
                                         obs_des=2, obs_cre=3, exponent=0.5, burn_in=6,
                                         n_obs=3, btw_obs=3, replica=replica, batch=1024)


def build_observables(device, replica: bool = False, seed: int = 0):
    """The ``observables`` (or with ``replica`` the ``obs_repl``)
    configuration on ``device``.  Returns (step, state, aux): ``step(state)``
    advances one iteration; ``aux["n_excitations"]`` is the template's
    candidates per determinant (a chunk's merge sees ``batch *
    n_excitations`` spawns)."""
    ham = frifull_system(device)
    step, _, state, aux = observables.build(ham, observables_config(replica), seed=seed)
    tmpl = mol.ExcitationTemplate.build(ham.n_orb, ham.n_elec)
    aux["n_excitations"] = tmpl.n_doub + tmpl.n_sing
    return step, state, aux


def subspace_config(**modes) -> subspace.SubspaceConfig:
    """bench.py's subsp configuration; ``modes`` sets the subspace's modes
    (``lowmem``, ``compress_mode``)."""
    return subspace.SubspaceConfig(eps=0.02, n_trial=2, vec_nonz=100_000,
                                   matr_samp=200_000, capacity=1 << 20,
                                   spawn_cap=300_000, restart_int=10, **modes)


def hf_and_single(ham, occ: int, virt: int):
    """(2, 1, W) trial keys: HF and its single occ -> virt."""
    hf = dets.hf_det(ham.n_orb, ham.n_elec)
    single, _ = dets.single_parity(hf[None], torch.tensor([occ]), torch.tensor([virt]))
    return torch.stack([hf[None], single]).numpy()


def build_subspace(device, seed: int = 0, **modes):
    """The subsp configuration (with ``modes``, :func:`subspace_config`) on
    ``device``.  Returns (step, state, aux): ``step(state)`` advances one
    iteration, and ``aux`` is :func:`fries_tpu_torch.drivers.subspace.build`'s."""
    ham = synth.ne_augccpvdz_like(seed=1, device=device)
    step, _, state, aux = subspace.build(ham, subspace_config(**modes),
                                         hf_and_single(ham, 4, 10), [[1.0], [1.0]], seed=seed)
    return step, state, aux


def subspfull_config() -> subspace.SubspaceConfig:
    return subspace.SubspaceConfig(eps=0.005, n_trial=2, vec_nonz=30_000, matr_samp=30_000,
                                   capacity=1 << 18, spawn_cap=42_000, restart_int=10,
                                   exact_h=True, batch=1024)


def build_subspfull(device, seed: int = 0):
    """The ``subspfull`` configuration on ``device``.  Returns (step, state,
    aux) as :func:`build_subspace` does; ``aux["n_excitations"]`` is the
    template's candidates per determinant (a chunk's merge sees T * batch *
    n_excitations spawns)."""
    ham = frifull_system(device)
    step, _, state, aux = subspace.build(ham, subspfull_config(), hf_and_single(ham, 2, 3),
                                         [[1.0], [1.0]], seed=seed)
    tmpl = mol.ExcitationTemplate.build(ham.n_orb, ham.n_elec)
    aux["n_excitations"] = tmpl.n_doub + tmpl.n_sing
    return step, state, aux


def frifull_hh_system() -> hubbard.HubbardHolstein:
    return hubbard.HubbardHolstein(n_sites=4, n_elec=4, ph_bits=3, u=2.0, omega=1.0, g=0.5)


def frifull_hh_config() -> power.PowerConfig:
    return power.PowerConfig(eps=0.01, target_nonz=30_000, capacity=1 << 17,
                             target_norm=60_000.0)


def build_frifull_hh(device, seed: int = 0):
    """The ``frifull_hh`` configuration on ``device``.  Returns (step, state,
    est, aux) as :func:`build` does."""
    step, _, state, aux = frifull_hh.build(frifull_hh_system(), 0.0, frifull_hh_config(),
                                           seed=seed, device=device)
    return step, state, estimator_args(aux), aux


def frisys_hh_system() -> hubbard.HubbardHolstein:
    return hubbard.HubbardHolstein(n_sites=12, n_elec=12, ph_bits=3, u=2.0, omega=1.0, g=0.5)


def frisys_hh_config() -> frisys_hh.FrisysHHConfig:
    return frisys_hh.FrisysHHConfig(eps=0.01, vec_nonz=N_SAMP, matr_samp=N_SAMP,
                                    capacity=CAPACITY, spawn_cap=int(N_SAMP * 1.4),
                                    target_norm=2.0 * N_SAMP)


def build_frisys_hh(device, seed: int = 0):
    """The ``frisys_hh`` configuration on ``device``.  Returns (step, state,
    est, aux) as :func:`build` does."""
    step, _, state, aux = frisys_hh.build(frisys_hh_system(), 0.0, frisys_hh_config(),
                                          seed=seed, device=device)
    return step, state, estimator_args(aux), aux


def frisys_hh_wide_system() -> hubbard.HubbardHolstein:
    return hubbard.HubbardHolstein(n_sites=16, n_elec=16, ph_bits=3, u=2.0, omega=1.0, g=0.5)


def build_frisys_hh_wide(device, seed: int = 0):
    """The ``frisys_hh_wide`` configuration on ``device``.  Returns (step,
    state, est, aux) as :func:`build` does."""
    step, _, state, aux = frisys_hh.build(frisys_hh_wide_system(), 0.0, frisys_hh_config(),
                                          seed=seed, device=device)
    return step, state, estimator_args(aux), aux


def fciqmc_system(device=None):
    return synth.n2_ccpvdz_like(seed=2, device=device)


def fciqmc_config(bench_values: bool = False) -> fciqmc.FciqmcConfig:
    """The ``fciqmc`` configuration; ``bench_values`` gives bench.py's own
    capacity (2^21) and shift interval (10)."""
    return fciqmc.FciqmcConfig(eps=1e-3, target_walkers=5_000_000.0,
                               capacity=1 << (21 if bench_values else 22),
                               attempt_cap=1 << 23, spawn_cap=1 << 22, distribution="HB",
                               integer_walkers=True, init_thresh=3.0, shift_damping=1.0,
                               shift_interval=10 if bench_values else 1)


FCIQMC_INIT_WALKERS = 4_000_000.0


def build_fciqmc(device, seed: int = 0):
    """The ``fciqmc`` configuration on ``device``.  Returns (step, state, est,
    aux): ``step(state, *est)`` advances one iteration, and ``aux`` is
    :func:`fries_tpu_torch.drivers.fciqmc.build`'s."""
    step, _, state, aux = fciqmc.build(fciqmc_system(device), fciqmc_config(), seed=seed,
                                       init_walkers=FCIQMC_INIT_WALKERS)
    return step, state, estimator_args(aux), aux


def frimulti_config() -> frimulti.FrimultiConfig:
    return frimulti.FrimultiConfig(eps=EPS, vec_nonz=N_SAMP, matr_samp=N_SAMP,
                                   capacity=CAPACITY, spawn_cap=int(N_SAMP * 1.4),
                                   target_norm=2.0 * N_SAMP, distribution="HB")


def build_frimulti(device, seed: int = 0):
    """The ``frimulti`` configuration on ``device``.  Returns (step, state,
    est, aux) as :func:`build` does."""
    ham = synth.n2_ccpvdz_like(seed=1, device=device)
    step, _, state, aux = frimulti.build(ham, frimulti_config(), seed=seed)
    return step, state, estimator_args(aux), aux


def ne_qz_system(device="cuda"):
    """Ne/cc-pVQZ with the 1s frozen: 54 orbitals, 8 electrons, four-word
    determinants (:func:`fries_tpu_torch.real_systems.ne_ccpvqz`)."""
    return real_systems.ne_ccpvqz(device)


def ne_qz_config(unnorm: bool = False) -> frisys.FrisysConfig:
    return frisys.FrisysConfig(eps=EPS, vec_nonz=NE_QZ_SAMP, matr_samp=NE_QZ_SAMP,
                               capacity=NE_QZ_CAPACITY, spawn_cap=NE_QZ_SPAWN_CAP,
                               init_thresh=1.0, target_norm=2.0 * NE_QZ_SAMP, unnorm=unnorm)


def build_ne_qz(device, unnorm: bool = False, seed: int = 0, ham=None):
    """The ``ne_qz`` configuration (``unnorm``: its unnormalized run) on
    ``device`` (``ham``: the system, when already built there).  Returns
    (step, state, est, aux) as :func:`build` does."""
    ham = ne_qz_system(device) if ham is None else ham
    step, _, state, aux = frisys.build(ham, ne_qz_config(unnorm), seed=seed)
    return step, state, estimator_args(aux), aux


def ne2_qz_molecule(device="cuda"):
    """(Ne2/cc-pVQZ's MolecularHamiltonian, the SCF's info): 108 active
    orbitals, 16 electrons, seven-word determinants, built on ``device``
    (:func:`fries_tpu_torch.scf.build_molecule`; ``info["seconds"]`` times
    its stages)."""
    centers = np.array([[0.0, 0.0, -NE2_R / 2], [0.0, 0.0, NE2_R / 2]])
    return scf.build_molecule(("Ne", "Ne"), centers, basis="cc-pvqz", n_frozen=NE2_FROZEN,
                              device=device)


def build_ne2_qz(device, seed: int = 0, ham=None):
    """``ne2_qz`` on ``device`` (``ham``: Ne2/cc-pVQZ, when already built
    there).  Returns (step, state, est, aux) as :func:`build` does."""
    ham = ne2_qz_molecule(device)[0] if ham is None else ham
    step, _, state, aux = frisys.build(ham, ne_qz_config(), seed=seed)
    return step, state, estimator_args(aux), aux


def build_ne2_qz_subsp(device, seed: int = 0, ham=None):
    """``ne2_qz_subsp`` on ``device`` (``ham``: Ne2/cc-pVQZ, when already
    built there).  Returns (step, state, aux) as :func:`build_subspace`
    does."""
    ham = ne2_qz_molecule(device)[0] if ham is None else ham
    return build_ne_qz_subsp(device, seed, ham=ham)


def ne_qz_single(ham):
    """bench.py's real-system single: the HOMO to the first virtual of its
    irrep in ``ham.symm``, as (occ, virt)."""
    symm = ham.symm.cpu().numpy()
    o = ham.n_elec // 2 - 1
    return o, next(i for i in range(o + 1, ham.n_orb) if symm[i] == symm[o])


def build_ne_qz_subsp(device, seed: int = 0, ham=None, **modes):
    """The ``ne_qz_subsp`` configuration on ``device`` (``ham``: the system,
    when already built there).  Returns (step, state, aux) as
    :func:`build_subspace` does."""
    ham = ne_qz_system(device) if ham is None else ham
    step, _, state, aux = subspace.build(ham, subspace_config(**modes),
                                         hf_and_single(ham, *ne_qz_single(ham)),
                                         [[1.0], [1.0]], seed=seed)
    return step, state, aux


# ---------------------------------------------------------------------------
# bench.py's real-molecule branches
# ---------------------------------------------------------------------------

def build_real(device, seed: int = 0, ham=None):
    """``rung_real``: the 1e6 rung on real N2/cc-pVDZ (``ham``: the system,
    when already built on ``device``).  Returns (step, state, est, aux) as
    :func:`build` does."""
    ham = real_systems.n2_ccpvdz(device) if ham is None else ham
    step, _, state, aux = frisys.build(ham, config(), seed=seed)
    return step, state, estimator_args(aux), aux


def cisd_determ_space(ham, n_determ: int = N_DETERM):
    """(space (n_determ, W) int64 numpy, e_cisd_corr): the ``n_determ``
    determinants of largest |c| in ``ham``'s CISD ground state, computed on
    ``ham``'s device; |c| rounded to 1e-10, ties in the arena's order (the
    CISD's determinants are sorted so)."""
    e, words, vec = cisd.cisd_ground_state(ham)
    return cisd.largest(words, vec, n_determ)[0], e


def build_semistoch_cisd(device, seed: int = 0, ham=None):
    """``semistoch_cisd``: ``rung_real`` plus the 150-determinant CISD
    space.  Returns (step, state, est, aux) as :func:`build_semistoch`
    does; ``aux["e_cisd"]`` is the CISD correlation energy."""
    ham = real_systems.n2_ccpvdz(device) if ham is None else ham
    space, e_cisd = cisd_determ_space(ham)
    step, _, state, aux = frisys.build(ham, config(), seed=seed, determ_keys=space)
    aux["e_cisd"] = e_cisd
    return step, state, estimator_args(aux), aux


FRIFULL_REAL_ORBITALS = 12


def frifull_real_system(device="cuda", full=None):
    """Real H2O/cc-pVDZ (``full``, when already built) sliced to its first
    :data:`FRIFULL_REAL_ORBITALS` orbitals: (10e, 12o)."""
    full = real_systems.h2o_ccpvdz(device) if full is None else full
    k = FRIFULL_REAL_ORBITALS
    return mol.MolecularHamiltonian(
        hcore=full.hcore[:k, :k].contiguous(), eris=full.eris[:k, :k, :k, :k].contiguous(),
        symm=full.symm[:k].contiguous(), n_orb=k, n_elec=full.n_elec, n_frozen=full.n_frozen)


def frifull_real_config() -> power.PowerConfig:
    return power.PowerConfig(eps=0.005, target_nonz=30_000, capacity=1 << 21,
                             target_norm=60_000.0, batch=1024, spawn_rows=49_152,
                             dedup_cap=1 << 19)


def build_frifull_real(device, seed: int = 0, ham=None):
    """``frifull_real`` on ``device`` (``ham``: the sliced system, when
    already built there).  Returns (step, state, est, aux) as
    :func:`build_frifull` does."""
    ham = frifull_real_system(device) if ham is None else ham
    step, _, state, aux = frifull.build(ham, frifull_real_config(), seed=seed)
    tmpl = mol.ExcitationTemplate.build(ham.n_orb, ham.n_elec)
    aux["n_excitations"] = tmpl.n_doub + tmpl.n_sing
    return step, state, estimator_args(aux), aux


def build_fciqmc_real(device, seed: int = 0, ham=None, bench_values: bool = False):
    """``fciqmc_real``: :func:`fciqmc_config` (or with ``bench_values``
    bench.py's own) on real stretched N2 (``ham``, when already built on
    ``device``).  Returns (step, state, est, aux) as :func:`build_fciqmc`
    does."""
    ham = real_systems.n2_stretched(device) if ham is None else ham
    step, _, state, aux = fciqmc.build(ham, fciqmc_config(bench_values), seed=seed,
                                       init_walkers=FCIQMC_INIT_WALKERS)
    return step, state, estimator_args(aux), aux


# ---------------------------------------------------------------------------
# hash-sharded configurations
# ---------------------------------------------------------------------------

SUBSP_EXCHANGE_CAP = 600_000


def build_real_sharded(shards, seed: int = 0, ham=None):
    """``rung_real_sharded`` on this rank (``shards``; ``ham``: real
    N2/cc-pVDZ on the rank's device, when already built).  Returns (step,
    state, est, aux) as :func:`build` does."""
    ham = real_systems.n2_ccpvdz(shards.device) if ham is None else ham
    cfg = dataclasses.replace(config(), n_shards=shards.size)
    step, _, state, aux = frisys.build_sharded(ham, cfg, seed, shards)
    return step, state, estimator_args(aux), aux


def subsp_sharded_config(n_shards: int) -> subspace.SubspaceConfig:
    return dataclasses.replace(subspace_config(), n_shards=n_shards,
                               exchange_cap=SUBSP_EXCHANGE_CAP)


def build_subsp_sharded(shards, seed: int = 0, ham=None):
    """``subsp_sharded`` on this rank (``ham``: real Ne/cc-pVQZ on the
    rank's device, when already built).  Returns (step, state, aux) as
    :func:`build_subspace` does."""
    ham = ne_qz_system(shards.device) if ham is None else ham
    step, _, state, aux = subspace.build_sharded(
        ham, subsp_sharded_config(shards.size), hf_and_single(ham, *ne_qz_single(ham)),
        [[1.0], [1.0]], seed, shards)
    return step, state, aux
