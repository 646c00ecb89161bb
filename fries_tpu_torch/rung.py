"""The 1e6 rung of bench.py's frisys_mol ladder (``FULL_LADDER``) on the
synthetic N2/cc-pVDZ-sized system ``synth.n2_ccpvdz_like(seed=1)``.

One definition for every script that drives the port at this size:
``chip_smoke.py`` times it and :mod:`fries_tpu_torch.profile_step` profiles
it.  eps 1e-3, vec_nonz = matr_samp = 1e6, arena capacity 2^21, spawn buffer
1,032,768 (matr_samp plus slack), target_norm 2e6, HF trial vector.
"""

from __future__ import annotations

from fries_tpu_torch import synth
from fries_tpu_torch.drivers import frisys

N_SAMP = 1_000_000
CAPACITY = 1 << 21
SPAWN_CAP = 1_032_768
EPS = 1e-3


def config() -> frisys.FrisysConfig:
    return frisys.FrisysConfig(eps=EPS, vec_nonz=N_SAMP, matr_samp=N_SAMP,
                               capacity=CAPACITY, spawn_cap=SPAWN_CAP,
                               target_norm=2.0 * N_SAMP)


def build(device, seed: int = 0):
    """The rung's workload on ``device``.  Returns (step, state, est, aux):
    ``step(state, *est)`` advances one iteration, and ``aux`` is
    :func:`fries_tpu_torch.drivers.frisys.build`'s."""
    ham = synth.n2_ccpvdz_like(seed=1, device=device)
    step, _, state, aux = frisys.build(ham, config(), seed=seed)
    est = (aux["num_keys"], aux["num_vals"], aux["den_keys"], aux["den_vals"],
           aux["ref_key"])
    return step, state, est, aux
