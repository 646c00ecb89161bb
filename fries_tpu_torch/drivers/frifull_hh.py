"""frifull_hh: the exact-Hamiltonian FRI power method for the
Hubbard-Holstein model.

Counterpart of ``fries_tpu/drivers/frifull_hh.py``: the Neel state at value
``init_val`` in a two-row arena, the exact off-diagonal spawner
(:func:`fries_tpu_torch.ops.hubbard.offdiag_batch`, through
:func:`fries_tpu_torch.drivers.power.chunked` when ``cfg.batch`` is set) on
the power core, the diagonal U * n_doub + omega * n_ph - e_ref, and the
direct estimator on the static connected set of the Neel state:

    numerator   = <neel| (H - e_ref) |psi>
    denominator = psi(neel)

``e_ref`` is the parameter file's ``gs_energy``.  The whole candidate
stream goes through one merge per step (the sorted-merge kernel on the
card), with the Neel state's keep bit.
"""

from __future__ import annotations

import torch

from fries_tpu_torch import dets
from fries_tpu_torch.drivers import power
from fries_tpu_torch.ops import hubbard as hub
from fries_tpu_torch.runtime import arena as ar

F64 = torch.float64


def neel_state(ham: hub.HubbardHolstein, device=None) -> torch.Tensor:
    """The Neel state's (W,) words."""
    return dets.pack_bits(dets.neel_bits_1d(ham.n_sites, ham.n_elec, ham.n_bits, device),
                          ham.n_words)


def estimator_aux(ham: hub.HubbardHolstein, neel, e_ref: float) -> dict:
    """The direct estimator's queries: the Neel state's connected set and
    the Neel state itself."""
    dev = neel.device
    conn_keys, conn_mels = hub.reference_connections(ham, neel, e_ref, device=dev)
    return {"e_ref": e_ref, "num_keys": conn_keys, "num_vals": conn_mels,
            "den_keys": neel[None], "den_vals": torch.ones(1, dtype=F64, device=dev),
            "ref_key": neel, "neel": neel}


def start_state(ham: hub.HubbardHolstein, capacity: int, neel, seed: int,
                init_val: float) -> power.PowerState:
    """A two-row arena holding ``init_val`` on the Neel state."""
    dev = neel.device
    a = ar.from_unsorted(ar.make(capacity, ham.n_words, 2, device=dev), neel[None],
                         torch.tensor([[init_val], [0.0]], dtype=F64, device=dev))
    return power.fresh_state(a, seed)


def build(ham: hub.HubbardHolstein, e_ref: float, cfg: power.PowerConfig, seed: int,
          init_val: float = 100.0, device=None):
    """Returns (step, run_steps, state, aux) on ``device``; ``aux`` holds the
    estimator's queries and the spawner (``aux["spawn"]``)."""
    neel = neel_state(ham, device)

    def spawn_one(keys, vals, h_fac, rns):
        new_words, amps = hub.offdiag_batch(ham, keys, vals, h_fac)
        return (new_words.reshape(-1, ham.n_words), amps.reshape(-1),
                power.per_parent_ini(vals, cfg.init_thresh, amps.shape[1]))

    spawn = power.chunked(spawn_one, cfg.capacity, cfg.batch, ham.n_words)
    step, run_steps = power.make_stepper(
        spawn, lambda keys: hub.diag_matrel(ham, keys) - e_ref, cfg, estimator="direct")
    aux = {**estimator_aux(ham, neel, e_ref), "spawn": spawn}
    return step, run_steps, start_state(ham, cfg.capacity, neel, seed, init_val), aux
