"""FRI power-iteration core, single-device branch.

Counterpart of ``fries_tpu/drivers/power.py``.  One step of
v <- (1 - eps (H - e_ref - S)) v:

  * the model's stochastically compressed off-diagonal spawn,
  * the sorted-merge accumulate with initiator gating and fused compaction
    (:func:`fries_tpu_torch.runtime.arena.accumulate_best`),
  * death/cloning on the diagonal recomputed from the merged keys,
  * trial / H-trial projected-energy dots on the post-death vector,
  * the norm-control shift, then find_preserve + systematic compression.

A model is a ``spawn_fn(keys, vals, h_fac, rns) -> (words, amps, ini)`` and a
``diag_fn(keys) -> (C,)`` (already e_ref-relative).  The systematic path
consumes only scalar uniforms: ``rns`` (6,) for the spawner and ``rn_vec``
for the vector compression.  ``step`` takes them as arguments and draws
them from the state's ``torch.Generator`` when they are not given.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fries_tpu_torch import compress, dets
from fries_tpu_torch.runtime import arena as ar

F64 = torch.float64
N_SPAWN_RNS = 6


@dataclass(frozen=True)
class PowerConfig:
    eps: float
    target_nonz: int
    capacity: int
    init_thresh: float = 0.0
    target_norm: float = 0.0
    shift_interval: int = 10
    shift_damping: float = 0.05


@dataclass
class PowerState:
    """Arena + scalars.  ``generator`` draws the step's uniforms when the
    caller injects none."""

    arena: ar.Arena
    en_shift: torch.Tensor
    last_norm: torch.Tensor
    iterat: int
    generator: torch.Generator


def fresh_state(a: ar.Arena, seed: int) -> PowerState:
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    zero = torch.zeros((), dtype=F64, device=a.device)
    return PowerState(arena=a, en_shift=zero, last_norm=zero.clone(), iterat=0,
                      generator=gen)


def draw_uniforms(state: PowerState):
    """(rns (6,), rn_vec) f64 uniforms in [0, 1) from the state's generator."""
    u = torch.rand(N_SPAWN_RNS + 1, dtype=F64, generator=state.generator)
    return u[:N_SPAWN_RNS], u[N_SPAWN_RNS]


def _as_f64(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=F64)
    return torch.tensor(np.asarray(x, np.float64), device=device)


def make_stepper(spawn_fn, diag_fn, cfg: PowerConfig):
    """Build (step, run_steps) for one model, with the reference's "direct"
    estimator (trial and H-trial dots on the post-death vector).

    step(state, num_keys, num_vals, den_keys, den_vals, ref_key, rns=None,
    rn_vec=None) -> (new_state, metrics) with the reference's metric keys.
    """
    eps = cfg.eps

    def step(state: PowerState, num_keys, num_vals, den_keys, den_vals,
             ref_key, rns=None, rn_vec=None):
        a = state.arena
        dev = a.device
        if rns is None or rn_vec is None:
            drawn_rns, drawn_rn = draw_uniforms(state)
            rns = drawn_rns if rns is None else rns
            rn_vec = drawn_rn if rn_vec is None else rn_vec
        rns = _as_f64(rns, dev)
        rn_vec = _as_f64(rn_vec, dev)
        vals0 = torch.where(a.valid, a.vals[0], 0.0)

        # dead rows of the previous step stay until this merge drops them
        keep_in = dets.det_eq(a.keys, ref_key[None, :])
        flat_words, flat_amps, flat_ini = spawn_fn(a.keys, vals0, -eps, rns)
        flat_words = torch.where((flat_amps != 0)[:, None], flat_words,
                                 dets.invalid_det(a.n_words, dev))
        a2, stats = ar.accumulate_best(a, flat_words, flat_amps, flat_ini,
                                       origin_row=0, dest_row=1, keep_mask=keep_in)

        # death / cloning + combine; the diagonal is recomputed from keys
        diag2 = diag_fn(a2.keys)
        new_v = a2.vals[0] * (1 - eps * (diag2 - state.en_shift)) + a2.vals[1]
        valid2 = a2.valid
        new_v = torch.where(valid2, new_v, 0.0)

        n_num = num_keys.shape[0]
        n_den = den_keys.shape[0]
        qpos, qfound = ar.lookup(a2, torch.cat([num_keys, den_keys]))
        gathered = torch.where(qfound, new_v[qpos], 0.0)
        proj_num = (gathered[:n_num] * num_vals.to(F64)).sum()
        proj_den = (gathered[n_num:n_num + n_den] * den_vals.to(F64)).sum()

        stoch_v = new_v
        keep, n_left, loc_norm = compress.find_preserve(stoch_v.abs(), cfg.target_nonz)
        glob_norm = loc_norm + torch.where(keep, stoch_v.abs(), 0.0).sum()

        do_shift = (state.iterat + 1) % cfg.shift_interval == 0
        en_shift, last_norm = state.en_shift, state.last_norm
        if do_shift:
            en_shift, last_norm = compress.adjust_shift(
                state.en_shift, glob_norm, state.last_norm, cfg.target_norm,
                cfg.shift_damping / cfg.shift_interval / eps)

        comp_v = compress.sys_comp(stoch_v, keep, n_left, rn_vec, loc_norm)
        a3 = ar.Arena(keys=a2.keys, vals=torch.stack([comp_v, torch.zeros_like(comp_v)]),
                      n_used=a2.n_used)
        is_ref = dets.det_eq(a3.keys, ref_key[None, :])
        live = (comp_v != 0) | is_ref

        metrics = {
            "proj_num": proj_num,
            "proj_den": proj_den,
            "norm": glob_norm,
            "shift": en_shift,
            "n_dets": live.sum(),
            "nkept": cfg.target_nonz - n_left,
            "n_ini": ((comp_v.abs() >= cfg.init_thresh) & (comp_v != 0)).sum(),
            "nnonz": (comp_v != 0).sum(),
            "sgn_coh": stats["nonini_occ_add"],
            "overflow": stats["overflow"],
        }
        return (PowerState(a3, en_shift, last_norm, state.iterat + 1,
                           state.generator), metrics)

    def run_steps(state, num_keys, num_vals, den_keys, den_vals, ref_key,
                  n_iter: int):
        """``n_iter`` steps (a host loop); returns (state, metrics stacked
        over the steps)."""
        traj = []
        for _ in range(n_iter):
            state, m = step(state, num_keys, num_vals, den_keys, den_vals, ref_key)
            traj.append(m)
        return state, {k: torch.stack([torch.as_tensor(m[k]) for m in traj])
                       for k in traj[0]}

    return step, run_steps
