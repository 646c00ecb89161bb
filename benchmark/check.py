"""The comparison that decides ``correct``.

The reference (:mod:`benchmark.reference`) builds its own system from the
integrals and steps a state of the program with the draws that the
program's step had; the program's state after the step is compared with
the reference's.  The steps compared: the first step of the set-up, from
the reference's own initial state; the warm-up's last step; one step of the
window picked uniformly from the seed; and the window's last step.  The
numbers, each the worst over those steps (``bad_dets`` their sum):

* ``vec_ks``: the largest gap between the running sums of |v| of the two
  vectors after the step, along the determinants' order, over the
  reference's 1-norm (the largest deviation of two cumulative
  distributions);
* ``est_gap``: the largest relative gap |a - b| / max(|a|, |b|) of the
  step's estimators and counts and of the shift state (``ESTIMATORS``);
* ``bad_dets``: rows of the program's vectors that are not determinants of
  the system (alpha or beta electrons other than half of ``n_elec``); the
  reference does not step a state that holds one.

An independent reference sums in its own order, so once in a while a grid
point that lies within rounding of a boundary falls on the other side and
one spawned amplitude lands elsewhere.  That changes the resampled mass of
the vector's compression, hence its unit, and shifts every later grid
point: many determinants then differ by a sample, but systematic resampling
keeps each side's running sum of |v| within one unit of its input's, so
``vec_ks`` moves by a few units of ~1e6 only.
"""

from __future__ import annotations

import math

import torch

ESTIMATORS = ("proj_num", "proj_den", "norm", "shift", "last_norm", "n_dets", "nnonz")


def snapshot(state) -> dict:
    """A step's state on the host: the arena and the scalars a step reads."""
    a = state.arena
    return {"keys": a.keys.cpu(), "vals": a.vals.cpu(), "en_shift": state.en_shift.cpu(),
            "last_norm": state.last_norm.cpu(), "iterat": state.iterat}


def rel(a, b) -> float:
    a, b = float(a), float(b)
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    scale = max(abs(a), abs(b))
    return 0.0 if scale == 0 else abs(a - b) / scale


def vec_ks(prog, ref) -> float:
    """``vec_ks`` of two vectors, each (columns, values) on one device."""
    (c1, v1), (c2, v2) = prog, ref
    uniq, inv = torch.unique(torch.cat([c1, c2.to(c1.device)]), dim=0, return_inverse=True)
    a = torch.zeros(uniq.shape[0], dtype=torch.float64, device=c1.device)
    b = torch.zeros_like(a)
    a.index_add_(0, inv[:c1.shape[0]], v1.to(torch.float64).abs())
    b.index_add_(0, inv[c1.shape[0]:], v2.to(a.device, torch.float64).abs())
    den = float(b.sum())
    gap = float((torch.cumsum(a, 0) - torch.cumsum(b, 0)).abs().max()) if a.numel() else 0.0
    return gap / den if den > 0 else (0.0 if gap == 0 else math.inf)


def estimator_gap(prog: dict, ref: dict) -> float:
    return max(rel(prog[k], ref[k]) for k in ESTIMATORS)


def compare(start, steps, reference) -> dict:
    """``start``: the program's initial snapshot; ``steps``: (snapshot
    before, snapshot after, the program's metrics on the host, the step's
    draws), the first from the reference's own initial state.  Returns the
    worst of each number."""
    cols, vals, shift, last = reference.start()
    first = reference.read(start)
    worst = {"vec_ks": vec_ks(first[:2], (cols, vals)), "est_gap": 0.0,
             "bad_dets": reference.sys.n_bad(first[0])}
    for i, (before, after, metrics, draws) in enumerate(steps):
        state = (cols, vals, shift, last) if i == 0 else reference.read(before)
        bad = reference.sys.n_bad(state[0])
        worst["bad_dets"] += bad
        p_cols, p_vals, p_shift, p_last = reference.read(after)
        worst["bad_dets"] += reference.sys.n_bad(p_cols)
        if bad:
            continue
        r_cols, r_vals, r_metrics = reference.advance(state, before["iterat"], draws)
        worst["vec_ks"] = max(worst["vec_ks"], vec_ks((p_cols, p_vals), (r_cols, r_vals)))
        prog = {**metrics, "shift": p_shift, "last_norm": p_last}
        worst["est_gap"] = max(worst["est_gap"], estimator_gap(prog, r_metrics))
    return worst
