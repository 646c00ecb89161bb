"""The card's published peaks and the bytes a kernel's call needs.

A roofline share is the least time the card could take for what a call's
data needs, over the device time it took.  Bytes count each input read once
and each output written once, as this run's data needs them (an arena's
rows up to ``n_used``, a walk up to its last emitted column), never the most
a call could touch.  The counts are device tensors, so reading them waits
for nothing inside a step.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12   # NVIDIA H100 SXM, published: 80 GB HBM3 at 3.35 TB/s
F32_OPS_PER_S = 67e12       # NVIDIA H100 SXM, published: f32 outside the tensor cores


def bound_s(n_bytes: float, n_ops: float = 0.0) -> float:
    """The least time: bytes over the memory rate or f32 operations over the
    peak rate, whichever is larger."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def merge_bytes(arena, spawn_keys, spawn_vals, spawn_ini, *_, keep_mask=None, **__):
    """Kernel A's call (``runtime.merge.accumulate``): the arena's keys and
    value rows up to ``n_used`` (and the keep mask's rows there) and the
    spawn tensors in, the arena at full capacity out.  Returns (bytes, ops)
    as 0-dim device tensors."""
    cap = arena.keys.shape[0]
    row = arena.keys.nbytes // cap + arena.vals.nbytes // cap
    n_used = arena.n_used[0].to(torch.int64)
    n_bytes = (row * (n_used + cap) + spawn_keys.nbytes + spawn_vals.nbytes
               + spawn_ini.nbytes
               + (0 if keep_mask is None else n_used * keep_mask.element_size()))
    return n_bytes, torch.zeros_like(n_bytes)


def emit_bytes(plan: dict, parent, sub):
    """Kernel B's call on this data (``parent``, ``sub``: its output):
    offsets for every parent; for each parent with a slot its other scalars
    (25 B weighted: kept_counts, g_start, uniform, cum_parent; 49 B uniform,
    with ndiv, parent_rem and u_val); for each weighted parent the columns
    its walk reaches, up to its last emitted sub (dense: one value each;
    factored: the fa, fb and kill entries of those columns); 24 B per
    output slot.  Ops: per column walked the keep test and the prefix add
    (and the factored product).  Returns (bytes, ops) as 0-dim tensors."""
    n = plan["offsets"].shape[0]
    live = parent >= 0
    last = torch.full((n,), -1, dtype=torch.int64, device=parent.device)
    last.scatter_reduce_(0, torch.where(live, parent, 0), torch.where(live, sub, -1), "amax")
    has, uni = last >= 0, plan["uniform"]
    weighted = has & ~uni
    cols = torch.where(weighted, last + 1, 0)
    if "fa" in plan:
        v_k, elem = plan["fb"].shape[1], plan["fa"].element_size()
        n_fa = torch.where(weighted, (cols - 1) // v_k + 1, 0).sum()
        row = elem * (n_fa + cols.clamp_max(v_k).sum()) + (
            0 if plan.get("kill_b0") is None else n_fa)
        ops_per_col = 3
    else:
        row = plan["w_sub"].element_size() * cols.sum()
        ops_per_col = 2
    n_bytes = (8 * n + 25 * weighted.sum() + 49 * (has & uni).sum() + row
               + 24 * plan["out_size"])
    return n_bytes, ops_per_col * cols.sum()
