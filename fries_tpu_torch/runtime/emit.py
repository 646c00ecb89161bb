"""comp_sub output-slot emission: the plain torch version and the wrapper of
its CUDA kernel (``csrc/emit.cu``).

Replaces the TPU kernel ``fries_tpu/runtime/pallas_emit.py:_make_kernel``
(reached through ``pallas_emit.emit`` from ``compress.comp_sub``).  For each
output slot ``s < total``: the parent is the LAST ``i`` with
``offsets[i] <= s`` (zero-count parents share offsets) and ``r = s -
offsets[i]``.  Slots ``r < kept_counts[i]`` emit the r-th kept sub (``w >=
thr`` and ``w > w_floor``) with its own value; the others emit the grid point
``y = (rn + g_start + r - kept) * unit - cum_parent`` with value ``unit``:
weighted parents pick the non-kept sub whose inclusive f32 mass prefix first
passes ``y`` (clamped to the last non-kept sub), uniform parents pick
``floor(y / rem * ndiv)``.  Invalid slots are ``(0, -1, -1)``.

The f32 prefix mirrors the reference: ``kernels.row_cumsum`` builds the
within-row prefix in f32 even for f64 stages and compares it with the f64
``y``.

On the H100 the kernel is bound by the bytes it reads: one binary search
over ``offsets`` (log2 N dependent loads, mostly L2 hits) plus one parent row
of ``K`` stage values per slot, read twice.  The simple design keeps one
thread per slot and reads the row straight from device memory; neighbouring
slots share a parent, so the row reads coalesce through L1/L2.
"""

from __future__ import annotations

import ctypes

import torch

from fries_tpu_torch import _build

F64 = torch.float64

LAUNCHES = 0
"""Kernel launches made by :func:`emit` (CUDA tensors only)."""

_EMIT_CHUNK_ELEMS = 1 << 26   # bounds the (slots, K) temporaries of the plain path


def emit_plain(offsets, kept_counts, g_start, ndiv, uniform, w_sub,
               cum_parent, parent_rem, u_val, rn, unit, thr, w_floor, total,
               out_size: int, k: int | None = None):
    """Plain torch emission.  ``w_sub`` is the (N, K) stage tensor or a
    function mapping a parent-index vector to its (M', K) rows (the factored
    stage recomputes rows from its factors; ``k`` then gives K).  Returns
    (out_val f64, out_parent int64, out_sub int64), each (out_size,)."""
    dev = offsets.device
    n = offsets.shape[0]
    if callable(w_sub):
        rows = w_sub
    else:
        k = w_sub.shape[1]
        rows = lambda p: w_sub[p]
    col_ids = torch.arange(k, device=dev)
    chunk = max(1, _EMIT_CHUNK_ELEMS // max(k, 1))
    parts = []
    for s0 in range(0, out_size, chunk):
        slot = torch.arange(s0, min(s0 + chunk, out_size), device=dev)
        valid = slot < total
        parent = (torch.searchsorted(offsets, slot, right=True) - 1).clamp(0, n - 1)
        r = slot - offsets[parent]
        p_kept = kept_counts[parent]
        p_uni = uniform[parent]
        p_ndiv_f = ndiv[parent].clamp_min(1).to(F64)
        w_rows = rows(parent)
        keep_rows = (w_rows > w_floor) & (w_rows.to(F64) >= thr)
        rem_rows_v = torch.where(keep_rows, 0.0, w_rows)

        kept_rank = torch.cumsum(keep_rows, -1) - 1
        kept_col = torch.where(keep_rows & (kept_rank == r[:, None]), col_ids, 0).sum(-1)
        kept_sub = torch.where(p_uni, r, kept_col)
        kept_val = torch.where(
            p_uni, u_val[parent],
            w_rows.gather(-1, kept_sub.clamp(0, k - 1)[:, None])[:, 0].to(F64))

        g = g_start[parent].to(F64) + (r - p_kept).to(F64)
        y = (rn + g) * unit - cum_parent[parent]
        uni_sub = torch.minimum(
            torch.floor(y / parent_rem[parent].clamp_min(1e-300) * p_ndiv_f)
            .clamp_min(0.0), p_ndiv_f - 1).to(torch.int64)
        live = rem_rows_v > 0
        row_cum = torch.cumsum(rem_rows_v.to(torch.float32), -1).to(F64)
        wt_sub = ((row_cum <= y[:, None]) & live).sum(-1)
        wt_sub = torch.minimum(wt_sub, (live.sum(-1) - 1).clamp_min(0))
        nk_rank = torch.cumsum(live, -1) - 1
        wt_col = torch.where(live & (nk_rank == wt_sub[:, None]), col_ids, 0).sum(-1)

        is_kept = r < p_kept
        sub = torch.where(is_kept, kept_sub, torch.where(p_uni, uni_sub, wt_col))
        val = torch.where(is_kept, kept_val, unit)
        parts.append((torch.where(valid, val, 0.0),
                      torch.where(valid, parent, -1),
                      torch.where(valid, sub, -1)))
    return tuple(torch.cat(p) for p in zip(*parts))


def _emit_cuda(offsets, kept_counts, g_start, ndiv, uniform, w_sub,
               cum_parent, parent_rem, u_val, rn, unit, thr, w_floor, total,
               out_size):
    global LAUNCHES
    n, k = w_sub.shape
    if w_sub.dtype not in (torch.float32, F64):
        raise ValueError(f"emit: w_sub must be float32 or float64, got {w_sub.dtype}")
    if n < 1:
        raise ValueError("emit: at least one parent row is required")
    for name, t, dt in (("offsets", offsets, torch.int64),
                        ("kept_counts", kept_counts, torch.int64),
                        ("g_start", g_start, torch.int64),
                        ("ndiv", ndiv, torch.int64),
                        ("uniform", uniform, torch.bool),
                        ("cum_parent", cum_parent, F64),
                        ("parent_rem", parent_rem, F64),
                        ("u_val", u_val, F64)):
        _build.check_tensor("emit", name, t, dt, (n,))
    _build.check_tensor("emit", "w_sub", w_sub, w_sub.dtype, (n, k))
    dev = w_sub.device
    scal = torch.stack([torch.as_tensor(x, dtype=F64, device=dev).reshape(())
                        for x in (rn, unit, thr, w_floor)])
    total = torch.as_tensor(total, dtype=torch.int64, device=dev).reshape(1)
    out_val = torch.empty(out_size, dtype=F64, device=dev)
    out_parent = torch.empty(out_size, dtype=torch.int64, device=dev)
    out_sub = torch.empty(out_size, dtype=torch.int64, device=dev)
    lib = _build.load()
    fn = lib.fries_emit_f32 if w_sub.dtype == torch.float32 else lib.fries_emit_f64
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    err = fn(p(offsets), p(kept_counts), p(g_start), p(ndiv), p(uniform),
             p(w_sub), p(cum_parent), p(parent_rem), p(u_val), p(scal), p(total),
             ctypes.c_int64(n), ctypes.c_int64(k), ctypes.c_int64(out_size),
             p(out_val), p(out_parent), p(out_sub),
             ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"emit kernel launch failed: {_build.error_string(err)}")
    LAUNCHES += 1
    return out_val, out_parent, out_sub


def emit(offsets, kept_counts, g_start, ndiv, uniform, w_sub, cum_parent,
         parent_rem, u_val, rn, unit, thr, w_floor, total, out_size: int):
    """comp_sub's emission: the CUDA kernel for tensors on the card, the
    plain version for tensors on the CPU.  Scalars (``rn``, ``unit``,
    ``thr``, ``w_floor``, ``total``) may be 0-dim device tensors, so the
    kernel path reads nothing back to the host."""
    if w_sub.is_cuda:
        return _emit_cuda(offsets, kept_counts, g_start, ndiv, uniform,
                          w_sub.contiguous(), cum_parent, parent_rem, u_val,
                          rn, unit, thr, w_floor, total, out_size)
    return emit_plain(offsets, kept_counts, g_start, ndiv, uniform, w_sub,
                      cum_parent, parent_rem, u_val, rn, unit, thr, w_floor,
                      total, out_size)
