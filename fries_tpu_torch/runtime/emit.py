"""comp_sub output-slot emission: the plain torch version and the wrappers of
its CUDA kernel (``csrc/emit.cu``), over two row sources.

Replaces the TPU kernel ``fries_tpu/runtime/pallas_emit.py:_make_kernel``
(pallas_emit.py:147, reached through ``pallas_emit.emit`` from
``compress.comp_sub``).  For each output slot ``s < total``: the parent is the
LAST ``i`` with ``offsets[i] <= s`` (zero-count parents share offsets) and
``r = s - offsets[i]``.  Slots ``r < kept_counts[i]`` emit the r-th kept sub
(``w >= thr`` and ``w > w_floor``) with its own value; the others emit the
grid point ``y = (rn + g_start + r - kept) * unit - cum_parent`` with value
``unit``: weighted parents pick the non-kept sub whose inclusive f32 mass
prefix first passes ``y`` (clamped to the last non-kept sub), uniform parents
pick ``floor(y / rem * ndiv)``.  Invalid slots are ``(0, -1, -1)``.

The f32 prefix mirrors the reference: ``kernels.row_cumsum`` builds the
within-row prefix in f32 even for f64 stages and compares it with the f64
``y``.

Row sources: :func:`emit` takes the (N, K) stage (the A+B and E rounds);
:func:`emit_factored` takes the rank-1 factors of ``comp_sub_factored`` (the
C+D round), ``w[i, e*V + v] = fa[i, e] * fb[i, v]`` with the v = 0 column
zeroed where ``kill_b0[i, e]`` (:func:`factored_rows`); the kernel forms
those rows on chip and never writes the (N, E*V) joint.

On the H100 the kernel is bound by bytes (3.35 TB/s): ``offsets`` for every
parent, the other scalars of each parent with slots (25 B weighted, 49 B
uniform), the part of each weighted parent's row that its walk reaches
(dense: K values at most; factored: E + V values and E kill bytes at most),
and 24 B per output slot.  A block takes consecutive parents, one thread
each, stages their rows in shared memory with 16-byte ``cp.async`` copies,
and each thread walks its row once, emitting kept subs by rank and grid
points as its f32 prefix passes them (``csrc/emit.cu`` has the design note).
"""

from __future__ import annotations

import ctypes

import torch

from fries_tpu_torch import _build, profiling

F64 = torch.float64

_EMIT_CHUNK_ELEMS = 1 << 26   # bounds the (slots, K) temporaries of the plain path


def _row_prefix(rows):
    """The inclusive prefix of each row, summed left to right as kernel B
    walks it.  On the card ``torch.cumsum`` along a row sums in a tree of
    its own; along the leading dimension it runs one thread per column,
    left to right, so the rows go through it transposed (a single row
    twice: a scan over every element of a tensor goes to CUB).  On the CPU
    both run left to right."""
    n = rows.shape[0]
    if rows.device.type != "cuda":
        return torch.cumsum(rows, -1)
    cols = (rows if n > 1 else torch.cat([rows, rows])).T.contiguous()
    return torch.cumsum(cols, 0).T[:n]


def factored_rows(fa, fb, kill_b0=None):
    """The (M, E*V) stage rows of factors ``fa`` (M, E) and ``fb`` (M, V):
    ``w[:, e*V + v] = fa[:, e] * fb[:, v]``, zero at v = 0 where
    ``kill_b0[:, e]``."""
    e_k, v_k = fa.shape[1], fb.shape[1]
    w = fa.repeat_interleave(v_k, dim=1) * fb.repeat(1, e_k)
    if kill_b0 is not None:
        col_v0 = (torch.arange(e_k * v_k, device=w.device) % v_k) == 0
        w = torch.where(kill_b0.repeat_interleave(v_k, dim=1) & col_v0,
                        torch.zeros((), dtype=w.dtype, device=w.device), w)
    return w


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
        row_cum = _row_prefix(rem_rows_v.to(torch.float32)).to(F64)
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


def emit_factored_plain(offsets, kept_counts, g_start, ndiv, uniform, fa, fb,
                        cum_parent, parent_rem, u_val, rn, unit, thr, w_floor,
                        total, out_size: int, kill_b0=None):
    """Plain torch emission over the factored source: :func:`emit_plain`
    with each slot's row rebuilt by :func:`factored_rows`."""
    def rows(parent):
        return factored_rows(fa[parent], fb[parent],
                             None if kill_b0 is None else kill_b0[parent])

    return emit_plain(offsets, kept_counts, g_start, ndiv, uniform, rows,
                      cum_parent, parent_rem, u_val, rn, unit, thr, w_floor,
                      total, out_size, k=fa.shape[1] * fb.shape[1])


def _launch(kernel, rows, dims, offsets, kept_counts, g_start, ndiv, uniform,
            cum_parent, parent_rem, u_val, rn, unit, thr, w_floor, total,
            out_size):
    """Check the per-parent arrays, allocate the outputs and launch the C
    entry ``kernel`` with the row pointers ``rows`` and row sizes ``dims``;
    each launch counts one in ``profiling``'s ``launch.emit``."""
    n = offsets.shape[0]
    if n < 1:
        raise ValueError(f"{kernel}: at least one parent row is required")
    for name, t, dt in (("offsets", offsets, torch.int64),
                        ("kept_counts", kept_counts, torch.int64),
                        ("g_start", g_start, torch.int64),
                        ("ndiv", ndiv, torch.int64),
                        ("uniform", uniform, torch.bool),
                        ("cum_parent", cum_parent, F64),
                        ("parent_rem", parent_rem, F64),
                        ("u_val", u_val, F64)):
        _build.check_tensor(kernel, name, t, dt, (n,))
    dev = offsets.device
    scal = torch.stack([torch.as_tensor(x, dtype=F64, device=dev).reshape(())
                        for x in (rn, unit, thr, w_floor)])
    total = torch.as_tensor(total, dtype=torch.int64, device=dev).reshape(1)
    out_val = torch.empty(out_size, dtype=F64, device=dev)
    out_parent = torch.empty(out_size, dtype=torch.int64, device=dev)
    out_sub = torch.empty(out_size, dtype=torch.int64, device=dev)
    p = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    err = getattr(_build.load(), kernel)(
        p(offsets), p(kept_counts), p(g_start), p(ndiv), p(uniform),
        *map(p, rows), p(cum_parent), p(parent_rem), p(u_val), p(scal), p(total),
        ctypes.c_int64(n), *map(ctypes.c_int64, dims), ctypes.c_int64(out_size),
        p(out_val), p(out_parent), p(out_sub),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: {_build.error_string(err)}")
    profiling.count("launch.emit")
    return out_val, out_parent, out_sub


def _stage_suffix(name, dtype):
    if dtype not in (torch.float32, F64):
        raise ValueError(f"emit: {name} must be float32 or float64, got {dtype}")
    return "f32" if dtype == torch.float32 else "f64"


def emit(offsets, kept_counts, g_start, ndiv, uniform, w_sub, cum_parent,
         parent_rem, u_val, rn, unit, thr, w_floor, total, out_size: int):
    """comp_sub's emission over the (N, K) stage ``w_sub``: the CUDA kernel
    for tensors on the card, the plain version for tensors on the CPU.
    Scalars (``rn``, ``unit``, ``thr``, ``w_floor``, ``total``) may be 0-dim
    device tensors, so the kernel path reads nothing back to the host."""
    if not w_sub.is_cuda:
        return emit_plain(offsets, kept_counts, g_start, ndiv, uniform, w_sub,
                          cum_parent, parent_rem, u_val, rn, unit, thr, w_floor,
                          total, out_size)
    w_sub = w_sub.contiguous()
    kernel = "fries_emit_" + _stage_suffix("w_sub", w_sub.dtype)
    _build.check_tensor(kernel, "w_sub", w_sub, w_sub.dtype, (offsets.shape[0], w_sub.shape[1]))
    return _launch(kernel, (w_sub,), (w_sub.shape[1],), offsets, kept_counts,
                   g_start, ndiv, uniform, cum_parent, parent_rem, u_val, rn,
                   unit, thr, w_floor, total, out_size)


def emit_factored(offsets, kept_counts, g_start, ndiv, uniform, fa, fb,
                  cum_parent, parent_rem, u_val, rn, unit, thr, w_floor, total,
                  out_size: int, kill_b0=None):
    """comp_sub's emission over the factored source (``fa`` (N, E), ``fb``
    (N, V), ``kill_b0`` (N, E) bool or None): the CUDA kernel for tensors on
    the card, :func:`emit_factored_plain` for tensors on the CPU.  Same
    returns as :func:`emit`."""
    if not fa.is_cuda:
        return emit_factored_plain(offsets, kept_counts, g_start, ndiv, uniform,
                                   fa, fb, cum_parent, parent_rem, u_val, rn, unit,
                                   thr, w_floor, total, out_size, kill_b0=kill_b0)
    n, (e_k, v_k) = offsets.shape[0], (fa.shape[1], fb.shape[1])
    fa, fb = fa.contiguous(), fb.contiguous()
    kernel = "fries_emit_factored_" + _stage_suffix("fa", fa.dtype)
    _build.check_tensor(kernel, "fa", fa, fa.dtype, (n, e_k))
    _build.check_tensor(kernel, "fb", fb, fa.dtype, (n, v_k))
    if kill_b0 is not None:
        kill_b0 = kill_b0.contiguous()
        _build.check_tensor(kernel, "kill_b0", kill_b0, torch.bool, (n, e_k))
    return _launch(kernel, (fa, fb, kill_b0), (e_k, v_k), offsets, kept_counts,
                   g_start, ndiv, uniform, cum_parent, parent_rem, u_val, rn,
                   unit, thr, w_floor, total, out_size)
