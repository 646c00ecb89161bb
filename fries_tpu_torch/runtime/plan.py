"""comp_sub_factored's threshold plan over the rank-1 factors: the plain torch
version, the wrappers of its CUDA kernel (``csrc/factored_plan.cu``, kernel
F) and the dispatchers between them.

The C+D round's plan (:func:`fries_tpu_torch.compress.comp_sub_factored_plan`)
reduces the joint rows ``w[i, e*V + v] = fa[i, e] * fb[i, v]``, zero at
``v = 0`` where ``kill_b0[i, e]`` (:func:`~fries_tpu_torch.runtime.emit.factored_rows`),
four ways:

* :func:`total`: the f64 sum of every w (the factored part of the norm);
* :func:`seed`: for each seed edge x (compared in the stage dtype), the
  mass of the w >= x, summed within a row in the stage dtype and over the
  rows in f64, and their count (both f64, as the histogram seed takes them);
* :func:`counts`: at a threshold ``thr`` (f64) and a floor ``w_floor`` (stage
  dtype), with kept = ``w > w_floor & w.to(f64) >= thr``, the f64 sum of the
  unkept w and the int64 count of the kept (one fixpoint round);
* :func:`parents`: the same two for each parent row (the final pass).

:func:`seed` and :func:`counts` add the parents split into ``ndiv`` equal
parts, ``uni = (u_uni, w_uni, ndiv)`` (each (N,): a part's weight, the
parent's, the part count), as the plan's histogram seed and fixpoint rounds
take them: the seed counts a part weight at or above an edge with its
parent's mass and ``max(ndiv, 1)`` parts, a round keeps a parent whose part
weight reaches ``thr`` for ``ndiv`` samples.

The plain version forms the joint in ``row_chunk``-row chunks (0 = one
chunk).  On the card the kernel forms each joint value in registers from the
factors, one correctly rounded multiply as torch's, so every comparison and
count equals the plain version's bit for bit; its f64 sums differ from the
plain version's only in the order of the additions, and the seed's masses in
the order of a row's stage-dtype sum.  Its sums run in a fixed order (no
floating-point atomics), so a call repeats bit for bit.  ``row_chunk`` does
not reach it: nothing of (N, E*V) is materialized.

Dispatch, from the inputs alone: the kernel where ``fa`` is on the card,
the plain version on the CPU.  The kernel's bounds are its own
(``fries_plan_grid``: at least one parent, E * V < 2^31 - 1, and a tile of
32 parents within 227 KB of shared memory, E + V up to about 1,800 at f32
and 900 at f64); card tensors past them raise.  Each launch of the kernel
counts one in ``profiling``'s ``launch.plan``: a plan of R fixpoint rounds
launches R + 3 (total, seed, R rounds, parents).

On the H100 the kernel is bound by bytes (3.35 TB/s): each launch reads the
factors once, N (E + V) B per byte of the stage dtype plus N E B of kill
bytes, the seed and each round 24 B a parent of ``uni``, and the
per-parent pass writes 16 B a parent; the plain version
writes and reads the joint, its f64 copy and its masks in every pass
(``csrc/factored_plan.cu`` has the design note).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fries_tpu_torch import _build, profiling
from fries_tpu_torch.runtime import emit as emit_mod

F64 = torch.float64
SEED_EDGES = 20                  # kEdges in csrc/factored_plan.cu
TOTAL, SEED, COUNTS, PARENTS = range(4)

_tickets: dict = {}              # (device, stream) -> the kernel's int32 ticket


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _chunks(fa, fb, kill_b0=None, row_chunk: int = 0):
    """(row slice, joint rows) of the factors in ``row_chunk``-row chunks."""
    n = fa.shape[0]
    row_chunk = n if not row_chunk or row_chunk >= n else row_chunk
    for s in range(0, n, row_chunk):
        sl = slice(s, s + row_chunk)
        yield sl, emit_mod.factored_rows(fa[sl], fb[sl],
                                         None if kill_b0 is None else kill_b0[sl])


def _keep(w, w_floor, thr):
    return (w > w_floor) & (w.to(F64) >= thr)


def total_plain(fa, fb, kill_b0=None, row_chunk: int = 0):
    """The f64 sum of the joint (0-dim)."""
    return sum(w.sum(dtype=F64) for _, w in _chunks(fa, fb, kill_b0, row_chunk))


def seed_plain(fa, fb, kill_b0, uni, edges, row_chunk: int = 0):
    """(mass_above, cost_above), each (SEED_EDGES,) f64, over ``edges``
    (f64, compared in the stage dtype); inner sums over a row in the stage
    dtype; the split parents' part as the histogram seed takes it."""
    from fries_tpu_torch.compress import _seed_hist_part   # compress imports this module

    cdtype = fa.dtype
    edges_c = edges.to(cdtype)
    zero_c = torch.zeros((), dtype=cdtype, device=fa.device)
    mass_above = torch.zeros(SEED_EDGES, dtype=F64, device=fa.device)
    cost_above = torch.zeros_like(mass_above)
    for _, w in _chunks(fa, fb, kill_b0, row_chunk):
        for e in range(SEED_EDGES):
            ge = w >= edges_c[e]
            mass_above[e] += torch.where(ge, w, zero_c).sum(1).sum(dtype=F64)
            cost_above[e] += ge.sum(1).sum(dtype=F64)
    u_uni, w_uni, ndiv = uni
    m, c = _seed_hist_part(u_uni, w_uni, ndiv.clamp_min(1).to(F64), edges)
    return mass_above + m, cost_above + c


def counts_plain(fa, fb, kill_b0, uni, w_floor, thr, row_chunk: int = 0):
    """(loc, used): the f64 sum of the unkept joint values and split parents'
    masses, and the int64 count of the kept values and of the kept split
    parents' parts at ``thr``, each 0-dim."""
    dev = fa.device
    zero_c = torch.zeros((), dtype=fa.dtype, device=dev)
    loc = torch.zeros((), dtype=F64, device=dev)
    used = torch.zeros((), dtype=torch.int64, device=dev)
    for _, w in _chunks(fa, fb, kill_b0, row_chunk):
        kept = _keep(w, w_floor, thr)
        loc = loc + torch.where(kept, zero_c, w).sum(dtype=F64)
        used = used + kept.sum()
    u_uni, w_uni, ndiv = uni
    kept_uni = (w_uni > 0) & (u_uni >= thr)
    loc = loc + torch.where(kept_uni, 0.0, w_uni).sum()
    return loc, used + torch.where(kept_uni, ndiv, 0).sum()


def parents_plain(fa, fb, kill_b0, w_floor, thr, row_chunk: int = 0):
    """(rem (N,) f64, kept (N,) int64): :func:`counts_plain`'s joint part
    for each parent row."""
    n, dev = fa.shape[0], fa.device
    zero_c = torch.zeros((), dtype=fa.dtype, device=dev)
    rem = torch.empty(n, dtype=F64, device=dev)
    kept_counts = torch.empty(n, dtype=torch.int64, device=dev)
    for sl, w in _chunks(fa, fb, kill_b0, row_chunk):
        kept = _keep(w, w_floor, thr)
        rem[sl] = torch.where(kept, zero_c, w).sum(1, dtype=F64)
        kept_counts[sl] = kept.sum(1)
    return rem, kept_counts


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _grid(mode: int, elem: int, n: int, e_k: int, v_k: int, kill: bool, device: int) -> int:
    """The kernel's grid for these shapes on ``device`` (fixed for a build and
    a card, so a call's sums run in the same order every time)."""
    lib = _build.load()
    lib.fries_plan_grid.restype = ctypes.c_int64
    with torch.cuda.device(device):
        grid = lib.fries_plan_grid(ctypes.c_int(mode), ctypes.c_int(elem), ctypes.c_int64(n),
                                   ctypes.c_int64(e_k), ctypes.c_int64(v_k), ctypes.c_int(kill))
    if grid < 1:
        raise ValueError(f"kernel F takes no ({n}, {e_k}, {v_k}) factors at {8 * elem} bits"
                         f"{' with kill bits' if kill else ''}: {_build.error_string(-grid)} "
                         "(an invalid argument: past its bounds)")
    return grid


def _ticket(dev, stream):
    """The kernel's grid-wide ticket on ``stream``: one int32, zeroed once;
    each launch's last block resets it."""
    key = (dev.index, stream.cuda_stream)
    if key not in _tickets:
        _tickets[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _tickets[key]


@profiling.spanned("fries.plan")
def launch(mode: int, fa, fb, kill_b0=None, uni=None, edges=None, w_floor=None, thr=None):
    """One launch of kernel F in ``mode`` (:data:`TOTAL`, :data:`SEED`,
    :data:`COUNTS`, :data:`PARENTS`); returns the mode's results as the
    plain functions do.  ``uni`` (seed, counts), ``edges`` (f64,
    :data:`SEED_EDGES`), ``w_floor`` (stage dtype) and ``thr`` (f64) may be
    device tensors: nothing is read back to the host.  Shapes past the
    kernel's bounds raise ValueError.  Counts one in ``profiling``'s
    ``launch.plan``; runs inside the span ``fries.plan``."""
    n, e_k = fa.shape
    v_k = fb.shape[1]
    if fa.dtype not in (torch.float32, F64):
        raise ValueError(f"plan: fa must be float32 or float64, got {fa.dtype}")
    kernel = "fries_plan_" + ("f32" if fa.dtype == torch.float32 else "f64")
    fa, fb = fa.contiguous(), fb.contiguous()
    _build.check_tensor(kernel, "fa", fa, fa.dtype, (n, e_k))
    _build.check_tensor(kernel, "fb", fb, fa.dtype, (n, v_k))
    if kill_b0 is not None:
        kill_b0 = kill_b0.contiguous()
        _build.check_tensor(kernel, "kill_b0", kill_b0, torch.bool, (n, e_k))
    dev = fa.device
    scalar = lambda x, dt: torch.as_tensor(x, dtype=dt, device=dev).reshape(1)
    u_uni = w_uni = ndiv = None
    if mode in (SEED, COUNTS):
        u_uni, w_uni, ndiv = (t.contiguous() for t in uni)
        for name, t, dt in (("u_uni", u_uni, F64), ("w_uni", w_uni, F64),
                            ("ndiv", ndiv, torch.int64)):
            _build.check_tensor(kernel, name, t, dt, (n,))
    if mode == SEED:
        edges = edges.to(F64).contiguous()
        _build.check_tensor(kernel, "edges", edges, F64, (SEED_EDGES,))
    if mode in (COUNTS, PARENTS):
        w_floor, thr = scalar(w_floor, fa.dtype), scalar(thr, F64)
    n_q = SEED_EDGES if mode == SEED else 1
    n_f = {TOTAL: 1, SEED: 2 * SEED_EDGES, COUNTS: 1, PARENTS: n}[mode]
    out_f = torch.empty(n_f, dtype=F64, device=dev)
    out_i = torch.empty(n if mode == PARENTS else 1, dtype=torch.int64, device=dev)
    grid = _grid(mode, fa.element_size(), n, e_k, v_k, kill_b0 is not None,
                 dev.index if dev.index is not None else torch.cuda.current_device())
    part_f = torch.empty(0 if mode == PARENTS else grid * n_q, dtype=F64, device=dev)
    part_i = torch.empty(part_f.shape[0], dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev)
    p = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    err = getattr(_build.load(), kernel)(
        ctypes.c_int(mode), p(fa), p(fb), p(kill_b0), p(u_uni), p(w_uni), p(ndiv), p(edges),
        p(w_floor), p(thr),
        ctypes.c_int64(n), ctypes.c_int64(e_k), ctypes.c_int64(v_k), p(out_f), p(out_i),
        p(part_f), p(part_i), p(_ticket(dev, stream)), ctypes.c_int64(grid),
        ctypes.c_void_p(stream.cuda_stream))
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: {_build.error_string(err)}")
    profiling.count("launch.plan")
    if mode == TOTAL:
        return out_f[0]
    if mode == SEED:
        return out_f[:SEED_EDGES], out_f[SEED_EDGES:]
    if mode == COUNTS:
        return out_f[0], out_i[0]
    return out_f, out_i


# ---------------------------------------------------------------------------
# the dispatchers
# ---------------------------------------------------------------------------

def total(fa, fb, kill_b0=None, row_chunk: int = 0):
    """:func:`total_plain`, through kernel F on the card."""
    if fa.is_cuda:
        return launch(TOTAL, fa, fb, kill_b0)
    return total_plain(fa, fb, kill_b0, row_chunk)


def seed(fa, fb, kill_b0, uni, edges, row_chunk: int = 0):
    """:func:`seed_plain`, through kernel F on the card."""
    if fa.is_cuda:
        return launch(SEED, fa, fb, kill_b0, uni=uni, edges=edges)
    return seed_plain(fa, fb, kill_b0, uni, edges, row_chunk)


def counts(fa, fb, kill_b0, uni, w_floor, thr, row_chunk: int = 0):
    """:func:`counts_plain`, through kernel F on the card."""
    if fa.is_cuda:
        return launch(COUNTS, fa, fb, kill_b0, uni=uni, w_floor=w_floor, thr=thr)
    return counts_plain(fa, fb, kill_b0, uni, w_floor, thr, row_chunk)


def parents(fa, fb, kill_b0, w_floor, thr, row_chunk: int = 0):
    """:func:`parents_plain`, through kernel F on the card."""
    if fa.is_cuda:
        return launch(PARENTS, fa, fb, kill_b0, w_floor=w_floor, thr=thr)
    return parents_plain(fa, fb, kill_b0, w_floor, thr, row_chunk)
