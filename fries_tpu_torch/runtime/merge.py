"""Sorted-merge accumulate: dispatch between the plain torch merge
(:func:`fries_tpu_torch.runtime.arena.accumulate`, after
:func:`~fries_tpu_torch.runtime.arena.compact` when a keep mask is given) and
the CUDA kernel ``csrc/merge.cu``.

Replaces the TPU kernel ``fries_tpu/runtime/pallas_merge.py:_kernel_v2``
(and the v1 ``_kernel``, which computes the same function), reached through
``pallas_merge.accumulate_pallas`` from ``arena.accumulate_best``.  It
computes exactly what compact-then-accumulate computes, in one call:

* an arena row survives iff it is valid and (origin != 0, or its keep bit,
  or at least one allowed spawn lands on it); without a keep mask every
  valid row survives;
* a new key is inserted iff at least one allowed spawn lands on it (by
  count, not value); an allowed spawn is valid and an initiator or lands on
  an arena row with nonzero origin value;
* on equal keys arena rows come first; ``overflow`` means more than C rows
  survive, and the first C of the merged order are kept;
* ``nonini_occ_add`` counts non-initiator spawns onto occupied targets.

The fused form equals compact-then-accumulate because the power step zeroes
the dest row before each merge.  Layouts: (n_vecs, origin, dest) in
{(1, 0, 0), (2, 0, 1)}.

On the H100 the merge is memory-bound: about C*(8+16) + S*(8+8+1) bytes per
call plus the O(log) binary-search reads, which hit L2.  The simple design is
a handful of plain kernels (lookup, per-segment sums in sorted order,
alive flags, two hand-written exclusive scans, scatter), each one pass over
its stream with coalesced loads; the spawn sort runs before it with
``torch.sort``.
"""

from __future__ import annotations

import ctypes

import torch

from fries_tpu_torch import _build, dets
from fries_tpu_torch.runtime import arena as arena_mod

F64 = torch.float64
SCAN_TILE = 1024   # elements per scan block in csrc/merge.cu

LAUNCHES = 0
"""Kernel launches made by :func:`accumulate` (CUDA tensors only)."""


def accumulate(arena, spawn_keys, spawn_vals, spawn_ini, origin_row: int = 0,
               dest_row: int = 0, keep_mask=None):
    """Merge spawns into the arena with the initiator rule and optional fused
    compaction.  Tensors on the card go through the CUDA kernel, tensors on
    the CPU through the plain torch merge.  Returns (new_arena, stats)."""
    if arena.keys.is_cuda:
        return _accumulate_cuda(arena, spawn_keys, spawn_vals, spawn_ini,
                                origin_row, dest_row, keep_mask)
    return accumulate_plain(arena, spawn_keys, spawn_vals, spawn_ini,
                            origin_row, dest_row, keep_mask)


def accumulate_plain(arena, spawn_keys, spawn_vals, spawn_ini,
                     origin_row: int = 0, dest_row: int = 0, keep_mask=None):
    """The plain torch version of the kernel: compact (when a keep mask is
    given), then :func:`fries_tpu_torch.runtime.arena.accumulate`."""
    if keep_mask is not None:
        arena = arena_mod.compact(arena, (arena.vals[origin_row] != 0) | keep_mask)
    return arena_mod.accumulate(arena, spawn_keys, spawn_vals, spawn_ini,
                                origin_row, dest_row)


def _accumulate_cuda(arena, spawn_keys, spawn_vals, spawn_ini, origin_row,
                     dest_row, keep_mask):
    global LAUNCHES
    layout = (arena.n_vecs, origin_row, dest_row)
    if layout not in ((1, 0, 0), (2, 0, 1)):
        raise NotImplementedError(
            f"merge kernel takes (n_vecs, origin, dest) in (1,0,0)|(2,0,1), got {layout}")
    c, w = arena.keys.shape
    s = spawn_keys.shape[0]
    if c < 1 or s < 1:
        raise ValueError("merge: arena and spawn stream must be non-empty")
    dev = arena.device
    akey = dets.pack_key(arena.keys).contiguous()
    skey, perm = torch.sort(dets.pack_key(spawn_keys), stable=True)
    sval = spawn_vals[perm].to(F64).contiguous()
    sini = spawn_ini[perm].contiguous()
    aorig = arena.vals[origin_row].contiguous()
    adest = arena.vals[dest_row].contiguous()
    _build.check_tensor("merge", "arena keys", akey, torch.int64, (c,))
    _build.check_tensor("merge", "arena origin row", aorig, F64, (c,))
    _build.check_tensor("merge", "spawn keys", skey, torch.int64, (s,))
    _build.check_tensor("merge", "spawn values", sval, F64, (s,))
    _build.check_tensor("merge", "spawn initiator flags", sini, torch.bool, (s,))
    if keep_mask is not None:
        keep_mask = keep_mask.contiguous()
        _build.check_tensor("merge", "keep mask", keep_mask, torch.bool, (c,))

    i64 = dict(dtype=torch.int64, device=dev)
    s_pos = torch.empty(s, **i64)
    s_flag = torch.empty(s, dtype=torch.uint8, device=dev)
    new_val = torch.empty(s, dtype=F64, device=dev)
    a_add = torch.empty(c, dtype=F64, device=dev)
    a_hit = torch.empty(c, dtype=torch.uint8, device=dev)
    scan_a = torch.empty(c + 1, **i64)
    scan_n = torch.empty(s + 1, **i64)
    bsum = torch.empty(-(-(c + 1) // SCAN_TILE) + -(-(s + 1) // SCAN_TILE), **i64)
    okey = torch.empty(c, **i64)
    oorig = torch.empty(c, dtype=F64, device=dev)
    odest = torch.empty(c, dtype=F64, device=dev) if layout[0] == 2 else oorig
    stats = torch.empty(2, **i64)

    p = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)
    err = _build.load().fries_merge(
        p(akey), p(aorig), p(adest if layout[0] == 2 else None), p(keep_mask),
        p(skey), p(sval), p(sini), ctypes.c_int64(dets.sentinel_key(w)),
        ctypes.c_int64(c), ctypes.c_int64(s),
        p(s_pos), p(s_flag), p(new_val), p(a_add), p(a_hit),
        p(scan_a), p(scan_n), p(bsum),
        p(okey), p(oorig), p(odest if layout[0] == 2 else None), p(stats),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"merge kernel launch failed: {_build.error_string(err)}")
    LAUNCHES += 1
    n_out = stats[0]
    vals = torch.stack([oorig, odest]) if layout[0] == 2 else oorig[None]
    new_arena = arena_mod.Arena(keys=dets.unpack_key(okey, w), vals=vals,
                                n_used=n_out.clamp_max(c)[None])
    return new_arena, {"overflow": n_out > c, "nonini_occ_add": stats[1]}
