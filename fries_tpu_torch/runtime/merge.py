"""Sorted-merge accumulate: dispatch between the plain torch merge
(:func:`fries_tpu_torch.runtime.arena.accumulate`, after
:func:`~fries_tpu_torch.runtime.arena.compact` when a keep mask is given) and
the CUDA kernel ``csrc/merge.cu`` (kernel A).

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

What the fused form requires of the dest row: with a keep mask, a row that
the mask lets drop (zero origin value, False bit) must hold no dest value,
because compact-then-accumulate would lose it while the kernel keeps it when
an initiator spawn re-creates the row.  The power step's single merge meets
this (it zeroes the dest row first).  Without a keep mask nothing is
required: every valid row survives, the dest row passes through whatever it
holds and the sums add to it, as the chunked exact-H step needs, whose dest
row carries the earlier chunks' sums; rows an earlier chunk inserted have
origin value 0, so a non-initiator spawn onto them does not count.  Layouts
(n_vecs, origin, dest): without a keep mask any 1 <= n_vecs <= :data:`MAX_ROWS`
with 0 <= origin, dest < n_vecs, origin == dest included (the observables'
four-row arena merges at (4, s, s) and (4, s, 3)); the rows other than dest
pass through.  With a keep mask only :data:`KEEP_LAYOUTS`, (1, 0, 0) and
(2, 0, 1), the layouts the fused-compaction condition above is shown for.
:func:`kernel_fits` states these bounds from shapes alone; outside them the
dispatcher :func:`fries_tpu_torch.runtime.arena.accumulate_best` takes the
plain merge on the card, as the reference takes XLA outside its Pallas
kernel's.

On the card the spawn keys are packed and sorted with ``torch.sort``
(:func:`sort_spawns`: one sort of the int64 key for W <= 2, one stable
sort per 64-bit limb of the key for 3 <= W <= :data:`MAX_WORDS`, L =
ceil(W / 2) of them: two for the 128-bit keys of W = 3, 4); everything else is the
kernel entry, four device operations (``csrc/merge_common.cuh`` has the design): it reads the arena's
(C, W) words and (R, C) value rows and the spawns through the sort's
permutation, and writes the merged arena's words and value rows.  The
returned ``n_used`` and ``nonini_occ_add`` are views of the kernel's control
block.
"""

from __future__ import annotations

import ctypes

import torch

from fries_tpu_torch import _build, dets, profiling
from fries_tpu_torch.runtime import arena as arena_mod

F64 = torch.float64
TILE = 1024        # kTile in csrc/merge_common.cuh
CTRL_HEAD = 8      # kCtrlHead: {n_out, nonini_occ_add, n_used, ...}
MAX_WORDS = 16     # kMaxWords: keys of W <= 2 words are one int64, of W = 3, 4
                   # 128 bits, of W = 5..16 L = ceil(W / 2) 64-bit limbs (256 orbitals)
MAX_ROWS = 32      # kMaxChannels: value rows of kernel A, value rows of kernel C
KEEP_LAYOUTS = ((1, 0, 0), (2, 0, 1))   # (n_vecs, origin, dest) of kernel A's keep mask


def kernel_fits(n_vecs: int, n_words: int, capacity: int, n_spawns: int,
                keep_layout=None) -> bool:
    """Whether a card merge of these shapes is one that kernel A or C
    takes: 1 <= n_vecs <= :data:`MAX_ROWS`, 1 <= n_words <=
    :data:`MAX_WORDS`, C + S < 2^31 and, for kernel A with a keep mask,
    ``keep_layout`` (n_vecs, origin, dest) in :data:`KEEP_LAYOUTS`.  From
    shapes alone, so it runs anywhere and reads nothing on the card."""
    return (1 <= n_vecs <= MAX_ROWS and 1 <= n_words <= MAX_WORDS
            and capacity + n_spawns < 2**31
            and (keep_layout is None or keep_layout in KEEP_LAYOUTS))


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


@profiling.spanned("fries.merge.sort")
def sort_spawns(spawn_keys):
    """The spawn stream's keys sorted (stable) and the permutation: the work
    a CUDA merge does before its kernel entry.  W <= 2: the (S,) packed
    int64 keys.  W > 2: the (S, L) keys as their L = ceil(W / 2)
    sign-flipped int64 columns (:func:`dets.key_columns`, the 128-bit
    key's (lo, hi) halves at W = 3, 4), from one stable sort per column, the
    lowest first (:func:`dets.sort_dets`' order).  The columns are gathered,
    not the (S, W) rows: a row gather through the permutation costs as much
    as the sorts on the card."""
    if dets.packable(spawn_keys.shape[-1]):
        return torch.sort(dets.pack_key(spawn_keys), stable=True)
    *low, top = dets.key_columns(spawn_keys)
    perm = torch.sort(low[0], stable=True).indices
    for col in low[1:]:
        perm = perm[torch.sort(col[perm], stable=True).indices]
    top_sorted, p = torch.sort(top[perm], stable=True)
    perm = perm[p]
    return torch.stack([col[perm] for col in low] + [top_sorted], dim=-1), perm


def ptr(t):
    """A tensor's device pointer for a C entry (NULL for None)."""
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def launch(kernel, entry, arena, spawn_keys, spawn_vals, spawn_ini, n_chan,
           arena_args=(), spawn_args=()):
    """Sort the spawns, allocate what kernel A or C writes and call its C
    entry ``entry`` with the arena's words, values, C, W and R, then
    ``arena_args``, the sorted keys, the permutation, the values, then
    ``spawn_args``, the initiator flags, S, the sentinel, the scratch, the
    control block, the outputs and the stream.  Returns the merged arena
    and its stats.  W > :data:`MAX_WORDS` raises ``NotImplementedError``
    before anything is allocated or launched."""
    c, w = arena.keys.shape
    s = spawn_keys.shape[0]
    if not 1 <= w <= MAX_WORDS:
        raise NotImplementedError(
            f"{kernel}: keys of {w} words (> {MAX_WORDS}, more than "
            f"{16 * MAX_WORDS} orbitals) are not ported to the card")
    if c < 1 or s < 1:
        raise ValueError(f"{kernel}: arena and spawn stream must be non-empty")
    if c + s >= 2**31:
        raise ValueError(f"{kernel}: C + S must stay below 2^31, got {c + s}")
    dev = arena.device
    keys, vals = arena.keys.contiguous(), arena.vals.contiguous()
    _build.check_tensor(kernel, "arena keys", keys, torch.int64, (c, w))
    _build.check_tensor(kernel, "arena values", vals, F64, (arena.n_vecs, c))
    _build.check_tensor(kernel, "spawn values", spawn_vals, F64, (s,))
    _build.check_tensor(kernel, "spawn initiator flags", spawn_ini, torch.bool, (s,))
    skey, perm = sort_spawns(spawn_keys)
    with profiling.span("fries.merge.kernel"):
        nt_r, nt_m = -(-s // TILE), -(-(c + s) // TILE)
        key_words = 1 if dets.packable(w) else dets.n_limbs(w)      # int64 words per key
        scratch = (torch.empty(key_words * s, dtype=torch.int64, device=dev),   # unique keys
                   torch.empty(2 * n_chan * s, dtype=F64, device=dev),          # their sums
                   torch.empty((n_chan + 1) * s, dtype=torch.int32, device=dev),  # their counts
                   torch.empty(2 * nt_r * (2 + 3 * n_chan), dtype=F64, device=dev))  # look-back
        ctrl = torch.empty(CTRL_HEAD + nt_r + nt_m, dtype=torch.int64, device=dev)
        okw = torch.empty((c, w), dtype=torch.int64, device=dev)
        ovals = torch.empty((arena.n_vecs, c), dtype=F64, device=dev)
        overflow = torch.empty((), dtype=torch.bool, device=dev)
        err = getattr(_build.load(), entry)(
            ptr(keys), ptr(vals), ctypes.c_int64(c), ctypes.c_int(w), ctypes.c_int(arena.n_vecs),
            *arena_args, ptr(skey), ptr(perm), ptr(spawn_vals), *spawn_args, ptr(spawn_ini),
            ctypes.c_int64(s), ctypes.c_int64(dets.sentinel_key(w) if key_words == 1 else 0),
            *map(ptr, scratch),
            ptr(ctrl), ptr(okw), ptr(ovals), ptr(overflow),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: {_build.error_string(err)}")
    return (arena_mod.Arena(keys=okw, vals=ovals, n_used=ctrl[2:3]),
            {"overflow": overflow, "nonini_occ_add": ctrl[1]})


def _accumulate_cuda(arena, spawn_keys, spawn_vals, spawn_ini, origin_row,
                     dest_row, keep_mask):
    n_vecs = arena.n_vecs
    layout = (n_vecs, origin_row, dest_row)
    if keep_mask is not None and layout not in KEEP_LAYOUTS:
        raise NotImplementedError(
            f"merge kernel with a keep mask takes (n_vecs, origin, dest) in "
            f"(1,0,0)|(2,0,1), got {layout}")
    if not (1 <= n_vecs <= MAX_ROWS and 0 <= origin_row < n_vecs and 0 <= dest_row < n_vecs):
        raise NotImplementedError(
            f"merge kernel takes 1 <= n_vecs <= {MAX_ROWS} and origin, dest rows "
            f"in [0, n_vecs), got {layout}")
    if keep_mask is not None:
        keep_mask = keep_mask.contiguous()
        _build.check_tensor("merge", "keep mask", keep_mask, torch.bool, (arena.capacity,))
    out = launch("merge", "fries_merge", arena, spawn_keys, spawn_vals.to(F64).contiguous(),
                 spawn_ini.contiguous(), 1,
                 arena_args=(ptr(keep_mask), ctypes.c_int(origin_row), ctypes.c_int(dest_row)))
    profiling.count("launch.merge")
    return out
