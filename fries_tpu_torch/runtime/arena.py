"""Sorted, capacity-padded sparse-vector arena.

Counterpart of ``fries_tpu/runtime/arena.py``.  One sparse vector is a fixed
capacity struct of arrays sorted by determinant key: ``keys`` (C, W) int64
words holding uint32 values, ascending and padded with the all-ones sentinel,
and ``vals`` (R, C) f64 value rows.  Spawned contributions are merged with
the initiator rule: a spawn from a non-initiator parent counts only when its
target is already in the arena with a nonzero origin-row value.

:func:`accumulate` here is the plain torch merge, the reference for the
sorted-merge CUDA kernel; :func:`accumulate_best` dispatches to
:func:`fries_tpu_torch.runtime.merge.accumulate`, which launches the kernel
for tensors on the card.  :func:`accumulate_multi` (per-spawn destination
rows) and :func:`accumulate_multi_best` do the same for the multi-row merge
kernel (:mod:`fries_tpu_torch.runtime.merge_multi`).  On the card both
dispatchers take the plain merges where the shapes are outside the
kernels' bounds (:func:`fries_tpu_torch.runtime.merge.kernel_fits`: more
than 32 value rows, keys past 16 words, a keep mask at another layout),
as the reference takes XLA outside its Pallas kernels'.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from fries_tpu_torch import dets, profiling
from fries_tpu_torch.ops import ordered

F64 = torch.float64


@dataclass(frozen=True)
class Arena:
    """keys (C, W) int64 sorted + sentinel-padded; vals (R, C) f64;
    n_used (1,) int64 occupied slots."""

    keys: torch.Tensor
    vals: torch.Tensor
    n_used: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def n_words(self) -> int:
        return self.keys.shape[1]

    @property
    def n_vecs(self) -> int:
        return self.vals.shape[0]

    @property
    def device(self) -> torch.device:
        return self.keys.device

    @property
    def valid(self) -> torch.Tensor:
        return ~dets.is_invalid(self.keys)


def make(capacity: int, n_words: int, n_vecs: int, device=None) -> Arena:
    """An empty arena."""
    return Arena(
        keys=dets.invalid_det(n_words, device).repeat(capacity, 1),
        vals=torch.zeros((n_vecs, capacity), dtype=F64, device=device),
        n_used=torch.zeros(1, dtype=torch.int64, device=device),
    )


def from_unsorted(arena: Arena, keys: torch.Tensor, vals: torch.Tensor) -> Arena:
    """Fill an empty arena from unsorted rows (duplicates are not merged)."""
    c, n = arena.capacity, keys.shape[0]
    dev = arena.device
    keys = keys.to(device=dev, dtype=torch.int64)
    vals = vals.to(device=dev, dtype=F64)
    if c > n:
        keys = torch.cat([keys, dets.invalid_det(arena.n_words, dev).repeat(c - n, 1)])
        vals = torch.cat([vals, vals.new_zeros((vals.shape[0], c - n))], dim=1)
    perm = dets.sort_dets(keys)
    keys = keys[perm]
    return Arena(keys=keys, vals=vals[:, perm],
                 n_used=(~dets.is_invalid(keys)).sum()[None])


@profiling.spanned("fries.compact")
def compact(arena: Arena, keep_mask: torch.Tensor) -> Arena:
    """Drop entries where ``keep_mask`` is False (stable, stays sorted)."""
    c = arena.capacity
    keep = keep_mask & arena.valid
    dest = torch.where(keep, torch.cumsum(keep, 0) - 1, c)
    keys = dets.invalid_det(arena.n_words, arena.device).repeat(c + 1, 1)
    keys[dest] = arena.keys
    vals = arena.vals.new_zeros((arena.n_vecs, c + 1))
    vals[:, dest] = arena.vals
    return Arena(keys=keys[:c], vals=vals[:, :c], n_used=keep.sum()[None])


def lookup(arena: Arena, query_keys: torch.Tensor):
    """(positions, found) of query determinants."""
    pos, found = dets.lookup_dets(arena.keys, query_keys)
    return pos, found & ~dets.is_invalid(query_keys)


def dot(arena: Arena, query_keys, query_vals, row: int = 0) -> torch.Tensor:
    """Dot product of one value row with a sparse vector (keys, values)."""
    pos, found = lookup(arena, query_keys)
    gathered = torch.where(found, arena.vals[row][pos], 0.0)
    return (gathered * query_vals.to(F64)).sum()


def n_nonzero(arena: Arena, row: int = 0) -> torch.Tensor:
    return ((arena.vals[row] != 0) & arena.valid).sum()


def one_norm(arena: Arena, row: int = 0) -> torch.Tensor:
    """Sum of |value| over one value row (empty slots hold 0)."""
    return arena.vals[row].abs().sum()


def grow(arena: Arena, new_capacity: int) -> Arena:
    """The arena with ``new_capacity`` slots: sentinel keys and zero values
    appended (the sorted prefix is unchanged); a smaller capacity returns
    the arena as it is."""
    extra = new_capacity - arena.capacity
    if extra <= 0:
        return arena
    return Arena(
        keys=torch.cat([arena.keys, dets.invalid_det(arena.n_words, arena.device).repeat(extra, 1)]),
        vals=torch.cat([arena.vals, arena.vals.new_zeros((arena.n_vecs, extra))], dim=1),
        n_used=arena.n_used)


def set_row(arena: Arena, row: int, values: torch.Tensor) -> Arena:
    vals = arena.vals.clone()
    vals[row] = values
    return replace(arena, vals=vals)


def occupancy_stats(arena: Arena, row: int = 0) -> dict:
    """Slot usage, live (valid-key) slots, nonzeros on ``row`` and zero-valued
    live slots (host-side diagnostics)."""
    valid = arena.valid
    live = int(valid.sum())
    nonz = int(((arena.vals[row] != 0) & valid).sum())
    used = int(arena.n_used.sum())
    return {"capacity": arena.capacity, "used": used, "live": live,
            "nonzero": nonz, "zero_live": live - nonz,
            "fill": used / arena.capacity}


def accumulate(arena: Arena, spawn_keys, spawn_vals, spawn_ini,
               origin_row: int = 0, dest_row: int = 0):
    """Merge spawned contributions into the arena (plain torch).

    Spawns are sorted by key (stable); each unique target sums its *allowed*
    spawns (valid, and initiator or landing on an arena row with nonzero
    origin value) in sorted order.  Arena rows pass through with the sum
    added to ``dest_row``; a new key is inserted iff at least one allowed
    spawn lands on it (by count, not value).  Invalid spawns carry the
    sentinel key.  Returns (new_arena, {"overflow", "nonini_occ_add"}); on
    overflow the first C rows of the merged order are kept."""
    c = arena.capacity
    dev = arena.device
    (akey, skey), sent, decode = dets.order_keys(arena.keys, spawn_keys)
    skey, perm = torch.sort(skey, stable=True)
    sval = spawn_vals[perm].to(F64)
    sini = spawn_ini[perm]
    s_valid = skey != sent
    pos = torch.searchsorted(akey, skey).clamp_max(c - 1)
    found = s_valid & (akey[pos] == skey)
    occupied = found & (arena.vals[origin_row][pos] != 0)
    allowed = s_valid & (sini | occupied)
    nonini = (s_valid & ~sini & occupied).sum()

    ukey, inv, counts = torch.unique_consecutive(skey, return_inverse=True, return_counts=True)
    seg_sum = ordered.segment_sum(torch.where(allowed, sval, 0.0), inv, counts)
    seg_cnt = torch.zeros(ukey.shape[0], dtype=torch.int64, device=dev).index_add_(
        0, inv, allowed.to(torch.int64))
    upos = torch.searchsorted(akey, ukey).clamp_max(c - 1)
    u_valid = ukey != sent
    u_found = u_valid & (akey[upos] == ukey)

    vals = arena.vals.clone()
    vals[dest_row, upos[u_found]] += seg_sum[u_found]
    is_new = u_valid & ~u_found & (seg_cnt > 0)
    n_new = profiling.host_read(is_new.sum(), "merge.plain_new")
    new_vals = vals.new_zeros((arena.n_vecs, n_new))
    new_vals[dest_row] = seg_sum[is_new]
    return _insert(arena, akey, vals, ukey[is_new], new_vals, nonini, sent, decode)


def _insert(arena: Arena, akey, vals, new_keys, new_vals, nonini, sent, decode):
    """The arena's valid rows (keys ``akey`` of :func:`dets.order_keys`, its
    ``sent`` and ``decode``; value rows ``vals``) merged with new keys in
    key order; the first C rows are kept."""
    c = arena.capacity
    dev = arena.device
    a_valid = akey != sent
    all_keys = torch.cat([akey[a_valid], new_keys])
    all_vals = torch.cat([vals[:, a_valid], new_vals], dim=1)
    order = torch.sort(all_keys, stable=True).indices[:c]
    n_alive = all_keys.shape[0]
    out_keys = torch.full((c,), sent, dtype=torch.int64, device=dev)
    out_keys[: order.shape[0]] = all_keys[order]
    out_vals = vals.new_zeros((arena.n_vecs, c))
    out_vals[:, : order.shape[0]] = all_vals[:, order]
    new_arena = Arena(keys=decode(out_keys), vals=out_vals,
                      n_used=torch.tensor([min(n_alive, c)], device=dev))
    return new_arena, {"overflow": torch.tensor(n_alive > c, device=dev),
                       "nonini_occ_add": nonini}


def accumulate_multi(arena: Arena, spawn_keys, spawn_vals, spawn_rows, spawn_ini):
    """Merge spawns that each carry their destination value row
    (``spawn_rows``; the multi-vector subspace layout), plain torch.

    A spawn counts iff it is valid, its row is one of the arena's, and it is
    an initiator or lands on an arena row whose value in the spawn's own row
    is nonzero.  Each unique target sums its counted spawns per row in
    sorted (stable) order; every valid arena row passes through with those
    sums added; a new key is inserted iff at least one counted spawn, of any
    row, lands on it.  ``nonini_occ_add`` counts non-initiator spawns onto
    occupied targets over all rows.  On overflow the first C rows of the
    merged order are kept.  Returns (new_arena, {"overflow",
    "nonini_occ_add"})."""
    c = arena.capacity
    r = arena.n_vecs
    dev = arena.device
    (akey, skey), sent, decode = dets.order_keys(arena.keys, spawn_keys)
    skey, perm = torch.sort(skey, stable=True)
    sval = spawn_vals[perm].to(F64)
    sini = spawn_ini[perm]
    srow = spawn_rows[perm].to(torch.int64)
    s_valid = (skey != sent) & (srow >= 0) & (srow < r)
    srow = srow.clamp(0, r - 1)
    pos = torch.searchsorted(akey, skey).clamp_max(c - 1)
    found = s_valid & (akey[pos] == skey)
    occupied = found & (arena.vals[srow, pos] != 0)
    allowed = s_valid & (sini | occupied)
    nonini = (s_valid & ~sini & occupied).sum()

    ukey, inv = torch.unique_consecutive(skey, return_inverse=True)
    n_u = ukey.shape[0]
    # each (key, row) run sums its counted spawns in the stream's order
    key_row, order = torch.sort(inv * r + srow, stable=True)
    kr, kr_inv, kr_counts = torch.unique_consecutive(key_row, return_inverse=True,
                                                     return_counts=True)
    seg_sum = sval.new_zeros((r, n_u))
    seg_sum[kr % r, kr // r] = ordered.segment_sum(
        torch.where(allowed, sval, 0.0)[order], kr_inv, kr_counts)
    seg_cnt = torch.zeros(n_u, dtype=torch.int64, device=dev).index_add_(
        0, inv, allowed.to(torch.int64))
    upos = torch.searchsorted(akey, ukey).clamp_max(c - 1)
    u_valid = ukey != sent
    u_found = u_valid & (akey[upos] == ukey)

    vals = arena.vals.clone()
    vals[:, upos[u_found]] += seg_sum[:, u_found]
    is_new = u_valid & ~u_found & (seg_cnt > 0)
    return _insert(arena, akey, vals, ukey[is_new], seg_sum[:, is_new], nonini, sent,
                   decode)


@profiling.spanned("fries.dedup")
def dedup_spawns(spawn_keys, spawn_vals, spawn_ini, cap: int):
    """Collapse duplicate spawn targets into at most ``cap`` rows before a
    merge (plain torch, as the reference's is plain XLA).

    An exact-H stream repeats each target once per connected source.  Live
    rows (valid key, nonzero value) are summed per (key, initiator flag), so
    the merge's per-spawn gate sees the same sums; each segment sums its rows
    one after another in the stream's order (:func:`ordered.run_sums`), so
    the card gives the CPU's bits.  Returns (keys (cap, W), vals (cap,),
    ini (cap,), overflow): rows sorted by (key, flag) and sentinel-padded;
    ``overflow`` says that more than ``cap`` segments were live, and then
    the first ``cap`` are kept.  Every shape is fixed, so nothing is read on
    the host."""
    s = spawn_keys.shape[0]
    dev = spawn_keys.device
    (key,), sent, decode = dets.order_keys(spawn_keys)
    key = torch.where(spawn_vals == 0, sent, key)
    skey, perm = torch.sort(key, stable=True)
    sval = spawn_vals[perm].to(F64)
    sini = spawn_ini[perm]
    live = skey != sent
    # the live rows lead; run j is the j-th distinct live key, and bin
    # 2 j + flag its segment.  A dead row counts at its own index, past
    # every run, so no index gathers the dead rows
    first = live.clone()
    first[1:] &= skey[1:] != skey[:-1]
    idx = torch.where(live, torch.cumsum(first, 0) - 1, torch.arange(s, device=dev))
    by_flag = torch.stack([live & ~sini, live & sini], dim=1)
    counts = torch.zeros((s, 2), dtype=torch.int64, device=dev).index_add_(
        0, idx, by_flag.to(torch.int64))
    lengths = counts.sum(1)
    sums = ordered.run_sums(torch.where(by_flag, sval[:, None], 0.0), lengths).view(-1)
    # output row k takes the k-th segment
    has = (counts > 0).view(-1)
    n_seg = has.sum()
    seg = torch.searchsorted(torch.cumsum(has, 0), torch.arange(1, cap + 1, device=dev))
    seg = seg.clamp_max(2 * s - 1)
    ok = torch.arange(cap, device=dev) < n_seg
    start = (torch.cumsum(lengths, 0) - lengths).clamp_max(s - 1)
    out_keys = torch.where(ok, skey[start[seg // 2]], sent)
    return (decode(out_keys), torch.where(ok, sums[seg], 0.0), ok & (seg % 2 == 1),
            n_seg > cap)


@profiling.spanned("fries.merge")
def accumulate_multi_best(arena: Arena, spawn_keys, spawn_vals, spawn_rows,
                          spawn_ini):
    """:func:`accumulate_multi`, through the multi-row merge kernel on the
    card (:func:`fries_tpu_torch.runtime.merge_multi.accumulate`) where its
    shapes fit it (:func:`fries_tpu_torch.runtime.merge.kernel_fits`); the
    plain merge on the card outside its bounds, counted in
    ``profiling``'s ``merge.plain_on_card``."""
    from fries_tpu_torch.runtime import merge, merge_multi

    if arena.keys.is_cuda and not merge.kernel_fits(arena.n_vecs, arena.n_words,
                                                    arena.capacity, spawn_keys.shape[0]):
        profiling.count("merge.plain_on_card")
        return accumulate_multi(arena, spawn_keys, spawn_vals, spawn_rows, spawn_ini)
    return merge_multi.accumulate(arena, spawn_keys, spawn_vals, spawn_rows, spawn_ini)


@profiling.spanned("fries.merge")
def accumulate_best(arena: Arena, spawn_keys, spawn_vals, spawn_ini,
                    origin_row: int = 0, dest_row: int = 0, keep_mask=None):
    """:func:`accumulate` with optional fused compaction (``keep_mask``:
    arena rows with zero origin value, a False mask bit and no allowed spawn
    are dropped), through the sorted-merge kernel on the card where its
    shapes fit it (:func:`fries_tpu_torch.runtime.merge.kernel_fits`).
    Outside its bounds on the card, as the reference outside its Pallas
    kernel's: a keep mask at another layout is a :func:`compact` first,
    then the merge without a mask (the kernel where the rest fits); too
    many rows or words take :func:`accumulate`.  Either route counts one in
    ``profiling``'s ``merge.plain_on_card``."""
    from fries_tpu_torch.runtime import merge

    s = spawn_keys.shape[0]
    layout = None if keep_mask is None else (arena.n_vecs, origin_row, dest_row)
    if arena.keys.is_cuda and not merge.kernel_fits(arena.n_vecs, arena.n_words,
                                                    arena.capacity, s, layout):
        profiling.count("merge.plain_on_card")
        if keep_mask is not None:
            arena = compact(arena, (arena.vals[origin_row] != 0) | keep_mask)
            keep_mask = None
        if not merge.kernel_fits(arena.n_vecs, arena.n_words, arena.capacity, s):
            return accumulate(arena, spawn_keys, spawn_vals, spawn_ini, origin_row, dest_row)
    return merge.accumulate(arena, spawn_keys, spawn_vals, spawn_ini,
                            origin_row, dest_row, keep_mask=keep_mask)
