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
kernel (:mod:`fries_tpu_torch.runtime.merge_multi`).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from fries_tpu_torch import dets
from fries_tpu_torch.ops import ordered

F64 = torch.float64
DEDUP_SPARE = 4096   # spare slots that dedup_spawns spreads its dead rows over


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
    new_vals = vals.new_zeros((arena.n_vecs, int(is_new.sum())))
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

    ukey, inv, counts = torch.unique_consecutive(skey, return_inverse=True, return_counts=True)
    n_u = ukey.shape[0]
    by_row = sval.new_zeros((sval.shape[0], r))
    by_row[torch.arange(sval.shape[0], device=dev), srow] = torch.where(allowed, sval, 0.0)
    seg_sum = ordered.segment_sum(by_row, inv, counts).T
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


def dedup_spawns(spawn_keys, spawn_vals, spawn_ini, cap: int):
    """Collapse duplicate spawn targets into at most ``cap`` rows before a
    merge (plain torch, as the reference's is plain XLA).

    An exact-H stream repeats each target once per connected source.  Live
    rows (valid key, nonzero value) are summed per (key, initiator flag), so
    the merge's per-spawn gate sees the same sums; each segment sums its rows
    in the stream's order.  Returns (keys (cap, W), vals (cap,), ini (cap,),
    overflow): rows sorted by (key, flag) and sentinel-padded; ``overflow``
    says that more than ``cap`` segments were live, and then the first
    ``cap`` are kept.  Every shape is fixed, so nothing is read on the
    host."""
    s = spawn_keys.shape[0]
    dev = spawn_keys.device
    (key,), sent, decode = dets.order_keys(spawn_keys)
    key = torch.where(spawn_vals == 0, sent, key)
    skey, perm = torch.sort(key, stable=True)
    sval = spawn_vals[perm].to(F64)
    sini = spawn_ini[perm]
    live = skey != sent
    # bin 2 * (index of the key among the sorted unique keys) + flag; the
    # dead rows go to spare slots of their own, spread so that their writes
    # and adds do not all meet at one address
    new_key = torch.ones(s, dtype=torch.int64, device=dev)
    new_key[1:] = (skey[1:] != skey[:-1]).to(torch.int64)
    spare = torch.arange(s, device=dev) % DEDUP_SPARE
    bins = torch.where(live, 2 * (torch.cumsum(new_key, 0) - 1) + sini.to(torch.int64),
                       2 * s + spare)
    has = torch.zeros(2 * s + DEDUP_SPARE, dtype=torch.bool, device=dev)
    has.index_fill_(0, bins, True)   # has[bins] = True would copy the scalar from the host
    has[2 * s:] = False
    rank = torch.cumsum(has, 0) - 1
    dest = torch.where(live & (rank[bins] < cap), rank[bins], cap + spare)
    out_keys = torch.full((cap + DEDUP_SPARE,), sent, dtype=torch.int64, device=dev)
    out_keys[dest] = skey
    # atomics on the card, so the sums' last bits may differ from run to
    # run: ops.ordered.index_add's fixed-order sum sorts the stream's
    # indices and doubled this function's device time on the H100 (PERF.md)
    out_vals = torch.zeros(cap + DEDUP_SPARE, dtype=F64, device=dev).index_add_(
        0, dest, torch.where(live, sval, 0.0))
    out_ini = torch.zeros(cap + DEDUP_SPARE, dtype=torch.bool, device=dev)
    out_ini[dest] = sini
    return (decode(out_keys[:cap]), out_vals[:cap], out_ini[:cap],
            has.sum() > cap)


def accumulate_multi_best(arena: Arena, spawn_keys, spawn_vals, spawn_rows,
                          spawn_ini):
    """:func:`accumulate_multi` through the multi-row merge kernel on the
    card (:func:`fries_tpu_torch.runtime.merge_multi.accumulate`)."""
    from fries_tpu_torch.runtime import merge_multi

    return merge_multi.accumulate(arena, spawn_keys, spawn_vals, spawn_rows, spawn_ini)


def accumulate_best(arena: Arena, spawn_keys, spawn_vals, spawn_ini,
                    origin_row: int = 0, dest_row: int = 0, keep_mask=None):
    """:func:`accumulate` with optional fused compaction (``keep_mask``:
    arena rows with zero origin value, a False mask bit and no allowed spawn
    are dropped), through the sorted-merge kernel on the card."""
    from fries_tpu_torch.runtime import merge

    return merge.accumulate(arena, spawn_keys, spawn_vals, spawn_ini,
                            origin_row, dest_row, keep_mask=keep_mask)
