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
for tensors on the card.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from fries_tpu_torch import dets

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
    dets.require_packable(n_words)
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
    perm = torch.sort(dets.pack_key(keys), stable=True).indices
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
    c, w = arena.keys.shape
    dev = arena.device
    sent = dets.sentinel_key(w)
    akey = dets.pack_key(arena.keys)
    skey, perm = torch.sort(dets.pack_key(spawn_keys), stable=True)
    sval = spawn_vals[perm].to(F64)
    sini = spawn_ini[perm]
    s_valid = skey != sent
    pos = torch.searchsorted(akey, skey).clamp_max(c - 1)
    found = s_valid & (akey[pos] == skey)
    occupied = found & (arena.vals[origin_row][pos] != 0)
    allowed = s_valid & (sini | occupied)
    nonini = (s_valid & ~sini & occupied).sum()

    ukey, inv = torch.unique_consecutive(skey, return_inverse=True)
    seg_sum = torch.zeros(ukey.shape[0], dtype=F64, device=dev).index_add_(
        0, inv, torch.where(allowed, sval, 0.0))
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

    a_valid = akey != sent
    all_keys = torch.cat([akey[a_valid], ukey[is_new]])
    all_vals = torch.cat([vals[:, a_valid], new_vals], dim=1)
    order = torch.sort(all_keys, stable=True).indices[:c]
    n_alive = all_keys.shape[0]
    out_keys = torch.full((c,), sent, dtype=torch.int64, device=dev)
    out_keys[: order.shape[0]] = all_keys[order]
    out_vals = vals.new_zeros((arena.n_vecs, c))
    out_vals[:, : order.shape[0]] = all_vals[:, order]
    new_arena = Arena(keys=dets.unpack_key(out_keys, w), vals=out_vals,
                      n_used=torch.tensor([min(n_alive, c)], device=dev))
    return new_arena, {"overflow": torch.tensor(n_alive > c, device=dev),
                       "nonini_occ_add": nonini}


def accumulate_best(arena: Arena, spawn_keys, spawn_vals, spawn_ini,
                    origin_row: int = 0, dest_row: int = 0, keep_mask=None):
    """:func:`accumulate` with optional fused compaction (``keep_mask``:
    arena rows with zero origin value, a False mask bit and no allowed spawn
    are dropped), through the sorted-merge kernel on the card."""
    from fries_tpu_torch.runtime import merge

    return merge.accumulate(arena, spawn_keys, spawn_vals, spawn_ini,
                            origin_row, dest_row, keep_mask=keep_mask)
