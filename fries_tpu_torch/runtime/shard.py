"""Hash sharding: the owning rank of a determinant and the spawn exchange.

Counterpart of ``fries_tpu/runtime/shard.py``.  Every rank holds the
determinants whose FNV-1a hash names it; a step's spawns travel to their
owners in one all-to-all over the ranks of a
:class:`fries_tpu_torch.parallel.Shards` world (``torch.distributed``: NCCL
between cards, gloo on the CPU):

* :func:`shard_of_words`: the hash, bit-exact with the reference's uint32
  arithmetic (the words are int64 tensors carrying uint32 values, so every
  product is reduced modulo 2^32 and none relies on int64 wrap-around);
* :func:`exchange_ragged`: only the live rows travel.  The per-pair counts
  are all-gathered and read on the host once (``all_to_all_single`` takes
  its split sizes there); a receiver that gets more than ``recv_cap`` rows
  raises the overflow flag on every rank, and the received rows sit in
  ``[0, recv_total)`` with the sentinel key and zero payload after them;
* :func:`exchange_dense`: fixed buckets of ``per_pair_cap`` rows per
  (sender, receiver) pair in one equal-split all-to-all, no host read; a
  bucket that overflows raises the all-reduced flag;
* :func:`exchange`: the ragged path, or the dense one under the reference's
  own switch ``FRIES_EXCHANGE=dense``.

All payload arrays of one exchange travel packed in one int64 buffer.  The
bucket build is plain torch, as it is XLA in the reference.  The
reference's ``_ragged_all_to_all_emulated`` (an XLA:CPU workaround) has no
counterpart.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from fries_tpu_torch import dets, profiling

FNV_PRIME = 0x01000193
FNV_SEED = 0x811C9DC5
MIX = 0x7FEB352D
_U32 = 0xFFFFFFFF


def _mul_u32(h, c: int):
    """(h * c) mod 2^32 of uint32 values held in int64, in 16-bit halves so
    no product reaches 2^63."""
    lo = (h & 0xFFFF) * c
    hi = ((h >> 16) * (c & 0xFFFF)) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def shard_of_words(words: torch.Tensor, n_shards: int, seed: int = 0) -> torch.Tensor:
    """FNV-1a hash of the key words (..., W) -> owning shard (...,) int64."""
    h = torch.full(words.shape[:-1], FNV_SEED ^ (seed & _U32), dtype=torch.int64,
                   device=words.device)
    for w in range(words.shape[-1]):
        h = _mul_u32(h ^ words[..., w], FNV_PRIME)
    h = h ^ (h >> 16)
    h = _mul_u32(h, MIX)
    h = h ^ (h >> 15)
    return h % n_shards


def exchange(arrays: dict, target: torch.Tensor, n_shards: int, per_pair_cap: int,
             shards):
    """Route spawn rows to their owning ranks: the ragged path with a receive
    buffer of ``n_shards * per_pair_cap`` rows, or the dense path under
    ``FRIES_EXCHANGE=dense``.  ``arrays`` holds (S, ...) payloads with
    ``"keys"`` (S, W), whose sentinel rows are dropped.  Returns (received
    dict of (n_shards * per_pair_cap, ...), overflow 0-dim bool)."""
    if os.environ.get("FRIES_EXCHANGE", "ragged") == "dense":
        return exchange_dense(arrays, target, n_shards, per_pair_cap, shards)
    return exchange_ragged(arrays, target, n_shards, n_shards * per_pair_cap, shards)


@profiling.spanned("fries.exchange.bucket")
def bucket_rows(keys, target, n_shards: int):
    """(order, count): the stable sort of the rows by destination (invalid
    rows last, in bucket ``n_shards``) and each destination's row count
    (n_shards,)."""
    target = torch.where(dets.is_invalid(keys), n_shards, target)
    order = torch.argsort(target, stable=True)
    count = torch.bincount(target, minlength=n_shards + 1)[:n_shards]
    return order, count


@profiling.spanned("fries.exchange.counts")
def gather_counts(count, shards):
    """(n, n) device tensor, row i what rank i sends to each destination."""
    return shards.gather(count)


@profiling.spanned("fries.exchange.read")
def read_counts(all_counts) -> np.ndarray:
    """The count matrix on the host: the exchange's one host read."""
    return np.asarray(profiling.host_read(all_counts, "exchange.counts"), dtype=np.int64)


def _pack(arrays: dict, rows):
    """One (len(rows), cols) int64 buffer of every payload's rows ``rows``,
    and the layout to unpack it."""
    cols, layout = [], []
    for name, arr in arrays.items():
        a = arr[rows].reshape(rows.shape[0], math.prod(arr.shape[1:]))
        if a.dtype == torch.float64:
            c = a.contiguous().view(torch.int64)
        elif a.dtype == torch.float32:
            c = a.contiguous().view(torch.int32).to(torch.int64)
        else:
            c = a.to(torch.int64)
        cols.append(c)
        layout.append((name, arr.dtype, tuple(arr.shape[1:]), c.shape[1]))
    return torch.cat(cols, 1), layout


def _unpack(buf, layout, n_rows: int, cap: int):
    """The payloads of ``buf``'s first ``n_rows`` rows, each in a buffer of
    ``cap`` rows filled with the sentinel key / zeros after them."""
    out, c0 = {}, 0
    n = min(n_rows, cap)
    for name, dtype, shape, nc in layout:
        c = buf[:n, c0:c0 + nc].contiguous()
        c0 += nc
        if dtype == torch.float64:
            v = c.view(torch.float64)
        elif dtype == torch.float32:
            v = c.to(torch.int32).view(torch.float32)
        else:
            v = c.to(dtype)
        if name == "keys":
            full = dets.invalid_det(shape[-1], buf.device).repeat(cap, 1)
        else:
            full = torch.zeros((cap,) + shape, dtype=dtype, device=buf.device)
        full[:n] = v.reshape((n,) + shape)
        out[name] = full
    return out


@profiling.spanned("fries.exchange.payload")
def payload(shards, send, recv_rows: int, out_splits, in_splits):
    """The all-to-all of the packed rows: ``send`` grouped by destination,
    ``recv_rows`` received in sender order."""
    recv = torch.empty((recv_rows, send.shape[1]), dtype=send.dtype, device=send.device)
    shards.all_to_all(recv, send, out_splits, in_splits)
    return recv


def exchange_ragged(arrays: dict, target, n_shards: int, recv_cap: int, shards):
    """Ragged spawn exchange: rows sorted by destination, the (n, n) counts
    all-gathered and read on the host, one ``all_to_all_single`` with those
    split sizes.  Rank ``me`` places sender j's block at the sum of the
    counts that senders before j send it, clamped into the buffer as the
    reference clamps; the overflow flag (some rank receives more than
    ``recv_cap`` rows) is the same on every rank, as the count matrix is."""
    order, count = bucket_rows(arrays["keys"], target, n_shards)
    counts = read_counts(gather_counts(count, shards))
    me = shards.rank
    overflow = bool((counts.sum(0) > recv_cap).any())
    offsets = np.minimum(np.cumsum(counts, 0) - counts, recv_cap - 1)
    sizes = np.minimum(counts, np.maximum(recv_cap - offsets, 0))
    send_sizes, recv_sizes = sizes[me], sizes[:, me]
    if (send_sizes == counts[me]).all():
        rows = order[:int(send_sizes.sum())]
    else:
        starts = np.cumsum(counts[me]) - counts[me]
        pick = np.concatenate([np.arange(s, s + k) for s, k in zip(starts, send_sizes)])
        rows = order[torch.as_tensor(pick, dtype=torch.int64, device=order.device)]
    send, layout = _pack(arrays, rows)
    recv = payload(shards, send, int(recv_sizes.sum()), recv_sizes.tolist(),
                   send_sizes.tolist())
    received = _unpack(recv, layout, int(recv_sizes.sum()), recv_cap)
    return received, torch.tensor(overflow, device=target.device)


def exchange_dense(arrays: dict, target, n_shards: int, per_pair_cap: int, shards):
    """Fixed-bucket exchange: slot (d, c) of the send buffer holds the c-th
    row bound for rank d (the sentinel key and zeros past the bucket's
    count); one equal-split all-to-all; received rows in sender-major
    order.  Overflow when any bucket holds more than ``per_pair_cap`` rows,
    all-reduced on the device."""
    s = target.shape[0]
    dev = target.device
    order, count = bucket_rows(arrays["keys"], target, n_shards)
    overflow = shards.sum((count > per_pair_cap).any().to(torch.int64)) > 0
    start = torch.cumsum(count, 0) - count
    d_idx = torch.arange(n_shards, device=dev).repeat_interleave(per_pair_cap)
    c_idx = torch.arange(per_pair_cap, device=dev).repeat(n_shards)
    ok = c_idx < count[d_idx]
    rows = order[(start[d_idx] + c_idx).clamp(0, s - 1)]
    send, layout = _pack(arrays, rows)
    fill, _ = _pack({name: (dets.invalid_det(arr.shape[-1], dev)[None] if name == "keys"
                            else torch.zeros((1,) + arr.shape[1:], dtype=arr.dtype,
                                             device=dev))
                     for name, arr in arrays.items()}, torch.zeros(1, dtype=torch.int64,
                                                                    device=dev))
    send = torch.where(ok[:, None], send, fill)
    n = n_shards * per_pair_cap
    recv = payload(shards, send, n, None, None)
    return _unpack(recv, layout, n, n), overflow
