"""Several devices: one process per rank over ``torch.distributed``.

Counterpart of ``fries_tpu/parallel.py``.  The reference runs one program
over a 1-D device mesh under ``shard_map``; the port runs one process per
rank (NCCL between cards, one rank per card; gloo on the CPU), and a
:class:`Shards` handle takes the place of the mesh axis name: every function
that takes ``axis_name`` in the reference takes ``shards=None`` here, and
``None`` means one device.

* The arena is hash-sharded: each rank holds a sorted, capacity-padded
  arena of the determinants it owns (:func:`distribute_rows` gives rank r
  its block, equal to rank r's slice of the reference's stacked arrays).
* Each rank's step already is the per-shard program, so the reference's
  ``shard_stepper`` / ``shard_subspace`` wrappers have no counterpart: the
  drivers take ``shards`` and issue the collectives themselves.  The scalar
  state (shift, norms, iteration, the random state) and the metrics are
  replicated, because the step all-reduces every quantity they are computed
  from, as the reference's psums do; the systematic uniforms come from one
  seed on every rank.
* :func:`launch` starts ``n`` ranks with ``torch.multiprocessing.spawn`` on
  a ``file://`` store (no network), or joins a ``torchrun`` world when
  ``RANK`` / ``WORLD_SIZE`` are set.  The process group has a timeout and
  the parent joins with one, so a rank that falls out of step fails instead
  of hanging.

:func:`launch` and :func:`init_world` default to the cards (NCCL, one rank
per card); a CPU world (gloo on ``"cpu"``) and a world of several ranks on
one card (gloo, every rank on ``cuda:0``, with CUDA tensors in every
collective) are choices the caller states.
"""

from __future__ import annotations

import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from fries_tpu_torch.runtime import arena as ar
from fries_tpu_torch.runtime import shard as sh

TIMEOUT = 120.0


@dataclass
class Shards:
    """One rank's view of the world: its rank, the world size, the backend,
    its device and the process group (None: the default one)."""

    rank: int
    size: int
    backend: str
    device: torch.device
    group: object = None

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks (bools are counted as int64)."""
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.MAX)

    def _all_reduce(self, x, op):
        t = torch.as_tensor(x, device=self.device)
        t = (t.to(torch.int64) if t.dtype == torch.bool else t).clone(
            memory_format=torch.contiguous_format)   # NCCL takes contiguous tensors only
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(size, ...) every rank's ``x``, in rank order."""
        x = torch.as_tensor(x, device=self.device).contiguous()
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x, group=self.group)
        return torch.stack(out)

    def gather_to_root(self, x: torch.Tensor):
        """(size, ...) every rank's ``x`` in rank order on rank 0, and None on
        the other ranks.  Gloo gathers host copies (what rank 0 keeps goes
        to the host)."""
        x = torch.as_tensor(x, device=self.device).contiguous()
        if self.backend != "nccl":
            x = x.cpu()
        out = [torch.empty_like(x) for _ in range(self.size)] if self.rank == 0 else None
        dist.gather(x, out, dst=0, group=self.group)
        return None if out is None else torch.stack(out)

    def all_to_all(self, out, inp, out_splits=None, in_splits=None):
        """``dist.all_to_all_single`` into ``out`` (equal splits when the
        split sizes are None)."""
        dist.all_to_all_single(out, inp, out_splits, in_splits, group=self.group)
        return out

    def barrier(self):
        dist.barrier(group=self.group)


def check_world(n_shards: int, shards) -> None:
    """Raise unless ``shards`` is a world of ``n_shards`` ranks (None: one)."""
    size = 1 if shards is None else shards.size
    if size != n_shards:
        raise ValueError(f"n_shards {n_shards} needs a world of as many ranks (a Shards "
                         f"handle); this one has {size}")


def gsum(shards, *xs):
    """The sums of ``xs`` over the ranks in one all-reduce (``xs`` themselves
    on one device).  One tensor comes back as a tensor.  Several 0-dim
    tensors are stacked (in f64 when their dtypes differ, so a count beside
    a norm is exact below 2^53) and come back as a tuple, each in its own
    dtype."""
    if shards is None:
        return xs[0] if len(xs) == 1 else xs
    if len(xs) == 1:
        return shards.sum(xs[0])
    same = all(x.dtype == xs[0].dtype for x in xs)
    s = shards.sum(torch.stack([x if same else x.to(torch.float64) for x in xs]))
    return tuple(v.to(x.dtype) for v, x in zip(s.unbind(), xs))


def rank_device(backend: str, device, rank: int) -> torch.device:
    """Rank ``rank``'s device: ``cuda:rank`` under NCCL, the given device
    otherwise (gloo ranks on one card share it)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank if backend == "nccl" else 0)
    return device


def init_world(rank: int, size: int, backend: str = "nccl", device="cuda",
               init_method: str | None = None, timeout: float = TIMEOUT) -> Shards:
    """Join (or, with ``size`` 1, make) a process group and return this
    rank's handle.  ``init_method`` None makes a ``file://`` store of its
    own, which only a one-rank world can share."""
    dev = rank_device(backend, device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if init_method is None:
        if size != 1:
            raise ValueError("a world of several ranks needs a shared init_method")
        init_method = "file://" + os.path.join(tempfile.mkdtemp(prefix="fries_world_"),
                                               "store")
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=size,
                            timeout=timedelta(seconds=timeout), **kw)
    return Shards(rank=rank, size=size, backend=backend, device=dev)


def close_world():
    if dist.is_initialized():
        dist.destroy_process_group()


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def _worker(rank, size, backend, device, init_method, timeout, fn, args, results):
    shards = init_world(rank, size, backend, device, init_method, timeout)
    try:
        # plain pickle: the bytes travel with the message, not a handle into
        # this process's memory, which is gone once the rank exits
        results.put((rank, pickle.dumps(_to_cpu(fn(shards, *args)))))
    finally:
        close_world()


def launch(fn, n: int, backend: str = "nccl", device="cuda", args=(), timeout: float = TIMEOUT,
           join_timeout: float | None = None):
    """Run ``fn(shards, *args)`` on ``n`` ranks and return the ranks' results
    in rank order (moved to the CPU).  ``fn`` must be importable by name (a
    module-level function of a module that the child processes can import).

    ``backend="nccl"`` (the default) puts rank r on ``cuda:r`` and stops
    when fewer than ``n`` cards are visible; ``"gloo"`` runs on ``device``
    (on ``"cuda"`` every rank shares ``cuda:0``).  Under ``torchrun`` (``RANK`` and
    ``WORLD_SIZE`` set) this process joins that world as its rank and
    returns ``[its result]``.  ``timeout`` is the process group's;
    ``join_timeout`` (default ``timeout`` + 60 s) bounds the whole run, after
    which the ranks are killed and ``TimeoutError`` raised."""
    if backend == "nccl":
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if visible < n:
            raise RuntimeError(f"nccl with {n} ranks needs {n} CUDA devices, "
                               f"{visible} visible")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device(device)
        if dev.type == "cuda" and backend == "nccl":
            dev = torch.device("cuda", local)
        shards = init_world(rank, size, backend, dev, "env://", timeout)
        try:
            return [fn(shards, *args)]
        finally:
            close_world()
    import torch.multiprocessing as mp

    join_timeout = timeout + 60.0 if join_timeout is None else join_timeout
    tmp = tempfile.mkdtemp(prefix="fries_world_")
    results = mp.get_context("spawn").Queue()
    ctx = mp.spawn(_worker, nprocs=n, join=False,
                   args=(n, backend, str(device), "file://" + os.path.join(tmp, "store"),
                         timeout, fn, tuple(args), results))
    out, deadline = {}, time.monotonic() + join_timeout
    try:
        while len(out) < n:
            try:
                rank, value = results.get(timeout=0.2)
                out[rank] = pickle.loads(value)
                continue
            except queue_mod.Empty:
                pass
            if ctx.join(timeout=0.01) and results.empty():   # raises on a failed rank
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{n} ranks did not finish within {join_timeout} s")
        while not ctx.join(timeout=min(60.0, max(0.1, deadline - time.monotonic()))):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{n} ranks did not exit within {join_timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
        shutil.rmtree(tmp, ignore_errors=True)
    if len(out) < n:
        raise RuntimeError(f"ranks {sorted(set(range(n)) - set(out))} returned no result")
    return [out[r] for r in range(n)]


def distribute_rows(keys, vals, n_shards: int, capacity: int, rank: int, device=None):
    """Rank ``rank``'s sorted, sentinel-padded block of the initial rows
    ``keys`` (N, W) / ``vals`` (R, N): the rows whose hash names it, as an
    :class:`fries_tpu_torch.runtime.arena.Arena` of ``capacity`` rows."""
    keys = torch.as_tensor(np.asarray(keys).astype(np.int64))
    vals = torch.as_tensor(np.asarray(vals, np.float64))
    mine = sh.shard_of_words(keys, n_shards) == rank
    if int(mine.sum()) > capacity:
        raise ValueError("initial rows exceed shard capacity")
    a = ar.make(capacity, keys.shape[1], vals.shape[0], device=device)
    return ar.from_unsorted(a, keys[mine].to(a.device), vals[:, mine].to(a.device))


def stacked(blocks):
    """The reference's stacked layout of per-rank arenas: keys (n*C, W)
    uint32, vals (R, n*C), n_used (n,) int32."""
    keys = np.concatenate([b.keys.cpu().numpy() for b in blocks]).astype(np.uint32)
    vals = np.concatenate([b.vals.cpu().numpy() for b in blocks], axis=1)
    n_used = np.asarray([int(b.n_used.sum()) for b in blocks], np.int32)
    return keys, vals, n_used


def unstack(keys, vals, n_used, rank: int, device=None) -> ar.Arena:
    """Rank ``rank``'s arena of the reference's stacked layout (n = len(n_used))."""
    keys, vals = np.asarray(keys), np.asarray(vals)
    cap = keys.shape[0] // len(n_used)
    rows = slice(rank * cap, (rank + 1) * cap)
    return ar.Arena(keys=torch.tensor(keys[rows].astype(np.int64), device=device),
                    vals=torch.tensor(vals[:, rows], dtype=torch.float64, device=device),
                    n_used=torch.tensor([int(n_used[rank])], device=device))


def sharded_state(keys, vals, shards: Shards, capacity: int, seed: int):
    """A power state of rank ``shards.rank``'s block of the initial rows; the
    scalars and the generator's seed are the same on every rank."""
    from fries_tpu_torch.drivers import power

    a = distribute_rows(keys, vals, shards.size, capacity, shards.rank, shards.device)
    return power.fresh_state(a, seed)

