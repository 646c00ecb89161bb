"""Checkpoint and resume of a driver's state: one ``.npz`` per run.

Counterpart of ``fries_tpu/runtime/checkpoint.py``.  The arena and the
scalars keep the reference's names and dtypes, so each package's
:func:`load_arena` reads the other's file: ``version``, ``keys`` (C, W)
uint32 words, ``vals`` (R, C) f64, ``n_used`` (1,) int32, ``iterat`` int32,
and where the state has them ``en_shift``, ``last_norm``, ``norm_factors``
and ``last_norms``.  Like the reference's load, :func:`load_arena` drops the
entries below 1e-9 in every row and re-sorts.

The random state is the port's own and goes under names of its own in place
of the reference's JAX key (``key``):

* ``torch_generator``: the uint8 state of a power state's
  ``torch.Generator`` (``get_state()``), which draws the systematic
  uniforms;
* ``key_tree``: the 64-bit key (uint64) of the run's
  :class:`fries_tpu_torch.rng.KeyTree` node (FCIQMC, frimulti, the
  subspace, the observables).

:func:`restore` puts a file's arena (every row), scalars and random state
into a fresh state of the same driver and raises when the file lacks a
field the state draws from: a run never reseeds silently.

A sharded run (``shards``) saves the reference's stacked layout: rank 0
gathers every rank's arena into keys (n*C, W), vals (R, n*C) and n_used
(n,) and writes the file with the replicated scalars and random state; a
resume takes rank r's block back, onto a world of the same size.
"""

from __future__ import annotations

from dataclasses import fields, replace

import numpy as np
import torch

from fries_tpu_torch import dets, parallel, rng
from fries_tpu_torch.runtime import arena as ar

FORMAT_VERSION = 2
SCALARS = ("en_shift", "last_norm", "norm_factors", "last_norms")
GENERATOR = "torch_generator"
KEY_TREE = "key_tree"


def save_state(path, state, shards=None):
    """Save a driver state (a dataclass with an ``arena`` and scalar fields)
    to ``path`` (.npz).  Sharded, every rank calls it and rank 0 writes the
    stacked arenas, gathered to it alone."""
    a = state.arena
    if shards is None:
        keys, vals = a.keys.cpu().numpy().astype(np.uint32), a.vals.cpu().numpy()
        n_used = a.n_used.cpu().numpy().astype(np.int32).reshape(1)
    else:
        g_keys, g_vals, g_used = (shards.gather_to_root(x)
                                  for x in (a.keys, a.vals, a.n_used.reshape(1)))
        if shards.rank != 0:
            return
        keys = g_keys.cpu().numpy().reshape(-1, a.n_words).astype(np.uint32)
        vals = g_vals.cpu().numpy().transpose(1, 0, 2).reshape(a.vals.shape[0], -1)
        n_used = g_used.cpu().numpy().astype(np.int32).reshape(-1)
    payload = {
        "version": FORMAT_VERSION,
        "keys": keys,
        "vals": vals,
        "n_used": n_used,
        "iterat": np.int32(state.iterat),
    }
    for name in SCALARS:
        if hasattr(state, name):
            payload[name] = getattr(state, name).cpu().numpy()
    if getattr(state, "generator", None) is not None:
        payload[GENERATOR] = state.generator.get_state().numpy()
    if isinstance(getattr(state, "key", None), rng.KeyTree):
        payload[KEY_TREE] = np.uint64(state.key.key)
    np.savez(path, **payload)


def load_arena(path, drop_below: float = 1e-9, device=None) -> ar.Arena:
    """The arena of a snapshot (either package's) on ``device``, without the
    entries below ``drop_below`` in every row, sorted."""
    with np.load(path) as z:
        keys, vals = z["keys"].astype(np.int64), z["vals"]
    live = (np.abs(vals) >= drop_below).any(axis=0) & (keys[:, -1] != dets.WORD_MASK)
    return ar.from_unsorted(ar.make(keys.shape[0], keys.shape[1], vals.shape[0], device),
                            torch.as_tensor(keys[live]), torch.as_tensor(vals[:, live]))


def load_scalars(path) -> dict:
    """Every field of a snapshot but the arena's keys and values."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k not in ("keys", "vals", "occ", "diag")}


def restore(path, state, shards=None):
    """``state`` (a fresh state of the workload that wrote ``path``) with the
    snapshot's iteration count, scalars, random state and arena, every row
    of it (so that a resumed run is the uninterrupted one exactly, on a
    card whose reductions depend on the rows' positions).  Sharded, this
    rank's block of the stacked file, whose world must have had the same
    size.  Raises ``ValueError`` naming the missing field when the file
    lacks the random state that ``state`` draws from, or when its world size
    differs."""
    scal = load_scalars(path)
    dev = state.arena.device
    names = {f.name for f in fields(state)}
    n_file = np.asarray(scal["n_used"]).reshape(-1).shape[0]
    if n_file != (1 if shards is None else shards.size):
        raise ValueError(f"{path} holds a run of {n_file} ranks; resume it on as many "
                         "(--n_chips)")
    if shards is None:
        arena = load_arena(path, 0.0, dev)
    else:
        with np.load(path) as z:
            arena = parallel.unstack(z["keys"], z["vals"], z["n_used"], shards.rank, dev)
    new = {"arena": arena, "iterat": int(scal["iterat"])}
    for name in SCALARS:
        if name in names and name in scal:
            new[name] = torch.as_tensor(scal[name], dtype=torch.float64, device=dev)
    if getattr(state, "generator", None) is not None:
        if GENERATOR not in scal:
            raise ValueError(f"{path} has no '{GENERATOR}' field: it holds no random "
                             "state of this port, so the run cannot resume")
        gen = torch.Generator(device="cpu")
        gen.set_state(torch.as_tensor(scal[GENERATOR], dtype=torch.uint8))
        new["generator"] = gen
    if isinstance(getattr(state, "key", None), rng.KeyTree):
        if KEY_TREE not in scal:
            raise ValueError(f"{path} has no '{KEY_TREE}' field: it holds no random "
                             "state of this port, so the run cannot resume")
        new["key"] = rng.KeyTree(0, state.key.device, _key=int(scal[KEY_TREE]))
    return replace(state, **new)
