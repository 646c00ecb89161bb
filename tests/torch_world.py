"""Rank programs for the sharded tests of fries_tpu_torch.

Each function here runs as one rank of a world that
``fries_tpu_torch.parallel.launch`` starts (gloo on the CPU, or on a card in
the ``cuda`` tests) and returns what the test compares.  This module imports
nothing of JAX or of the reference package, so a rank starts in a few
seconds; the tests run the reference in their own process and hand the
ranks plain numpy inputs: Hamiltonian integrals, the reference's arenas and
its draws.  :class:`ReplayKeys` serves the reference's array draws to the
port's pivotal functions by the path of fold / split calls that reaches
them (the test records the table in its process)."""

from __future__ import annotations

import numpy as np
import torch

from fries_tpu_torch import compress, convert, parallel
from fries_tpu_torch.drivers import fciqmc, frifull, frisys, observables, power, subspace
from fries_tpu_torch.runtime import shard as sh

torch.set_num_threads(1)


class ReplayKeys:
    """A key node whose ``uniform`` draws come from ``table``, keyed by the
    path of ``fold`` / ``split`` calls from the root and the shape."""

    def __init__(self, table, path=()):
        self.table, self.path = table, path

    def fold(self, i):
        return ReplayKeys(self.table, self.path + (("fold", int(i)),))

    def split(self, n):
        return [ReplayKeys(self.table, self.path + (("split", n, j),)) for j in range(n)]

    def uniform(self, shape=()):
        return torch.as_tensor(self.table[(self.path, tuple(shape))])


def ham_of(h):
    return convert.hamiltonian(h["hcore"], h["eris"], h["symm"], h["n_orb"], h["n_elec"])


def arena_np(a):
    return {"keys": a.keys.cpu().numpy(), "vals": a.vals.cpu().numpy(),
            "n_used": int(a.n_used.sum())}


# ---------------------------------------------------------------------------
# runtime/shard and parallel
# ---------------------------------------------------------------------------

def exchange(shards, keys, amps, cap_dense, cap_ragged):
    """Rank r sends its rows ``keys[r]`` / ``amps[r]`` through both paths."""
    k = torch.as_tensor(keys[shards.rank].astype(np.int64))
    a = torch.as_tensor(amps[shards.rank])
    tgt = sh.shard_of_words(k, shards.size)
    out = {}
    for mode, fn, cap in (("dense", sh.exchange_dense, cap_dense),
                          ("ragged", sh.exchange_ragged, cap_ragged)):
        rec, ovf = fn({"keys": k, "amps": a}, tgt, shards.size, cap, shards)
        out[mode] = (rec["keys"].numpy(), rec["amps"].numpy(), bool(ovf))
    return out


def shard_world(shards, exchanges, keys, vals, capacity):
    """Each (keys, amps, dense cap, ragged cap) of ``exchanges`` through both
    paths, and this rank's block of distribute_rows."""
    return {"exchange": [exchange(shards, *args) for args in exchanges],
            "distribute": arena_np(parallel.distribute_rows(keys, vals, shards.size, capacity,
                                                            shards.rank))}


def fail_on_rank_one(shards):
    if shards.rank == 1:
        raise RuntimeError("rank 1 fails")


def sleep_forever(shards):
    import time

    while True:
        time.sleep(1)


# ---------------------------------------------------------------------------
# compress
# ---------------------------------------------------------------------------

def compress_cases(shards, cases, table):
    """Each case (name, per-rank inputs, budget, rn) through the port's
    sharded function on this rank's inputs."""
    keys = ReplayKeys(table)
    r = shards.rank
    out = {}
    for name, data, n_samp, rn in cases:
        d = {k: torch.as_tensor(v[r]) for k, v in data.items()}
        if name == "find_preserve":
            keep, n_left, loc = compress.find_preserve(d["vals"].abs(), n_samp, shards=shards)
            res = (keep, n_left, loc)
        elif name == "compress_vector":
            res = (compress.compress_vector(d["vals"], n_samp, rn, shards),)
        elif name == "piv_comp":
            res = (compress.piv_comp(keys.fold(5), d["vals"], n_samp, shards),)
        elif name == "multi_comp":
            keep, n_left, loc = compress.find_preserve(d["vals"].abs(), n_samp, shards=shards)
            res = (compress.multi_comp(keys.fold(7), d["vals"], keep, n_left, loc, shards),)
        elif name == "comp_sub":
            res = compress.comp_sub(d["values"], d["ndiv"], d["w"], d["w"] != 0, n_samp, rn,
                                    d["w"].shape[0] * 4, shards=shards)
        elif name == "comp_sub_factored":
            res = compress.comp_sub_factored(d["values"], d["ndiv"], d["fa"], d["fb"], n_samp,
                                             rn, d["fa"].shape[0] * 4, shards=shards)
        elif name == "comp_sub_piv":
            res = compress.comp_sub_piv(d["values"], d["ndiv"], d["w"], d["w"] != 0, n_samp,
                                        keys.fold(11), d["w"].shape[0] * 4, shards=shards)
        out[name] = [x.numpy() for x in res]
    return out


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

def frisys_steps(shards, h, cfg, states, draws, determ_keys=None):
    """One sharded frisys step from each of the reference's stacked states,
    fed the reference's draws (with ``determ_keys``: semistochastic, the
    space replicated and protected where each rank holds it)."""
    ham = ham_of(h)
    step, _, _, aux = frisys.build_sharded(ham, frisys.FrisysConfig(**cfg), 0, shards,
                                           determ_keys=determ_keys)
    est = [aux[k] for k in ("num_keys", "num_vals", "den_keys", "den_vals", "ref_key")]
    out = []
    for st, (rns, rn) in zip(states, draws):
        state = convert.sharded_power_state(st, shards.rank)
        state, m = step(state, *est, rns=rns, rn_vec=rn,
                        protected_keys=aux["protected_keys"])
        out.append((arena_np(state.arena), {k: v.numpy() for k, v in m.items()}))
    return out


def frisys_run(shards, h, cfg, n_iter, seed):
    ham = ham_of(h)
    _, run, state, aux = frisys.build_sharded(ham, frisys.FrisysConfig(**cfg), seed, shards)
    est = [aux[k] for k in ("num_keys", "num_vals", "den_keys", "den_vals", "ref_key")]
    _, traj = run(state, *est, n_iter)
    return traj


def frifull_run(shards, h, cfg, n_iter):
    ham = ham_of(h)
    _, run, state, aux = frifull.build_sharded(ham, power.PowerConfig(**cfg), 0, shards)
    est = [aux[k] for k in ("num_keys", "num_vals", "den_keys", "den_vals", "ref_key")]
    _, traj = run(state, *est, n_iter)
    return traj


def subspace_run(shards, h, cfg, t_keys, t_vals, n_iter):
    ham = ham_of(h)
    _, run, state, _ = subspace.build_sharded(ham, subspace.SubspaceConfig(**cfg), t_keys,
                                              t_vals, 0, shards)
    _, traj = run(state, n_iter)
    return traj


def fciqmc_run(shards, h, cfg, n_iter, seed, init_walkers):
    ham = ham_of(h)
    _, run, state, aux = fciqmc.build_sharded(ham, fciqmc.FciqmcConfig(**cfg), seed, shards,
                                              init_walkers=init_walkers)
    est = [aux[k] for k in ("num_keys", "num_vals", "den_keys", "den_vals", "ref_key")]
    _, traj = run(state, *est, n_iter)
    return traj


def observables_run(shards, h, cfg, n_iter):
    ham = ham_of(h)
    _, run, state, _ = observables.build_sharded(ham, observables.ObservablesConfig(**cfg), 0,
                                                 shards)
    _, traj = run(state, n_iter)
    return traj


def equivalences(shards, h, runs):
    """Several of the runs above in one world: ``runs`` is a list of (name,
    kwargs)."""
    fns = {"frifull": frifull_run, "subspace": subspace_run, "observables": observables_run,
           "fciqmc": fciqmc_run, "frisys": frisys_run}
    return {name: fns[name](shards, h, **kw) for name, kw in runs}




# ---------------------------------------------------------------------------
# card tests
# ---------------------------------------------------------------------------

def probe_cuda(shards):
    """Which collectives this world takes on CUDA tensors (the names that
    raise)."""
    import torch.distributed as dist

    x = torch.ones(2 * shards.size, device=shards.device)
    refused = []
    for name, fn in (("all_reduce", lambda: dist.all_reduce(x.clone())),
                     ("all_gather", lambda: dist.all_gather(
                         [torch.empty_like(x) for _ in range(shards.size)], x)),
                     ("all_to_all_single", lambda: dist.all_to_all_single(torch.empty_like(x),
                                                                          x))):
        try:
            fn()
            torch.cuda.synchronize()
        except Exception:
            refused.append(name)
    return refused


def frisys_small_steps(shards, h, cfg, n_steps, seed):
    """``n_steps`` sharded frisys steps from the start on this rank's device
    (the draws from the state's CPU generator, the same on every device)."""
    ham = convert.hamiltonian(h["hcore"], h["eris"], h["symm"], h["n_orb"], h["n_elec"],
                              device=shards.device)
    step, _, state, aux = frisys.build_sharded(ham, frisys.FrisysConfig(**cfg), seed, shards)
    est = [aux[k] for k in ("num_keys", "num_vals", "den_keys", "den_vals", "ref_key")]
    out = []
    for _ in range(n_steps):
        state, m = step(state, *est)
        out.append((arena_np(state.arena), {k: v.cpu().numpy() for k, v in m.items()}))
    return out


def repeat_steps(shards, cfg, n_warm, seed):
    """Reproducibility on this rank: the anchor-like 8-orbital system's
    sharded frisys run twice from ``seed`` for ``n_warm`` steps, then one
    step from the state it reached twice with fixed uniforms.  Returns
    {"runs": [bytes of each run's arena], "steps": [bytes of each step's
    arena and metrics]}."""
    from fries_tpu_torch import rung, synth

    def raw(state, m=None):
        parts = [state.arena.keys, state.arena.vals, state.arena.n_used]
        parts += [] if m is None else [torch.as_tensor(v) for _, v in sorted(m.items())]
        return b"".join(p.contiguous().numpy().tobytes() for p in parts)

    ham = synth.make_system(8, 4, seed=3, scale_two=0.1)
    runs, state = [], None
    for _ in range(2):
        step, _, state, aux = frisys.build_sharded(ham, frisys.FrisysConfig(**cfg), seed,
                                                   shards)
        est = rung.estimator_args(aux)
        for _ in range(n_warm):
            state, _ = step(state, *est)
        runs.append(raw(state))
    rns = torch.rand(6, dtype=torch.float64, generator=torch.Generator().manual_seed(seed))
    steps = [raw(*step(state, *est, rns=rns, rn_vec=0.41)) for _ in range(2)]
    return {"runs": runs, "steps": steps}
