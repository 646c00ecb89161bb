"""FRI power-iteration core shared by the single-vector drivers.

Counterpart of ``fries_tpu/drivers/power.py``.  One step of
v <- (1 - eps (H - e_ref - S)) v:

  * the model's off-diagonal spawn, exact or stochastically compressed,
    from the whole arena or from its first ``spawn_rows`` rows;
  * the sorted-merge accumulate with initiator gating
    (:func:`fries_tpu_torch.runtime.arena.accumulate_best`): one merge of
    the whole stream with fused compaction, or, for an exact-H model that
    gives a ``spawn_chunk_fn``, one spawn and one merge per chunk of
    ``batch`` rows (optionally deduplicated first), so the full candidate
    stream never exists, and one compaction at the end of the step;
  * death/cloning on the diagonal recomputed from the merged keys;
  * the projected-energy estimator: the before/after-multiply form
    (``"before_after"``) or trial / H-trial dots on the post-death vector
    (``"direct"``);
  * the norm-control shift (with the optional tracking term), then
    find_preserve + systematic compression, which skip the protected
    (semistochastic) determinants.

A model is a ``spawn_fn(keys, vals, h_fac, rand) -> (words, amps, ini)`` and a
``diag_fn(keys) -> (C,)`` (already e_ref-relative).  The systematic path
consumes only scalar uniforms: ``rand`` is ``rns`` (6,) for the spawner, and
``rn_vec`` serves the vector compression.  ``step`` takes them as arguments
and draws them from the state's ``torch.Generator`` when they are not given.
A chunk spawner gets the same ``rns`` for every chunk (the exact-H spawners
draw nothing).  A keyed stepper (``keyed=True``, the frimulti spawner) draws
from the state's key node (:mod:`fries_tpu_torch.rng`) instead, as the
reference's core does: ``split(2)`` of ``key.fold(iterat)`` gives the
spawner's node and the node of ``rn_vec``.

Hash sharding (``shards``, a :class:`fries_tpu_torch.parallel.Shards`
handle): each rank steps its own block of the arena.  The spawns travel to
their owners (:func:`fries_tpu_torch.runtime.shard.exchange`, a receive
buffer of ``exchange_cap`` or 2 S / n_shards rows per sender for S spawns)
and each rank merges what it receives; the compressions run on global
budgets and a shared grid, the estimator dots, norms and counts are
all-reduced, and the chunked spawn is off, as in the reference.  Protected
(semistochastic) keys are replicated and each rank protects the ones it
holds.  A world of one rank still runs the exchange (a copy), so it drives
the collectives of a larger world.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fries_tpu_torch import compress, dets, parallel, profiling
from fries_tpu_torch.runtime import arena as ar
from fries_tpu_torch.runtime import shard as sh

F64 = torch.float64
N_SPAWN_RNS = 6


@dataclass(frozen=True)
class PowerConfig:
    eps: float
    target_nonz: int        # vector compression budget
    capacity: int           # determinants held
    init_thresh: float = 0.0
    target_norm: float = 0.0
    shift_interval: int = 10
    shift_damping: float = 0.05
    shift_tracking: float = 0.0   # once the controller is active, each update
                                  # also subtracts tracking / (interval * eps)
                                  # * ln(norm / target), which pins the
                                  # stationary one-norm at target_norm (the
                                  # rate-only controller, 0.0, freezes it
                                  # wherever the first crossing left it)
    batch: int = 0          # rows per chunk of the chunked spawn (0 = all)
    spawn_rows: int = 0     # spawn only from the first spawn_rows arena rows
                            # (valid rows are a sorted prefix, so this is
                            # exact while n_used <= spawn_rows; the overflow
                            # flag says when it is not).  0 = whole arena
    dedup_cap: int = 0      # collapse duplicate targets to at most this many
                            # (key, ini) rows before each chunk's merge
                            # (arena.dedup_spawns).  0 = off
    n_shards: int = 1       # ranks of a sharded run
    exchange_cap: int = 0   # exchange rows per sender (0 = 2 S / n_shards)


@dataclass
class PowerState:
    """Arena + scalars.  ``generator`` draws the step's uniforms when the
    caller injects none; ``key`` is a keyed stepper's key node."""

    arena: ar.Arena
    en_shift: torch.Tensor
    last_norm: torch.Tensor
    iterat: int
    generator: torch.Generator
    key: object = None


def fresh_state(a: ar.Arena, seed: int, key=None) -> PowerState:
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    zero = torch.zeros((), dtype=F64, device=a.device)
    return PowerState(arena=a, en_shift=zero, last_norm=zero.clone(), iterat=0,
                      generator=gen, key=key)


def draw_uniforms(state: PowerState):
    """(rns (6,), rn_vec) f64 uniforms in [0, 1) from the state's generator."""
    u = torch.rand(N_SPAWN_RNS + 1, dtype=F64, generator=state.generator)
    return u[:N_SPAWN_RNS], u[N_SPAWN_RNS]


def _as_f64(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=F64)
    return torch.tensor(np.asarray(x, np.float64), device=device)


def exchange_spawns(cfg, shards, words, amps, **payload):
    """Route a spawn stream to its owners.  Returns (words, amps with zeros
    on the sentinel rows, the other payloads, overflow)."""
    cap = cfg.exchange_cap or max(1, 2 * amps.shape[0] // cfg.n_shards)
    received, overflow = sh.exchange(
        {"keys": words, "amps": amps, **payload}, sh.shard_of_words(words, cfg.n_shards),
        cfg.n_shards, cap, shards)
    words = received.pop("keys")
    amps = torch.where(dets.is_invalid(words), 0.0, received.pop("amps"))
    return words, amps, received, overflow


def make_stepper(spawn_fn, diag_fn, cfg: PowerConfig,
                 estimator: str = "before_after", spawn_chunk_fn=None,
                 keyed: bool = False, shards=None):
    """Build (step, run_steps) for one model.

    step(state, num_keys, num_vals, den_keys, den_vals, ref_key, rns=None,
    rn_vec=None, protected_keys=None) -> (new_state, metrics) with the
    reference's metric keys:
      estimator="before_after": proj_num from <den|v> before and after the
        multiply; num_* are ignored (pass den_* again);
      estimator="direct": proj_num = <num|v_new>, proj_den = <den|v_new> on
        the post-death uncompressed vector.
    ``protected_keys`` (P, W): determinants exempt from stochastic
    compression and deletion, the semistochastic deterministic subspace.

    ``spawn_chunk_fn`` (exact-H drivers): a spawner of the same signature
    applied to ``cfg.batch`` rows at a time.  When given, the step spawns
    and merges chunk by chunk: each chunk's stream goes into value row 1 of
    the running arena without a keep mask (row positions shift with every
    chunk), the initiator rule gates against the pass-through origin row,
    which no chunk modifies, and the arena is compacted once at the end.

    ``keyed``: the spawner takes a key node; ``rns`` and ``rn_vec`` are not
    taken, both come from ``state.key``.

    ``shards``: this rank's handle of a sharded run (``cfg.n_shards`` ranks);
    ``spawn_fn`` must compress over the same ranks, and ``spawn_chunk_fn``
    is not used.
    """
    if estimator not in ("before_after", "direct"):
        raise ValueError(f"unknown estimator {estimator!r}")
    parallel.check_world(cfg.n_shards, shards)
    if shards is not None:
        spawn_chunk_fn = None
    eps = cfg.eps

    def protected_mask(pos, found, c):
        """(c,) bools, True at the found positions."""
        mask = torch.zeros(c + 1, dtype=torch.bool, device=pos.device)
        mask.index_fill_(0, torch.where(found, pos, c), True)
        return mask[:c]

    @profiling.stepped
    def step(state: PowerState, num_keys, num_vals, den_keys, den_vals,
             ref_key, rns=None, rn_vec=None, protected_keys=None):
        a = state.arena
        dev = a.device
        if keyed:
            if rns is not None or rn_vec is not None:
                raise ValueError("a keyed stepper draws from state.key, not from rns")
            rns, key_vec = state.key.fold(state.iterat).split(2)
            rn_vec = key_vec.uniform(()).to(dev)
        else:
            if rns is None or rn_vec is None:
                drawn_rns, drawn_rn = draw_uniforms(state)
                rns = drawn_rns if rns is None else rns
                rn_vec = drawn_rn if rn_vec is None else rn_vec
            rns = _as_f64(rns, dev)
            rn_vec = _as_f64(rn_vec, dev)
        vals0 = torch.where(a.valid, a.vals[0], 0.0)
        sentinel = dets.invalid_det(a.n_words, dev)

        spawn_over = torch.zeros((), dtype=torch.bool, device=dev)
        if cfg.spawn_rows and cfg.spawn_rows < a.capacity:
            r = cfg.spawn_rows
            spawn_over = a.n_used[0] > r
            s_keys, s_vals = a.keys[:r], vals0[:r]
        else:
            r = a.capacity
            s_keys, s_vals = a.keys, vals0

        if spawn_chunk_fn is not None:
            batch = cfg.batch or r
            n_chunks = -(-r // batch)
            pad = n_chunks * batch - r
            if pad:
                s_keys = torch.cat([s_keys, sentinel.repeat(pad, 1)])
                s_vals = torch.cat([s_vals, s_vals.new_zeros(pad)])
            a2 = a
            overflow = spawn_over
            nonini = torch.zeros((), dtype=torch.int64, device=dev)
            for i in range(n_chunks):
                rows = slice(i * batch, (i + 1) * batch)
                w, amp, ini = spawn_chunk_fn(s_keys[rows], s_vals[rows], -eps, rns)
                w = torch.where((amp != 0)[:, None], w, sentinel)
                if cfg.dedup_cap:
                    w, amp, ini, dedup_over = ar.dedup_spawns(w, amp, ini, cfg.dedup_cap)
                    overflow = overflow | dedup_over
                a2, st = ar.accumulate_best(a2, w, amp, ini, origin_row=0, dest_row=1)
                overflow = overflow | st["overflow"]
                nonini = nonini + st["nonini_occ_add"]
        else:
            # dead rows of the previous step (zero compressed value, not the
            # reference or protected) stay until this merge drops them
            keep_in = dets.det_eq(a.keys, ref_key[None, :])
            if protected_keys is not None:
                keep_in = keep_in | protected_mask(*ar.lookup(a, protected_keys), a.capacity)
            flat_words, flat_amps, flat_ini = spawn_fn(s_keys, s_vals, -eps, rns)
            flat_words = torch.where((flat_amps != 0)[:, None], flat_words, sentinel)
            exch_over = torch.zeros((), dtype=torch.bool, device=dev)
            if shards is not None:
                flat_words, flat_amps, rec, exch_over = exchange_spawns(
                    cfg, shards, flat_words, flat_amps, ini=flat_ini)
                flat_ini = rec["ini"]
            a2, st = ar.accumulate_best(a, flat_words, flat_amps, flat_ini,
                                        origin_row=0, dest_row=1, keep_mask=keep_in)
            overflow = st["overflow"] | spawn_over
            nonini = st["nonini_occ_add"]

        # death / cloning + combine; the diagonal is recomputed from keys
        diag2 = diag_fn(a2.keys)
        new_v = a2.vals[0] * (1 - eps * (diag2 - state.en_shift)) + a2.vals[1]
        new_v = torch.where(a2.valid, new_v, 0.0)

        # one lookup serves the estimator dots and the protected mask; the
        # merge passes the origin row through, so a2.vals[0] at the merged
        # positions is the vector before the multiply
        with profiling.span("fries.estimator"):
            n_num = num_keys.shape[0]
            n_den = den_keys.shape[0]
            queries = [num_keys, den_keys]
            if protected_keys is not None:
                queries.append(protected_keys)
            qpos, qfound = ar.lookup(a2, torch.cat(queries))
            gathered = torch.where(qfound, new_v[qpos], 0.0)
            den_sl = slice(n_num, n_num + n_den)
            den_after = (gathered[den_sl] * den_vals.to(F64)).sum()
            if estimator == "before_after":
                gathered0 = torch.where(qfound, a2.vals[0][qpos], 0.0)
                den_other = (gathered0[den_sl] * den_vals.to(F64)).sum()
            else:
                den_other = (gathered[:n_num] * num_vals.to(F64)).sum()

        if protected_keys is not None:
            prot = protected_mask(qpos[n_num + n_den:], qfound[n_num + n_den:],
                                  a2.capacity)
        else:
            prot = torch.zeros(a2.capacity, dtype=torch.bool, device=dev)
        stoch_v = torch.where(prot, 0.0, new_v)

        keep, n_left, loc_norm = compress.find_preserve(stoch_v.abs(), cfg.target_nonz,
                                                        shards=shards)
        glob_norm = (loc_norm + torch.where(keep, stoch_v.abs(), 0.0).sum()
                     + torch.where(prot, new_v.abs(), 0.0).sum())
        den_after, den_other, glob_norm = parallel.gsum(shards, den_after, den_other,
                                                      glob_norm)
        if estimator == "before_after":
            proj_num = ((1 + eps * state.en_shift) * den_other - den_after) / eps
            proj_den = den_other
        else:
            proj_num, proj_den = den_other, den_after

        do_shift = (state.iterat + 1) % cfg.shift_interval == 0
        en_shift, last_norm = state.en_shift, state.last_norm
        if do_shift:
            en_shift, last_norm = compress.adjust_shift(
                state.en_shift, glob_norm, state.last_norm, cfg.target_norm,
                cfg.shift_damping / cfg.shift_interval / eps)
            if cfg.shift_tracking:
                tracked = en_shift - (cfg.shift_tracking / cfg.shift_interval / eps
                                      ) * torch.log(glob_norm / cfg.target_norm)
                en_shift = torch.where(state.last_norm != 0, tracked, en_shift)

        comp_v = compress.sys_comp(stoch_v, keep, n_left, rn_vec, loc_norm, shards)
        comp_v = torch.where(prot, new_v, comp_v)
        a3 = ar.Arena(keys=a2.keys, vals=torch.stack([comp_v, torch.zeros_like(comp_v)]),
                      n_used=a2.n_used)
        is_ref = dets.det_eq(a3.keys, ref_key[None, :])
        live = (comp_v != 0) | is_ref | prot
        if spawn_chunk_fn is not None:
            # no keep mask fused into the chunks' merges: compact here
            a3 = ar.compact(a3, live)
            n_dets = a3.n_used[0]
        else:
            n_dets = live.sum()
        n_ini = ((comp_v.abs() >= cfg.init_thresh) & (comp_v != 0)).sum()
        nnonz = (comp_v != 0).sum()
        if shards is not None:
            n_dets, n_ini, nnonz, nonini, n_over = parallel.gsum(
                shards, n_dets, n_ini, nnonz, nonini.to(torch.int64),
                overflow.to(torch.int64))
            overflow = (n_over > 0) | exch_over

        metrics = {
            "proj_num": proj_num,
            "proj_den": proj_den,
            "norm": glob_norm,
            "shift": en_shift,
            "n_dets": n_dets,
            "nkept": cfg.target_nonz - n_left,
            "n_ini": n_ini,
            "nnonz": nnonz,
            "sgn_coh": nonini,
            "overflow": overflow,
        }
        return (PowerState(a3, en_shift, last_norm, state.iterat + 1,
                           state.generator, state.key), metrics)

    def run_steps(state, num_keys, num_vals, den_keys, den_vals, ref_key,
                  n_iter: int, protected_keys=None):
        """``n_iter`` steps (a host loop); returns (state, metrics stacked
        over the steps)."""
        traj = []
        for _ in range(n_iter):
            state, m = step(state, num_keys, num_vals, den_keys, den_vals, ref_key,
                            protected_keys=protected_keys)
            traj.append(m)
        return state, {k: torch.stack([torch.as_tensor(m[k]) for m in traj])
                       for k in traj[0]}

    return step, run_steps


def per_parent_ini(vals, init_thresh, n_per: int):
    """Initiator flags for spawners that emit ``n_per`` candidates per
    parent (|v_parent| >= threshold)."""
    return (vals.abs() >= init_thresh).repeat_interleave(n_per)


def chunked(spawn_one, capacity: int, batch: int, n_words: int):
    """Wrap a whole-batch spawn function with fixed-size chunking (a host
    loop; bounds the temporaries of an exact H application, not its
    stream, which is still merged once).  For a stepper that is given no
    ``spawn_chunk_fn``; a step that merges chunk by chunk does not call it.
    ``spawn_one`` must return flat tensors of B * NC rows for B input rows."""
    if not batch or batch >= capacity:
        return spawn_one

    def spawn(keys, vals, h_fac, rns):
        c = keys.shape[0]
        pad = -c % batch
        if pad:
            keys = torch.cat([keys, dets.invalid_det(n_words, keys.device).repeat(pad, 1)])
            vals = torch.cat([vals, vals.new_zeros(pad)])
        parts = [spawn_one(keys[s:s + batch], vals[s:s + batch], h_fac, rns)
                 for s in range(0, c + pad, batch)]
        w, amp, ini = (torch.cat(x) for x in zip(*parts))
        take = c * (amp.shape[0] // (c + pad))
        return w[:take], amp[:take], ini[:take]

    return spawn
