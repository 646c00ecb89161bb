"""Observable estimators for an operator that does not commute with H
(observables_mol, obs_repl_mol).

Counterpart of ``fries_tpu/drivers/observables.py``.  The observable is the
spin-summed single excitation O = sum_s a^+_cre,s a_des,s.  The iterate
evolves by exact multiplication with 1 - eps (H - e_ref) and systematic
vector compression in a four-row arena: row 0 the iterate, row 1 the
second replica, row 2 the Rayleigh snapshot, row 3 O applied to a vector.

* Rayleigh mode: on an alternating schedule (``burn_in`` steps, then
  periods of ``n_obs`` observable steps and ``btw_obs`` free steps) the
  iterate is snapshotted into row 2 at a period start and O v into row 3;
  in an observable step the compression is importance-weighted by
  (1 + |O v|)^exponent, and the estimator reports <v_t | O v_s> and
  <v_t | v_s> every step (the caller keeps the in-period ones).
* Replica mode (``replica=True``): rows 0 and 1 evolve independently, row 3
  holds O v2 every step, and the estimator is <v1 | O | v2> / <v1 | v2>.

Every merge goes through :func:`fries_tpu_torch.runtime.arena.accumulate_best`
(the sorted-merge kernel on the card) with all spawns initiators:

* ``apply_one_elec``: one merge of 2 x capacity spawns at (n_vecs, origin,
  dest) = (4, src, 3);
* ``h_multiply``: the reference enumerates the exact spawn of every
  capacity row at once, sentinel and zero-valued rows included; the port
  takes the nonzero rows of the source row from the arena before the merge,
  writes the diagonal part into the destination row, and spawns and merges
  them ``batch`` rows at a time (``molecule.exact_offdiag_batch``) at
  (4, src, src).  Zero-amplitude spawns insert rows in the reference
  (insertion counts spawns, not values) and the step's closing compaction
  removes them; the port never inserts them, so after the step both arenas
  are equal, the sums differing only in their order of addition.

The random draws follow the reference's key tree: ``key.fold(iterat)`` per
step, ``.fold(1)`` and ``.fold(2)`` for the compression uniform of rows 0
and 1 (:mod:`fries_tpu_torch.rng`).  Unlike the reference, the step also
reports the overflow of the Rayleigh snapshot's merge.

Hash sharding (:func:`build_sharded`): each rank holds its block of the
four rows; every merge's spawns (O's, and each chunk of the exact spawn, the
ranks running the largest rank's number of chunks) travel to their owners
first, and the dots, norms and counts are all-reduced.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fries_tpu_torch import compress, dets, parallel, profiling, rng
from fries_tpu_torch.drivers import frisys, power, subspace
from fries_tpu_torch.ops import molecule as mol
from fries_tpu_torch.runtime import arena as ar

F64 = torch.float64
N_ROWS = 4


@dataclass(frozen=True)
class ObservablesConfig:
    eps: float
    target_nonz: int
    capacity: int
    obs_des: int            # spatial orbital annihilated
    obs_cre: int            # spatial orbital created
    exponent: float = 0.5   # importance-sampling exponent
    burn_in: int = 100
    n_obs: int = 20         # observable-period length
    btw_obs: int = 20       # free-evolution period length
    replica: bool = False   # replica-trick estimator instead of Rayleigh
    batch: int = 1024       # source rows per exact spawn-and-merge chunk
    axis_name: str | None = None   # the reference's mesh axis (unused here)
    n_shards: int = 1
    exchange_cap: int = 0   # see power.PowerConfig.exchange_cap

    def check(self):
        if self.batch < 1:
            raise ValueError("observables needs batch >= 1")


@dataclass
class ObsState:
    """The four-row arena, the key tree node of the run and the iteration
    count."""

    arena: ar.Arena
    key: object
    iterat: int


def schedule(cfg: ObservablesConfig, it: int):
    """(in_obs, at_obs_start) of iteration ``it``: inside an observable
    period, and at the start of one."""
    phase = max(it - cfg.burn_in, 0) % (cfg.n_obs + cfg.btw_obs)
    return it >= cfg.burn_in and phase < cfg.n_obs, it >= cfg.burn_in and phase == 0


def _route(cfg, shards, words, amps):
    """The spawns at their owners (unchanged on one device) and the
    exchange's overflow."""
    if shards is None:
        return words, amps, torch.zeros((), dtype=torch.bool, device=amps.device)
    words, amps, _, over = power.exchange_spawns(cfg, shards, words, amps)
    return words, amps, over


@profiling.spanned("fries.one_elec")
def apply_one_elec(cfg: ObservablesConfig, n_orb: int, a: ar.Arena, src_row: int,
                   dest_row: int, shards=None):
    """dest_row <- O src_row in one merge (all spawns initiators, origin
    ``src_row``; sharded, after the exchange).  Returns (arena, overflow)."""
    dev = a.device
    sentinel = dets.invalid_det(a.n_words, dev)
    vals = torch.where(a.valid, a.vals[src_row], 0.0)
    words, amps = [], []
    for spin in range(2):
        des, cre = cfg.obs_des + spin * n_orb, cfg.obs_cre + spin * n_orb
        ok = dets.read_bit(a.keys, des) & ~dets.read_bit(a.keys, cre)
        new_words, sign = dets.single_parity(a.keys, des, cre)
        amp = torch.where(ok & (vals != 0), sign * vals, 0.0)
        words.append(torch.where((amp != 0)[:, None], new_words, sentinel))
        amps.append(amp)
    words, amps, over = _route(cfg, shards, torch.cat(words), torch.cat(amps))
    a = ar.set_row(a, dest_row, torch.zeros(a.capacity, dtype=F64, device=dev))
    a, stats = ar.accumulate_best(a, words, amps,
                                  torch.ones(amps.shape, dtype=torch.bool, device=dev),
                                  origin_row=src_row, dest_row=dest_row)
    return a, stats["overflow"] | over


def build(ham: mol.MolecularHamiltonian, cfg: ObservablesConfig, seed: int,
          init_val: float = 100.0, shards=None):
    """Returns (step, run_steps, state, aux) on ``ham``'s device; ``aux``
    holds ``e_ref`` (the HF diagonal energy).  ``step(state)`` advances one
    iteration and returns (state, metrics) with the reference's metric keys
    (obs_num, obs_den, in_obs, norm, n_dets, overflow), ``n_merges`` (the
    step's merges) and ``spawn_rows`` (the source rows of its exact
    spawns).  ``shards``: see :func:`build_sharded`."""
    cfg.check()
    parallel.check_world(cfg.n_shards, shards)
    dev = ham.device
    gsum = lambda x: parallel.gsum(shards, x)
    n_orb = ham.n_orb
    hf_words, _, hf_en = mol.hf_reference(ham)
    hf_en = float(hf_en)
    tmpl = mol.ExcitationTemplate.build(n_orb, ham.n_elec)
    diag_fn = frisys.make_diag_fn(ham, hf_en)
    sentinel = dets.invalid_det(ham.n_words, dev)

    def valid_row(a, row):
        return torch.where(a.valid, a.vals[row], 0.0)

    def h_multiply(a: ar.Arena, row: int):
        """row <- (1 - eps (H - e_ref)) row, exact: the diagonal part, then
        the off-diagonal spawn of the row's nonzero entries merged ``batch``
        source rows at a time.  Returns (arena, overflow, merges, source
        rows)."""
        vals = valid_row(a, row)
        src = torch.nonzero(vals).squeeze(1)
        src_keys, src_vals = a.keys[src], vals[src]
        a = ar.set_row(a, row, vals * (1 - cfg.eps * diag_fn(a.keys)))
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
        n_src = src.shape[0]
        n_chunks = -(-n_src // cfg.batch)
        if shards is not None:
            n_chunks = profiling.host_read(shards.max(torch.tensor(n_chunks)), "exact.chunks")
        for i in range(n_chunks):
            rows = slice(i * cfg.batch, (i + 1) * cfg.batch)
            w, amp = subspace.exact_spawn(ham, tmpl, src_keys[rows], src_vals[rows],
                                          -cfg.eps)
            w, amp, over = _route(cfg, shards, torch.where((amp != 0)[:, None], w, sentinel),
                                  amp)
            a, stats = ar.accumulate_best(a, w, amp, torch.ones(amp.shape, dtype=torch.bool,
                                                                device=dev),
                                          origin_row=row, dest_row=row)
            overflow = overflow | stats["overflow"] | over
        return a, overflow, n_chunks, n_src

    def internal_dot(a, r1, r2):
        return gsum(torch.where(a.valid, a.vals[r1] * a.vals[r2], 0.0).sum())

    def compress_row(a, row, key, weighted):
        """Systematic compression of one row, importance-weighted by
        (1 + |O v|)^exponent in an observable step."""
        v = valid_row(a, row)
        wfac = (1.0 + a.vals[3].abs()) ** cfg.exponent
        v_w = v * wfac if weighted else v
        keep, n_left, loc_norm = compress.find_preserve(v_w.abs(), cfg.target_nonz,
                                                        shards=shards)
        cv = compress.sys_comp(v_w, keep, n_left, key.uniform(()).to(dev), loc_norm, shards)
        return ar.set_row(a, row, cv / wfac if weighted else cv)

    def normalize(a, row):
        norm = gsum(valid_row(a, row).abs().sum())
        return ar.set_row(a, row, a.vals[row] / norm.clamp_min(1e-300)), norm

    @profiling.stepped
    def step(state: ObsState):
        a = state.arena
        key_iter = state.key.fold(state.iterat)
        in_obs, at_obs_start = schedule(cfg, state.iterat)
        n_merges = n_rows = 0
        if cfg.replica:
            a, overflow = apply_one_elec(cfg, n_orb, a, 1, 3, shards)
            n_merges += 1
            obs_num, obs_den = internal_dot(a, 0, 3), internal_dot(a, 0, 1)
        else:
            overflow = torch.zeros((), dtype=torch.bool, device=dev)
            if at_obs_start:
                a = ar.set_row(a, 2, a.vals[0])
                a, overflow = apply_one_elec(cfg, n_orb, a, 0, 3, shards)
                n_merges += 1
            obs_num, obs_den = internal_dot(a, 0, 3), internal_dot(a, 0, 2)

        rows = (0, 1) if cfg.replica else (0,)
        for row in rows:
            a = compress_row(a, row, key_iter.fold(row + 1), in_obs)
        for row in rows:
            a, ovf, n, n_src = h_multiply(a, row)
            overflow = overflow | ovf
            n_merges += n
            n_rows += n_src
        for row in rows:
            a, row_norm = normalize(a, row)
            norm = row_norm if row == 0 else norm
        a = ar.compact(a, (a.vals != 0).any(0))
        n_dets = a.n_used[0]
        if shards is not None:
            n_dets, n_over = parallel.gsum(shards, n_dets, overflow.to(torch.int64))
            overflow = n_over > 0

        metrics = {
            "obs_num": obs_num, "obs_den": obs_den,
            "in_obs": torch.tensor(in_obs), "norm": norm,
            "n_dets": n_dets, "overflow": overflow,
            "n_merges": torch.tensor(n_merges), "spawn_rows": torch.tensor(n_rows),
        }
        return ObsState(a, state.key, state.iterat + 1), metrics

    def run_steps(state, n_iter: int):
        """``n_iter`` steps (a host loop); returns (state, metrics stacked
        over the steps)."""
        traj = []
        for _ in range(n_iter):
            state, m = step(state)
            traj.append(m)
        return state, {k: torch.stack([m[k].to(dev) for m in traj]) for k in traj[0]}

    init_vals = np.zeros((N_ROWS, 1))
    init_vals[0, 0] = init_val
    if cfg.replica:
        init_vals[1, 0] = init_val
    if shards is not None:
        a = parallel.distribute_rows(hf_words[None].cpu(), init_vals, shards.size,
                                     cfg.capacity, shards.rank, dev)
    else:
        a = ar.from_unsorted(ar.make(cfg.capacity, ham.n_words, N_ROWS, device=dev),
                             hf_words[None], torch.as_tensor(init_vals))
    state = ObsState(a, rng.KeyTree(seed, dev), 0)
    return step, run_steps, state, {"e_ref": hf_en}


def build_sharded(ham: mol.MolecularHamiltonian, cfg: ObservablesConfig, seed: int, shards,
                  init_val: float = 100.0):
    """Hash-sharded observable estimators on this rank (``shards``,
    ``cfg.n_shards`` ranks; ``cfg.capacity`` per rank).  Returns (step,
    run_steps, state, aux) as :func:`build` does, for this rank."""
    return build(ham, cfg, seed, init_val, shards=shards)
