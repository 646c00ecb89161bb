"""Multi-state subspace iteration (subsp_mol).

Counterpart of ``fries_tpu/drivers/subspace.py``.  n_trial vectors share one
sorted arena (one value row each) and are multiplied by 1 - eps (H - e_ref)
together.  Per iteration, in the reference's order:

  1. normalize each row by its norm factor (``compress.adjust_shift2`` every
     ``shift_interval`` steps);
  2. h_mat[i, j] = <H trial_i | v_j> and d_mat[i, j] = <trial_i | v_j> by
     arena lookup of the stored H * trial and trial vectors;
  3. every ``restart_int`` steps, v <- R^-1 v with QR(d - eps h) = Q R
     (computed on the host in f64, :mod:`fries_tpu_torch.linalg`), each
     row's 1-norm restored;
  4. per-row vector compression (pivotal ``piv_comp`` or systematic
     ``find_preserve`` + ``sys_comp``), then entries zero in every row drop;
  5. per-row HB-PP spawn (pivotal or systematic stages) with the
     norm-relative initiator threshold init_thresh * ||v_j||_1 / matr_samp;
     death on every row and the multi-row merge
     (``arena.accumulate_multi_best``, kernel C on the card).

The random draws follow the reference's key tree: ``key.fold(iterat)`` per
step, ``.fold(100 + j)`` for row j's compression and ``.fold(200 + j)`` for
its spawn (:mod:`fries_tpu_torch.rng`).  The spawn stream is row-major (row
0's ``spawn_cap`` slots, then row 1's, ...), the order the merge sums each
target's contributions in.

``spin_parity`` (+1 / -1, the CLI's ``--time_reversal``): the trial vectors
fold onto spin-flip canonical representatives at build time, H * trial and
the step's diagonal are the folded ones, and the spawner folds its sampled
excitations.

Modes:

* ``lowmem`` (``subsp_mol_lowmem``): no stored H * trial rows; every step
  enumerates H|trial_i> (``molecule.exact_offdiag_batch``, folded with
  ``time_reversal.adjust_exact`` in a sector) and dots it, with the trial's
  diagonal, against the arena rows;
* ``exact_h`` (``subspfull_mol``): every row's exact off-diagonal spawn,
  all initiators, in place of the sampled one.  The reference enumerates
  all capacity rows at once, which at the card's sizes is capacity x
  template candidates per vector; the port spawns from a snapshot of the
  compressed arena's rows (each nonzero in some vector) ``batch`` rows at a
  time and merges each chunk's T streams into the running arena (kernel C
  on the card), so the sums differ from the reference's only in the order
  of addition.  In a sector the exact spawns are folded as ``frifull``
  folds them (the reference leaves them unfolded).  Its steps also report
  ``spawn_rows`` and ``n_merges`` (the chunks merged);
* ``compress_mode="multi"``: multinomial vector compression
  (:func:`fries_tpu_torch.compress.multi_comp`) after ``find_preserve``.

Hash sharding (:func:`build_sharded`, or ``build(..., shards=)``): each rank
holds its block of the arena; the norms, the h / d projections and the
restart's norms are all-reduced, every compression runs on global budgets,
and the spawns (every chunk's, in ``exact_h``; the ranks run the largest
rank's number of chunks) travel to their owners with their destination rows
before the multi-row merge.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fries_tpu_torch import compress, dets, linalg, parallel, profiling, rng
from fries_tpu_torch.drivers import frisys, power
from fries_tpu_torch.ops import heat_bath as hb
from fries_tpu_torch.ops import molecule as mol
from fries_tpu_torch.ops import time_reversal as tr_mod
from fries_tpu_torch.runtime import arena as ar

F64 = torch.float64


@dataclass(frozen=True)
class SubspaceConfig:
    eps: float
    n_trial: int
    vec_nonz: int           # per-vector compression budget
    matr_samp: int          # per-vector Hamiltonian budget
    capacity: int
    spawn_cap: int
    restart_int: int = 10
    init_thresh: float = 0.0
    shift_interval: int = 10
    shift_damping: float = 0.05
    unnorm: bool = True
    exact_h: bool = False
    compress_mode: str = "piv"   # "piv" or "sys"
    pivotal_h: bool = True
    lowmem: bool = False
    spin_parity: int = 0
    batch: int = 1024       # exact_h: arena rows per spawn-and-merge chunk
    axis_name: str | None = None   # the reference's mesh axis (unused here)
    n_shards: int = 1
    exchange_cap: int = 0   # see power.PowerConfig.exchange_cap

    def check(self):
        if self.compress_mode not in ("piv", "sys", "multi"):
            raise ValueError(f"unknown compress_mode {self.compress_mode!r}")
        if self.exact_h and self.batch < 1:
            raise ValueError("exact_h needs batch >= 1")


@dataclass
class SubspaceState:
    """Arena (one value row per vector), per-row norm factors and last norms
    (T,), the key tree node of the run and the iteration count."""

    arena: ar.Arena
    norm_factors: torch.Tensor
    last_norms: torch.Tensor
    key: object
    iterat: int


def pad_rows(rows, n_words):
    """(T, N, W) sentinel-padded keys and (T, N) zero-padded values of a list
    of (keys, vals) rows."""
    n = max(1, max(len(v) for _, v in rows))
    keys = np.full((len(rows), n, n_words), dets.WORD_MASK, np.int64)
    vals = np.zeros((len(rows), n))
    for j, (k, v) in enumerate(rows):
        keys[j, :len(v)] = k
        vals[j, :len(v)] = v
    return keys, vals


def exact_spawn(ham: mol.MolecularHamiltonian, tmpl: mol.ExcitationTemplate, keys, vals,
                h_fac, spin_parity: int = 0):
    """Flat (words, amps) of H's exact off-diagonal action on the rows
    ``keys`` with values ``vals``, times ``h_fac``; folded onto the
    spin-flip sector ``spin_parity`` when it is not 0."""
    occ = dets.occ_list(keys, ham.n_bits, ham.n_elec)
    w, amp = mol.exact_offdiag_batch(ham, tmpl, keys, occ, vals, h_fac)
    nc = amp.shape[1]
    w, amp = w.reshape(-1, ham.n_words), amp.reshape(-1)
    if spin_parity:
        w, amp = tr_mod.adjust_exact(
            ham, keys.repeat_interleave(nc, 0), occ.repeat_interleave(nc, 0), w, amp,
            spin_parity, scale=(vals * h_fac).repeat_interleave(nc))
    return w, amp


@profiling.spanned("fries.lowmem_h_row")
def lowmem_h_mat(ham: mol.MolecularHamiltonian, tmpl: mol.ExcitationTemplate, trial_keys,
                 trial_vals, trial_diag, spin_parity: int, keys, vals):
    """(T_query, T_vec) <trial_i| (H - e_ref) |v_j> with H|trial_i>
    enumerated now: trial i's (Nt, W) keys, values and relative diagonal
    (zero on padding rows) against the arena's sorted ``keys`` and value
    rows ``vals``."""
    rows = []
    for tk, tv, td in zip(trial_keys, trial_vals, trial_diag):
        w, amp = exact_spawn(ham, tmpl, tk, torch.where(dets.is_invalid(tk), 0.0, tv), 1.0,
                             spin_parity)
        pos_o, found_o = dets.lookup_dets(keys, w)
        pos_t, found_t = dets.lookup_dets(keys, tk)
        off = (torch.where(found_o[None], vals[:, pos_o], 0.0) * amp[None]).sum(1)
        dia = (torch.where(found_t[None], vals[:, pos_t], 0.0) * (tv * td)[None]).sum(1)
        rows.append(off + dia)
    return torch.stack(rows)


def build(ham: mol.MolecularHamiltonian, cfg: SubspaceConfig, trial_keys,
          trial_vals, seed: int, e_ref=None, shards=None):
    """trial_keys (T, Nt, W) sentinel-padded determinant words and
    trial_vals (T, Nt); the iterates start as the trial vectors.  ``e_ref``
    overrides the HF diagonal energy as the diagonal's shift.  Returns
    (step, run_steps, state, aux); ``aux`` holds ``e_ref`` and the padded
    trial and H * trial vectors.  ``shards``: see :func:`build_sharded`."""
    cfg.check()
    parallel.check_world(cfg.n_shards, shards)
    dev = ham.device
    gsum = lambda x: parallel.gsum(shards, x)
    t, n_words = cfg.n_trial, ham.n_words
    trial_keys = np.asarray(trial_keys).astype(np.int64).reshape(t, -1, n_words)
    trial_vals = np.asarray(trial_vals, np.float64).reshape(t, -1)
    if cfg.spin_parity:
        trial_keys, trial_vals = pad_rows(
            [tr_mod.fold_vector_host(ham, trial_keys[j], trial_vals[j], cfg.spin_parity)
             for j in range(t)], n_words)
    hf_en = float(mol.hf_reference(ham)[2]) if e_ref is None else float(e_ref)
    tmpl = mol.ExcitationTemplate.build(ham.n_orb, ham.n_elec)
    if cfg.exact_h:
        spawn = None
    else:
        syminfo = mol.SymmInfo.build(ham.symm.cpu().numpy())
        fcfg = frisys.FrisysConfig(
            eps=cfg.eps, vec_nonz=cfg.vec_nonz, matr_samp=cfg.matr_samp,
            capacity=cfg.capacity, spawn_cap=cfg.spawn_cap, unnorm=cfg.unnorm,
            pivotal=cfg.pivotal_h, spin_parity=cfg.spin_parity)
        spawn = frisys.make_hbpp_spawner(ham, hb.setup(ham), syminfo,
                                         frisys.hf_p_doub(ham, syminfo), fcfg, hf_en,
                                         shards=shards)

    est = {name: torch.as_tensor(x, device=dev) for name, x in (
        ("trial_keys", trial_keys), ("trial_vals", trial_vals))}
    if cfg.lowmem:
        est["htrial_keys"] = est["htrial_vals"] = None
    else:
        h_keys, h_vals = pad_rows(
            [frisys.compute_htrial(ham, trial_keys[j], trial_vals[j], e_ref=hf_en,
                                   spin_parity=cfg.spin_parity) for j in range(t)], n_words)
        est["htrial_keys"] = torch.as_tensor(h_keys, device=dev)
        est["htrial_vals"] = torch.as_tensor(h_vals, device=dev)
    t_valid = ~dets.is_invalid(est["trial_keys"])
    t_occ = dets.occ_list(est["trial_keys"], ham.n_bits, ham.n_elec)
    t_diag = torch.where(t_valid, mol.diag_matrel(ham, t_occ) - hf_en, 0.0)
    if cfg.spin_parity:
        delta, forbid = tr_mod.tr_diag(ham, est["trial_keys"], t_occ, cfg.spin_parity)
        t_diag = torch.where(forbid | ~t_valid, 0.0, t_diag + delta)

    # initial arena: the union of the trial determinants, row j = trial j
    uniq = {}
    for row in trial_keys.reshape(-1, n_words):
        if row[-1] != dets.WORD_MASK:
            uniq.setdefault(tuple(row), len(uniq))
    init_vals = np.zeros((t, len(uniq)))
    for j in range(t):
        for kk, v in zip(map(tuple, trial_keys[j]), trial_vals[j]):
            if kk in uniq:
                init_vals[j, uniq[kk]] += v
    init_keys = np.asarray(list(uniq), np.int64).reshape(-1, n_words)
    if shards is not None:
        a = parallel.distribute_rows(init_keys, init_vals, shards.size, cfg.capacity,
                                     shards.rank, dev)
    else:
        a = ar.from_unsorted(ar.make(cfg.capacity, n_words, t, device=dev),
                             torch.as_tensor(init_keys), torch.as_tensor(init_vals))
    state = SubspaceState(
        arena=a, norm_factors=torch.ones(t, dtype=F64, device=dev),
        last_norms=torch.as_tensor(np.abs(init_vals).sum(1), device=dev),
        key=rng.KeyTree(seed, dev), iterat=0)

    def dots(keys, vals, qkeys, qvals):
        """(T_query, T_vec) overlaps of the query rows with the arena rows."""
        pos, found = dets.lookup_dets(keys, qkeys.reshape(-1, n_words))
        g = torch.where(found[None], vals[:, pos], 0.0).reshape(t, *qvals.shape)
        return gsum((g * qvals[None]).sum(-1).T)

    def restart(vals, d_mat, h_mat):
        rinv = linalg.inv_r_factor((d_mat - cfg.eps * h_mat).cpu().numpy())
        new_vals = torch.as_tensor(rinv, device=dev).T @ vals
        scale = gsum(vals.abs().sum(1)) / gsum(new_vals.abs().sum(1)).clamp_min(1e-300)
        return new_vals * scale[:, None]

    diag_fn = frisys.make_diag_fn(ham, hf_en, cfg.spin_parity)

    def compress_row(key, v):
        if cfg.compress_mode == "piv":
            return compress.piv_comp(key, v, cfg.vec_nonz, shards)
        keep, n_left, loc_norm = compress.find_preserve(v.abs(), cfg.vec_nonz, shards=shards)
        if cfg.compress_mode == "multi":
            return compress.multi_comp(key, v, keep, n_left, loc_norm, shards)
        return compress.sys_comp(v, keep, n_left, key.uniform(()).to(dev), loc_norm, shards)

    def route(words, amps, rows, ini):
        """The spawns' stream at their owners (unchanged on one device), and
        the exchange's overflow."""
        if shards is None:
            return words, amps, rows, ini, torch.zeros((), dtype=torch.bool, device=dev)
        words = torch.where((amps != 0)[:, None], words, dets.invalid_det(n_words, dev))
        words, amps, rec, over = power.exchange_spawns(cfg, shards, words, amps, rows=rows,
                                                       ini=ini)
        return words, amps, rec["rows"], rec["ini"], over

    def merge_exact(a, dvals, vrows):
        """The exact spawn of ``a``'s rows (values ``vrows``) merged chunk by
        chunk into the arena ``a`` with the values ``dvals`` after death.
        Returns (merged arena, overflow, rows spawned from, merges)."""
        a2 = ar.Arena(a.keys, dvals, a.n_used)
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
        n_rows = profiling.host_read(a.n_used[0], "exact.n_used")
        n_chunks = -(-n_rows // cfg.batch)
        if shards is not None:
            n_chunks = profiling.host_read(shards.max(torch.tensor(n_chunks)), "exact.chunks")
        for i in range(n_chunks):
            rows = slice(i * cfg.batch, (i + 1) * cfg.batch)
            words, amps = zip(*(exact_spawn(ham, tmpl, a.keys[rows], vrows[j, rows],
                                            -cfg.eps, cfg.spin_parity) for j in range(t)))
            dest = torch.arange(t, device=dev).repeat_interleave(amps[0].shape[0])
            words, amps, dest, ini, over = route(
                torch.cat(words), torch.cat(amps), dest,
                torch.ones(dest.shape[0], dtype=torch.bool, device=dev))
            a2, st = ar.accumulate_multi_best(a2, words, amps, dest, ini)
            overflow = overflow | st["overflow"] | over
        return a2, overflow, n_rows, n_chunks

    @profiling.stepped
    def step(state: SubspaceState):
        a = state.arena
        key_iter = state.key.fold(state.iterat)

        # 1. normalize by the norm-factor controller
        norms = gsum(torch.where(a.valid[None], a.vals, 0.0).abs().sum(1))
        norm_factors, last_norms = state.norm_factors, state.last_norms
        if (state.iterat + 1) % cfg.shift_interval == 0:
            norm_factors, last_norms = compress.adjust_shift2(
                norm_factors, norms, last_norms, cfg.shift_damping)
        vals = a.vals / norm_factors[:, None]

        # 2. h / d projections; 3. restart
        d_mat = dots(a.keys, vals, est["trial_keys"], est["trial_vals"])
        h_mat = (lowmem_h_mat(ham, tmpl, est["trial_keys"], est["trial_vals"], t_diag,
                              cfg.spin_parity, a.keys, vals) if cfg.lowmem
                 else dots(a.keys, vals, est["htrial_keys"], est["htrial_vals"]))
        if cfg.lowmem:
            h_mat = gsum(h_mat)
        if (state.iterat + 1) % cfg.restart_int == 0:
            vals = restart(vals, d_mat, h_mat)

        # 4. per-row compression; drop entries zero in every row
        vrows = torch.where(a.valid[None], vals, 0.0)
        vals = torch.stack([compress_row(key_iter.fold(100 + j), vrows[j])
                            for j in range(t)])
        a = ar.compact(ar.Arena(a.keys, vals, a.n_used), (vals != 0).any(0))

        # 5. per-row spawn, death, multi-row merge
        valid = a.valid
        vrows = torch.where(valid[None], a.vals, 0.0)
        thr_rows = cfg.init_thresh * gsum(vrows.abs().sum(1)) / cfg.matr_samp
        n_ini = gsum(((vrows.abs() >= thr_rows[:, None]) & (vrows != 0)).sum(1))
        death = 1 - cfg.eps * diag_fn(a.keys)
        dvals = torch.where(valid[None], a.vals * death[None], 0.0)
        exact = {}
        if cfg.exact_h:
            a2, overflow, n_rows, n_merges = merge_exact(a, dvals, vrows)
            exact = {"spawn_rows": torch.tensor(n_rows), "n_merges": torch.tensor(n_merges)}
        else:
            spawned = []
            for j in range(t):
                kj = key_iter.fold(200 + j)
                spawned.append(spawn(a.keys, vrows[j], -cfg.eps,
                                     kj if cfg.pivotal_h else kj.uniform((6,)).to(dev),
                                     thresh=thr_rows[j]))
            words, amps, ini = zip(*spawned)
            rows = torch.arange(t, device=dev).repeat_interleave(amps[0].shape[0])
            words, amps, rows, ini, over = route(torch.cat(words), torch.cat(amps), rows,
                                                 torch.cat(ini))
            a2, stats = ar.accumulate_multi_best(
                ar.Arena(a.keys, dvals, a.n_used), words, amps, rows, ini)
            overflow = stats["overflow"] | over
        n_dets = a2.n_used
        if shards is not None:
            n_dets, n_over = parallel.gsum(shards, a2.n_used[0],
                                               overflow.to(torch.int64))
            n_dets, overflow = n_dets.reshape(1), n_over > 0

        metrics = {
            "h_mat": h_mat, "d_mat": d_mat, "norms": norms,
            "norm_factors": norm_factors, "n_ini": n_ini, "n_dets": n_dets,
            "overflow": overflow, **exact,
        }
        return (SubspaceState(a2, norm_factors, last_norms, state.key,
                              state.iterat + 1), metrics)

    def run_steps(state, n_iter: int):
        """``n_iter`` steps (a host loop); returns (state, metrics stacked
        over the steps)."""
        traj = []
        for _ in range(n_iter):
            state, m = step(state)
            traj.append(m)
        return state, {k: torch.stack([m[k] for m in traj]) for k in traj[0]}

    aux = {"e_ref": hf_en, "spawn": spawn, **est}
    return step, run_steps, state, aux


def build_sharded(ham: mol.MolecularHamiltonian, cfg: SubspaceConfig, trial_keys,
                  trial_vals, seed: int, shards, e_ref=None):
    """Hash-sharded subspace iteration on this rank (``shards``,
    ``cfg.n_shards`` ranks): ``cfg.capacity`` is per rank, the budgets are
    global, and the key tree is the same on every rank.  Returns (step,
    run_steps, state, aux) as :func:`build` does, for this rank."""
    return build(ham, cfg, trial_keys, trial_vals, seed, e_ref=e_ref, shards=shards)
