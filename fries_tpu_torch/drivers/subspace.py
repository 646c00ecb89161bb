"""Multi-state subspace iteration (subsp_mol), single device.

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
excitations.  ``lowmem``, ``exact_h``, ``compress_mode="multi"`` and sharding
are not ported and raise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fries_tpu_torch import compress, dets, linalg, rng
from fries_tpu_torch.drivers import frisys
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
    axis_name: str | None = None
    n_shards: int = 1

    def check_ported(self):
        for name, bad in (("lowmem", self.lowmem), ("exact_h", self.exact_h),
                          ("compress_mode='multi'", self.compress_mode == "multi"),
                          ("axis_name / n_shards > 1",
                           self.axis_name or self.n_shards > 1)):
            if bad:
                raise NotImplementedError(f"subspace option {name} is not ported")
        if self.compress_mode not in ("piv", "sys"):
            raise ValueError(f"unknown compress_mode {self.compress_mode!r}")


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


def build(ham: mol.MolecularHamiltonian, cfg: SubspaceConfig, trial_keys,
          trial_vals, seed: int, e_ref=None):
    """trial_keys (T, Nt, W) sentinel-padded determinant words and
    trial_vals (T, Nt); the iterates start as the trial vectors.  ``e_ref``
    overrides the HF diagonal energy as the diagonal's shift.  Returns
    (step, run_steps, state, aux); ``aux`` holds ``e_ref`` and the padded
    trial and H * trial vectors."""
    cfg.check_ported()
    dev = ham.device
    t, n_words = cfg.n_trial, ham.n_words
    trial_keys = np.asarray(trial_keys).astype(np.int64).reshape(t, -1, n_words)
    trial_vals = np.asarray(trial_vals, np.float64).reshape(t, -1)
    if cfg.spin_parity:
        trial_keys, trial_vals = pad_rows(
            [tr_mod.fold_vector_host(ham, trial_keys[j], trial_vals[j], cfg.spin_parity)
             for j in range(t)], n_words)
    syminfo = mol.SymmInfo.build(ham.symm.cpu().numpy())
    p_doub = frisys.hf_p_doub(ham, syminfo)
    hf_en = float(mol.hf_reference(ham)[2]) if e_ref is None else float(e_ref)
    fcfg = frisys.FrisysConfig(
        eps=cfg.eps, vec_nonz=cfg.vec_nonz, matr_samp=cfg.matr_samp,
        capacity=cfg.capacity, spawn_cap=cfg.spawn_cap, unnorm=cfg.unnorm,
        pivotal=cfg.pivotal_h, spin_parity=cfg.spin_parity)
    spawn = frisys.make_hbpp_spawner(ham, hb.setup(ham), syminfo, p_doub, fcfg, hf_en)

    h_keys, h_vals = pad_rows(
        [frisys.compute_htrial(ham, trial_keys[j], trial_vals[j], e_ref=hf_en,
                               spin_parity=cfg.spin_parity) for j in range(t)], n_words)
    est = {name: torch.as_tensor(x, device=dev) for name, x in (
        ("trial_keys", trial_keys), ("trial_vals", trial_vals),
        ("htrial_keys", h_keys), ("htrial_vals", h_vals))}

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
    a = ar.from_unsorted(ar.make(cfg.capacity, n_words, t, device=dev),
                         torch.as_tensor(np.asarray(list(uniq), np.int64)),
                         torch.as_tensor(init_vals))
    state = SubspaceState(
        arena=a, norm_factors=torch.ones(t, dtype=F64, device=dev),
        last_norms=torch.as_tensor(np.abs(init_vals).sum(1), device=dev),
        key=rng.KeyTree(seed, dev), iterat=0)

    def dots(keys, vals, qkeys, qvals):
        """(T_query, T_vec) overlaps of the query rows with the arena rows."""
        pos, found = dets.lookup_dets(keys, qkeys.reshape(-1, n_words))
        g = torch.where(found[None], vals[:, pos], 0.0).reshape(t, *qvals.shape)
        return (g * qvals[None]).sum(-1).T

    def restart(vals, d_mat, h_mat):
        rinv = linalg.inv_r_factor((d_mat - cfg.eps * h_mat).cpu().numpy())
        new_vals = torch.as_tensor(rinv, device=dev).T @ vals
        scale = vals.abs().sum(1) / new_vals.abs().sum(1).clamp_min(1e-300)
        return new_vals * scale[:, None]

    diag_fn = frisys.make_diag_fn(ham, hf_en, cfg.spin_parity)

    def compress_row(key, v):
        if cfg.compress_mode == "piv":
            return compress.piv_comp(key, v, cfg.vec_nonz)
        keep, n_left, loc_norm = compress.find_preserve(v.abs(), cfg.vec_nonz)
        return compress.sys_comp(v, keep, n_left, key.uniform(()).to(dev), loc_norm)

    def step(state: SubspaceState):
        a = state.arena
        key_iter = state.key.fold(state.iterat)

        # 1. normalize by the norm-factor controller
        norms = torch.where(a.valid[None], a.vals, 0.0).abs().sum(1)
        norm_factors, last_norms = state.norm_factors, state.last_norms
        if (state.iterat + 1) % cfg.shift_interval == 0:
            norm_factors, last_norms = compress.adjust_shift2(
                norm_factors, norms, last_norms, cfg.shift_damping)
        vals = a.vals / norm_factors[:, None]

        # 2. h / d projections; 3. restart
        d_mat = dots(a.keys, vals, est["trial_keys"], est["trial_vals"])
        h_mat = dots(a.keys, vals, est["htrial_keys"], est["htrial_vals"])
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
        thr_rows = cfg.init_thresh * vrows.abs().sum(1) / cfg.matr_samp
        n_ini = ((vrows.abs() >= thr_rows[:, None]) & (vrows != 0)).sum(1)
        spawned = []
        for j in range(t):
            kj = key_iter.fold(200 + j)
            spawned.append(spawn(a.keys, vrows[j], -cfg.eps,
                                 kj if cfg.pivotal_h else kj.uniform((6,)).to(dev),
                                 thresh=thr_rows[j]))
        words, amps, ini = zip(*spawned)
        rows = torch.arange(t, device=dev).repeat_interleave(amps[0].shape[0])
        death = 1 - cfg.eps * diag_fn(a.keys)
        dvals = torch.where(valid[None], a.vals * death[None], 0.0)
        a2, stats = ar.accumulate_multi_best(
            ar.Arena(a.keys, dvals, a.n_used), torch.cat(words), torch.cat(amps),
            rows, torch.cat(ini))

        metrics = {
            "h_mat": h_mat, "d_mat": d_mat, "norms": norms,
            "norm_factors": norm_factors, "n_ini": n_ini, "n_dets": a2.n_used,
            "overflow": stats["overflow"],
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
