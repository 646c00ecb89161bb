"""Stochastic vector compression: exact preservation, systematic resampling
and hierarchical (subdivided) compression.

Counterpart of the main-path part of ``fries_tpu/compress.py``:

* ``find_preserve``: the greedy "preserve the largest exactly" rule as a
  threshold fixpoint, seeded by a histogram bound (``_preserve_threshold_seed``).
* ``sys_comp``: systematic resampling on a shared grid; ``compress_vector``
  runs ``find_preserve`` and ``sys_comp`` in one call.
* ``comp_sub``: one hierarchical compression level whose output slots are
  emitted by :func:`fries_tpu_torch.runtime.emit.emit` (the comp_sub
  emission kernel on the card).
* ``comp_sub_factored``: the same level over a rank-1 factored row, emitted
  by :func:`fries_tpu_torch.runtime.emit.emit_factored` (the same kernel,
  reading the two factor rows).
* ``adjust_shift`` / ``adjust_shift2``: the norm-control energy shift and
  the subspace iteration's norm-factor controller.
* walker rounding and row sampling: ``round_binomially``,
  ``stochastic_round`` and ``sample_categorical_rows``, drawing from a key
  node (:mod:`fries_tpu_torch.rng`); Walker's alias tables,
  ``setup_alias`` (host numpy, the reference's) and ``sample_alias``, which
  the hot paths do not use (they sample rows by inverse CDF).
* pivotal resampling: ``piv_select_tree`` / ``piv_select_tree_2d`` (the
  log-depth duel tournaments, in the reference's duel order), ``piv_comp``
  (vector compression) and ``comp_sub_piv`` (one pivotal hierarchical
  level).  They draw from a key node (:mod:`fries_tpu_torch.rng`).
  ``piv_budget`` splits a pivotal budget over the ranks with
  ``piv_comp_serial`` (the sequential pivotal method, a host loop).
* ``multi_comp``: multinomial vector compression (the subspace's
  ``compress_mode="multi"``), drawing from a key node.

Hash sharding: where the reference takes ``axis_name``, these functions
take ``shards`` (a :class:`fries_tpu_torch.parallel.Shards` handle, None on
one device).  Budgets, norms and counts are then global
(:func:`fries_tpu_torch.parallel.gsum`, the reference's ``_gsum``; a norm
and a count share one all-reduce), each rank's
systematic grid starts at the norm of the ranks below it (the reference's
``_gsum`` and ``_prefix_sum_over_shards`` of a rank's norm are one
all-gather here, ``_norm_over_ranks``), and a pivotal budget is split over
the ranks by ``piv_budget`` with each rank's key folded with its rank.

The reference's ``lax.while_loop`` fixpoints are host loops here: each round
reads one count back from the device.  Every branch and loop that depends on
the data tests an all-reduced value, so all ranks issue the same
collectives.  Every array keeps the static, capacity-padded shape of the
reference, so a step's work is set by the rung and not by the current
population.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fries_tpu_torch import parallel, profiling
from fries_tpu_torch.ops import ordered
from fries_tpu_torch.runtime import emit as emit_mod, plan as plan_mod

F64 = torch.float64
_SEED_EDGES = plan_mod.SEED_EDGES
_SEED_TILE = 8192


def _f64(x, device):
    return torch.as_tensor(x, dtype=F64, device=device)


def _norm_over_ranks(loc_norm, count, shards):
    """(global norm, global count, norm of the ranks below) from one
    all-gather of this rank's (norm, count); (loc_norm, count, 0) on one
    device.  Every rank sums the gathered rows in rank order."""
    if shards is None:
        return loc_norm, count, torch.zeros_like(loc_norm)
    count = torch.as_tensor(count, device=loc_norm.device).to(F64)
    g = shards.gather(torch.stack([loc_norm.to(F64), count]))
    return g[:, 0].sum(), g[:, 1].sum().to(torch.int64), g[:shards.rank, 0].sum()


# ---------------------------------------------------------------------------
# stochastic rounding and row sampling
# ---------------------------------------------------------------------------

@profiling.spanned("fries.binomial")
def round_binomially(key, p, n):
    """Unbiased integer rounding floor(p) * n + Binomial(n, frac(p)) (int64)
    of ``p`` >= 0 with ``n`` trials per element; the draws are the key
    node's ``binomial``."""
    flr = torch.floor(p)
    draws = key.binomial(n, p - flr).to(p.device)
    return flr.to(torch.int64) * n.to(torch.int64) + draws


def stochastic_round(key, p):
    """Each element of ``p`` >= 0 rounded to its floor or ceiling, unbiased."""
    flr = torch.floor(p)
    u = key.uniform(p.shape).to(device=p.device, dtype=p.dtype)
    return flr + (u < p - flr).to(p.dtype)


@profiling.spanned("fries.categorical")
def sample_categorical_rows(key, probs, valid=None):
    """One inverse-CDF index per row of (..., K) weights: the number of f32
    prefix sums at or below u * the row's f64 total; where u lands past
    every prefix (rounding left the last f32 prefix below the f64 total),
    the last column of positive weight, so a column of weight 0 is never
    drawn (a row of zeros gives K - 1).

    The reference's prefix is an f32 triangular matmul, whose order of adds
    XLA picks per K; here both sums run left to right, one add per column
    and the same rounding on every device (the f64 total is XLA's order at
    these widths), so a prefix may differ from the reference's in its last
    f32 bit, and an index flips only where u lands in that bit (a chance
    near 1e-7 per row).  Past every prefix the reference caps the count at
    K - 1, a column that may have weight 0 (a heat-bath double with
    o1 = o2); the port takes the last positive column there instead.

    While a profiler records, the draws that took that column in place of
    column K - 1 are added to the device counter ``sampler.fallback``
    (:func:`profiling.device_count`)."""
    p = probs.to(F64)
    if valid is not None:
        p = torch.where(valid, p, 0.0)
    k = probs.shape[-1]
    cols = p.movedim(-1, 0).contiguous()
    tot = cols[0].clone()
    for col in cols[1:]:
        tot += col
    u = key.uniform(probs.shape[:-1] + (1,)).to(probs.device)[..., 0] * tot
    acc = cols[0].to(torch.float32)
    idx = (acc.to(F64) <= u).to(torch.int64)
    last = torch.where(cols[0] > 0, 0, k - 1)
    for c, col in enumerate(cols[1:], 1):
        acc += col.to(torch.float32)
        idx += acc.to(F64) <= u
        last = torch.where(col > 0, c, last)
    past = idx >= k
    profiling.device_count("sampler.fallback", lambda: past & (last < k - 1))
    return torch.where(past, last, idx)


def setup_alias(probs):
    """Walker / Vose alias tables (aliases int64 (n,), alias_probs f64 (n,))
    of one distribution: host numpy, the reference's construction
    (compress_utils.cpp:823-897)."""
    probs = np.asarray(probs, dtype=np.float64)
    n = probs.shape[0]
    aliases = np.arange(n, dtype=np.int64)
    alias_probs = n * probs.copy()
    small = [i for i in range(n) if alias_probs[i] < 1]
    big = [i for i in range(n) if alias_probs[i] >= 1]
    while small and big:
        s = small.pop()
        b = big[-1]
        aliases[s] = b
        alias_probs[b] += alias_probs[s] - 1
        if alias_probs[b] < 1:
            small.append(b)
            big.pop()
    return aliases, alias_probs


def sample_alias(key, aliases, alias_probs, shape):
    """int32 draws of ``shape`` from the alias tables of :func:`setup_alias`:
    ``key`` (a key node) splits in two, a uniform index and a uniform that
    keeps it or takes its alias; on the key node's device."""
    k_idx, k_u = key.split(2)
    idx_u = k_idx.uniform(shape)
    aliases = torch.as_tensor(aliases, dtype=torch.int64, device=idx_u.device)
    alias_probs = torch.as_tensor(alias_probs, dtype=F64, device=idx_u.device)
    n = aliases.shape[0]
    idx = (idx_u * n).to(torch.int64).clamp_max(n - 1)
    u = k_u.uniform(shape).to(idx_u.device)
    return torch.where(u < alias_probs[idx], idx, aliases[idx]).to(torch.int32)


# ---------------------------------------------------------------------------
# greedy-threshold seeding
# ---------------------------------------------------------------------------

def _seed_edges(tot_mass, n_samp):
    """Geometric (4x-spaced) threshold edges below T0 = tot_mass/n_samp."""
    t0 = tot_mass / max(int(n_samp), 1)
    k = torch.arange(_SEED_EDGES, dtype=F64, device=tot_mass.device)
    return t0 * torch.exp2(-2.0 * k)


def _seed_hist_part(u, mass, cost, edges):
    """(mass_above, cost_above) of one part over the seed edges."""
    uf = u.reshape(-1)
    mass_above = torch.zeros(_SEED_EDGES, dtype=F64, device=uf.device)
    cost_above = torch.zeros_like(mass_above)
    if (mass is u and uf.dtype == torch.float32 and cost is None
            and uf.shape[0] >= _SEED_TILE):
        # f32 rows: per-tile f32 sums under an f64 outer sum, as the
        # reference does; tile errors sit far inside the one-bucket backoff
        tns = uf.shape[0] // _SEED_TILE * _SEED_TILE
        ur = uf[:tns].view(-1, _SEED_TILE)
        tail = uf[tns:].to(F64)
        edges32 = edges.to(torch.float32)
        for e in range(_SEED_EDGES):
            ge = ur >= edges32[e]
            mass_above[e] = torch.where(ge, ur, 0.0).sum(1).sum(dtype=F64)
            cost_above[e] = ge.sum(1, dtype=torch.float32).sum(dtype=F64)
            if tail.numel():
                ge_t = tail >= edges[e]
                mass_above[e] += torch.where(ge_t, tail, 0.0).sum()
                cost_above[e] += ge_t.sum(dtype=F64)
        return mass_above, cost_above
    mf = mass.reshape(-1)
    cf = None if cost is None else cost.reshape(-1).to(F64)
    u64 = uf.to(F64)
    for e in range(_SEED_EDGES):
        ge = u64 >= edges[e]
        mass_above[e] = torch.where(ge, mf, 0.0).sum(dtype=F64)
        cost_above[e] = (ge.sum(dtype=F64) if cf is None
                         else torch.where(ge, cf, 0.0).sum())
    return mass_above, cost_above


def _seed_finish(mass_above, cost_above, n_samp, tot_mass, shards=None):
    """Greedy simulation over whole histogram buckets -> conservative T_est
    (the histogram summed over the ranks)."""
    if shards is not None:
        mass_above, cost_above = shards.sum(torch.stack([mass_above, cost_above])).unbind()
    n_sampf = float(max(int(n_samp), 1))
    t0 = tot_mass / n_sampf
    edges = _seed_edges(tot_mass, n_samp)
    zero1 = torch.zeros(1, dtype=F64, device=mass_above.device)
    cm_excl = torch.cat([zero1, mass_above[:-1]])
    cc_excl = torch.cat([zero1, cost_above[:-1]])
    budget_rem = n_sampf - cc_excl
    thr_before = (tot_mass - cm_excl) / budget_rem.clamp_min(1e-300)
    ok = (budget_rem > 0) & (cost_above <= n_sampf) & (edges >= thr_before)
    prefix_ok = torch.cumsum((~ok).to(torch.int64), 0) == 0
    b_last = prefix_ok.sum() - 1
    inf = torch.tensor(float("inf"), dtype=F64, device=t0.device)
    t_est = torch.where(
        b_last >= 0, t0 * torch.exp2(-2.0 * (b_last - 1).clamp_min(0).to(F64)), inf)
    return torch.where(tot_mass > 0, t_est, inf)


@profiling.spanned("fries.seed")
def _preserve_threshold_seed(parts, n_samp, tot_mass, shards=None):
    """Conservative upper bound T_est >= the final greedy preserve threshold.

    ``parts``: list of (u, mass, cost): u the per-budget-unit weight (0 =
    inactive), mass the preserved 1-norm, cost the budget units consumed
    (None = 1).  Every item with u >= T_est is in the greedy preserve set."""
    edges = _seed_edges(tot_mass, n_samp)
    mass_above = torch.zeros(_SEED_EDGES, dtype=F64, device=tot_mass.device)
    cost_above = torch.zeros_like(mass_above)
    for u, mass, cost in parts:
        m, c = _seed_hist_part(u, mass, cost, edges)
        mass_above += m
        cost_above += c
    return _seed_finish(mass_above, cost_above, n_samp, tot_mass, shards)


# ---------------------------------------------------------------------------
# exact preservation and systematic resampling
# ---------------------------------------------------------------------------

@profiling.spanned("fries.preserve")
def find_preserve(abs_vals: torch.Tensor, n_samp: int, max_rounds: int = 64,
                  shards=None):
    """Elements to preserve exactly before stochastic resampling.

    An element is preserved when its magnitude is at least the remaining mean
    mass per remaining sample, iterated to a fixpoint (one host read per
    round).  Returns (keep (N,) bool, n_samp_left 0-dim int64, loc_norm 0-dim
    f64 1-norm of this rank's non-preserved elements); the budget is global
    over ``shards``' ranks and may be a 0-dim device tensor, read once."""
    abs_vals = abs_vals.to(F64)
    n_samp = (profiling.host_read(n_samp, "preserve.budget") if torch.is_tensor(n_samp)
              else int(n_samp))
    tot_mass = parallel.gsum(shards, abs_vals.sum())
    t_est = _preserve_threshold_seed([(abs_vals, abs_vals, None)], n_samp, tot_mass,
                                     shards)
    keep = abs_vals >= t_est
    live = abs_vals > 0
    inf = torch.tensor(float("inf"), dtype=F64, device=abs_vals.device)
    # each round reads the global preserved count once (one all-reduce with
    # the residual norm); an unchanged count means the last round added nothing
    n_prev = -1
    for rounds in range(max_rounds + 1):
        rem_mask = ~keep & live
        loc_norm = torch.where(rem_mask, abs_vals, 0.0).sum()
        glob_norm, n_kept = parallel.gsum(shards, loc_norm, keep.sum())
        n_now = profiling.host_read(n_kept, "fixpoint.preserve")
        if n_now == n_prev or rounds == max_rounds:
            break
        n_prev = n_now
        budget = (n_samp - n_kept).clamp_min(0)
        threshold = torch.where(budget > 0, glob_norm / budget.clamp_min(1).to(F64), inf)
        keep = keep | (rem_mask & (abs_vals >= threshold))
    n_left = (n_samp - n_kept).clamp_min(0)
    n_left = torch.where(glob_norm < 1e-9, 0, n_left)
    return keep, n_left, loc_norm


def _grid_count_below(x, rn, unit):
    """Number of grid points (rn + k) * unit, k >= 0, strictly below x."""
    return (torch.floor(x / unit - rn) + 1).clamp_min(0.0).to(torch.int64)


@profiling.spanned("fries.sys_comp")
def sys_comp(vals, keep, n_samp, rn, loc_norm, shards=None):
    """Systematic resampling of the non-preserved elements: each becomes
    sign * glob_norm / n_samp times the number of shared-grid points landing
    in its interval, the grid shared by every rank (``rn`` the same on all;
    this rank's interval starts at the norm of the ranks below it).
    Unbiased: E[out] = in."""
    dtype = vals.dtype
    vals64 = vals.to(F64)
    absw = torch.where(~keep, vals64.abs(), 0.0)
    inf = torch.tensor(float("inf"), dtype=F64, device=vals.device)
    glob_norm, _, lbound = _norm_over_ranks(loc_norm, 0, shards)
    unit = torch.where(n_samp > 0, glob_norm / n_samp.clamp_min(1), inf)
    cum = ordered.cumsum(absw) - absw
    if shards is not None:
        cum = lbound + cum
    hits = (_grid_count_below(cum + absw, rn, unit)
            - _grid_count_below(cum, rn, unit)).to(F64)
    sampled = torch.sign(vals64) * hits * unit
    out = torch.where(keep, vals64, torch.where(n_samp > 0, sampled, 0.0))
    return out.to(dtype)


def compress_vector(vals, n_samp: int, rn, shards=None):
    """``find_preserve`` then ``sys_comp``: one vector compression step."""
    keep, n_left, loc_norm = find_preserve(vals.abs(), n_samp, shards=shards)
    return sys_comp(vals, keep, n_left, rn, loc_norm, shards)


# ---------------------------------------------------------------------------
# pivotal resampling
# ---------------------------------------------------------------------------

def _duel(u, pa, pb, ia, ib, none):
    """One round of pivotal duels between pairs (pa, ia) and (pb, ib): the
    pair's surviving (probability, index) and the index finalized as
    selected (``none`` where the round finalizes nothing)."""
    tot = pa + pb
    small = tot <= 1.0
    # tot <= 1: the winner absorbs the pair's mass; tot > 1: one element is
    # selected for good and the other carries tot - 1
    take_a_small = u * tot.clamp_min(1e-300) < pa
    sel_a_big = u * (2.0 - tot).clamp_min(1e-300) < (1.0 - pb)
    new_p = torch.where(small, tot, tot - 1.0)
    new_i = torch.where(small, torch.where(take_a_small, ia, ib),
                        torch.where(sel_a_big, ib, ia))
    fin = torch.where(small, none, torch.where(sel_a_big, ia, ib))
    return new_p, new_i, fin


@profiling.spanned("fries.piv_tree")
def piv_select_tree(key, p):
    """Pivotal (Deville-Tille) 0/1 selection with inclusion probabilities
    ``p`` (N,) by a log-depth pairing tournament: level ``lev`` duels
    neighbours with uniforms ``key.fold(lev)``; the last survivor is kept
    with its leftover probability (``key.fold(levels)``).  E[sel] = p and
    floor(sum p) or ceil(sum p) elements are selected.  Returns (N,) bool."""
    n = p.shape[0]
    dev = p.device
    levels = max(1, math.ceil(math.log2(max(n, 2))))
    size = 1 << levels
    pr = torch.zeros(size, dtype=F64, device=dev)
    pr[:n] = p
    idx = torch.full((size,), n, dtype=torch.int64, device=dev)
    idx[:n] = torch.arange(n, device=dev)
    sel = torch.zeros(n + 1, dtype=torch.bool, device=dev)   # slot n: none
    for lev in range(levels):
        u = key.fold(lev).uniform((size >> (lev + 1),)).to(dev)
        pr, idx, fin = _duel(u, pr[0::2], pr[1::2], idx[0::2], idx[1::2], n)
        sel[fin] = True
    u_last = key.fold(levels).uniform(()).to(dev)
    sel[torch.where(u_last < pr[0], idx[0], n)] = True
    return sel[:n]


@profiling.spanned("fries.piv_tree_2d")
def piv_select_tree_2d(key, p):
    """Pivotal 0/1 selection over an (N, K) grid: duels within each row
    first (uniforms ``key.fold(lev)`` of shape (N, K/2^(lev+1)) over the
    row padded to a power of two), then the rows' residuals duel across rows
    in :func:`piv_select_tree` with ``key.fold(997)``.  Returns (N, K)
    bool."""
    n, k = p.shape
    dev = p.device
    lev_k = max(1, math.ceil(math.log2(max(k, 2))))
    kpow = 1 << lev_k
    pr = torch.zeros((n, kpow), dtype=F64, device=dev)
    pr[:, :k] = p
    idx = torch.arange(kpow, device=dev).expand(n, kpow)
    sel = torch.zeros((n, kpow + 1), dtype=torch.bool, device=dev)  # col kpow: none
    for lev in range(lev_k):
        u = key.fold(lev).uniform((n, kpow >> (lev + 1))).to(dev)
        pr, idx, fin = _duel(u, pr[:, 0::2], pr[:, 1::2], idx[:, 0::2],
                             idx[:, 1::2], kpow)
        sel.scatter_(1, fin, True)
    sel_rows = piv_select_tree(key.fold(997), pr[:, 0])
    sel.scatter_(1, torch.where(sel_rows, idx[:, 0], kpow)[:, None], True)
    return sel[:, :k]


def piv_comp_shard(key, vals, keep, n_budget):
    """Pivotal resampling of the non-preserved elements against the budget
    ``n_budget``: elements reaching the unit norm / budget are preserved
    first (the reference's adjust_probs capping as a greedy preserve), the
    rest are tree-pivotal sampled at that unit."""
    dtype = vals.dtype
    vals64 = vals.to(F64)
    stoch = torch.where(keep, 0.0, vals64.abs())
    cap_keep, n_left, cap_norm = find_preserve(stoch, n_budget)
    inf = torch.tensor(float("inf"), dtype=F64, device=vals.device)
    unit = torch.where(n_left > 0, cap_norm / n_left.clamp_min(1), inf)
    p = torch.where(cap_keep, 0.0, (stoch / unit).clamp_max(1.0))
    m = p.shape[0]
    if m % 128 == 0 and m >= 256:
        # the reference's duel order: within 128-wide blocks, then across
        selected = piv_select_tree_2d(key, p.reshape(-1, 128)).reshape(-1)
    else:
        selected = piv_select_tree(key, p)
    out = torch.where(keep | cap_keep, vals64,
                      torch.where(selected & (n_left > 0), torch.sign(vals64) * unit, 0.0))
    return out.to(dtype)


def _rank_budget(key, loc_norm, n_left, shards):
    """(this rank's pivotal budget, its key): the global budget split over
    the ranks by :func:`piv_budget` under ``key.fold(1)``, and
    ``key.fold(2).fold(rank)``; (n_left, key) on one device."""
    if shards is None:
        return n_left, key
    budgets = piv_budget(key.fold(1), shards.gather(loc_norm), n_left)
    return budgets[shards.rank], key.fold(2).fold(shards.rank)


@profiling.spanned("fries.piv_comp")
def piv_comp(key, vals, n_samp, shards=None):
    """Pivotal vector compression: the global find_preserve, then
    :func:`piv_comp_shard` with this rank's share of the remaining budget
    (the whole of it on one device)."""
    keep, n_left, loc_norm = find_preserve(vals.abs(), n_samp, shards=shards)
    budget, key = _rank_budget(key, loc_norm, n_left, shards)
    return piv_comp_shard(key, vals, keep, budget)


def piv_budget(key, shard_norms, n_samp):
    """Integer budgets (n,) int64 of the ranks from their norms
    ``shard_norms`` (n,): the floor of each share of ``n_samp``, plus one
    for the ranks whose fractional remainders :func:`piv_comp_serial`
    selects, so they sum to ``n_samp``.  Every rank computes the same split
    from the gathered norms.  A budget of 0 gives every rank 0: the
    reference's split divides by max(n_samp, 1) and hands a rank holding
    all the norm a budget of 1, which then samples at an infinite unit."""
    shard_norms = shard_norms.to(F64)
    n_samp = torch.as_tensor(n_samp, device=shard_norms.device)
    unit = shard_norms.sum() / n_samp.clamp_min(1)
    share = shard_norms / unit.clamp_min(1e-300)
    base = torch.floor(share).to(torch.int64)
    frac = share - base
    extra = piv_comp_serial(key, frac, torch.zeros_like(frac, dtype=torch.bool),
                            n_samp - base.sum(), frac.sum())
    return torch.where(n_samp > 0, base + (extra > 0).to(torch.int64), 0)


def piv_comp_serial(key, vals, keep, n_samp, loc_norm):
    """Pivotal resampling of the non-preserved elements by the sequential
    pivotal method in natural order (a host loop over the elements, exact and
    O(N); the port calls it on the per-rank norms): the running residual
    duels each element with uniform ``key.uniform((N,))[i]``, and the last
    residual survives with its probability (``key.fold(1).uniform(())``).
    Each element is selected at most once at sign * loc_norm / n_samp;
    E[out] = in."""
    dtype, dev = vals.dtype, vals.device
    vals64 = vals.to(F64)
    absw = torch.where(~keep, vals64.abs(), 0.0)
    n_samp = torch.as_tensor(n_samp, device=dev)
    inf = torch.tensor(float("inf"), dtype=F64, device=dev)
    unit = torch.where(n_samp > 0, torch.as_tensor(loc_norm, dtype=F64, device=dev)
                       / n_samp.clamp_min(1), inf)
    p = profiling.host_read(torch.where(absw > 0, absw / unit, 0.0), "pivotal.serial")
    u = profiling.host_read(key.uniform((len(p),)), "pivotal.serial")
    res_p, res_idx = 0.0, -1
    selected = [False] * len(p)
    for i, (pi, ui) in enumerate(zip(p, u)):
        if not pi > 0:
            continue
        tot = res_p + pi
        if tot < 1.0:
            res_idx = i if ui < pi / max(tot, 1e-300) else res_idx
            res_p = tot
        else:
            sel_new = ui < (1.0 - res_p) / max(2.0 - tot, 1e-300)
            fin, res_idx = (i, res_idx) if sel_new else (res_idx, i)
            if fin >= 0:
                selected[fin] = True
            res_p = tot - 1.0
    last_u = profiling.host_read(key.fold(1).uniform(()), "pivotal.serial")
    if res_idx >= 0 and last_u < res_p:
        selected[res_idx] = True
    sel = torch.tensor(selected, dtype=torch.bool, device=dev)
    out = torch.where(keep, vals64, torch.where(sel & (n_samp > 0),
                                                torch.sign(vals64) * unit, 0.0))
    return out.to(dtype)


@profiling.spanned("fries.multi_comp")
def multi_comp(key, vals, keep, n_samp, loc_norm, shards=None):
    """Multinomial compression of the non-preserved elements: counts ~
    Multinomial(n_samp, |v| / glob_norm), each value sign * unit * count
    with unit = glob_norm / n_samp; the preserved elements pass through.

    The draws are ``key.uniform((N,))``, N = len(vals), the same on every
    rank; those past the budget are masked before the sort (masking after it
    would keep the smallest), the rest are placed by ``searchsorted`` against
    the running |v| sum, which starts at the norm of the ranks below, and
    counted by index.  A rank counts only the draws above that start: the
    reference counts the lower ranks' draws at its first element."""
    n = vals.shape[0]
    dev = vals.device
    vals64 = vals.to(F64)
    absw = torch.where(~keep, vals64.abs(), 0.0)
    n_samp = torch.as_tensor(n_samp, device=dev)
    inf = torch.tensor(float("inf"), dtype=F64, device=dev)
    glob_norm, _, lbound = _norm_over_ranks(loc_norm, 0, shards)
    unit = torch.where(n_samp > 0, glob_norm / n_samp.clamp_min(1), inf)
    cum = ordered.cumsum(absw)
    u = key.uniform((n,)).to(dev)
    live_draw = torch.arange(n, device=dev) < n_samp
    draws = torch.sort(torch.where(live_draw, u, inf)).values * glob_norm
    if shards is not None and shards.rank > 0:
        cum = lbound + cum
        draws = torch.where(draws > lbound, draws, inf)
    pos = torch.searchsorted(cum, draws, side="left")
    counts = torch.zeros(n + 1, dtype=torch.int64, device=dev).index_add_(
        0, pos.clamp_max(n), torch.ones_like(pos))[:n]
    sampled = torch.sign(vals64) * unit * counts.to(F64)
    out = torch.where(keep, vals64, torch.where(n_samp > 0, sampled, 0.0))
    return out.to(vals.dtype)


# ---------------------------------------------------------------------------
# subdivided (hierarchical) compression
# ---------------------------------------------------------------------------

@profiling.spanned("fries.fixpoint")
def _threshold_fixpoint(counts_at, t_est, n_samp, max_rounds, shards=None):
    """The scalar-threshold fixpoint of comp_sub: thresholds descend; stop
    once the global preserved budget stops changing (one host read per
    round, of an all-reduced count, so every rank runs the same rounds)."""
    thr = t_est
    n_kept, n_prev = -1, -2
    rounds = 0
    while n_kept != n_prev and rounds < max_rounds:
        loc, used = parallel.gsum(shards, *counts_at(thr))
        budget = (n_samp - used).clamp_min(0)
        new_thr = torch.where(budget > 0, loc / budget.clamp_min(1).to(F64), thr)
        thr = torch.minimum(new_thr, thr)
        n_prev, n_kept = n_kept, profiling.host_read(used, "fixpoint.comp_sub")
        rounds += 1
    return thr


@profiling.spanned("fries.layout")
def _grid_layout(parent_rem, kept_counts, loc_norm, kept_budget, n_samp, rn,
                 out_size, shards=None):
    """Per-parent grid starts, output offsets and totals shared by the
    comp_sub variants.  Sharded, the grid is global: its unit is the global
    norm over the global grid budget, and this rank's parents start at the
    norm of the ranks below (a nonzero ``cum_parent`` offset)."""
    inf = torch.tensor(float("inf"), dtype=F64, device=parent_rem.device)
    glob_norm, kept_g, lbound = _norm_over_ranks(loc_norm, kept_budget, shards)
    n_grid = (n_samp - kept_g).clamp_min(0)
    n_grid = torch.where(glob_norm < 1e-9, 0, n_grid)
    unit = torch.where(n_grid > 0, glob_norm / n_grid.clamp_min(1).to(F64), inf)
    cum_parent = ordered.cumsum(parent_rem) - parent_rem
    if shards is not None:
        cum_parent = lbound + cum_parent
    g_start = _grid_count_below(cum_parent, rn, unit)
    g_end = _grid_count_below(cum_parent + parent_rem, rn, unit)
    grid_counts = torch.where(n_grid > 0, g_end - g_start, 0)
    counts = kept_counts + grid_counts
    offsets = torch.cumsum(counts, 0) - counts
    total = counts.sum()
    return dict(unit=unit, cum_parent=cum_parent, g_start=g_start,
                offsets=offsets, total=total, overflow=total > out_size)


def comp_sub_plan(values, ndiv, sub_weights, sub_mask, n_samp, rn,
                  out_size: int, max_rounds: int = 64, shards=None):
    """comp_sub up to its emission: the preservation fixpoint and the grid
    layout.  Returns (the keyword arguments of
    :func:`fries_tpu_torch.runtime.emit.emit`, overflow flag)."""
    dev = values.device
    values = values.to(F64)
    cdtype = torch.float32 if sub_weights.dtype == torch.float32 else F64
    n_samp = int(n_samp)
    rn = _f64(rn, dev)

    uniform = (ndiv > 0) & (values > 0)
    weighted = (ndiv == 0) & (values > 0)
    w_sub = torch.where(weighted[:, None] & sub_mask,
                        values.to(cdtype)[:, None] * sub_weights.to(cdtype),
                        torch.zeros((), dtype=cdtype, device=dev))
    w_uni = torch.where(uniform, values, 0.0)
    ndiv_f = ndiv.clamp_min(1).to(F64)
    tot_norm0 = parallel.gsum(shards, w_sub.sum(dtype=F64) + w_uni.sum())
    w_floor = (1e-14 * tot_norm0).to(cdtype)
    u_uni = w_uni / ndiv_f

    t_est = _preserve_threshold_seed(
        [(w_sub, w_sub, None), (u_uni, w_uni, ndiv_f)], n_samp, tot_norm0, shards)

    def keep_at(thr):
        return (w_sub > w_floor) & (w_sub.to(F64) >= thr)

    def counts_at(thr):
        kept = keep_at(thr)
        kept_uni = (w_uni > 0) & (u_uni >= thr)
        loc = (torch.where(kept, 0.0, w_sub).sum(dtype=F64)
               + torch.where(kept_uni, 0.0, w_uni).sum())
        used = kept.sum() + torch.where(kept_uni, ndiv, 0).sum()
        return loc, used

    thr_f = _threshold_fixpoint(counts_at, t_est, n_samp, max_rounds, shards)
    keep_sub = keep_at(thr_f)
    keep_uni = (w_uni > 0) & (u_uni >= thr_f)
    loc_norm, kept_budget = counts_at(thr_f)

    parent_rem = (torch.where(keep_sub, 0.0, w_sub).sum(1, dtype=F64)
                  + torch.where(keep_uni, 0.0, w_uni))
    kept_counts = torch.where(keep_uni, ndiv, keep_sub.sum(1))
    lay = _grid_layout(parent_rem, kept_counts, loc_norm, kept_budget, n_samp,
                       rn, out_size, shards)
    plan = dict(offsets=lay["offsets"], kept_counts=kept_counts,
                g_start=lay["g_start"], ndiv=ndiv, uniform=uniform, w_sub=w_sub,
                cum_parent=lay["cum_parent"], parent_rem=parent_rem,
                u_val=values / ndiv_f, rn=rn, unit=lay["unit"], thr=thr_f,
                w_floor=w_floor.to(F64), total=lay["total"], out_size=out_size)
    return plan, lay["overflow"]


@profiling.spanned("fries.comp_sub")
def comp_sub(values, ndiv, sub_weights, sub_mask, n_samp, rn, out_size: int,
             max_rounds: int = 64, shards=None):
    """One level of hierarchical compression.

    Parent i carries weight ``values[i]`` (>= 0) subdivided uniformly into
    ``ndiv[i]`` parts (ndiv > 0) or by the probability row ``sub_weights[i]``
    over ``sub_mask`` (ndiv == 0).  Subs above the preservation threshold are
    kept exactly; the rest are systematically resampled on a shared grid.
    ``sub_weights`` may be float32: per-sub masses are then held in f32 while
    norms and grid positions stay f64.

    Sharded (``shards``), the budget ``n_samp`` is global and the grid
    shared: each rank emits its own parents' slots.

    Returns (out_vals (M,) f64, out_parent (M,), out_sub (M,), n_out,
    overflow) with M = ``out_size``; invalid slots are (0, -1, -1)."""
    plan, overflow = comp_sub_plan(values, ndiv, sub_weights, sub_mask, n_samp,
                                   rn, out_size, max_rounds, shards)
    with profiling.span("fries.emit"):
        out_val, out_parent, out_sub = emit_mod.emit(**plan)
    return (out_val, out_parent, out_sub,
            plan["total"].clamp_max(out_size), overflow)


@profiling.spanned("fries.seed")
def _factored_seed(fa, fb, kill_b0, uni, row_chunk, tot_norm0, n_samp, shards=None):
    """comp_sub's histogram seed over the factored rows and the uniformly
    split parents ``uni``: the mass and count above each edge
    (:func:`fries_tpu_torch.runtime.plan.seed`), inner reductions over K in
    the stage dtype."""
    edges = _seed_edges(tot_norm0, n_samp)
    mass_above, cost_above = plan_mod.seed(fa, fb, kill_b0, uni, edges, row_chunk)
    return _seed_finish(mass_above, cost_above, n_samp, tot_norm0, shards)


def comp_sub_factored_plan(values, ndiv, fac_a, fac_b, n_samp, rn, out_size: int,
                           kill_b0=None, max_rounds: int = 64, row_chunk: int = 0,
                           shards=None):
    """:func:`comp_sub_factored` up to its emission.  Returns (the keyword
    arguments of :func:`fries_tpu_torch.runtime.emit.emit_factored`,
    overflow flag).  The reductions over the joint go through
    :mod:`fries_tpu_torch.runtime.plan` (kernel F on the card)."""
    dev = values.device
    values = values.to(F64)
    cdtype = torch.float32 if fac_a.dtype == torch.float32 else F64
    n_samp = int(n_samp)
    rn = _f64(rn, dev)
    zero_c = torch.zeros((), dtype=cdtype, device=dev)

    uniform = (ndiv > 0) & (values > 0)
    weighted = (ndiv == 0) & (values > 0)
    fa = torch.where(weighted[:, None],
                     values.to(cdtype)[:, None] * fac_a.to(cdtype), zero_c)
    fb = fac_b.to(cdtype)
    w_uni = torch.where(uniform, values, 0.0)
    ndiv_f = ndiv.clamp_min(1).to(F64)
    u_uni = w_uni / ndiv_f

    tot_norm0 = parallel.gsum(shards, plan_mod.total(fa, fb, kill_b0, row_chunk)
                              + w_uni.sum())
    w_floor = (1e-14 * tot_norm0).to(cdtype)
    uni = (u_uni, w_uni, ndiv)
    t_est = _factored_seed(fa, fb, kill_b0, uni, row_chunk, tot_norm0, n_samp, shards)

    def counts_at(thr):
        return plan_mod.counts(fa, fb, kill_b0, uni, w_floor, thr, row_chunk)

    thr_f = _threshold_fixpoint(counts_at, t_est, n_samp, max_rounds, shards)
    keep_uni = (w_uni > 0) & (u_uni >= thr_f)
    rem_uni = torch.where(keep_uni, 0.0, w_uni)

    parent_rem_w, kept_counts_w = plan_mod.parents(fa, fb, kill_b0, w_floor, thr_f, row_chunk)
    # scalars derived from the per-parent arrays (self-consistent grid)
    loc_norm = parent_rem_w.sum() + rem_uni.sum()
    kept_budget = kept_counts_w.sum() + torch.where(keep_uni, ndiv, 0).sum()
    parent_rem = parent_rem_w + rem_uni
    kept_counts = torch.where(keep_uni, ndiv, kept_counts_w)
    lay = _grid_layout(parent_rem, kept_counts, loc_norm, kept_budget, n_samp,
                       rn, out_size, shards)
    plan = dict(offsets=lay["offsets"], kept_counts=kept_counts,
                g_start=lay["g_start"], ndiv=ndiv, uniform=uniform, fa=fa, fb=fb,
                cum_parent=lay["cum_parent"], parent_rem=parent_rem,
                u_val=values / ndiv_f, rn=rn, unit=lay["unit"], thr=thr_f,
                w_floor=w_floor.to(F64), total=lay["total"], out_size=out_size,
                kill_b0=kill_b0)
    return plan, lay["overflow"]


@profiling.spanned("fries.comp_sub_factored")
def comp_sub_factored(values, ndiv, fac_a, fac_b, n_samp, rn, out_size: int,
                      kill_b0=None, max_rounds: int = 64, row_chunk: int = 0,
                      shards=None):
    """comp_sub over a rank-1 factored probability row, never materializing
    the (N, E*V) joint stage: weighted parents carry

        w_sub[i, e*V + v] = values[i] * fac_a[i, e] * fac_b[i, v]

    with the v = 0 column zeroed where ``kill_b0[i, e]``.  The plan's
    reductions over the joint (:mod:`fries_tpu_torch.runtime.plan`) run in
    kernel F on the card, which forms each joint value in registers; the
    plain version recomputes the joint from the factors in ``row_chunk``-row
    chunks (0 = one pass), with identical elementwise expressions so keep
    masks agree across passes; the emission
    (:func:`fries_tpu_torch.runtime.emit.emit_factored`) reads the factors.
    Same returns as :func:`comp_sub`."""
    plan, overflow = comp_sub_factored_plan(values, ndiv, fac_a, fac_b, n_samp, rn,
                                            out_size, kill_b0, max_rounds, row_chunk,
                                            shards)
    with profiling.span("fries.emit"):
        out_val, out_parent, out_sub = emit_mod.emit_factored(**plan)
    return (out_val, out_parent, out_sub,
            plan["total"].clamp_max(out_size), overflow)


@profiling.spanned("fries.comp_sub_piv")
def comp_sub_piv(values, ndiv, sub_weights, sub_mask, n_samp, key, out_size: int,
                 max_ndiv: int = 0, max_rounds: int = 64, shards=None):
    """Pivotal variant of :func:`comp_sub`: every sub of the (N, Kp) grid
    (Kp = max(K, max_ndiv); a uniform parent's value split over its first
    ndiv columns) is one item; items above the greedy preservation threshold
    are kept exactly, the rest are selected by :func:`piv_select_tree_2d`
    under ``key`` at the unit norm / remaining budget.  Output slots list the
    flagged items in row-major order.  Sharded, the remaining budget is split
    over the ranks (:func:`piv_budget`) and each rank selects at its own unit
    under its own key, a selected item carrying the global unit.  Same
    returns as :func:`comp_sub`."""
    dev = values.device
    n, k = sub_weights.shape
    kp = max(k, max_ndiv)
    values = values.to(F64)
    cdtype = torch.float32 if sub_weights.dtype == torch.float32 else F64
    zero_c = torch.zeros((), dtype=cdtype, device=dev)
    n_samp = int(n_samp)

    uniform = (ndiv > 0) & (values > 0)
    weighted = (ndiv == 0) & (values > 0)
    ndiv_f = ndiv.clamp_min(1).to(F64)
    col = torch.arange(kp, device=dev)
    w_flat = torch.where(uniform[:, None] & (col[None, :] < ndiv[:, None]),
                         (values / ndiv_f).to(cdtype)[:, None], zero_c)
    w_flat[:, :k] += torch.where(weighted[:, None] & sub_mask,
                                 values.to(cdtype)[:, None] * sub_weights.to(cdtype),
                                 zero_c)
    tot_norm0 = parallel.gsum(shards, w_flat.sum(dtype=F64))
    w_floor = (1e-14 * tot_norm0).to(cdtype)
    t_est = _preserve_threshold_seed([(w_flat, w_flat, None)], n_samp, tot_norm0, shards)

    def keep_at(thr):
        return (w_flat > w_floor) & (w_flat.to(F64) >= thr)

    def counts_at(thr):
        kept = keep_at(thr)
        return torch.where(kept, zero_c, w_flat).sum(dtype=F64), kept.sum()

    keep = keep_at(_threshold_fixpoint(counts_at, t_est, n_samp, max_rounds, shards))
    rem = torch.where(keep, zero_c, w_flat)
    loc_norm = rem.sum(dtype=F64)
    glob_norm, n_kept = parallel.gsum(shards, loc_norm, keep.sum())
    n_grid = (n_samp - n_kept).clamp_min(0)
    n_grid = torch.where(glob_norm < 1e-9, 0, n_grid)
    inf = torch.tensor(float("inf"), dtype=F64, device=dev)
    unit = torch.where(n_grid > 0, glob_norm / n_grid.clamp_min(1), inf)
    budget, key = _rank_budget(key, loc_norm, n_grid, shards)
    p = (rem.to(F64) / torch.where(budget > 0, loc_norm / budget.clamp_min(1), inf)
         ).clamp_max(1.0)
    flagged = keep | (piv_select_tree_2d(key, p) & (budget > 0))

    # slot s holds the (s+1)-th flagged item in row-major order
    cum = torch.cumsum(flagged.reshape(-1), 0)
    total = cum[-1]
    slot = torch.arange(out_size, device=dev)
    pos = torch.searchsorted(cum, slot + 1).clamp_max(n * kp - 1)
    valid = slot < total
    kept_val = w_flat.reshape(-1)[pos].to(F64)
    out_val = torch.where(valid, torch.where(keep.reshape(-1)[pos], kept_val, unit), 0.0)
    out_parent = torch.where(valid, pos // kp, -1)
    out_sub = torch.where(valid, pos % kp, -1)
    return out_val, out_parent, out_sub, total.clamp_max(out_size), total > out_size


# ---------------------------------------------------------------------------
# energy-shift controller
# ---------------------------------------------------------------------------

def adjust_shift(shift, one_norm, last_norm, target_norm, damp_factor):
    """Norm-control shift update; returns (new_shift, new_last_norm).
    Inactive until the norm first exceeds ``target_norm``; afterwards
    S <- S - damp * log(norm / last_norm)."""
    active = last_norm != 0
    new_shift = torch.where(
        active, shift - damp_factor * torch.log(
            one_norm / torch.where(active, last_norm, 1.0)), shift)
    new_last = torch.where(
        active, one_norm, torch.where(one_norm > target_norm, one_norm, last_norm))
    return new_shift, new_last


def adjust_shift2(shift, one_norm, last_norm, damp_factor):
    """Multiplicative norm-factor controller of the subspace iteration;
    returns (new_shift, new_last_norm)."""
    new_shift = shift ** (1 - damp_factor) * (one_norm / last_norm) ** damp_factor
    new_last = last_norm ** damp_factor * (one_norm / shift) ** (1 - damp_factor)
    return new_shift, new_last
