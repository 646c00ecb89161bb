"""Stochastic vector compression: exact preservation, systematic resampling
and hierarchical (subdivided) compression.

Counterpart of the main-path part of ``fries_tpu/compress.py``:

* ``find_preserve``: the greedy "preserve the largest exactly" rule as a
  threshold fixpoint, seeded by a histogram bound (``_preserve_threshold_seed``).
* ``sys_comp``: systematic resampling on a shared grid.
* ``comp_sub``: one hierarchical compression level whose output slots are
  emitted by :func:`fries_tpu_torch.runtime.emit.emit` (the comp_sub
  emission kernel on the card).
* ``comp_sub_factored``: the same level over a rank-1 factored row, with its
  emission recomputing rows from the factors (plain torch).
* ``adjust_shift``: the norm-control energy shift.

The reference's ``lax.while_loop`` fixpoints are host loops here: each round
reads one count back from the device.  Every array keeps the static,
capacity-padded shape of the reference, so a step's work is set by the rung
and not by the current population.
"""

from __future__ import annotations

import torch

from fries_tpu_torch.runtime import emit as emit_mod

F64 = torch.float64
_SEED_EDGES = 20
_SEED_TILE = 8192


def _f64(x, device):
    return torch.as_tensor(x, dtype=F64, device=device)


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


def _seed_finish(mass_above, cost_above, n_samp, tot_mass):
    """Greedy simulation over whole histogram buckets -> conservative T_est."""
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


def _preserve_threshold_seed(parts, n_samp, tot_mass):
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
    return _seed_finish(mass_above, cost_above, n_samp, tot_mass)


# ---------------------------------------------------------------------------
# exact preservation and systematic resampling
# ---------------------------------------------------------------------------

def find_preserve(abs_vals: torch.Tensor, n_samp: int, max_rounds: int = 64):
    """Elements to preserve exactly before stochastic resampling.

    An element is preserved when its magnitude is at least the remaining mean
    mass per remaining sample, iterated to a fixpoint (one host read per
    round).  Returns (keep (N,) bool, n_samp_left 0-dim int64, loc_norm 0-dim
    f64 1-norm of the non-preserved elements)."""
    abs_vals = abs_vals.to(F64)
    n_samp = int(n_samp)
    tot_mass = abs_vals.sum()
    t_est = _preserve_threshold_seed([(abs_vals, abs_vals, None)], n_samp, tot_mass)
    keep = abs_vals >= t_est
    live = abs_vals > 0
    inf = torch.tensor(float("inf"), dtype=F64, device=abs_vals.device)
    for _ in range(max_rounds):
        rem_mask = ~keep & live
        glob_norm = torch.where(rem_mask, abs_vals, 0.0).sum()
        budget = (n_samp - keep.sum()).clamp_min(0)
        threshold = torch.where(budget > 0, glob_norm / budget.clamp_min(1).to(F64), inf)
        added = rem_mask & (abs_vals >= threshold)
        keep = keep | added
        if not bool(added.any()):
            break
    rem_mask = ~keep & live
    loc_norm = torch.where(rem_mask, abs_vals, 0.0).sum()
    n_left = (n_samp - keep.sum()).clamp_min(0)
    n_left = torch.where(loc_norm < 1e-9, 0, n_left)
    return keep, n_left, loc_norm


def _grid_count_below(x, rn, unit):
    """Number of grid points (rn + k) * unit, k >= 0, strictly below x."""
    return (torch.floor(x / unit - rn) + 1).clamp_min(0.0).to(torch.int64)


def sys_comp(vals, keep, n_samp, rn, loc_norm):
    """Systematic resampling of the non-preserved elements: each becomes
    sign * glob_norm / n_samp times the number of shared-grid points landing
    in its interval.  Unbiased: E[out] = in."""
    dtype = vals.dtype
    vals64 = vals.to(F64)
    absw = torch.where(~keep, vals64.abs(), 0.0)
    inf = torch.tensor(float("inf"), dtype=F64, device=vals.device)
    unit = torch.where(n_samp > 0, loc_norm / n_samp.clamp_min(1), inf)
    cum = torch.cumsum(absw, 0) - absw
    hits = (_grid_count_below(cum + absw, rn, unit)
            - _grid_count_below(cum, rn, unit)).to(F64)
    sampled = torch.sign(vals64) * hits * unit
    out = torch.where(keep, vals64, torch.where(n_samp > 0, sampled, 0.0))
    return out.to(dtype)


# ---------------------------------------------------------------------------
# subdivided (hierarchical) compression
# ---------------------------------------------------------------------------

def _threshold_fixpoint(counts_at, t_est, n_samp, max_rounds):
    """The scalar-threshold fixpoint of comp_sub: thresholds descend; stop
    once the preserved budget stops changing (one host read per round)."""
    thr = t_est
    n_kept, n_prev = -1, -2
    rounds = 0
    while n_kept != n_prev and rounds < max_rounds:
        loc, used = counts_at(thr)
        budget = (n_samp - used).clamp_min(0)
        new_thr = torch.where(budget > 0, loc / budget.clamp_min(1).to(F64), thr)
        thr = torch.minimum(new_thr, thr)
        n_prev, n_kept = n_kept, int(used)
        rounds += 1
    return thr


def _grid_layout(parent_rem, kept_counts, loc_norm, kept_budget, n_samp, rn,
                 out_size):
    """Per-parent grid starts, output offsets and totals shared by the
    comp_sub variants."""
    inf = torch.tensor(float("inf"), dtype=F64, device=parent_rem.device)
    n_grid = (n_samp - kept_budget).clamp_min(0)
    n_grid = torch.where(loc_norm < 1e-9, 0, n_grid)
    unit = torch.where(n_grid > 0, loc_norm / n_grid.clamp_min(1).to(F64), inf)
    cum_parent = torch.cumsum(parent_rem, 0) - parent_rem
    g_start = _grid_count_below(cum_parent, rn, unit)
    g_end = _grid_count_below(cum_parent + parent_rem, rn, unit)
    grid_counts = torch.where(n_grid > 0, g_end - g_start, 0)
    counts = kept_counts + grid_counts
    offsets = torch.cumsum(counts, 0) - counts
    total = counts.sum()
    return dict(unit=unit, cum_parent=cum_parent, g_start=g_start,
                offsets=offsets, total=total, overflow=total > out_size)


def comp_sub_plan(values, ndiv, sub_weights, sub_mask, n_samp, rn,
                  out_size: int, max_rounds: int = 64):
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
    tot_norm0 = w_sub.sum(dtype=F64) + w_uni.sum()
    w_floor = (1e-14 * tot_norm0).to(cdtype)
    u_uni = w_uni / ndiv_f

    t_est = _preserve_threshold_seed(
        [(w_sub, w_sub, None), (u_uni, w_uni, ndiv_f)], n_samp, tot_norm0)

    def keep_at(thr):
        return (w_sub > w_floor) & (w_sub.to(F64) >= thr)

    def counts_at(thr):
        kept = keep_at(thr)
        kept_uni = (w_uni > 0) & (u_uni >= thr)
        loc = (torch.where(kept, 0.0, w_sub).sum(dtype=F64)
               + torch.where(kept_uni, 0.0, w_uni).sum())
        used = kept.sum() + torch.where(kept_uni, ndiv, 0).sum()
        return loc, used

    thr_f = _threshold_fixpoint(counts_at, t_est, n_samp, max_rounds)
    keep_sub = keep_at(thr_f)
    keep_uni = (w_uni > 0) & (u_uni >= thr_f)
    loc_norm, kept_budget = counts_at(thr_f)

    parent_rem = (torch.where(keep_sub, 0.0, w_sub).sum(1, dtype=F64)
                  + torch.where(keep_uni, 0.0, w_uni))
    kept_counts = torch.where(keep_uni, ndiv, keep_sub.sum(1))
    lay = _grid_layout(parent_rem, kept_counts, loc_norm, kept_budget, n_samp,
                       rn, out_size)
    plan = dict(offsets=lay["offsets"], kept_counts=kept_counts,
                g_start=lay["g_start"], ndiv=ndiv, uniform=uniform, w_sub=w_sub,
                cum_parent=lay["cum_parent"], parent_rem=parent_rem,
                u_val=values / ndiv_f, rn=rn, unit=lay["unit"], thr=thr_f,
                w_floor=w_floor.to(F64), total=lay["total"], out_size=out_size)
    return plan, lay["overflow"]


def comp_sub(values, ndiv, sub_weights, sub_mask, n_samp, rn, out_size: int,
             max_rounds: int = 64):
    """One level of hierarchical compression.

    Parent i carries weight ``values[i]`` (>= 0) subdivided uniformly into
    ``ndiv[i]`` parts (ndiv > 0) or by the probability row ``sub_weights[i]``
    over ``sub_mask`` (ndiv == 0).  Subs above the preservation threshold are
    kept exactly; the rest are systematically resampled on a shared grid.
    ``sub_weights`` may be float32: per-sub masses are then held in f32 while
    norms and grid positions stay f64.

    Returns (out_vals (M,) f64, out_parent (M,), out_sub (M,), n_out,
    overflow) with M = ``out_size``; invalid slots are (0, -1, -1)."""
    plan, overflow = comp_sub_plan(values, ndiv, sub_weights, sub_mask, n_samp,
                                   rn, out_size, max_rounds)
    out_val, out_parent, out_sub = emit_mod.emit(**plan)
    return (out_val, out_parent, out_sub,
            plan["total"].clamp_max(out_size), overflow)


def comp_sub_factored(values, ndiv, fac_a, fac_b, n_samp, rn, out_size: int,
                      kill_b0=None, max_rounds: int = 64, row_chunk: int = 0):
    """comp_sub over a rank-1 factored probability row, never materializing
    the (N, E*V) joint stage: weighted parents carry

        w_sub[i, e*V + v] = values[i] * fac_a[i, e] * fac_b[i, v]

    with the v = 0 column zeroed where ``kill_b0[i, e]``.  Every (N, K)
    quantity is recomputed from the factors in ``row_chunk``-row chunks
    (0 = one pass), with identical elementwise expressions so keep masks
    agree across passes.  Same returns as :func:`comp_sub`."""
    dev = values.device
    n, e_k = fac_a.shape
    v_k = fac_b.shape[1]
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
    col_v0 = (torch.arange(e_k * v_k, device=dev) % v_k) == 0

    def rows_of(a, b, kc):
        w = a.repeat_interleave(v_k, dim=1) * b.repeat(1, e_k)
        if kc is not None:
            w = torch.where(kc.repeat_interleave(v_k, dim=1) & col_v0, zero_c, w)
        return w

    row_chunk = n if not row_chunk or row_chunk >= n else row_chunk

    def chunks():
        for s in range(0, n, row_chunk):
            sl = slice(s, s + row_chunk)
            yield sl, rows_of(fa[sl], fb[sl],
                              None if kill_b0 is None else kill_b0[sl])

    tot_norm0 = sum(w.sum(dtype=F64) for _, w in chunks()) + w_uni.sum()
    w_floor = (1e-14 * tot_norm0).to(cdtype)

    # histogram seed; inner reductions over K stay in the stage dtype
    edges = _seed_edges(tot_norm0, n_samp)
    edges_c = edges.to(cdtype)
    mass_above = torch.zeros(_SEED_EDGES, dtype=F64, device=dev)
    cost_above = torch.zeros_like(mass_above)
    for _, w in chunks():
        for e in range(_SEED_EDGES):
            ge = w >= edges_c[e]
            mass_above[e] += torch.where(ge, w, zero_c).sum(1).sum(dtype=F64)
            cost_above[e] += ge.sum(1).sum(dtype=F64)
    m, c = _seed_hist_part(u_uni, w_uni, ndiv_f, edges)
    t_est = _seed_finish(mass_above + m, cost_above + c, n_samp, tot_norm0)

    def keep_of(w, thr):
        return (w > w_floor) & (w.to(F64) >= thr)

    def counts_at(thr):
        loc = torch.zeros((), dtype=F64, device=dev)
        used = torch.zeros((), dtype=torch.int64, device=dev)
        for _, w in chunks():
            kept = keep_of(w, thr)
            loc = loc + torch.where(kept, zero_c, w).sum(dtype=F64)
            used = used + kept.sum()
        kept_uni = (w_uni > 0) & (u_uni >= thr)
        loc = loc + torch.where(kept_uni, 0.0, w_uni).sum()
        return loc, used + torch.where(kept_uni, ndiv, 0).sum()

    thr_f = _threshold_fixpoint(counts_at, t_est, n_samp, max_rounds)
    keep_uni = (w_uni > 0) & (u_uni >= thr_f)
    rem_uni = torch.where(keep_uni, 0.0, w_uni)

    parent_rem_w = torch.empty(n, dtype=F64, device=dev)
    kept_counts_w = torch.empty(n, dtype=torch.int64, device=dev)
    for sl, w in chunks():
        kept = keep_of(w, thr_f)
        parent_rem_w[sl] = torch.where(kept, zero_c, w).sum(1, dtype=F64)
        kept_counts_w[sl] = kept.sum(1)
    # scalars derived from the per-parent arrays (self-consistent grid)
    loc_norm = parent_rem_w.sum() + rem_uni.sum()
    kept_budget = kept_counts_w.sum() + torch.where(keep_uni, ndiv, 0).sum()
    parent_rem = parent_rem_w + rem_uni
    kept_counts = torch.where(keep_uni, ndiv, kept_counts_w)
    lay = _grid_layout(parent_rem, kept_counts, loc_norm, kept_budget, n_samp,
                       rn, out_size)

    def rows(parent):
        return rows_of(fa[parent], fb[parent],
                       None if kill_b0 is None else kill_b0[parent])

    out_val, out_parent, out_sub = emit_mod.emit_plain(
        lay["offsets"], kept_counts, lay["g_start"], ndiv, uniform, rows,
        lay["cum_parent"], parent_rem, values / ndiv_f, rn, lay["unit"],
        thr_f, w_floor.to(F64), lay["total"], out_size, k=e_k * v_k)
    return (out_val, out_parent, out_sub,
            lay["total"].clamp_max(out_size), lay["overflow"])


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
