"""Stochastic compression and sampling by definition.

* Exact preservation: candidates sorted by value, largest first, each kept
  while its value is at least the mass not yet kept over the budget not yet
  spent (the greedy rule); the rest is resampled.
* Systematic resampling: one uniform ``rn`` places the grid points
  (rn + k) * unit, unit = the resampled mass over the samples left, along
  the running sum of the resampled masses in their order; an element gets
  the points that fall in its interval.  ``below(x)`` = floor(x / unit - rn)
  + 1 points lie strictly below x.
* One level of the hierarchical compression splits each parent's mass over
  its subs: by a row of masses (held in float32, the configuration's stage
  precision, and walked left to right in float32 inside the row) or into
  ``ndiv`` equal parts.  Its output lists, parent after parent, the kept
  subs and then the grid's samples, each sample worth one unit.
"""

from __future__ import annotations

import torch

from . import REAL

F32 = torch.float32
POINT_CHUNK = 1 << 17


def greedy_keep(value, cost, mass, budget, rest):
    """Kept flags of candidates (value, cost in samples, mass), greedily;
    ``rest`` is the mass that is never a candidate."""
    order = torch.argsort(value, descending=True, stable=True)
    v, c, m = value[order], cost[order], mass[order]
    unkept = torch.flip(torch.cumsum(torch.flip(m, [0]), 0), [0]) + rest
    left = budget - (torch.cumsum(c, 0) - c)
    ok = (left > 0) & (v >= unkept / left.clamp_min(1).to(REAL))
    n_keep = int(torch.cumprod(ok.to(torch.int64), 0).sum()) if ok.numel() else 0
    kept = torch.zeros(value.shape[0], dtype=torch.bool, device=value.device)
    kept[order[:n_keep]] = True
    return kept


def below(x, rn, unit):
    """Grid points (rn + k) * unit, k >= 0, strictly below x."""
    return (torch.floor(x / unit - rn) + 1).clamp_min(0.0).to(torch.int64)


def vector(vals, n_samp: int, rn):
    """Preservation and systematic resampling of a vector in its order:
    (the compressed vector, the mass resampled, the samples it got)."""
    a = vals.abs()
    live = a > 0
    keep = torch.zeros_like(live)
    keep[live] = greedy_keep(a[live], torch.ones_like(a[live], dtype=torch.int64), a[live],
                             n_samp, torch.zeros((), dtype=REAL, device=a.device))
    rem = torch.where(keep, 0.0, a)
    loc = rem.sum()
    n_left = max(n_samp - int(keep.sum()), 0)
    if loc < 1e-9:
        n_left = 0
    if n_left == 0:
        return torch.where(keep, vals, 0.0), loc, n_left
    unit = loc / n_left
    cum = torch.cumsum(rem, 0) - rem
    hits = below(cum + rem, rn, unit) - below(cum, rn, unit)
    return torch.where(keep, vals, torch.sign(vals) * hits.to(REAL) * unit), loc, n_left


def prefix_f32(rows):
    """The inclusive prefix of each float32 row, summed left to right."""
    out = torch.empty_like(rows)
    acc = torch.zeros(rows.shape[0], dtype=F32, device=rows.device)
    for c in range(rows.shape[1]):
        acc = acc + rows[:, c]
        out[:, c] = acc
    return out


def level(rows, uni, ndiv, n_samp: int, rn):
    """One level of hierarchical systematic compression.

    ``rows`` (N, K) float32: the sub masses of the parents split by a row
    (zero rows for the others); ``uni`` (N,): the mass of the parents split
    into ``ndiv`` equal parts (0 for the others).  Returns (parent, sub,
    value) of the outputs, in order."""
    dev = rows.device
    n, k = rows.shape
    rn = float(rn)
    total = rows.sum(dtype=REAL) + uni.sum()
    floor = (1e-14 * total).to(F32)
    cand = rows > floor
    is_uni = uni > 0
    wvals = rows[cand].to(REAL)
    value = torch.cat([wvals, uni[is_uni] / ndiv[is_uni].to(REAL)])
    cost = torch.cat([torch.ones_like(wvals, dtype=torch.int64), ndiv[is_uni]])
    mass = torch.cat([wvals, uni[is_uni]])
    rest = torch.where(cand, 0.0, rows).sum(dtype=REAL)
    kept_flat = greedy_keep(value, cost, mass, n_samp, rest)
    kept = torch.zeros_like(cand)
    kept[cand] = kept_flat[:wvals.shape[0]]
    kept_uni = torch.zeros_like(is_uni)
    kept_uni[is_uni] = kept_flat[wvals.shape[0]:]

    rem = torch.where(kept, torch.zeros((), dtype=F32, device=dev), rows)
    parent_rem = rem.sum(1, dtype=REAL) + torch.where(kept_uni, 0.0, uni)
    loc = parent_rem.sum()
    n_grid = max(n_samp - int(kept.sum()) - int(ndiv[kept_uni].sum()), 0)
    if loc < 1e-9:
        n_grid = 0
    # kept subs: weighted ones by column, uniform ones all ndiv parts
    kp, kc = torch.nonzero(kept, as_tuple=True)
    ku = torch.nonzero(kept_uni)[:, 0]
    ku_n = ndiv[ku]
    ku_p = torch.repeat_interleave(ku, ku_n)
    ku_s = torch.arange(ku_p.shape[0], device=dev) - torch.repeat_interleave(
        torch.cumsum(ku_n, 0) - ku_n, ku_n)
    parts = [(kp, kc, rows[kp, kc].to(REAL)),
             (ku_p, ku_s, (uni / ndiv.clamp_min(1).to(REAL))[ku_p])]
    if n_grid > 0:
        unit = loc / n_grid
        cum = torch.cumsum(parent_rem, 0) - parent_rem
        start = below(cum, rn, unit)
        hits = below(cum + parent_rem, rn, unit) - start
        gp = torch.repeat_interleave(torch.arange(n, device=dev), hits)
        g = start[gp] + torch.arange(gp.shape[0], device=dev) - torch.repeat_interleave(
            torch.cumsum(hits, 0) - hits, hits)
        y = (rn + g.to(REAL)) * unit - cum[gp]
        sub = torch.empty_like(gp)
        u_pt = uni[gp] > 0
        nd = ndiv[gp].clamp_min(1).to(REAL)
        sub_u = torch.minimum(torch.floor(y / parent_rem[gp].clamp_min(1e-300) * nd)
                              .clamp_min(0.0), nd - 1).to(torch.int64)
        sub[u_pt] = sub_u[u_pt]
        w_pt = torch.nonzero(~u_pt)[:, 0]
        pre = prefix_f32(rem)
        for s in range(0, w_pt.shape[0], POINT_CHUNK):
            idx = w_pt[s:s + POINT_CHUNK]
            p = gp[idx]
            live = rem[p] > 0
            rank = ((pre[p].to(REAL) <= y[idx, None]) & live).sum(1)
            rank = torch.minimum(rank, (live.sum(1) - 1).clamp_min(0))
            nth = torch.cumsum(live.to(torch.int64), 1) - 1
            sub[idx] = (live & (nth == rank[:, None])).to(torch.int64).argmax(1)
        parts.append((gp, sub, torch.full_like(y, float(unit))))
    parent = torch.cat([p for p, _, _ in parts])
    order = torch.sort(parent, stable=True).indices
    return (parent[order], torch.cat([s for _, s, _ in parts])[order],
            torch.cat([v for _, _, v in parts])[order])


def categorical(u, probs):
    """One index per row of ``probs``: the first column whose float32 prefix
    sum, left to right, exceeds u times the row's float64 total (left to
    right); where rounding leaves u past every prefix, the last column of
    positive probability.  A column of probability 0 is never drawn."""
    tot = probs[:, 0].clone()
    for c in range(1, probs.shape[1]):
        tot = tot + probs[:, c]
    x = u * tot
    acc = probs[:, 0].to(F32)
    idx = (acc.to(REAL) <= x).to(torch.int64)
    for c in range(1, probs.shape[1]):
        acc = acc + probs[:, c].to(F32)
        idx = idx + (acc.to(REAL) <= x)
    k = probs.shape[1]
    last_pos = (k - 1) - torch.flip(probs > 0, [1]).to(torch.int64).argmax(1)
    return torch.where(idx >= k, last_pos, idx)


def round_binomially(key, p, n):
    """floor(p) * n + Binomial(n, frac(p)), from the key node's draws."""
    flr = torch.floor(p)
    return flr.to(torch.int64) * n.to(torch.int64) + key.binomial(n, p - flr).to(p.device)


def shift(s, norm, last, target, damp):
    """The norm-control shift: inactive until the norm first passes
    ``target``; then S <- S - damp * log(norm / last norm).  Returns (S, last)."""
    if last != 0:
        return s - damp * torch.log(norm / last), norm
    return s, (norm if norm > target else last)
