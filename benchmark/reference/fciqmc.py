"""One step of integer initiator FCIQMC with heat-bath doubles, by definition.

Attempt slot k (of ``attempt_cap``) belongs to the determinant whose
interval of the running walker counts, in the vector's order, holds k; its
draws are element k of each key node's uniforms.  A slot is a double with
probability p_doub (node "split"), else a single:

  * double (node "spawn", then its first of two children, split in four):
    the first electron, the second, the first empty orbital and the second
    orbital of the symmetry row, each by :func:`sampling.categorical`; its
    probability is the HB-PP pick probability (both orders summed);
  * single (the second child, split in two): an electron with an allowed
    single, then one of its allowed empty orbitals, uniformly.

The spawn -eps <D'|H|D> sign(v) / (P p) is rounded binomially (node
"round"), the walkers of each determinant die or clone by rounding
|1 - eps (H_DD - E_HF - S)| n binomially (node "death", folded with 1) over
the vector laid out in ``capacity`` slots, and the spawns join the
post-death vector under the initiator rule (parent above ``init_thresh``
walkers, or a target with walkers after death).  The nodes: the seed's
tree folded with the step count, split in four (split, spawn, death,
round).
"""

from __future__ import annotations

import torch

from . import REAL, sampling
from .fri import join, lookup


class FCIQMC:
    def __init__(self, sys, params: dict, init_walkers: float, key):
        self.s, self.p, self.key = sys, params, key
        self.p_doub = sys.p_doub()
        self.trial = sys.hf_trial()
        self.init_walkers = float(init_walkers)

    def start(self):
        s = self.s
        zero = torch.zeros((), dtype=REAL, device=s.dev)
        return (s.hf_cols[None], torch.full((1,), self.init_walkers, dtype=REAL,
                                            device=s.dev), zero, zero.clone())

    def _draws(self, key, slots):
        """Element k of the node's uniforms for each attempt slot k."""
        return key.uniform((int(self.p["attempt_cap"]),)).to(self.s.dev)[slots]

    def _doubles(self, keys, slots, bits, occ):
        s = self.s
        n = s.n
        u1, u2, u3, u4 = (self._draws(k, slots) for k in keys)
        p1 = s.p_first(occ)
        e1 = sampling.categorical(u1, p1)
        p2 = s.p_second(occ, e1)
        e2 = sampling.categorical(u2, p2)
        a, b = occ.gather(1, e1[:, None])[:, 0], occ.gather(1, e2[:, None])[:, 0]
        pv, virts = s.p_first_virtual(bits, a)
        v = sampling.categorical(u3, pv)
        x = virts.gather(1, v[:, None])[:, 0] + (a // n) * n
        pw, row = s.p_second_virtual(a, b, x)
        c = sampling.categorical(u4, pw)
        y_sp = row.gather(1, c[:, None])[:, 0]
        y = torch.where(y_sp < n, y_sp, 0) + (b // n) * n
        ok = ((p1.sum(1) > 0) & (p2.sum(1) > 0) & (pv.sum(1) > 0) & (pw.sum(1) > 0)
              & (y_sp < n) & ~bits.gather(1, y[:, None])[:, 0] & (x != y))
        return a, b, x, y, ok

    def _singles(self, keys, slots, bits, occ):
        s = self.s
        n = s.n
        counts = s.single_counts(bits, occ)
        allowed = counts > 0
        n_alw = allowed.sum(1)
        u1, u2 = (self._draws(k, slots) for k in keys)
        idx = lambda u, cnt: torch.minimum((u * cnt).to(torch.int32), (cnt - 1).clamp_min(0))
        r = idx(u1, n_alw.clamp_min(1))
        nth = torch.cumsum(allowed.to(torch.int64), 1) - 1
        hit = allowed & (nth == r[:, None])
        el = hit.to(torch.int64).argmax(1)
        o = occ.gather(1, el[:, None])[:, 0]
        m = counts.gather(1, el[:, None])[:, 0]
        irow = s.irrep_rows[s.symm[o % n]]
        cand = (irow < n) & ~bits.gather(1, irow.clamp_max(n - 1) + (o // n)[:, None] * n)
        r2 = idx(u2, m.clamp_min(1))
        nth = torch.cumsum(cand.to(torch.int64), 1) - 1
        hit2 = cand & (nth == r2[:, None])
        u = irow.gather(1, hit2.to(torch.int64).argmax(1)[:, None])[:, 0] + (o // n) * n
        ok = (n_alw > 0) & hit.any(1) & (m > 0) & hit2.any(1)
        prob = 1.0 / m.clamp_min(1).to(REAL) / n_alw.clamp_min(1).to(REAL)
        return o, u, prob, ok

    def step(self, cols, vals, shift, last, iterat: int, _draws=None):
        """One step from the vector (columns, values, in order: the program's
        compacted arena), shift, last norm and step count; returns (columns,
        values, metrics) with metrics holding the new shift and last norm."""
        s, p = self.s, self.p
        eps, a_cap, cap = float(p["eps"]), int(p["attempt_cap"]), int(p["capacity"])
        k_split, k_spawn, k_death, k_round = self.key.fold(iterat).split(4)
        kd, ks = k_spawn.split(2)
        bits = s.bits(cols)
        occ = s.occ(bits)
        n_int = torch.round(vals.abs()).to(torch.int64)
        total = int(n_int.sum())
        slots = torch.arange(min(total, a_cap), device=s.dev)
        parent = torch.repeat_interleave(torch.arange(cols.shape[0], device=s.dev),
                                         n_int)[:a_cap]
        pb, po = bits[parent], occ[parent]
        is_d = self._draws(k_split, slots) < self.p_doub
        a, b, x, y, d_ok = self._doubles(kd.split(4), slots, pb, po)
        o, u, s_prob, s_ok = self._singles(ks.split(2), slots, pb, po)
        d_ok, s_ok = is_d & d_ok, ~is_d & s_ok
        d_mag = eps * s.double(po, a, b, x, y) / s.pick_prob(pb, po, a, b, x, y) / self.p_doub
        s_mag = eps * s.single(po, o, u) / s_prob / (1 - self.p_doub)
        val = -torch.where(d_ok, d_mag, torch.where(s_ok, s_mag, 0.0)) * torch.sign(vals[parent])
        full = torch.zeros(a_cap, dtype=REAL, device=s.dev)
        full[:val.shape[0]] = val.abs()
        ones = torch.ones(a_cap, dtype=torch.int32, device=s.dev)
        rounded = sampling.round_binomially(k_round, full, ones).to(REAL)[:val.shape[0]]
        val = torch.sign(val) * rounded
        tb = pb.clone()
        i = torch.arange(tb.shape[0], device=s.dev)
        tb[i, torch.where(d_ok, a, o)] = False
        tb[i[d_ok], b[d_ok]] = False
        tb[i, torch.where(d_ok, x, u)] = True
        tb[i[d_ok], y[d_ok]] = True
        live = val != 0
        t_cols, t_vals = s.cols(tb[live]), val[live]
        t_ini = vals[parent].abs()[live] > float(p["init_thresh"])
        over = total > a_cap or int(live.sum()) > int(p["spawn_cap"])

        # death and cloning, over the vector laid out in its capacity
        diag = s.diag(occ) - s.e_hf
        death = (1 - eps * (diag - shift)) * torch.sign(vals)
        dp = torch.zeros(cap, dtype=REAL, device=s.dev)
        dn = torch.zeros(cap, dtype=torch.int64, device=s.dev)
        dp[:cols.shape[0]], dn[:cols.shape[0]] = death.abs(), n_int
        kept = sampling.round_binomially(k_death.fold(1), dp, dn)[:cols.shape[0]]
        post = torch.sign(death) * kept.to(REAL)

        cols, post, add = join(cols, post, t_cols, t_vals, t_ini)
        final = post + add
        over = over or cols.shape[0] > cap

        proj_num = (lookup(cols, self.trial[0], final) * self.trial[1]).sum()
        proj_den = lookup(cols, s.hf_cols[None], final)[0]
        norm = final.abs().sum()
        if (iterat + 1) % int(p["shift_interval"]) == 0:
            damp = float(p["shift_damping"]) / int(p["shift_interval"]) / eps
            shift, last = sampling.shift(shift, norm, last, float(p["target_walkers"]), damp)
        is_hf = (cols == s.hf_cols).all(1)
        keep = (final != 0) | is_hf
        cols, final = cols[keep], final[keep]
        metrics = {"proj_num": proj_num, "proj_den": proj_den, "norm": norm, "shift": shift,
                   "last_norm": last, "n_dets": keep.sum(), "nnonz": (final != 0).sum(),
                   "overflow": over}
        return cols, final, metrics
