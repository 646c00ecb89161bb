"""One step of systematic FCI-FRI with the HB-PP compression, by definition:

    v <- compress(v - eps (H - E_HF - S) v)

The off-diagonal product is compressed in three levels (uniforms rns[1],
rns[2], rns[4]), budget ``matr_samp`` each:

  1. per determinant, over (first electron, as a double) and (electron
     with an allowed single, uniform);
  2. per double, over (second electron) x (first empty orbital), the
     product of the two probabilities; per single, uniformly over the
     electron's allowed empty orbitals;
  3. per double, over the second empty orbital (the symmetry row, occupied
     orbitals included, whose samples are lost); singles pass whole.

A sample of value x on the excitation D -> D' spawns
-eps <D'|H|D> sign(v_D) x / P, P = p_doub * the HB-PP pick probability
for a double, (1 - p_doub) / (electrons with a single) / (their empty
orbitals) for a single.  A spawn counts if its parent's |v| reaches
``init_thresh`` or its target holds a nonzero value (the initiator rule);
the diagonal acts on the old values; then the shift and the vector's
preservation and systematic resampling (uniform ``rn_vec``, budget
``vec_nonz``) in the vector's order.  Stage masses are float32 products
f32(f32(|x|) * f32(p)) (the configuration's stage precision).
"""

from __future__ import annotations

import torch

from . import REAL, sampling
from .sampling import F32


class FRI:
    def __init__(self, sys, params: dict, init_val: float):
        self.s, self.p = sys, params
        self.p_doub = sys.p_doub()
        self.trial = sys.hf_trial()
        self.init_val = float(init_val)

    def start(self):
        """(columns, values, shift, last norm) of the initial state: HF alone."""
        s = self.s
        zero = torch.zeros((), dtype=REAL, device=s.dev)
        return (s.hf_cols[None], torch.full((1,), self.init_val, dtype=REAL, device=s.dev),
                zero, zero.clone())

    # ---- the compressed off-diagonal product ----------------------------

    def spawn(self, cols, vals, rns):
        """(target columns, spawned values, initiator flags)."""
        s, p = self.s, self.p
        m = int(p["matr_samp"])
        e, nv = s.n_elec, s.n_virt
        bits = s.bits(cols)
        occ = s.occ(bits)
        mass = vals.abs()
        f32 = lambda x: x.to(F32)

        # level 1
        counts = s.single_counts(bits, occ)
        n_alw = (counts > 0).sum(1)
        w_s = torch.where(torch.arange(e, device=s.dev)[None] < n_alw[:, None],
                          (1 - self.p_doub) / n_alw.clamp_min(1).to(REAL)[:, None], 0.0)
        row = torch.cat([self.p_doub * s.p_first(occ), w_s], 1)
        rows = torch.where(row != 0, f32(mass)[:, None] * f32(row), 0.0)
        zeros = torch.zeros_like(mass)
        nd0 = torch.zeros_like(n_alw)
        par, sub, val = sampling.level(rows, zeros, nd0, m, rns[1])
        dbl = sub < e
        first = torch.where(dbl, sub, 0)
        # the electron of the single: the (sub - E)-th with an allowed one
        allowed = counts[par] > 0
        rank = torch.where(dbl, 0, sub - e)
        nth = torch.cumsum(allowed.to(torch.int64), 1) - 1
        hit = allowed & (nth == rank[:, None])
        s_el = hit.to(torch.int64).argmax(1)
        s_n = torch.where(hit.any(1), counts[par].gather(1, s_el[:, None])[:, 0], 0)

        # level 2
        b2, o2 = bits[par], occ[par]
        a = o2.gather(1, first[:, None])[:, 0]
        p2 = s.p_second(o2, first)
        pv, virts = s.p_first_virtual(b2, a)
        good = (p2.sum(1) * pv.sum(1)) > 0
        v_d = torch.where(dbl & good, val, 0.0)
        fa = torch.where(dbl[:, None], f32(v_d)[:, None] * f32(p2), 0.0)
        rows = (fa[:, :, None] * torch.where(dbl[:, None], f32(pv), 0.0)[:, None, :]
                ).reshape(-1, e * nv)
        uni = torch.where(~dbl & (s_n > 0), val, 0.0)
        par2, sub2, val = sampling.level(rows, uni, s_n, m, rns[2])
        par = par[par2]
        dbl, first, s_el, s_n = dbl[par2], first[par2], s_el[par2], s_n[par2]
        second = torch.where(dbl, sub2 // nv, 0)
        vslot = torch.where(dbl, sub2 % nv, 0)
        vrank = torch.where(dbl, 0, sub2)

        # level 3
        b3, o3 = bits[par], occ[par]
        a = o3.gather(1, first[:, None])[:, 0]
        b = o3.gather(1, second[:, None])[:, 0]
        n = s.n
        x = s.virtuals(b3, a // n).gather(1, vslot[:, None])[:, 0] + (a // n) * n
        pw, row3 = s.p_second_virtual(a, b, x)
        good = pw.sum(1) > 0
        v_d = torch.where(dbl & good, val, 0.0)
        rows = torch.where(dbl[:, None] & (pw > 0), f32(v_d)[:, None] * f32(pw), 0.0)
        uni = torch.where(dbl, 0.0, val)
        par3, sub3, val = sampling.level(rows, uni, torch.where(dbl, 0, 1), m, rns[4])
        par, dbl, first, second = par[par3], dbl[par3], first[par3], second[par3]
        x, row3, s_el, s_n, vrank = x[par3], row3[par3], s_el[par3], s_n[par3], vrank[par3]
        col = torch.where(dbl, sub3, 0)

        # the spawns
        bf, of = bits[par], occ[par]
        sgn = torch.sign(vals[par])
        h_fac = -float(p["eps"])
        a = of.gather(1, first[:, None])[:, 0]
        b = of.gather(1, second[:, None])[:, 0]
        y_sp = row3.gather(1, col[:, None])[:, 0]
        y = torch.where(y_sp < n, y_sp, 0) + (b // n) * n
        y_empty = ~bf.gather(1, y[:, None])[:, 0]
        d_ok = dbl & (y_sp < n) & y_empty & (x != y)
        pick = s.pick_prob(bf, of, a, b, x, y)
        d_amp = torch.where(d_ok & (pick > 0), h_fac * s.double(of, a, b, x, y) * sgn * val
                            / pick.clamp_min(1e-300) / self.p_doub, 0.0)
        # singles: the electron and the vrank-th empty orbital of its spin and irrep
        o = of.gather(1, s_el[:, None])[:, 0]
        irow = s.irrep_rows[s.symm[o % n]]
        cand = (irow < n) & ~bf.gather(1, (irow.clamp_max(n - 1) + (o // n)[:, None] * n))
        nth = torch.cumsum(cand.to(torch.int64), 1) - 1
        hit = cand & (nth == vrank[:, None])
        u = irow.gather(1, hit.to(torch.int64).argmax(1)[:, None])[:, 0] + (o // n) * n
        s_ok = ~dbl & hit.any(1)
        n_alw = (s.single_counts(bf, of) > 0).sum(1)
        s_amp = torch.where(s_ok, h_fac * s.single(of, o, u) * sgn * val * n_alw.to(REAL)
                            * s_n.to(REAL) / (1 - self.p_doub), 0.0)
        amp = torch.where(dbl, d_amp, s_amp)
        # the targets' bits
        tb = bf.clone()
        rows_i = torch.arange(tb.shape[0], device=s.dev)
        src1 = torch.where(dbl, a, o)
        dst1 = torch.where(dbl, x, u)
        tb[rows_i, src1] = False
        tb[rows_i[dbl], b[dbl]] = False
        tb[rows_i, dst1] = True
        tb[rows_i[dbl], y[dbl]] = True
        live = amp != 0
        ini = vals[par].abs() >= float(p["init_thresh"])
        return s.cols(tb[live]), amp[live], ini[live]

    # ---- the step --------------------------------------------------------

    def step(self, cols, vals, shift, last, iterat: int, rns, rn_vec):
        """One step from the vector (columns, values, in order), the shift, the
        last norm and the step count; returns (columns, values, metrics) with
        metrics holding the new shift and last norm."""
        s, p = self.s, self.p
        eps = float(p["eps"])
        # the vector the step reads: nonzero values and HF
        keep = (vals != 0) | (cols == s.hf_cols).all(1)
        cols, vals = cols[keep], vals[keep]
        t_cols, t_vals, t_ini = self.spawn(cols, vals, rns)
        cols, old, add = join(cols, vals, t_cols, t_vals, t_ini)
        diag = s.diag(s.occ(s.bits(cols))) - s.e_hf
        new = old * (1 - eps * (diag - shift)) + add

        proj_num = (lookup(cols, self.trial[0], new) * self.trial[1]).sum()
        proj_den = lookup(cols, s.hf_cols[None], new)[0]
        norm = new.abs().sum()
        if (iterat + 1) % int(p["shift_interval"]) == 0:
            damp = float(p["shift_damping"]) / int(p["shift_interval"]) / eps
            shift, last = sampling.shift(shift, norm, last, float(p["target_norm"]), damp)
        comp, _, _ = sampling.vector(new, int(p["vec_nonz"]), float(rn_vec))
        is_hf = (cols == s.hf_cols).all(1)
        metrics = {"proj_num": proj_num, "proj_den": proj_den, "norm": norm, "shift": shift,
                   "last_norm": last, "n_dets": ((comp != 0) | is_hf).sum(),
                   "nnonz": (comp != 0).sum()}
        return cols, comp, metrics


def join(cols, vals, t_cols, t_vals, t_ini):
    """The spawns joined to the vector under the initiator rule: a spawn
    counts if it is an initiator's or its target holds a nonzero value; a
    target the vector lacks is added if a spawn counts on it.  Returns
    (columns in order, the vector's values, the counted spawns' sums)."""
    nv = cols.shape[0]
    uniq, inv = torch.unique(torch.cat([cols, t_cols]), dim=0, return_inverse=True)
    old = torch.zeros(uniq.shape[0], dtype=vals.dtype, device=vals.device)
    old[inv[:nv]] = vals
    held = torch.zeros(uniq.shape[0], dtype=torch.int64, device=vals.device)
    held[inv[:nv]] = 1
    tgt = inv[nv:]
    ok = t_ini | (old[tgt] != 0)
    add = torch.zeros_like(old).index_add_(0, tgt[ok], t_vals[ok])
    held.index_add_(0, tgt[ok], torch.ones_like(tgt[ok]))
    rows = held > 0
    return uniq[rows], old[rows], add[rows]


def lookup(cols, q_cols, vals):
    """The values of ``vals`` (over the rows ``cols``) at the rows
    ``q_cols``; 0 where a row is absent."""
    uniq, inv = torch.unique(torch.cat([cols, q_cols]), dim=0, return_inverse=True)
    at = torch.zeros(uniq.shape[0], dtype=vals.dtype, device=vals.device)
    at[inv[:cols.shape[0]]] = vals
    return at[inv[cols.shape[0]:]]
