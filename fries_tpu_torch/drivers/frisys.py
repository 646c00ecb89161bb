"""frisys_mol: systematic FCI-FRI with the heat-bath Power-Pitzer (HB-PP)
factorized Hamiltonian compression.

Counterpart of ``fries_tpu/drivers/frisys.py`` (systematic, single device).
Each iteration's off-diagonal spawn runs three compression rounds over
statically shaped sample buffers, then finalizes the sampled excitations:

  A+B. one ``comp_sub`` over a joint (C, 2E) row per arena determinant:
       double-branch mass p_doub * P(o1) and single-branch mass
       (1 - p_doub) / n_allowed per allowed-electron rank;
  C+D. one ``comp_sub_factored`` over the rank-1 (o2, u1) joint
       P(o2 | o1) P(u1 | o1); singles ride it as uniform ndiv = n_virt rows;
  E.   one ``comp_sub`` over the symmetry-allowed u2 row;
  finalize: Slater-Condon elements, fermionic parities and the HB-PP
       selection weights (calc_norm_wt / calc_unnorm_wt).

The spawner consumes the scalar uniforms ``rns[1]``, ``rns[2]`` and
``rns[4]`` of the step's six (the reference's level numbering).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fries_tpu_torch import compress, dets
from fries_tpu_torch.drivers import power
from fries_tpu_torch.ops import heat_bath as hb
from fries_tpu_torch.ops import molecule as mol
from fries_tpu_torch.runtime import arena as ar

F64 = torch.float64


@dataclass(frozen=True)
class FrisysConfig:
    eps: float
    vec_nonz: int
    matr_samp: int
    capacity: int
    spawn_cap: int
    init_thresh: float = 0.0
    target_norm: float = 0.0
    shift_interval: int = 10
    shift_damping: float = 0.05
    unnorm: bool = False
    pivotal: bool = False
    spin_parity: int = 0
    stage_f32: bool = True
    fuse_ab: bool = True
    fuse_cd: bool = True
    axis_name: str | None = None
    n_shards: int = 1

    def check_ported(self):
        for name, bad in (("pivotal", self.pivotal),
                          ("spin_parity", self.spin_parity),
                          ("fuse_ab=False", not self.fuse_ab),
                          ("fuse_cd=False", not self.fuse_cd),
                          ("axis_name / n_shards > 1",
                           self.axis_name or self.n_shards > 1)):
            if bad:
                raise NotImplementedError(f"frisys option {name} is not ported")

    def power(self) -> power.PowerConfig:
        return power.PowerConfig(
            eps=self.eps, target_nonz=self.vec_nonz, capacity=self.capacity,
            init_thresh=self.init_thresh, target_norm=self.target_norm,
            shift_interval=self.shift_interval,
            shift_damping=self.shift_damping)


def _rank_to_index(mask, rank):
    """Column of the rank-th True entry per row (K if out of range)."""
    k = mask.shape[-1]
    cum = torch.cumsum(mask, -1) - 1
    hit = mask & (cum == rank[..., None])
    idx = torch.where(hit, torch.arange(k, device=mask.device), 0).sum(-1)
    found = hit.any(-1)
    return torch.where(found, idx, k), found


def _at(rows, idx):
    """rows[b, idx[b]]."""
    return rows.gather(-1, idx[:, None])[:, 0]


def make_hbpp_spawner(ham: mol.MolecularHamiltonian, tens: hb.HeatBathTensors,
                      syminfo: mol.SymmInfo, p_doub: float, cfg: FrisysConfig,
                      e_ref):
    """Stochastically compressed H application conforming to the power core's
    spawn interface ``spawn(keys, vals, h_fac, rns) -> (words, amps, ini)``.
    ``e_ref`` is unused, as in the reference (the diagonal carries it)."""
    cfg.check_ported()
    dets.require_packable(ham.n_words)
    dev = ham.device
    n_orb, n_elec = ham.n_orb, ham.n_elec
    n_bits = 2 * n_orb
    n_virt = n_orb - n_elec // 2
    lookup = torch.as_tensor(syminfo.lookup, device=dev)
    symm = torch.as_tensor(syminfo.symm, device=dev)
    symm_counts = torch.as_tensor(syminfo.counts, device=dev)
    s_cap, m_samp, unnorm = cfg.spawn_cap, cfg.matr_samp, cfg.unnorm
    stage = torch.float32 if cfg.stage_f32 else F64
    # chunk the factored stage's row passes at ~256 MB of (chunk, K) rows
    kj_bytes = n_elec * n_virt * (4 if cfg.stage_f32 else 8)
    cd_row_chunk = (0 if s_cap * kj_bytes <= 64_000_000
                    else max(1, (256_000_000 // kj_bytes) // 8192 * 8192))
    sentinel = dets.invalid_det(ham.n_words, dev)
    cols_e = torch.arange(n_elec, device=dev)

    def stage_comp_sub(vals_in, ndiv_in, w_in, rn):
        return compress.comp_sub(vals_in, ndiv_in, w_in.to(stage), w_in != 0,
                                 m_samp, rn, s_cap)

    def source(keys, occ, det_idx):
        s_keys = keys[det_idx]
        return occ[det_idx], s_keys, dets.unpack_bits(s_keys, n_bits)

    def spawn(keys, vals, h_fac, rns):
        c = keys.shape[0]
        occ = dets.occ_list(keys, n_bits, n_elec)
        absv = vals.abs()

        # ---- fused level A+B: joint (kind, o1 / allowed-electron rank) ----
        counts0 = hb.unocc_symm_counts(n_orb, n_elec, symm, symm_counts, occ)
        _, n_alw0 = hb.sing_allowed(n_orb, n_elec, symm, counts0, occ)
        probs_b0, o1_norm0 = hb.o1_probs(tens, n_orb, occ)
        if unnorm:
            w_doub = torch.where(cols_e[None, :] == 0, 0.0,
                                 probs_b0 * o1_norm0[:, None]) * (p_doub / tens.s_norm)
        else:
            w_doub = probs_b0 * p_doub
        w_sing = torch.where(cols_e[None, :] < n_alw0[:, None],
                             (1.0 - p_doub) / n_alw0.clamp_min(1).to(F64)[:, None],
                             0.0)
        val, parent, sub, _, overflow = stage_comp_sub(
            absv, torch.zeros(c, dtype=torch.int64, device=dev),
            torch.cat([w_doub, w_sing], dim=1), rns[1])
        live = parent >= 0
        det_idx = torch.where(live, parent, 0)
        is_doub = live & (sub < n_elec)
        o1_idx = torch.where(is_doub, sub, 0)
        sing_rank = torch.where(~is_doub & live, sub - n_elec, 0)

        # ---- fused level C+D: joint (o2, u1) over n_elec * n_virt columns --
        s_occ, s_keys, occ_bits = source(keys, occ, det_idx)
        counts = hb.unocc_symm_counts(n_orb, n_elec, symm, symm_counts, s_occ)
        per_elec, _ = hb.sing_allowed(n_orb, n_elec, symm, counts, s_occ)
        if unnorm:
            probs_c, o2_frac = hb.o2_probs_half(tens, n_orb, n_elec, s_occ, o1_idx)
            val = torch.where(is_doub, val * o2_frac, val)
        else:
            probs_c, _ = hb.o2_probs(tens, n_orb, n_elec, s_occ, o1_idx)
        s_elec, s_found = _rank_to_index(per_elec > 0, sing_rank)
        s_elec = torch.where(s_found, s_elec, 0)
        s_nvirt = _at(per_elec, s_elec)
        sing_ok = ~is_doub & live & s_found & (s_nvirt > 0)
        o1_orb = _at(s_occ, o1_idx)
        w_u1, frac_d, _ = hb.u1_probs(tens, n_orb, n_elec, occ_bits, o1_orb)
        if unnorm:
            fac_b = w_u1 * frac_d[:, None]
            kill_b0 = (s_occ // n_orb) == (o1_orb // n_orb)[:, None]
        else:
            fac_b = w_u1
            kill_b0 = None
        rowsum = probs_c.sum(-1) * fac_b.sum(-1)
        if kill_b0 is not None:
            rowsum = rowsum - torch.where(kill_b0, probs_c, 0.0).sum(-1) * fac_b[:, 0]
        fac_a = torch.where(is_doub[:, None], probs_c, 0.0).to(stage)
        ndiv_cd = torch.where(is_doub, 0, s_nvirt.clamp_min(1))
        val_cd = torch.where(is_doub | sing_ok, val, 0.0)
        val_cd = torch.where(is_doub & (rowsum <= 0), 0.0, val_cd)
        val, parent, sub, _, ovf = compress.comp_sub_factored(
            val_cd, ndiv_cd, fac_a, fac_b.to(stage), m_samp, rns[2], s_cap,
            kill_b0=kill_b0, row_chunk=cd_row_chunk)
        overflow = overflow | ovf
        live = parent >= 0
        pidx = torch.where(live, parent, 0)
        det_idx, o1_idx, s_elec = det_idx[pidx], o1_idx[pidx], s_elec[pidx]
        is_doub = is_doub[pidx] & live
        o2_idx = torch.where(is_doub, sub // n_virt, 0)
        u1_slot = torch.where(is_doub, sub % n_virt, 0)
        virt_rank = torch.where(~is_doub & live, sub, 0)

        # ---- level E: u2 (doubles) ----
        def first_virtual(s_occ, occ_bits, o1_idx, u1_slot):
            o1_orb = _at(s_occ, o1_idx)
            spin1 = o1_orb // n_orb
            spin_bits = torch.where((spin1 == 0)[:, None], occ_bits[:, :n_orb],
                                    occ_bits[:, n_orb:n_bits])
            virts = hb.virtual_slots(n_orb, n_elec, spin_bits)
            u1_sp = _at(virts, u1_slot.clamp(0, n_virt - 1))
            return o1_orb, torch.where(u1_sp < n_orb, u1_sp + spin1 * n_orb, 0)

        s_occ, s_keys, occ_bits = source(keys, occ, det_idx)
        o1_orb, u1_orb = first_virtual(s_occ, occ_bits, o1_idx, u1_slot)
        o2_orb = _at(s_occ, o2_idx)
        probs_e, u2_frac, _ = hb.u2_probs(tens, n_orb, symm, lookup, o1_orb,
                                          o2_orb, u1_orb, occ_bits=occ_bits,
                                          half=unnorm)
        if unnorm:
            val = torch.where(is_doub, val * u2_frac, val)
        ndiv_e = torch.where(is_doub, 0, 1)
        val_e = torch.where(is_doub & (probs_e.sum(-1) <= 0), 0.0, val)
        w_e = torch.where(is_doub[:, None] & (probs_e > 0), probs_e, 0.0)
        val, parent, sub, _, ovf = stage_comp_sub(val_e, ndiv_e, w_e, rns[4])
        overflow = overflow | ovf
        live = parent >= 0
        pidx = torch.where(live, parent, 0)
        det_idx, o1_idx, o2_idx = det_idx[pidx], o1_idx[pidx], o2_idx[pidx]
        s_elec, virt_rank, u1_slot = s_elec[pidx], virt_rank[pidx], u1_slot[pidx]
        is_doub = is_doub[pidx] & live
        is_sing = ~is_doub & live
        u2_slot = torch.where(is_doub, sub, 0)

        # ---- finalize: doubles ----
        s_occ, s_keys, occ_bits = source(keys, occ, det_idx)
        pval = vals[det_idx]
        sign = torch.sign(pval)
        o1_orb, u1_orb = first_virtual(s_occ, occ_bits, o1_idx, u1_slot)
        o2_orb = _at(s_occ, o2_idx)
        spin2 = o2_orb // n_orb
        g = symm[o1_orb % n_orb] ^ symm[o2_orb % n_orb] ^ symm[u1_orb % n_orb]
        u2_sp = _at(lookup[g], u2_slot.clamp(0, lookup.shape[1] - 1))
        u2_valid = u2_sp < n_orb
        u2_orb = torch.where(u2_valid, u2_sp, 0) + spin2 * n_orb
        u2_occupied = hb.dets_read(occ_bits, u2_orb[:, None], n_bits)[:, 0]
        doub_ok = is_doub & u2_valid & ~u2_occupied & (u1_orb != u2_orb)
        o_lo, o_hi = torch.minimum(o1_orb, o2_orb), torch.maximum(o1_orb, o2_orb)
        u_lo, u_hi = torch.minimum(u1_orb, u2_orb), torch.maximum(u1_orb, u2_orb)
        if unnorm:
            tot = hb.unnorm_weight(tens, n_orb, o_lo, o_hi, u_lo, u_hi)
        else:
            tot = hb.norm_weight(tens, n_orb, n_elec, symm, lookup, s_occ,
                                 occ_bits, o_lo, o_hi, u_lo, u_hi)
        dval = val / tot.clamp_min(1e-300)
        dmel = mol.doub_matr_el(ham, o_lo, o_hi, u_lo, u_hi)
        dwords, dsign = dets.double_parity(s_keys, o_lo, o_hi, u_lo, u_hi)
        damp = torch.where(doub_ok & (tot > 0),
                           h_fac * dmel * dsign * sign * dval / p_doub, 0.0)

        # ---- finalize: singles ----
        counts = hb.unocc_symm_counts(n_orb, n_elec, symm, symm_counts, s_occ)
        per_elec, n_occ_allowed = hb.sing_allowed(n_orb, n_elec, symm, counts, s_occ)
        so_orb = _at(s_occ, s_elec)
        so_spin = so_orb // n_orb
        orb_row = lookup[symm[so_orb % n_orb]]
        cand_bit = (orb_row + so_spin[:, None] * n_orb).clamp(0, n_bits - 1)
        cand_unocc = (orb_row < n_orb) & ~hb.dets_read(occ_bits, cand_bit, n_bits)
        su_col, su_found = _rank_to_index(cand_unocc, virt_rank)
        su_sp = _at(orb_row, su_col.clamp(0, orb_row.shape[1] - 1))
        su_orb = torch.where(su_found & (su_sp < n_orb), su_sp + so_spin * n_orb, 0)
        sing_ok = is_sing & su_found & (su_sp < n_orb)
        s_nvirt = _at(per_elec, s_elec)
        smel = mol.sing_matr_el(ham, so_orb, su_orb, s_occ)
        swords, ssign = dets.single_parity(s_keys, so_orb, su_orb)
        samp = torch.where(
            sing_ok,
            h_fac * smel * ssign * sign * val * n_occ_allowed * s_nvirt / (1.0 - p_doub),
            0.0)

        amps = torch.where(is_doub, damp, samp)
        new_words = torch.where(is_doub[:, None], dwords, swords)
        new_words = torch.where((amps != 0)[:, None], new_words, sentinel)
        return new_words, amps, pval.abs() >= cfg.init_thresh

    return spawn


def make_diag_fn(ham: mol.MolecularHamiltonian, e_ref):
    """Diagonal closure for the power core, recomputed from keys each step."""
    def diag_fn(keys):
        occ = dets.occ_list(keys, ham.n_bits, ham.n_elec)
        return mol.diag_matrel_chunked(ham, occ) - e_ref

    return diag_fn


def hf_p_doub(ham: mol.MolecularHamiltonian, syminfo: mol.SymmInfo) -> float:
    """p_doub from the HF determinant's double / single excitation counts."""
    dev = ham.device
    tmpl = mol.ExcitationTemplate.build(ham.n_orb, ham.n_elec)
    hf_words, hf_occ, _ = mol.hf_reference(ham)
    *_, dmask = mol.enumerate_doubles(ham, tmpl, hf_words[None], hf_occ[None])
    n_doub = int(dmask.sum())
    symm = torch.as_tensor(syminfo.symm, device=dev)
    counts = hb.unocc_symm_counts(ham.n_orb, ham.n_elec, symm,
                                  torch.as_tensor(syminfo.counts, device=dev),
                                  hf_occ[None])
    per_elec, _ = hb.sing_allowed(ham.n_orb, ham.n_elec, symm, counts, hf_occ[None])
    n_sing = int(per_elec.sum())
    return n_doub / (n_doub + n_sing)


def compute_htrial(ham: mol.MolecularHamiltonian, trial_keys, trial_vals,
                   e_ref=None):
    """(keys, vals) numpy of (H - e_ref)|trial> by exact application plus the
    diagonal; ``e_ref`` defaults to the HF diagonal energy."""
    dev = ham.device
    trial_keys = np.asarray(trial_keys, np.int64)
    trial_vals = np.asarray(trial_vals, np.float64)
    live = trial_vals != 0
    tk = torch.as_tensor(trial_keys[live], device=dev)
    tv = torch.as_tensor(trial_vals[live], device=dev)
    occ = dets.occ_list(tk, ham.n_bits, ham.n_elec)
    tmpl = mol.ExcitationTemplate.build(ham.n_orb, ham.n_elec)
    if e_ref is None:
        e_ref = float(mol.hf_reference(ham)[2])
    chunk = max(1, min(len(tv), (1 << 22) // max(tmpl.n_doub, 1) + 1))
    w_parts, a_parts = [], []
    for s in range(0, len(tv), chunk):
        w, amp, _ = mol.exact_offdiag_batch(ham, tmpl, tk[s:s + chunk],
                                            occ[s:s + chunk], tv[s:s + chunk], 1.0)
        w = w.reshape(-1, ham.n_words)
        amp = amp.reshape(-1)
        keep = amp != 0
        w_parts.append(w[keep].cpu().numpy())
        a_parts.append(amp[keep].cpu().numpy())
    diag = (mol.diag_matrel(ham, occ) - float(e_ref)).cpu().numpy()
    keys_all = np.concatenate([tk.cpu().numpy()] + w_parts)
    vals_all = np.concatenate([tv.cpu().numpy() * diag] + a_parts)
    packed = dets.pack_key(torch.as_tensor(keys_all)).numpy()
    uniq, first, inv = np.unique(packed, return_index=True, return_inverse=True)
    summed = np.bincount(inv.reshape(-1), weights=vals_all, minlength=len(uniq))
    return keys_all[first], summed


def build(ham: mol.MolecularHamiltonian, cfg: FrisysConfig, seed: int,
          init_val: float = 100.0, determ_keys=None, e_ref=None):
    """Assemble the frisys workload on ``ham``'s device: HB-PP spawner + power
    core + the HF trial vector and its H-trial vector, starting from HF *
    ``init_val``.  ``e_ref`` overrides the HF diagonal energy as the
    diagonal's shift.  Returns (step, run_steps, state, aux); ``aux`` holds
    the trial / H-trial estimator vectors, ``e_ref``, ``p_doub`` and the
    spawner (``aux["spawn"]``)."""
    if determ_keys is not None:
        raise NotImplementedError("the semistochastic deterministic subspace is not ported")
    dev = ham.device
    syminfo = mol.SymmInfo.build(ham.symm.cpu().numpy())
    tens = hb.setup(ham)
    p_doub = hf_p_doub(ham, syminfo)
    hf_words, _, hf_en = mol.hf_reference(ham)
    hf_en = float(hf_en) if e_ref is None else float(e_ref)

    spawn = make_hbpp_spawner(ham, tens, syminfo, p_doub, cfg, hf_en)
    diag_fn = make_diag_fn(ham, hf_en)
    step, run_steps = power.make_stepper(spawn, diag_fn, cfg.power())
    htrial_keys, htrial_vals = compute_htrial(ham, hf_words.cpu().numpy()[None],
                                              np.ones(1), e_ref=hf_en)
    aux = {
        "e_ref": hf_en,
        "num_keys": torch.as_tensor(htrial_keys, device=dev),
        "num_vals": torch.as_tensor(htrial_vals, device=dev),
        "den_keys": hf_words[None],
        "den_vals": torch.ones(1, dtype=F64, device=dev),
        "ref_key": hf_words,
        "p_doub": p_doub,
        "spawn": spawn,
    }
    a = ar.from_unsorted(ar.make(cfg.capacity, ham.n_words, 2, device=dev), hf_words[None],
                         torch.tensor([[init_val], [0.0]], dtype=F64, device=dev))
    return step, run_steps, power.fresh_state(a, seed), aux
