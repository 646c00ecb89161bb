"""frisys_mol: FCI-FRI with the heat-bath Power-Pitzer (HB-PP) factorized
Hamiltonian compression.

Counterpart of ``fries_tpu/drivers/frisys.py``.  Each
iteration's off-diagonal spawn runs three compression rounds over statically
shaped sample buffers, then finalizes the sampled excitations:

  A+B. one ``comp_sub`` over a joint (C, 2E) row per arena determinant:
       double-branch mass p_doub * P(o1) and single-branch mass
       (1 - p_doub) / n_allowed per allowed-electron rank;
  C+D. one ``comp_sub_factored`` over the rank-1 (o2, u1) joint
       P(o2 | o1) P(u1 | o1); singles ride it as uniform ndiv = n_virt rows;
  E.   one ``comp_sub`` over the symmetry-allowed u2 row;
  finalize: Slater-Condon elements, fermionic parities and the HB-PP
       selection weights (calc_norm_wt / calc_unnorm_wt).

With ``fuse_ab=False`` A+B is two rounds, level A (double or single, K = 2)
and level B (o1 of a double, K = n_elec; the allowed-electron rank of a
single as a uniform row); with ``fuse_cd=False`` C+D is level C (o2, K =
n_elec; the virtual of a single as a uniform row) and level D (u1, K =
n_virt).  The chain masses are those of the fused rounds.  Both off: five
rounds.  Each round is systematic (``comp_sub``; C+D through
``comp_sub_factored``) and consumes the scalar uniform ``rns[level]`` of the
step's six, levels A to E numbered 0 to 4 (fused A+B takes ``rns[1]``, fused
C+D ``rns[2]``), or with ``pivotal=True`` pivotal (``comp_sub_piv``, C+D
over the materialized joint) and consumes the key nodes
``key.fold(77).split(5)[level]`` (:mod:`fries_tpu_torch.rng`).  The
reference's memory gate on the pivotal fused C+D
(``FRIES_FUSE_CD_MAX_BYTES``, a workaround for the TPU's memory) is not
ported: C+D stays fused unless the config says otherwise.

Options: the semistochastic deterministic subspace (``determ_keys``: its
members are exempt from sampling and their dense H block is applied
exactly), time reversal (``spin_parity`` +1 / -1: sampled excitations and
the diagonal fold onto the spin-flip symmetrized basis), a trial vector and
an initial vector other than HF.  Hash sharding: :func:`build_sharded` (or
``build(..., shards=)``) steps this rank's block of the arena; every
compression round runs over the ranks' joint stage with a global budget.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fries_tpu_torch import compress, dets, parallel, profiling
from fries_tpu_torch.drivers import power
from fries_tpu_torch.ops import heat_bath as hb
from fries_tpu_torch.ops import molecule as mol
from fries_tpu_torch.ops import time_reversal as tr_mod
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
    shift_tracking: float = 0.0   # see power.PowerConfig.shift_tracking
    unnorm: bool = False
    pivotal: bool = False
    spin_parity: int = 0    # time-reversal sector (+1 / -1; 0 = off)
    stage_f32: bool = True
    fuse_ab: bool = True
    fuse_cd: bool = True
    axis_name: str | None = None   # the reference's mesh axis; the port takes
                                   # a Shards handle (build_sharded)
    n_shards: int = 1
    exchange_cap: int = 0   # see power.PowerConfig.exchange_cap
    spawn_rows: int = 0     # see power.PowerConfig.spawn_rows

    def power(self) -> power.PowerConfig:
        return power.PowerConfig(
            eps=self.eps, target_nonz=self.vec_nonz, capacity=self.capacity,
            init_thresh=self.init_thresh, target_norm=self.target_norm,
            shift_interval=self.shift_interval,
            shift_damping=self.shift_damping,
            shift_tracking=self.shift_tracking, spawn_rows=self.spawn_rows,
            n_shards=self.n_shards, exchange_cap=self.exchange_cap)


def _rank_to_index(mask, rank):
    """Column of the rank-th True entry per row (K if out of range)."""
    k = mask.shape[-1]
    cum = dets.running_count(mask) - 1
    hit = mask & (cum == rank[..., None])
    idx = torch.where(hit, torch.arange(k, device=mask.device), 0).sum(-1)
    found = hit.any(-1)
    return torch.where(found, idx, k), found


def _at(rows, idx):
    """rows[b, idx[b]]."""
    return rows.gather(-1, idx[:, None])[:, 0]


def make_hbpp_spawner(ham: mol.MolecularHamiltonian, tens: hb.HeatBathTensors,
                      syminfo: mol.SymmInfo, p_doub: float, cfg: FrisysConfig,
                      e_ref, determ=None, shards=None):
    """Stochastically compressed H application conforming to the power core's
    spawn interface ``spawn(keys, vals, h_fac, rand, thresh=None) -> (words,
    amps, ini)``.  ``rand`` is the six uniforms ``rns`` of a systematic
    spawner or the key node of a pivotal one; ``thresh`` overrides
    ``cfg.init_thresh`` as the initiator cutoff.  ``e_ref`` is unused, as in
    the reference (the diagonal carries it).

    ``determ`` (:func:`build_determ_block`): the semistochastic deterministic
    subspace.  Its members are left out of the sampling, whose budget shrinks
    by the block's element count, and the dense block spawns exactly: its
    rows follow the ``spawn_cap`` sampled ones, all as initiators.

    ``shards``: every round compresses over the ranks' joint stage with the
    global budget ``matr_samp`` (each rank spawns from its own arena)."""
    dev = ham.device
    n_orb, n_elec = ham.n_orb, ham.n_elec
    n_bits = 2 * n_orb
    n_virt = n_orb - n_elec // 2
    lookup = torch.as_tensor(syminfo.lookup, device=dev)
    symm = torch.as_tensor(syminfo.symm, device=dev)
    symm_counts = torch.as_tensor(syminfo.counts, device=dev)
    s_cap, m_samp, unnorm = cfg.spawn_cap, cfg.matr_samp, cfg.unnorm
    if determ is not None:
        m_samp -= determ["n_elements"]
        if m_samp <= 0:
            raise ValueError("matr_samp must exceed the dense block's "
                             f"{determ['n_elements']} elements")
    stage = torch.float32 if cfg.stage_f32 else F64
    # chunk the factored stage's row passes at ~256 MB of (chunk, K) rows
    kj_bytes = n_elec * n_virt * (4 if cfg.stage_f32 else 8)
    cd_row_chunk = (0 if s_cap * kj_bytes <= 64_000_000
                    else max(1, (256_000_000 // kj_bytes) // 8192 * 8192))
    sentinel = dets.invalid_det(ham.n_words, dev)
    cols_e = torch.arange(n_elec, device=dev)
    # the spans of the rounds, by level: A+B and C+D where fused
    stage_span = ("fries.stage.a", "fries.stage.ab" if cfg.fuse_ab else "fries.stage.b",
                  "fries.stage.cd" if cfg.fuse_cd else "fries.stage.c", "fries.stage.d",
                  "fries.stage.e")

    def stage_comp_sub(level, vals_in, ndiv_in, w_in, rand, max_ndiv):
        with profiling.span(stage_span[level]):
            if cfg.pivotal:
                return compress.comp_sub_piv(vals_in, ndiv_in, w_in.to(stage), w_in != 0,
                                             m_samp, rand[level], s_cap, max_ndiv=max_ndiv,
                                             shards=shards)
            return compress.comp_sub(vals_in, ndiv_in, w_in.to(stage), w_in != 0,
                                     m_samp, rand[level], s_cap, shards=shards)

    def source(keys, occ, det_idx):
        s_keys = keys[det_idx]
        return occ[det_idx], s_keys, dets.unpack_bits(s_keys, n_bits)

    @profiling.spanned("fries.spawn")
    def spawn(keys, vals, h_fac, rand, thresh=None):
        c = keys.shape[0]
        rand = rand.fold(77).split(5) if cfg.pivotal else rand
        occ = dets.occ_list(keys, n_bits, n_elec)
        vals_full = vals
        if determ is not None:
            dpos, dfound = dets.lookup_dets(keys, determ["keys"])
            is_determ = torch.zeros(c + 1, dtype=torch.bool, device=dev)
            is_determ.index_fill_(0, torch.where(dfound, dpos, c), True)
            vals = torch.where(is_determ[:c], 0.0, vals)
        absv = vals.abs()

        if cfg.fuse_ab:
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
                1, absv, torch.zeros(c, dtype=torch.int64, device=dev),
                torch.cat([w_doub, w_sing], dim=1), rand, 0)
            live = parent >= 0
            det_idx = torch.where(live, parent, 0)
            is_doub = live & (sub < n_elec)
            o1_idx = torch.where(is_doub, sub, 0)
            sing_rank = torch.where(~is_doub & live, sub - n_elec, 0)
        else:
            # ---- level A: double or single ----
            w_a = torch.tensor([p_doub, 1.0 - p_doub], dtype=F64, device=dev).expand(c, 2)
            val, parent, sub, _, overflow = stage_comp_sub(
                0, absv, torch.zeros(c, dtype=torch.int64, device=dev), w_a, rand, 0)
            live = parent >= 0
            det_idx = torch.where(live, parent, 0)
            is_doub = (sub == 0) & live

            # ---- level B: o1 (doubles) / allowed-electron rank (singles) ----
            s_occ, _, _ = source(keys, occ, det_idx)
            counts = hb.unocc_symm_counts(n_orb, n_elec, symm, symm_counts, s_occ)
            _, n_occ_allowed = hb.sing_allowed(n_orb, n_elec, symm, counts, s_occ)
            probs_b, o1_norm_frac = hb.o1_probs(tens, n_orb, s_occ)
            if unnorm:
                # o2 must lie below o1: drop the first electron, and fold the
                # normalization fraction into the value
                w = torch.where(cols_e[None, :] == 0, 0.0, probs_b * o1_norm_frac[:, None])
                new_norm = w.sum(-1)
                probs_b = w / new_norm.clamp_min(1e-300)[:, None]
                val = torch.where(is_doub, val * (new_norm / tens.s_norm), val)
            ndiv_b = torch.where(is_doub, 0, n_occ_allowed.clamp_min(1))
            val_b = torch.where(live & (is_doub | (n_occ_allowed > 0)), val, 0.0)
            val, parent, sub, _, ovf = stage_comp_sub(
                1, val_b, ndiv_b, torch.where(is_doub[:, None], probs_b, 0.0), rand, n_elec)
            overflow = overflow | ovf
            live = parent >= 0
            pidx = torch.where(live, parent, 0)
            det_idx = det_idx[pidx]
            is_doub = is_doub[pidx] & live
            o1_idx = torch.where(is_doub, sub, 0)
            sing_rank = torch.where(~is_doub & live, sub, 0)

        # ---- level C (+ D when fused): o2 (and u1) of doubles, virtual of singles ----
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
        ndiv_c = torch.where(is_doub, 0, s_nvirt.clamp_min(1))
        val_c = torch.where(is_doub | sing_ok, val, 0.0)
        if cfg.fuse_cd:
            # joint (o2, u1) over n_elec * n_virt columns
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
            val_c = torch.where(is_doub & (rowsum <= 0), 0.0, val_c)
            fac_b = fac_b.to(stage)
            if cfg.pivotal:
                joint = fac_a[:, :, None] * fac_b[:, None, :]
                if kill_b0 is not None:
                    joint[:, :, 0] = torch.where(kill_b0, 0.0, joint[:, :, 0])
                val, parent, sub, _, ovf = stage_comp_sub(
                    2, val_c, ndiv_c, joint.reshape(-1, n_elec * n_virt), rand,
                    max(n_virt, n_elec * n_virt))
            else:
                with profiling.span("fries.stage.cd"):
                    val, parent, sub, _, ovf = compress.comp_sub_factored(
                        val_c, ndiv_c, fac_a, fac_b, m_samp, rand[2], s_cap,
                        kill_b0=kill_b0, row_chunk=cd_row_chunk, shards=shards)
            overflow = overflow | ovf
            live = parent >= 0
            pidx = torch.where(live, parent, 0)
            det_idx, o1_idx, s_elec = det_idx[pidx], o1_idx[pidx], s_elec[pidx]
            is_doub = is_doub[pidx] & live
            o2_idx = torch.where(is_doub, sub // n_virt, 0)
            u1_slot = torch.where(is_doub, sub % n_virt, 0)
            virt_rank = torch.where(~is_doub & live, sub, 0)
        else:
            val_c = torch.where(is_doub & (probs_c.sum(-1) <= 0), 0.0, val_c)
            w_c = torch.where(is_doub[:, None] & (probs_c > 0), probs_c, 0.0)
            val, parent, sub, _, ovf = stage_comp_sub(2, val_c, ndiv_c, w_c, rand, n_virt)
            overflow = overflow | ovf
            live = parent >= 0
            pidx = torch.where(live, parent, 0)
            det_idx, o1_idx, s_elec = det_idx[pidx], o1_idx[pidx], s_elec[pidx]
            is_doub = is_doub[pidx] & live
            o2_idx = torch.where(is_doub, sub, 0)
            virt_rank = torch.where(~is_doub & live, sub, 0)

            # ---- level D: u1 (doubles) ----
            s_occ, _, occ_bits = source(keys, occ, det_idx)
            o1_orb = _at(s_occ, o1_idx)
            if unnorm:
                same_oo = (o1_orb // n_orb) == (_at(s_occ, o2_idx) // n_orb)
                probs_d, u1_frac, _ = hb.u1_probs(tens, n_orb, n_elec, occ_bits, o1_orb,
                                                  exclude_first=same_oo)
                val = torch.where(is_doub, val * u1_frac, val)
            else:
                probs_d, _, _ = hb.u1_probs(tens, n_orb, n_elec, occ_bits, o1_orb)
            val_d = torch.where(is_doub & (probs_d.sum(-1) <= 0), 0.0, val)
            w_d = torch.where(is_doub[:, None] & (probs_d > 0), probs_d, 0.0)
            val, parent, sub, _, ovf = stage_comp_sub(
                3, val_d, torch.where(is_doub, 0, 1), w_d, rand, 1)
            overflow = overflow | ovf
            live = parent >= 0
            pidx = torch.where(live, parent, 0)
            det_idx, o1_idx, o2_idx = det_idx[pidx], o1_idx[pidx], o2_idx[pidx]
            s_elec, virt_rank = s_elec[pidx], virt_rank[pidx]
            is_doub = is_doub[pidx] & live
            u1_slot = torch.where(is_doub, sub, 0)

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
        val, parent, sub, _, ovf = stage_comp_sub(4, val_e, ndiv_e, w_e, rand, 1)
        overflow = overflow | ovf
        live = parent >= 0
        pidx = torch.where(live, parent, 0)
        det_idx, o1_idx, o2_idx = det_idx[pidx], o1_idx[pidx], o2_idx[pidx]
        s_elec, virt_rank, u1_slot = s_elec[pidx], virt_rank[pidx], u1_slot[pidx]
        is_doub = is_doub[pidx] & live
        is_sing = ~is_doub & live
        u2_slot = torch.where(is_doub, sub, 0)

        with profiling.span("fries.finalize"):
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

            if cfg.spin_parity:
                # fold the sampled excitations: the direct and the reverse
                # (spin-flipped) elements and selection weights combine
                direct_mel = torch.where(is_doub, dmel * dsign, smel * ssign)
                w_doub = tot.clamp_min(1e-300) * p_doub
                w_sing = (1.0 - p_doub) / (n_occ_allowed * s_nvirt).to(F64).clamp_min(1e-300)
                ok = torch.where(is_doub, doub_ok & (tot > 0), sing_ok)
                new_words, t_mel, t_w, t_keep = tr_mod.adjust_sampled(
                    ham, tens, symm, counts, n_occ_allowed, s_keys, s_occ, occ_bits,
                    torch.where(is_doub[:, None], dwords, swords), direct_mel,
                    torch.where(is_doub, w_doub, w_sing), cfg.spin_parity, p_doub, unnorm)
                amps = torch.where(ok & t_keep & live,
                                   h_fac * sign * val * t_mel / t_w.clamp_min(1e-300), 0.0)
            else:
                amps = torch.where(is_doub, damp, samp)
                new_words = torch.where(is_doub[:, None], dwords, swords)
            new_words = torch.where((amps != 0)[:, None], new_words, sentinel)
            ini = pval.abs() >= (cfg.init_thresh if thresh is None else thresh)
            if determ is not None:
                # exact multiplication by the dense block: amp = h_fac H_elem v[from]
                v_from = torch.where(dfound, vals_full[dpos], 0.0)[determ["from"]]
                d_amp = h_fac * determ["amp"] * v_from
                new_words = torch.cat([new_words, torch.where((d_amp != 0)[:, None],
                                                              determ["words"], sentinel)])
                amps = torch.cat([amps, d_amp])
                ini = torch.cat([ini, torch.ones_like(d_amp, dtype=torch.bool)])
            return new_words, amps, ini

    return spawn


def make_diag_fn(ham: mol.MolecularHamiltonian, e_ref, spin_parity: int = 0):
    """Diagonal closure for the power core, recomputed from keys each step,
    with the folded-basis correction under time reversal."""
    def diag_fn(keys):
        occ = dets.occ_list(keys, ham.n_bits, ham.n_elec)
        d = mol.diag_matrel_chunked(ham, occ) - e_ref
        if spin_parity:
            delta, forbid = tr_mod.tr_diag(ham, keys, occ, spin_parity)
            d = torch.where(forbid, d, d + delta)
        return d

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


def build_determ_block(ham: mol.MolecularHamiltonian, determ_keys):
    """The dense H block of the deterministic subspace: every
    symmetry-allowed excitation from each member determinant with its
    sign-carrying matrix element.  Compacted once here: the template
    enumerates every (occupied pair, target pair) slot and most carry no
    element.  Returns dict(keys (D, W), words (DH, W), amp (DH,), from (DH,)
    member index of each element, n_elements)."""
    dev = ham.device
    determ_keys = torch.as_tensor(np.asarray(determ_keys).astype(np.int64), device=dev)
    d = determ_keys.shape[0]
    occ = dets.occ_list(determ_keys, ham.n_bits, ham.n_elec)
    tmpl = mol.ExcitationTemplate.build(ham.n_orb, ham.n_elec)
    w, amp = mol.exact_offdiag_batch(ham, tmpl, determ_keys, occ,
                                     torch.ones(d, dtype=F64, device=dev), 1.0)
    from_idx = torch.arange(d, device=dev).repeat_interleave(amp.shape[1])
    amp = amp.reshape(-1)
    live = amp != 0
    return {"keys": determ_keys, "words": w.reshape(-1, ham.n_words)[live],
            "amp": amp[live], "from": from_idx[live], "n_elements": int(live.sum())}


def compute_htrial(ham: mol.MolecularHamiltonian, trial_keys, trial_vals,
                   e_ref=None, spin_parity: int = 0):
    """(keys, vals) numpy of (H - e_ref)|trial> by exact application plus the
    diagonal; ``e_ref`` defaults to the HF diagonal energy.  With
    ``spin_parity`` the trial vector lives on the folded basis, and the
    elements and the diagonal are the folded ones (the subspace iteration's
    H * trial; the frisys estimator's stays unfolded, as in the reference)."""
    dev = ham.device
    trial_keys = np.asarray(trial_keys).astype(np.int64)
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
        rows = slice(s, s + chunk)
        w, amp = mol.exact_offdiag_batch(ham, tmpl, tk[rows], occ[rows], tv[rows], 1.0)
        nc = amp.shape[1]
        w = w.reshape(-1, ham.n_words)
        amp = amp.reshape(-1)
        if spin_parity:
            w, amp = tr_mod.adjust_exact(
                ham, tk[rows].repeat_interleave(nc, 0), occ[rows].repeat_interleave(nc, 0),
                w, amp, spin_parity, scale=tv[rows].repeat_interleave(nc))
        keep = amp != 0
        w_parts.append(w[keep].cpu().numpy())
        a_parts.append(amp[keep].cpu().numpy())
    diag = mol.diag_matrel(ham, occ) - float(e_ref)
    if spin_parity:
        delta, forbid = tr_mod.tr_diag(ham, tk, occ, spin_parity)
        diag = torch.where(forbid, 0.0, diag + delta)
    keys_all = np.concatenate([tk.cpu().numpy()] + w_parts)
    vals_all = np.concatenate([tv.cpu().numpy() * diag.cpu().numpy()] + a_parts)
    (order,), _, _ = dets.order_keys(torch.as_tensor(keys_all))
    uniq, first, inv = np.unique(order.numpy(), return_index=True, return_inverse=True)
    summed = np.bincount(inv.reshape(-1), weights=vals_all, minlength=len(uniq))
    return keys_all[first], summed


def build(ham: mol.MolecularHamiltonian, cfg: FrisysConfig, seed: int,
          init_val: float = 100.0, determ_keys=None, trial=None, init_vec=None,
          e_ref=None, shards=None):
    """Assemble the frisys workload on ``ham``'s device: HB-PP spawner + power
    core + the trial vector and its H-trial vector.

    ``determ_keys`` (D, W): the deterministic subspace; ``aux["protected_keys"]``
    carries it for the power step, and the vector starts on its members (HF
    with ``init_val``, the others 0) so that the dense block is live from the
    start.  ``trial``: (keys (N, W), vals (N,)) estimator trial vector
    (default the HF unit vector).  ``init_vec``: (keys, vals) starting vector
    (default HF * ``init_val``).  ``e_ref`` overrides the HF diagonal energy
    as the diagonal's shift.  Returns (step, run_steps, state, aux); ``aux``
    holds the trial / H-trial estimator vectors, ``e_ref``, ``p_doub``,
    ``protected_keys`` (or None), the dense block's ``n_elements`` and the
    spawner (``aux["spawn"]``).  ``shards``: see :func:`build_sharded`."""
    dev = ham.device
    syminfo = mol.SymmInfo.build(ham.symm.cpu().numpy())
    tens = hb.setup(ham)
    p_doub = hf_p_doub(ham, syminfo)
    hf_words, _, hf_en = mol.hf_reference(ham)
    hf_en = float(hf_en) if e_ref is None else float(e_ref)

    determ = None if determ_keys is None else build_determ_block(ham, determ_keys)
    spawn = make_hbpp_spawner(ham, tens, syminfo, p_doub, cfg, hf_en, determ=determ,
                              shards=shards)
    diag_fn = make_diag_fn(ham, hf_en, cfg.spin_parity)
    step, run_steps = power.make_stepper(spawn, diag_fn, cfg.power(), estimator="direct",
                                         shards=shards)

    hf_np = hf_words.cpu().numpy()
    if trial is None:
        trial_keys, trial_vals = hf_np[None], np.ones(1)
    else:
        trial_keys = np.asarray(trial[0]).astype(np.int64)
        trial_vals = np.asarray(trial[1], np.float64)
    htrial_keys, htrial_vals = compute_htrial(ham, trial_keys, trial_vals, e_ref=hf_en)
    aux = {
        "e_ref": hf_en,
        "num_keys": torch.as_tensor(htrial_keys, device=dev),
        "num_vals": torch.as_tensor(htrial_vals, device=dev),
        "den_keys": torch.as_tensor(trial_keys, device=dev),
        "den_vals": torch.as_tensor(trial_vals, device=dev),
        "ref_key": hf_words,
        "p_doub": p_doub,
        "protected_keys": None if determ is None else determ["keys"],
        "n_elements": 0 if determ is None else determ["n_elements"],
        "spawn": spawn,
    }

    if init_vec is not None:
        init_keys = np.asarray(init_vec[0]).astype(np.int64)
        init_vals = np.asarray(init_vec[1], np.float64)
    elif determ is not None:
        dkeys = determ["keys"].cpu().numpy()
        others = dkeys[(dkeys != hf_np[None]).any(1)]
        init_keys = np.concatenate([hf_np[None], others])
        init_vals = np.concatenate([[init_val], np.zeros(len(others))])
    else:
        init_keys, init_vals = hf_np[None], np.array([init_val])
    init_rows = np.stack([init_vals, np.zeros_like(init_vals)])
    if shards is not None:
        a = parallel.distribute_rows(init_keys, init_rows, shards.size, cfg.capacity,
                                     shards.rank, dev)
    else:
        a = ar.from_unsorted(ar.make(cfg.capacity, ham.n_words, 2, device=dev),
                             torch.as_tensor(init_keys), torch.as_tensor(init_rows))
    return step, run_steps, power.fresh_state(a, seed), aux


def build_sharded(ham: mol.MolecularHamiltonian, cfg: FrisysConfig, seed: int, shards,
                  init_val: float = 100.0, trial=None, init_vec=None, e_ref=None,
                  determ_keys=None):
    """Hash-sharded frisys on this rank (``shards``, ``cfg.n_shards`` ranks;
    ``ham`` on the rank's device): ``cfg.capacity`` is per rank, the budgets
    are global.  The initial vector is distributed by hash, the trial and
    H-trial vectors and the deterministic space are replicated (each rank
    protects the members it holds).  Returns (step, run_steps, state, aux)
    as :func:`build` does, for this rank."""
    return build(ham, cfg, seed, init_val=init_val, determ_keys=determ_keys, trial=trial,
                 init_vec=init_vec, e_ref=e_ref, shards=shards)
