"""Heat-bath Power-Pitzer (HB-PP) factorized Hamiltonian compression tables
and batched probability rows.

Counterpart of ``fries_tpu/ops/heat_bath.py``.  Tables are indexed by
unfrozen spatial orbitals and stored dense-square:

  d_diff[i, j]  = sum_{a != i, b != j} |<i j | a b>|        (opposite spin)
  d_same[i, j]  = sum_{b < a; a,b not in {i,j}} 2 |<i j|a b> - <i j|b a>|
  s_tens[i]     = sum_j d_same[i, j] + sum_j d_diff[i, j]
  exch_sqrt[i, j] = sqrt(|<i j | j i>|), diagonal sqrt(|<i i | i i>|)
  exch_norms[i] = sum_j exch_sqrt[i, j]
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fries_tpu_torch import dets
from fries_tpu_torch.ops import molecule as mol


@dataclass(frozen=True)
class HeatBathTensors:
    d_same: torch.Tensor
    d_diff: torch.Tensor
    s_tens: torch.Tensor
    s_norm: torch.Tensor
    exch_sqrt: torch.Tensor
    exch_norms: torch.Tensor


def setup(ham: mol.MolecularHamiltonian) -> HeatBathTensors:
    """Precompute the HB-PP tables from the active-space ERIs (O(n_orb^4)
    host numpy, the same arithmetic as the reference), then move them onto
    the Hamiltonian's device."""
    hf = ham.n_frozen // 2
    eri = ham.eris.cpu().numpy()[hf:, hf:, hf:, hf:]
    n = eri.shape[0]
    absv = np.abs(eri)
    i_idx = np.arange(n)
    ii = i_idx[:, None, None, None]
    jj = i_idx[None, :, None, None]
    aa = i_idx[None, None, :, None]
    bb = i_idx[None, None, None, :]
    valid_diff = (aa != ii) & (bb != jj)
    d_diff = np.einsum("ijab,ijab->ij", absv, valid_diff.astype(float))
    anti = np.abs(eri - eri.transpose(0, 1, 3, 2))
    valid_same = (aa != ii) & (aa != jj) & (bb != ii) & (bb != jj) & (aa > bb)
    d_same = 2 * np.einsum("ijab,ijab->ij", anti, valid_same.astype(float))
    np.fill_diagonal(d_same, 0.0)
    s_tens = d_same.sum(1) + d_diff.sum(1)
    exch = np.sqrt(np.abs(np.einsum("ijji->ij", eri)))
    exch_sqrt = exch.copy()
    np.fill_diagonal(exch_sqrt, np.sqrt(np.abs(np.einsum("iiii->i", eri))))
    tabs = dict(d_same=d_same, d_diff=d_diff, s_tens=s_tens,
                s_norm=np.asarray(s_tens.sum()), exch_sqrt=exch_sqrt,
                exch_norms=exch_sqrt.sum(1))
    return HeatBathTensors(**{
        k: torch.as_tensor(v, dtype=torch.float64, device=ham.device)
        for k, v in tabs.items()})


# ---------------------------------------------------------------------------
# batched probability rows
# ---------------------------------------------------------------------------

def _normalize(w):
    norm = w.sum(-1, keepdim=True)
    return w / norm.clamp_min(1e-300), norm[..., 0]


def o1_probs(tens: HeatBathTensors, n_orb: int, occ):
    """(B, E) normalized first-occupied weights s_tens[occ], and the norm."""
    return _normalize(tens.s_tens[occ % n_orb])


def o2_probs(tens: HeatBathTensors, n_orb: int, n_elec: int, occ, o1_idx):
    """(B, E) normalized second-occupied weights given o1's slot."""
    half = n_elec // 2
    o1_orb = occ.gather(-1, o1_idx[..., None])[..., 0]
    cols = torch.arange(n_elec, device=occ.device)
    same = (cols >= half)[None, :] == (o1_orb // n_orb)[..., None]
    occ_sp = occ % n_orb
    o1_sp = (o1_orb % n_orb)[..., None]
    w = torch.where(same, tens.d_same[o1_sp, occ_sp], tens.d_diff[o1_sp, occ_sp])
    w = torch.where(cols[None, :] == o1_idx[..., None], 0.0, w)
    return _normalize(w)


def o2_probs_half(tens, n_orb, n_elec, occ, o1_idx):
    """Ordered variant (slots below o1 only); returns (probs, norm / s_tens[o1])."""
    probs, norm = o2_probs(tens, n_orb, n_elec, occ, o1_idx)
    below = torch.arange(n_elec, device=occ.device)[None, :] < o1_idx[..., None]
    w = probs * below.to(probs.dtype) * norm[..., None]
    new_norm = w.sum(-1, keepdim=True)
    o1_orb = occ.gather(-1, o1_idx[..., None])[..., 0]
    frac = new_norm[..., 0] / tens.s_tens[o1_orb % n_orb].clamp_min(1e-300)
    return w / new_norm.clamp_min(1e-300), frac


def virtual_slots(n_orb: int, n_elec: int, occ_bits_spin):
    """(B, n_orb) spin occupancy -> (B, n_orb - n_elec/2) ascending
    unoccupied spatial orbitals (n_orb where fewer exist)."""
    return dets.occ_list_from_bits(~occ_bits_spin, n_orb - n_elec // 2)


def u1_probs(tens: HeatBathTensors, n_orb, n_elec, occ_bits, o1_orb,
             exclude_first=None):
    """(B, n_virt) first-virtual weights exch_sqrt[o1, v] over o1's spin's
    unoccupied orbitals.  Returns (probs, norm / exch_norms[o1], virts)."""
    spin0 = (o1_orb // n_orb == 0)[:, None]
    spin_bits = torch.where(spin0, occ_bits[:, :n_orb], occ_bits[:, n_orb:2 * n_orb])
    virts = virtual_slots(n_orb, n_elec, spin_bits)
    o1_sp = (o1_orb % n_orb)[:, None]
    w = torch.where(virts < n_orb,
                    tens.exch_sqrt[o1_sp, virts.clamp(0, n_orb - 1)], 0.0)
    if exclude_first is not None:
        first = torch.arange(w.shape[1], device=w.device) == 0
        w = torch.where(exclude_first[:, None] & first, 0.0, w)
    probs, norm = _normalize(w)
    frac = norm / tens.exch_norms[o1_orb % n_orb].clamp_min(1e-300)
    return probs, frac, virts


def u2_probs(tens: HeatBathTensors, n_orb, symm, lookup, o1_orb, o2_orb,
             u1_orb, occ_bits=None, half=False):
    """(B, K) second-virtual weights over the symmetry row of
    irrep(o1)^irrep(o2)^irrep(u1).  half=True (unnormalized variant) masks
    occupied targets and restricts same-spin pairs to u2 < u1.

    Returns (probs, norm / exch_norms[o2], orb_row (B, K) spatial)."""
    o2_sp = o2_orb % n_orb
    u1_sp = u1_orb % n_orb
    same_spin = (o1_orb // n_orb) == (o2_orb // n_orb)
    g = symm[o1_orb % n_orb] ^ symm[o2_sp] ^ symm[u1_sp]
    orb_row = lookup[g]
    w = torch.where(orb_row < n_orb,
                    tens.exch_sqrt[o2_sp[:, None], orb_row.clamp(0, n_orb - 1)],
                    0.0)
    w = torch.where(same_spin[:, None] & (orb_row == u1_sp[:, None]), 0.0, w)
    if half:
        bit = orb_row + (o2_orb // n_orb)[:, None] * n_orb
        w = torch.where(dets_read(occ_bits, bit, 2 * n_orb), 0.0, w)
        w = torch.where(same_spin[:, None] & (orb_row >= u1_sp[:, None]), 0.0, w)
    probs, norm = _normalize(w)
    frac = norm / tens.exch_norms[o2_sp].clamp_min(1e-300)
    return probs, frac, orb_row


def dets_read(occ_bits, pos, n_bits):
    """Bits at positions ``pos`` (B, K) of unpacked occupancy (B, n_bits)."""
    return occ_bits.gather(-1, pos.clamp(0, n_bits - 1))


# ---------------------------------------------------------------------------
# total selection weights
# ---------------------------------------------------------------------------

def unnorm_weight(tens: HeatBathTensors, n_orb, o1, o2, u1, u2):
    """calc_unnorm_wt, batched; o1 < o2 (and u1 < u2 for same spin)."""
    same = (o1 // n_orb) == (o2 // n_orb)
    o1s, o2s, u1s, u2s = o1 % n_orb, o2 % n_orb, u1 % n_orb, u2 % n_orb
    base = torch.where(same, tens.d_same[o1s, o2s], tens.d_diff[o2s, o1s])
    return (base * tens.exch_sqrt[o1s, u1s] * tens.exch_sqrt[o2s, u2s]
            / tens.s_norm / tens.exch_norms[o1s] / tens.exch_norms[o2s])


def norm_weight(tens: HeatBathTensors, n_orb, n_elec, symm, lookup,
                occ, occ_bits, o1, o2, u1, u2):
    """calc_norm_wt, batched: total probability of selecting
    (o1,o2)->(u1,u2) under the normalized HB-PP factorization, summed over
    both selection orders."""
    o1s, o2s, u1s, u2s = o1 % n_orb, o2 % n_orb, u1 % n_orb, u2 % n_orb
    o1_spin, o2_spin = o1 // n_orb, o2 // n_orb
    same = o1_spin == o2_spin
    n_alpha = occ_bits[:, :n_orb].to(torch.float64)
    n_beta = occ_bits[:, n_orb:2 * n_orb].to(torch.float64)
    n_tot = n_alpha + n_beta
    s_denom = (tens.s_tens * n_tot).sum(-1)

    irrep_onehot = (symm[:, None] == torch.arange(8, device=symm.device)[None, :])
    symm_sums = tens.exch_sqrt @ irrep_onehot.to(torch.float64)   # (n_orb, 8)

    def rows(os_, spin):
        n_same = torch.where((spin == 0)[:, None], n_alpha, n_beta)
        n_diff = torch.where((spin == 0)[:, None], n_beta, n_alpha)
        ds, dd, ex = tens.d_same[os_], tens.d_diff[os_], tens.exch_sqrt[os_]
        d_denom = (ds * n_same + dd * n_diff).sum(-1)
        e_virt = tens.exch_norms[os_] - (ex * n_same).sum(-1)
        return ds, dd, ex, symm_sums[os_], tens.s_tens[os_], d_denom, e_virt

    rows_ds1, rows_dd1, rows_o1, ss_o1, s_tens_o1, d1_denom, e1_virt = rows(o1s, o1_spin)
    _, rows_dd2, rows_o2, ss_o2, s_tens_o2, d2_denom, e2_virt = rows(o2s, o2_spin)

    def at(r, j):
        return r.gather(-1, j[:, None])[:, 0]

    u1_irrep = symm[u1s]
    u2_irrep = symm[u2s]
    exo1u1, exo1u2 = at(rows_o1, u1s), at(rows_o1, u2s)
    exo2u1, exo2u2 = at(rows_o2, u1s), at(rows_o2, u2s)
    excl = same & (u1_irrep == u2_irrep)
    e2_symm_no1 = at(ss_o2, u2_irrep) - torch.where(excl, exo2u1, 0.0)
    e1_symm_no1 = at(ss_o1, u2_irrep) - torch.where(excl, exo1u1, 0.0)
    e2_symm_no2 = at(ss_o2, u1_irrep) - torch.where(excl, exo2u2, 0.0)
    e1_symm_no2 = at(ss_o1, u1_irrep) - torch.where(excl, exo1u2, 0.0)

    def safe_div(a, b):
        return a / torch.where(b == 0, 1.0, b) * (b != 0)

    d_same_12 = at(rows_ds1, o2s)
    d_diff_12 = at(rows_dd1, o2s)
    d_diff_21 = at(rows_dd2, o1s)
    w_same = d_same_12 / s_denom * (
        safe_div(s_tens_o1, d1_denom * e1_virt)
        * (safe_div(exo1u1 * exo2u2, e2_symm_no1) + safe_div(exo1u2 * exo2u1, e2_symm_no2))
        + safe_div(s_tens_o2, d2_denom * e2_virt)
        * (safe_div(exo2u1 * exo1u2, e1_symm_no1) + safe_div(exo2u2 * exo1u1, e1_symm_no2))
    )
    w_diff = (
        safe_div(s_tens_o1 * d_diff_12, d1_denom * e1_virt * e2_symm_no1)
        + safe_div(s_tens_o2 * d_diff_21, d2_denom * e2_virt * e1_symm_no2)
    ) * exo1u1 * exo2u2 / s_denom
    return torch.where(same, w_same, w_diff)


# ---------------------------------------------------------------------------
# symmetry-allowed singles counting
# ---------------------------------------------------------------------------

def _irrep_spin_key(n_orb, n_elec, symm, occ):
    spin = (torch.arange(n_elec, device=occ.device) >= n_elec // 2).to(torch.int64)
    return symm[occ % n_orb] * 2 + spin[None, :]


def unocc_symm_counts(n_orb, n_elec, symm, symm_counts, occ):
    """(B, 8, 2) unoccupied orbitals per (irrep, spin)."""
    key = _irrep_spin_key(n_orb, n_elec, symm, occ)
    occ_counts = torch.zeros(occ.shape[0], 16, dtype=torch.int64, device=occ.device)
    occ_counts.scatter_add_(-1, key, torch.ones_like(key))
    return symm_counts[None, :, None] - occ_counts.view(-1, 8, 2)


def sing_allowed(n_orb, n_elec, symm, counts, occ):
    """Per-electron count of symmetry-allowed single targets (B, E), and the
    number of electrons with any (B,)."""
    key = _irrep_spin_key(n_orb, n_elec, symm, occ)
    per_elec = counts.reshape(counts.shape[0], 16).gather(-1, key)
    return per_elec, (per_elec > 0).sum(-1)
