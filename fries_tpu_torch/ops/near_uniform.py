"""Near-uniform and heat-bath excitation sampling, one excitation per
attempt.

Counterpart of ``fries_tpu/ops/near_uniform.py``.  The reference's
per-walker rejection and search loops become masked rank inversions over
static orbital grids: every attempt draws from the uniform distribution over
its allowed choices with one uniform variate, no rejection.  Each sampler
takes a key node (:mod:`fries_tpu_torch.rng`) where the reference takes a
key and splits it the same way (3 ways in :func:`sample_doubles`, 2 in
:func:`sample_singles`, 4 in :func:`sample_doubles_heat_bath`), so that fed
the reference's key tree it draws the reference's variates.

All functions take a batch of attempts, each tied to a parent determinant:
its occupied list ``occ`` (B, E), its occupancy bits ``occ_bits`` (B, 2n)
and, for the uniform samplers, its unoccupied counts per (irrep, spin)
``counts`` (B, 8, 2) from :func:`fries_tpu_torch.ops.heat_bath.unocc_symm_counts`.
"""

from __future__ import annotations

import torch

from fries_tpu_torch import compress, dets, profiling
from fries_tpu_torch.ops import heat_bath as hb

F64 = torch.float64


def _uniform_index(key, count):
    """A uniform integer in [0, count) per row (count >= 1 where used)."""
    u = key.uniform(count.shape).to(count.device)
    return torch.minimum((u * count).to(torch.int32), (count - 1).clamp_min(0))


def _masked_rank_select(mask, rank):
    """Column of the rank-th True per row (0 where there is none), and
    whether there is one."""
    k = mask.shape[-1]
    cum = dets.running_count(mask) - 1
    hit = mask & (cum == rank[..., None])
    idx = torch.where(hit, torch.arange(k, device=mask.device), 0).sum(-1)
    return idx, hit.any(-1)


def _at(rows, idx):
    """rows[b, idx[b]]."""
    return rows.gather(-1, idx.long()[:, None])[:, 0]


def tri_to_pair(n_elec: int, tri_idx):
    """Triangle inversion: pair index (f64) -> (electron slot hi, lo)."""
    i1 = ((torch.sqrt(tri_idx * 8.0 + 1.0) - 1.0) / 2.0).to(torch.int32)
    i2 = (tri_idx - i1 * (i1 + 1) // 2).to(torch.int32)
    i1 = i1 + 1
    return i1.clamp(0, n_elec - 1), i2.clamp(0, n_elec - 1)


def _counts_at(counts, irrep, spin):
    """counts[b, irrep[b, ...], spin[b, ...]]."""
    b = counts.shape[0]
    flat = counts.reshape(b, -1)
    idx = (irrep * 2 + spin).reshape(b, -1)
    return flat.gather(-1, idx).reshape(irrep.shape)


@profiling.spanned("fries.sampler.nu_doubles")
def sample_doubles(key, n_orb, n_elec, symm, lookup, occ, occ_bits, counts):
    """One uniform symmetry-allowed double excitation per attempt.

    Returns dict(o1, o2, u1, u2, prob, valid): the orbital quadruple with
    o1 < o2 and u1 < u2, and the generation probability (1 where not
    valid)."""
    b = occ.shape[0]
    dev = occ.device
    k1, k2, k3 = key.split(3)

    n_pairs = n_elec * (n_elec - 1) // 2
    tri = _uniform_index(k1, torch.full((b,), n_pairs, dtype=torch.int32, device=dev))
    e_hi, e_lo = tri_to_pair(n_elec, tri.to(F64))
    orb1, orb2 = _at(occ, e_hi), _at(occ, e_lo)
    spin1, spin2 = orb1 // n_orb, orb2 // n_orb
    same_spin = spin1 == spin2
    sym_prod = symm[orb1 % n_orb] ^ symm[orb2 % n_orb]

    # ---- first virtual: uniform over allowed a with a nonempty b row
    all_orbs = torch.arange(2 * n_orb, device=dev)
    a_spa, a_spin = all_orbs % n_orb, all_orbs // n_orb
    spin_ok = torch.where(same_spin[:, None], a_spin[None, :] == spin1[:, None], True)
    b_spin = torch.where(same_spin[:, None], a_spin[None, :],
                         spin1[:, None] ^ spin2[:, None] ^ a_spin[None, :])
    b_symm = sym_prod[:, None] ^ symm[a_spa][None, :]
    n_virt2 = _counts_at(counts, b_symm, b_spin) - (
        (sym_prod[:, None] == 0) & (a_spin[None, :] == b_spin)).to(counts.dtype)
    a_mask = ~occ_bits & spin_ok & (n_virt2 > 0)
    m_a_allow = a_mask.sum(-1)
    a_rank = _uniform_index(k2, m_a_allow.clamp_min(1))
    u1, found1 = _masked_rank_select(a_mask, a_rank)
    valid = (m_a_allow > 0) & found1
    u1 = torch.where(valid, u1, 0)
    u1_spin = u1 // n_orb
    u2_spin = torch.where(same_spin, u1_spin, spin1 ^ spin2 ^ u1_spin)
    u1_symm = symm[u1 % n_orb]
    u2_symm = sym_prod ^ u1_symm

    # ---- second virtual: uniform over unoccupied same-irrep orbitals != u1
    orb_row = lookup[u2_symm]
    row_valid = orb_row < n_orb
    cand = torch.where(row_valid, orb_row, 0) + u2_spin[:, None] * n_orb
    cand_unocc = (row_valid & ~hb.dets_read(occ_bits, cand, 2 * n_orb)
                  & (cand != u1[:, None]))
    pair_fix = ((sym_prod == 0) & (u1_spin == u2_spin)).to(counts.dtype)
    m_ab = _counts_at(counts, u2_symm[:, None], u2_spin[:, None])[:, 0] - pair_fix
    b_rank = _uniform_index(k3, m_ab.clamp_min(1))
    u2, found2 = _masked_rank_select(cand_unocc, b_rank)
    u2 = _at(cand, u2.clamp(0, cand.shape[1] - 1))
    valid = valid & (m_ab > 0) & found2

    m_ba = _counts_at(counts, u1_symm[:, None], u1_spin[:, None])[:, 0] - pair_fix
    prob = (2.0 / n_elec / (n_elec - 1) / m_a_allow.clamp_min(1).to(F64)
            * (1.0 / m_ab.clamp_min(1).to(F64) + 1.0 / m_ba.clamp_min(1).to(F64)))
    return {"o1": torch.minimum(orb1, orb2), "o2": torch.maximum(orb1, orb2),
            "u1": torch.minimum(u1, u2), "u2": torch.maximum(u1, u2),
            "prob": torch.where(valid, prob, 1.0), "valid": valid}


@profiling.spanned("fries.sampler.singles")
def sample_singles(key, n_orb, n_elec, symm, lookup, occ, occ_bits, counts):
    """One uniform symmetry-allowed single excitation per attempt: dict(o,
    u, prob, valid)."""
    per_elec, _ = hb.sing_allowed(n_orb, n_elec, symm, counts, occ)
    allowed = per_elec > 0
    n_allowed = allowed.sum(-1)
    k1, k2 = key.split(2)
    e_rank = _uniform_index(k1, n_allowed.clamp_min(1))
    e_idx, found_e = _masked_rank_select(allowed, e_rank)
    valid = (n_allowed > 0) & found_e
    e_idx = torch.where(valid, e_idx, 0)
    o = _at(occ, e_idx)
    o_spin = o // n_orb
    orb_row = lookup[symm[o % n_orb]]
    row_valid = orb_row < n_orb
    cand = torch.where(row_valid, orb_row, 0) + o_spin[:, None] * n_orb
    cand_unocc = row_valid & ~hb.dets_read(occ_bits, cand, 2 * n_orb)
    m_allow = _at(per_elec, e_idx)
    u_rank = _uniform_index(k2, m_allow.clamp_min(1))
    u_col, found_u = _masked_rank_select(cand_unocc, u_rank)
    u = _at(cand, u_col.clamp(0, cand.shape[1] - 1))
    valid = valid & (m_allow > 0) & found_u
    prob = 1.0 / m_allow.clamp_min(1).to(F64) / n_allowed.clamp_min(1).to(F64)
    return {"o": o, "u": u, "prob": torch.where(valid, prob, 1.0), "valid": valid}


@profiling.spanned("fries.sampler.hb_doubles")
def sample_doubles_heat_bath(key, tens, n_orb, n_elec, symm, lookup, occ, occ_bits):
    """One heat-bath Power-Pitzer double excitation per attempt, with the
    total normalized selection weight
    (:func:`fries_tpu_torch.ops.heat_bath.norm_weight`) as its probability:
    dict(o1, o2, u1, u2, prob, valid).  ``valid`` is False where the two
    electrons are one (o1 = o2), which the reference does not check."""
    k1, k2, k3, k4 = key.split(4)
    probs1, _ = hb.o1_probs(tens, n_orb, occ)
    o1_idx = compress.sample_categorical_rows(k1, probs1)
    probs2, _ = hb.o2_probs(tens, n_orb, n_elec, occ, o1_idx)
    o2_idx = compress.sample_categorical_rows(k2, probs2)
    o1, o2 = _at(occ, o1_idx), _at(occ, o2_idx)

    probs_u1, _, virts = hb.u1_probs(tens, n_orb, n_elec, occ_bits, o1)
    u1_slot = compress.sample_categorical_rows(k3, probs_u1)
    u1_sp = _at(virts, u1_slot.clamp(0, virts.shape[1] - 1))
    u1 = torch.where(u1_sp < n_orb, u1_sp, 0) + (o1 // n_orb) * n_orb

    probs_u2, u2_norm, orb_row = hb.u2_probs(tens, n_orb, symm, lookup, o1, o2, u1)
    u2_col = compress.sample_categorical_rows(k4, probs_u2)
    u2_sp = _at(orb_row, u2_col.clamp(0, orb_row.shape[1] - 1))
    u2 = torch.where(u2_sp < n_orb, u2_sp, 0) + (o2 // n_orb) * n_orb

    valid = ((probs1.sum(-1) > 0) & (probs2.sum(-1) > 0) & (probs_u1.sum(-1) > 0)
             & (u2_norm > 0) & (u1_sp < n_orb) & (u2_sp < n_orb)
             & ~hb.dets_read(occ_bits, u2[:, None], 2 * n_orb)[:, 0] & (u1 != u2)
             & (o1 != o2))
    o_lo, o_hi = torch.minimum(o1, o2), torch.maximum(o1, o2)
    u_lo, u_hi = torch.minimum(u1, u2), torch.maximum(u1, u2)
    prob = hb.norm_weight(tens, n_orb, n_elec, symm, lookup, occ, occ_bits,
                          o_lo, o_hi, u_lo, u_hi)
    return {"o1": o_lo, "o2": o_hi, "u1": u_lo, "u2": u_hi,
            "prob": torch.where(valid, prob, 1.0), "valid": valid}
