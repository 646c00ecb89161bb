"""CISD trial vectors and the orbital-phase gauge.

Counterpart of ``fries_tpu/cisd.py``: enumerate the symmetry-restricted
CISD determinant space, build its dense H block with the port's exact
off-diagonal action (the pieces of
:func:`fries_tpu_torch.ops.molecule.exact_offdiag_batch`) and diagonal on the Hamiltonian's device (elements evaluated only for
targets inside the set; the reference evaluates every candidate and drops
the outside ones), and take the ground state by
Lanczos (:func:`fries_tpu_torch.linalg.lanczos_ground_state`).
Determinants are the port's (N, W) int64 words (32 bits each, the
reference's uint32 values) in the arena's order: lexicographic, the last
word the most significant, for any W (Ne/cc-pVQZ's 54 orbitals take
four words).

``orbital_phases`` recovers the per-spatial-orbital sign vector between
two CI vectors over the same determinants (a GF(2) linear system), and
``apply_phases`` carries CI coefficients across it.
"""

from __future__ import annotations

import numpy as np
import torch

from fries_tpu_torch import dets, linalg
from fries_tpu_torch.ops import molecule as mol


def enumerate_cisd(ham: mol.MolecularHamiltonian, target_irrep: int = 0):
    """(N, W) int64 words on ``ham``'s device: the CISD space of ``ham``
    restricted to total irrep ``target_irrep`` (XOR product relative to the
    closed shell), HF included, sorted in the arena's order."""
    n_orb, n_elec = ham.n_orb, ham.n_elec
    half = n_elec // 2
    symm = ham.symm.cpu().numpy()
    hf_occ = list(range(half)) + list(range(n_orb, n_orb + half))

    def occ_irrep(occ):
        g = 0
        for p in occ:
            g ^= int(symm[p % n_orb])
        return g

    base_irrep = occ_irrep(hf_occ)
    hf_set = set(hf_occ)
    virt = [p for p in range(2 * n_orb) if p not in hf_set]
    occs = [sorted(hf_occ)]
    for o in hf_occ:                                 # singles
        for u in virt:
            if (o < n_orb) == (u < n_orb):
                occ = sorted(hf_set - {o} | {u})
                if occ_irrep(occ) ^ base_irrep == target_irrep:
                    occs.append(occ)
    for i in range(n_elec):                          # doubles
        for j in range(i + 1, n_elec):
            o1, o2 = hf_occ[i], hf_occ[j]
            for ui, u1 in enumerate(virt):
                for u2 in virt[ui + 1:]:
                    if (o1 < n_orb) + (o2 < n_orb) != (u1 < n_orb) + (u2 < n_orb):
                        continue
                    occ = sorted(hf_set - {o1, o2} | {u1, u2})
                    if occ_irrep(occ) ^ base_irrep == target_irrep:
                        occs.append(occ)
    bits = np.zeros((len(occs), ham.n_bits), bool)
    for k, occ in enumerate(occs):
        bits[k, occ] = True
    words = dets.pack_bits(torch.as_tensor(bits, device=ham.device), ham.n_words)
    words = words[dets.sort_dets(words)]
    keep = torch.ones(len(words), dtype=torch.bool, device=ham.device)
    keep[1:] = (words[1:] != words[:-1]).any(-1)
    return words[keep]


def _offdiag_in_set(ham, tmpl, words, occ, det_set):
    """(rows, cols, amps): the non-zero off-diagonal elements <det_set[col]|H|
    words[row]> over the symmetry-allowed singles and doubles of ``words``
    whose targets lie in the sorted set ``det_set``.  The pieces of
    :func:`fries_tpu_torch.ops.molecule.exact_offdiag_batch` (its
    enumerations, parities and Slater-Condon elements), with the elements
    evaluated only for the targets found in the set."""
    o1, o2, u1, u2, dmask = mol.enumerate_doubles(ham, tmpl, words, occ)
    so, su, smask = mol.enumerate_singles(ham, tmpl, words, occ)
    rows, cols, amps = [], [], []
    for mask, idx, parity, element in (
            (dmask, (o1, o2, u1, u2), dets.double_parity,
             lambda r, i: mol.doub_matr_el(ham, *i)),
            (smask, (so, su), dets.single_parity,
             lambda r, i: mol.sing_matr_el(ham, *i, occ[r]))):
        r, c = torch.nonzero(mask, as_tuple=True)
        idx = [x[r, c] for x in idx]
        new, sign = parity(words[r], *idx)
        pos, hit = dets.lookup_dets(det_set, new)
        r, pos, idx, sign = r[hit], pos[hit], [x[hit] for x in idx], sign[hit]
        amp = element(r, idx) * sign
        rows.append(r)
        cols.append(pos)
        amps.append(amp)
    return torch.cat(rows), torch.cat(cols), torch.cat(amps)


def build_dense_h(ham: mol.MolecularHamiltonian, det_words, chunk: int = 1024):
    """Dense H matrix (N, N) over the sorted determinant set ``det_words``,
    float64 on ``ham``'s device: the exact off-diagonal action of ``chunk``
    rows at a time, spawns outside the set dropped (the CISD projection),
    and the Slater-Condon diagonal."""
    dev = ham.device
    det_words = torch.as_tensor(det_words, device=dev)
    n = det_words.shape[0]
    occ_all = dets.occ_list(det_words, ham.n_bits, ham.n_elec)
    tmpl = mol.ExcitationTemplate.build(ham.n_orb, ham.n_elec)
    h = torch.zeros((n, n), dtype=torch.float64, device=dev)
    for s in range(0, n, chunk):
        rows, cols, amps = _offdiag_in_set(ham, tmpl, det_words[s:s + chunk],
                                           occ_all[s:s + chunk], det_words)
        keep = amps != 0.0
        h.index_put_((s + rows[keep], cols[keep]), amps[keep], accumulate=True)
    h.diagonal().copy_(mol.diag_matrel(ham, occ_all))
    return h


def cisd_ground_state(ham: mol.MolecularHamiltonian, target_irrep: int = 0, m: int = 120):
    """(e_cisd_corr, det_words, coeffs): the CISD ground state of ``ham`` on
    its device.  ``e_cisd_corr`` is relative to the HF determinant's
    diagonal; the coefficients are normalized with the HF one positive."""
    words = enumerate_cisd(ham, target_irrep)
    h = build_dense_h(ham, words)
    n = h.shape[0]
    hf = dets.hf_det(ham.n_orb, ham.n_elec, device=ham.device)
    hf_idx = int(torch.nonzero((words == hf).all(-1))[0, 0])
    h.diagonal().sub_(h[hf_idx, hf_idx].clone())
    v0 = torch.zeros(n, dtype=torch.float64, device=ham.device)
    v0[hf_idx] = 1.0
    e, vec = linalg.lanczos_ground_state(lambda v: h @ v, n, m=m, v0=v0)
    if vec[hf_idx] < 0:
        vec = -vec
    return e, words, vec


def largest(words, coeffs, k: int):
    """(words, coeffs) of the ``k`` determinants of largest |c|, as numpy
    arrays: |c| rounded to 1e-10, ties in the given order (the CISD's
    determinants come sorted), so the choice is the same on every device."""
    words = words.cpu().numpy() if torch.is_tensor(words) else np.asarray(words)
    coeffs = coeffs.cpu().numpy() if torch.is_tensor(coeffs) else np.asarray(coeffs)
    mag = np.round(np.abs(coeffs), 10)
    order = np.lexsort((np.arange(len(mag)), -mag))[:k]
    return words[order], coeffs[order]


def _occupancy(det_words):
    """(N, 32 W) bool occupancy of words given as a tensor or an array of
    32-bit values (uint32 or int64)."""
    w = det_words.cpu().numpy() if torch.is_tensor(det_words) else np.asarray(det_words)
    w = w.astype(np.uint64)
    shifts = np.arange(32, dtype=np.uint64)
    return ((w[:, :, None] >> shifts) & np.uint64(1)).astype(bool).reshape(len(w), -1)


def _orbital_parity(det_words, n_orb):
    """(N, n_orb) int8: 1 where the spatial orbital is singly occupied."""
    occ = _occupancy(det_words)[:, :2 * n_orb]
    return (occ[:, :n_orb] ^ occ[:, n_orb:]).astype(np.int8)


def orbital_phases(det_words, vals_a, vals_b, n_orb, thresh=1e-4):
    """Per-spatial-orbital sign vector s (±1, length n_orb) with
    vals_b[D] ~ gsign * vals_a[D] * prod_{p singly occupied in D} s_p.
    Returns (s, gsign, n_equations); raises if the GF(2) system is
    inconsistent.  Orbitals never singly occupied in a significant
    determinant keep s = +1 (unobservable)."""
    vals_a = np.asarray(torch.as_tensor(vals_a).cpu())
    vals_b = np.asarray(torch.as_tensor(vals_b).cpu())
    sig = (np.abs(vals_a) > thresh) & (np.abs(vals_b) > thresh)
    par = _orbital_parity(det_words, n_orb)[sig]
    b = (vals_a[sig] * vals_b[sig] < 0).astype(np.int8)
    a = np.concatenate([par, np.ones((len(b), 1), np.int8)], axis=1)   # + global sign
    nvar = n_orb + 1
    pivots, r = {}, 0
    for col in range(nvar):                          # GF(2) gaussian elimination
        nz = np.nonzero(a[r:, col])[0]
        if len(nz) == 0:
            continue
        piv = r + int(nz[0])
        a[[r, piv]] = a[[piv, r]]
        b[[r, piv]] = b[[piv, r]]
        rows = a[:, col].astype(bool)
        rows[r] = False
        a[rows] ^= a[r]
        b[rows] ^= b[r]
        pivots[col] = r
        r += 1
    if np.any(b[r:].astype(bool) & ~a[r:].any(axis=1)):
        raise RuntimeError("orbital-phase system inconsistent: the two CI vectors differ "
                           "beyond orbital sign gauge")
    x = np.zeros(nvar, np.int8)
    for col, rr in pivots.items():
        x[col] = b[rr]
    s = np.where(x[:n_orb] == 1, -1, 1).astype(np.int64)
    return s, (-1 if x[n_orb] else 1), len(b)


def apply_phases(det_words, vals, s, gsign=1):
    """CI coefficients carried across the orbital-sign gauge ``s`` (numpy)."""
    s = np.asarray(s)
    n_orb = len(s)
    occ = _occupancy(det_words)[:, :2 * n_orb]
    neg = np.concatenate([s < 0, s < 0])
    flips = (occ & neg).sum(axis=1) % 2
    out = np.asarray(torch.as_tensor(vals).cpu(), float) * gsign
    return np.where(flips == 1, -out, out)
