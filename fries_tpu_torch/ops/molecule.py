"""Molecular Hamiltonian: Slater-Condon matrix elements and symmetry-resolved
excitation enumeration on torch tensors.

Counterpart of ``fries_tpu/ops/molecule.py``.  ERIs are the dense
physicist-notation tensor ``<pq|rs>``; matrix elements are evaluated for whole
batches of excitations with gathers and occupancy-vector reductions.  The TPU
package's one-hot matmul gathers and integer-split f32 products become plain
indexing and f64 matmuls here.

Orbital conventions: ``n_orb`` unfrozen spatial orbitals; spin orbitals
``0..n_orb-1`` alpha, ``n_orb..2n_orb-1`` beta; frozen-core spatial orbitals
occupy the first ``n_frozen/2`` rows of ``hcore``/``eris``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fries_tpu_torch import dets

N_IRREPS = 8


@dataclass(frozen=True)
class MolecularHamiltonian:
    """Integrals + system sizes (tensors on one device).

    hcore: (T, T) f64, T = n_orb + n_frozen/2.  eris: (T, T, T, T) f64
    physicist notation.  symm: (n_orb,) int64 irrep labels.
    """

    hcore: torch.Tensor
    eris: torch.Tensor
    symm: torch.Tensor
    n_orb: int
    n_elec: int
    n_frozen: int = 0

    @property
    def tot_orb(self) -> int:
        return self.n_orb + self.n_frozen // 2

    @property
    def n_bits(self) -> int:
        return 2 * self.n_orb

    @property
    def n_words(self) -> int:
        return dets.n_words(self.n_bits)

    @property
    def device(self) -> torch.device:
        return self.hcore.device


def _spatial(ham: MolecularHamiltonian, spin_orb):
    return spin_orb % ham.n_orb + ham.n_frozen // 2


def _spin(ham: MolecularHamiltonian, spin_orb):
    return spin_orb // ham.n_orb


def _slices(ham: MolecularHamiltonian):
    """coul3[p,r,q] = <pq|rq>, exch3[p,r,q] = <pq|qr>, coul2[p,q] = <pq|pq>,
    exch2[p,q] = <pq|qp>."""
    t = torch.arange(ham.tot_orb, device=ham.device)
    p, r, q = t[:, None, None], t[None, :, None], t[None, None, :]
    e = ham.eris
    return (e[p, q, r, q], e[p, q, q, r],
            e[t[:, None], t[None, :], t[:, None], t[None, :]],
            e[t[:, None], t[None, :], t[None, :], t[:, None]])


def doub_matr_el(ham: MolecularHamiltonian, o1, o2, u1, u2):
    """Sign-free double-excitation element <o1 o2||u1 u2> (batched)."""
    same_sp = _spin(ham, o1) == _spin(ham, o2)
    s0, s1 = _spatial(ham, o1), _spatial(ham, o2)
    s2, s3 = _spatial(ham, u1), _spatial(ham, u2)
    e = ham.eris
    return e[s0, s1, s2, s3] - torch.where(same_sp, e[s0, s1, s3, s2], 0.0)


def _counts(idx, weights, t):
    """(..., E) indices + weights -> (..., T) occupancy counts."""
    out = torch.zeros(idx.shape[:-1] + (t,), dtype=torch.float64,
                      device=idx.device)
    return out.scatter_add_(-1, idx, weights.to(torch.float64))


def sing_matr_el(ham: MolecularHamiltonian, o, u, occ):
    """Sign-free single-excitation element, batched over leading dims.

    o, u: (...,) occupied / virtual spin orbitals (same spin); occ: (..., E)
    occupied spin-orbital lists (broadcast against ``o``)."""
    t = ham.tot_orb
    half_frz = ham.n_frozen // 2
    coul3, exch3, _, _ = _slices(ham)
    so, su = _spatial(ham, o), _spatial(ham, u)
    spin_o = _spin(ham, o)
    shape = torch.broadcast_shapes(occ.shape, o.shape + (1,))
    occ_b = occ.expand(shape)
    occ_spa = _spatial(ham, occ_b)
    same = (_spin(ham, occ_b) == spin_o[..., None]).to(torch.float64)
    n_all = _counts(occ_spa, torch.ones_like(same), t)
    n_same = _counts(occ_spa, same, t)
    coul_row = coul3[so, su]
    exch_row = exch3[so, su]
    mel = ham.hcore[so, su]
    mel = mel + (coul_row * n_all).sum(-1)
    mel = mel - (exch_row * n_same).sum(-1)
    if half_frz:
        mel = mel + 2 * coul_row[..., :half_frz].sum(-1)
        mel = mel - exch_row[..., :half_frz].sum(-1)
    return mel


def diag_matrel(ham: MolecularHamiltonian, occ):
    """Diagonal element <det|H|det>, batched over leading dims of ``occ``.

    Pairwise Coulomb/exchange sums as occupancy-vector quadratic forms:
    sum_{j<k} C[s_j, s_k] = (n^T C n - sum_p n_p C_pp) / 2, likewise per spin
    for exchange."""
    t = ham.tot_orb
    half_frz = ham.n_frozen // 2
    _, _, coul2, exch2 = _slices(ham)
    spa = _spatial(ham, occ)
    spin = _spin(ham, occ)
    a_vec = _counts(spa, spin == 0, t)
    b_vec = _counts(spa, spin == 1, t)
    n_vec = a_vec + b_vec
    h_diag = torch.diagonal(ham.hcore)
    c_diag = torch.diagonal(coul2)
    x_diag = torch.diagonal(exch2)

    total = (n_vec * h_diag).sum(-1)
    nc = n_vec @ coul2
    total = total + 0.5 * ((nc * n_vec).sum(-1) - (n_vec * c_diag).sum(-1))
    ax = a_vec @ exch2
    bx = b_vec @ exch2
    total = total - 0.5 * (
        (ax * a_vec).sum(-1) - (a_vec * x_diag).sum(-1)
        + (bx * b_vec).sum(-1) - (b_vec * x_diag).sum(-1)
    )
    if half_frz:
        j = torch.arange(half_frz, device=ham.device)
        core = 2 * ham.hcore[j, j].sum() + c_diag[j].sum()
        mask = j[None, :] > j[:, None]
        core = core + torch.where(
            mask, 4 * coul2[j[:, None], j[None, :]]
            - 2 * exch2[j[:, None], j[None, :]], 0.0).sum()
        fa = (2 * coul2[:, :half_frz] - exch2[:, :half_frz]).sum(1)
        total = total + core + (n_vec * fa).sum(-1)
    return total


def diag_matrel_chunked(ham: MolecularHamiltonian, occ, chunk: int = 1 << 20):
    """diag_matrel over row chunks of ``occ`` (bounds the (chunk, T)
    temporaries for multi-million-row arenas)."""
    if occ.shape[0] <= chunk:
        return diag_matrel(ham, occ)
    return torch.cat([diag_matrel(ham, occ[s:s + chunk])
                      for s in range(0, occ.shape[0], chunk)])


def hf_reference(ham: MolecularHamiltonian):
    """(hf_det_words, hf_occ, hf_energy) of the aufbau determinant."""
    words = dets.hf_det(ham.n_orb, ham.n_elec, device=ham.device)
    occ = dets.occ_list(words[None], ham.n_bits, ham.n_elec)[0]
    energy = diag_matrel(ham, occ[None])[0]
    return words, occ, energy


# ---------------------------------------------------------------------------
# symmetry tables and excitation templates (host-side numpy)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SymmInfo:
    """Irrep labels and per-irrep orbital lists; ``lookup`` is the dense
    (N_IRREPS, max_count) table padded with n_orb."""

    symm: np.ndarray
    counts: np.ndarray
    lookup: np.ndarray
    max_count: int

    @staticmethod
    def build(symm) -> "SymmInfo":
        symm = np.asarray(symm, dtype=np.int64)
        n_orb = symm.shape[0]
        counts = np.zeros(N_IRREPS, np.int64)
        rows = []
        for g in range(N_IRREPS):
            orbs = np.where(symm == g)[0]
            counts[g] = len(orbs)
            rows.append(orbs)
        max_count = max(1, int(counts.max()))
        lookup = np.full((N_IRREPS, max_count), n_orb, np.int64)
        for g in range(N_IRREPS):
            lookup[g, : counts[g]] = rows[g]
        return SymmInfo(symm, counts, lookup, max_count)


@dataclass(frozen=True)
class ExcitationTemplate:
    """Static per-system candidate excitations, masked per determinant:
    (electron-slot pair) x (spatial target pair) doubles for the three spin
    cases, (electron slot) x (spatial target) singles."""

    d_e1: np.ndarray
    d_e2: np.ndarray
    d_t1: np.ndarray
    d_t2: np.ndarray
    s_e: np.ndarray
    s_t: np.ndarray

    @property
    def n_doub(self) -> int:
        return len(self.d_e1)

    @property
    def n_sing(self) -> int:
        return len(self.s_e)

    @staticmethod
    def build(n_orb: int, n_elec: int) -> "ExcitationTemplate":
        half = n_elec // 2
        d = []
        for e1 in range(half):                       # alpha-beta
            for e2 in range(half, n_elec):
                for t1 in range(n_orb):
                    for t2 in range(n_orb):
                        d.append((e1, e2, t1, t2))
        for base in (0, half):                       # same spin
            for e1 in range(base, base + half):
                for e2 in range(e1 + 1, base + half):
                    for t1 in range(n_orb):
                        for t2 in range(t1 + 1, n_orb):
                            d.append((e1, e2, t1, t2))
        d = np.asarray(d, np.int64).reshape(-1, 4)
        s = np.asarray([(e, t) for e in range(n_elec) for t in range(n_orb)],
                       np.int64).reshape(-1, 2)
        return ExcitationTemplate(d[:, 0], d[:, 1], d[:, 2], d[:, 3],
                                  s[:, 0], s[:, 1])


def _t(x, device):
    return torch.as_tensor(x, device=device)


def enumerate_doubles(ham: MolecularHamiltonian, tmpl: ExcitationTemplate,
                      det_words, occ):
    """All symmetry-allowed doubles of a batch: (o1, o2, u1, u2, valid),
    each (B, ND)."""
    dev = ham.device
    n_orb, half = ham.n_orb, ham.n_elec // 2
    e1, e2 = _t(tmpl.d_e1, dev), _t(tmpl.d_e2, dev)
    o1, o2 = occ[:, e1], occ[:, e2]
    u1 = (_t(tmpl.d_t1, dev) + (e1 >= half) * n_orb).expand(o1.shape)
    u2 = (_t(tmpl.d_t2, dev) + (e2 >= half) * n_orb).expand(o2.shape)
    w = det_words[:, None, :]
    unocc = ~dets.read_bit(w, u1) & ~dets.read_bit(w, u2)
    symm = ham.symm
    allowed = (symm[o1 % n_orb] ^ symm[o2 % n_orb] ^ symm[u1 % n_orb]
               ^ symm[u2 % n_orb]) == 0
    return o1, o2, u1, u2, unocc & allowed


def enumerate_singles(ham: MolecularHamiltonian, tmpl: ExcitationTemplate,
                      det_words, occ):
    """All symmetry-allowed singles (o, u, valid), each (B, NS)."""
    dev = ham.device
    n_orb, half = ham.n_orb, ham.n_elec // 2
    e = _t(tmpl.s_e, dev)
    o = occ[:, e]
    u = (_t(tmpl.s_t, dev) + (e >= half) * n_orb).expand(o.shape)
    unocc = ~dets.read_bit(det_words[:, None, :], u)
    allowed = ham.symm[o % n_orb] == ham.symm[u % n_orb]
    return o, u, unocc & allowed


def exact_offdiag_batch(ham: MolecularHamiltonian, tmpl: ExcitationTemplate,
                        det_words, occ, vals, h_fac):
    """Exact off-diagonal H action of a batch of source determinants.

    Returns (new_words (B, NC, W), amps (B, NC), new_occ (B, NC, E)); masked
    candidates carry zero amplitude and the sentinel key."""
    o1, o2, u1, u2, dmask = enumerate_doubles(ham, tmpl, det_words, occ)
    so, su, smask = enumerate_singles(ham, tmpl, det_words, occ)
    w = det_words[:, None, :]
    vals = torch.as_tensor(vals, dtype=torch.float64, device=ham.device)

    dmel = doub_matr_el(ham, o1, o2, u1, u2)
    dnew, dsign = dets.double_parity(w, o1, o2, u1, u2)
    damp = torch.where(dmask, dmel * dsign * vals[:, None] * h_fac, 0.0)

    smel = sing_matr_el(ham, so, su, occ[:, None, :])
    snew, ssign = dets.single_parity(w, so, su)
    samp = torch.where(smask, smel * ssign * vals[:, None] * h_fac, 0.0)

    new_words = torch.cat([dnew, snew], dim=1)
    amps = torch.cat([damp, samp], dim=1)
    masks = torch.cat([dmask, smask], dim=1)
    new_occ = dets.occ_list(new_words, ham.n_bits, ham.n_elec)
    sentinel = dets.invalid_det(ham.n_words, device=ham.device)
    new_words = torch.where(masks[..., None], new_words, sentinel)
    return new_words, amps, new_occ
