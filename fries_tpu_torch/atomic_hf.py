"""Closed-shell atomic RHF over uncontracted same-center (s, p) primitives,
with closed-form integrals, for re-deriving a basis set
(:mod:`fries_tpu_torch.derive_ccpvqz`).

Counterpart of ``tools/atomic_hf.py`` on torch tensors (float64, on the
device given; entry points default to the card).  At one center the
McMurchie-Davidson Hermite Coulomb tensor is diagonal in parity: with
PQ = 0, R_TUV(0) = (T-1)!! (U-1)!! (V-1)!! rn[(T+U+V)/2] for even T, U, V,
where rn = pref (-2 alpha)^n F_n(0) and F_n(0) = 1/(2n+1).  So a block of
primitive ERIs is a few einsums over the pair E-tables
(:class:`fries_tpu_torch.gto._PairData`), with no loop over quartets; the
one-electron integrals are the same-center Gaussian moment formulas.

Not ported: the script's ``AtomBasisPrim`` (uncontracted shells of any l),
which nothing in the repository calls; :func:`fries_tpu_torch.derive_ccpvqz.
atomic_rhf_uncontracted` builds any uncontracted atomic set on the batched
engine instead.
"""

from __future__ import annotations

from math import factorial

import numpy as np
import torch

from fries_tpu_torch import gto

F64 = torch.float64
CUDA = "cuda"


def _dfact(n):
    """n!! (1 for n <= 0)."""
    r = 1
    for i in range(n, 0, -2):
        r *= i
    return r


def _moment(lmn1, lmn2, p):
    """The same-center overlap of two raw cartesian components at total
    exponent ``p`` (0 unless every power sum is even)."""
    n = [lmn1[d] + lmn2[d] for d in range(3)]
    if any(x % 2 for x in n):
        return torch.zeros_like(p)
    return (_dfact(n[0] - 1) * _dfact(n[1] - 1) * _dfact(n[2] - 1)
            / (2.0 * p) ** (sum(n) // 2) * (np.pi / p) ** 1.5)


def _overlap_cart(l1, l2, a, b):
    """(ncart1, ncart2, *shape) same-center overlaps over raw cartesians;
    ``a`` and ``b`` broadcast."""
    p = a + b
    c1, c2 = gto._CART_COMPS[l1], gto._CART_COMPS[l2]
    return torch.stack([torch.stack([_moment(x, y, p) for y in c2]) for x in c1])


def _kinetic_cart(l1, l2, a, b):
    """Same-center kinetic integrals by the operator identity
    T_ab = b (2 (i2+j2+k2) + 3) S - 2 b^2 sum_d S(+2 on d)
    - 1/2 sum_d n_d (n_d - 1) S(-2 on d), over the second component's
    powers n."""
    p = a + b
    c1, c2 = gto._CART_COMPS[l1], gto._CART_COMPS[l2]

    def elem(x, y):
        t = b * (2 * sum(y) + 3) * _moment(x, y, p)
        for d in range(3):
            up = list(y)
            up[d] += 2
            t = t - 2.0 * b * b * _moment(x, up, p)
            if y[d] >= 2:
                dn = list(y)
                dn[d] -= 2
                t = t - 0.5 * y[d] * (y[d] - 1) * _moment(x, dn, p)
        return t
    return torch.stack([torch.stack([elem(x, y) for y in c2]) for x in c1])


def _nuclear_cart(l1, l2, a, b, z):
    """Same-center nuclear attraction (the nucleus at the shared center):
    -Z times the angular average times the radial moment."""
    p = a + b
    c1, c2 = gto._CART_COMPS[l1], gto._CART_COMPS[l2]

    def elem(x, y):
        i, j, k = (x[d] + y[d] for d in range(3))
        if i % 2 or j % 2 or k % 2:
            return torch.zeros_like(p)
        big_l = i + j + k
        ang = (4.0 * np.pi * _dfact(i - 1) * _dfact(j - 1) * _dfact(k - 1)
               / _dfact(big_l + 1))
        return -z * ang * factorial(big_l // 2) / (2.0 * p ** (big_l // 2 + 1))
    return torch.stack([torch.stack([elem(x, y) for y in c2]) for x in c1])


def _same_center_eri(sh_a, sh_b, sh_c, sh_d, device=CUDA):
    """The primitive-resolved cartesian ERI block of four same-center shells:
    (na, nb, nc, nd, ncA, ncB, ncC, ncD), the primitives' normalization
    folded in through ``Shell.coefs``."""
    pd1 = gto._PairData([(sh_a, sh_b)], device)
    pd2 = gto._PairData([(sh_c, sh_d)], device)
    ltot = pd1.la + pd1.lb + pd2.la + pd2.lb
    p1, p2 = pd1.p[:, None], pd2.p[None, :]
    alpha = p1 * p2 / (p1 + p2)
    pref = 2.0 * np.pi ** 2.5 / (p1 * p2 * torch.sqrt(p1 + p2))
    rn = torch.stack([(-2.0 * alpha) ** n / (2 * n + 1) for n in range(ltot + 1)]) * pref
    b1, b2 = pd1.box, pd2.box
    tmax = b1 + b2 - 2
    r0 = rn.new_zeros((tmax + 1,) * 3 + rn.shape[1:])
    for t in range(0, tmax + 1, 2):
        for u in range(0, tmax + 1, 2):
            for v in range(0, tmax + 1, 2):
                if t + u + v <= ltot:
                    r0[t, u, v] = (_dfact(t - 1) * _dfact(u - 1) * _dfact(v - 1)
                                   * rn[(t + u + v) // 2])
    e1 = pd1.efull.reshape(pd1.efull.shape[:3] + (b1,) * 3)
    e2 = pd2.efull.reshape(pd2.efull.shape[:3] + (b2,) * 3)
    k = None
    for t2 in range(b2):
        for u2 in range(b2):
            for v2 in range(b2):
                sign = -1.0 if (t2 + u2 + v2) % 2 else 1.0
                term = sign * torch.einsum("qcd,tuvpq->pqcdtuv", e2[:, :, :, t2, u2, v2],
                                           r0[t2:t2 + b1, u2:u2 + b1, v2:v2 + b1])
                k = term if k is None else k + term
    blk = torch.einsum("pabtuv,pqcdtuv->pqabcd", e1, k)
    n = (len(sh_a.exps), len(sh_b.exps), len(sh_c.exps), len(sh_d.exps))
    return blk.reshape(n + blk.shape[2:])


def _normalized(s_mat, t_mat, v_mat, eri):
    """The integrals over unit-normalized AOs (the diagonal of S to 1)."""
    scale = 1.0 / torch.sqrt(torch.diagonal(s_mat))
    outer = scale[:, None] * scale[None, :]
    return s_mat * outer, t_mat * outer, v_mat * outer, gto._scale4(eri, scale)


class AtomSPBasis:
    """An uncontracted same-center (s, p) primitive basis with closed-form
    integrals.  AO order: s_0 .. s_{ns-1}, then p_0x, p_0y, p_0z, p_1x, ...
    (normalized)."""

    def __init__(self, s_exps, p_exps, z, device=CUDA):
        self.s = np.asarray(s_exps, float)
        self.p = np.asarray(p_exps, float)
        self.z = float(z)
        self.device = torch.device(device)
        self.n = len(self.s) + 3 * len(self.p)

    def integrals(self):
        """(S, T, V, ERI-chemist) over the normalized AOs, float64 tensors."""
        ns, npr, n, dev = len(self.s), len(self.p), self.n, self.device
        zero3 = np.zeros(3)
        sh = {0: gto.Shell(0, zero3, self.s, np.ones(ns), 0),
              1: gto.Shell(1, zero3, self.p, np.ones(npr), 0)}
        t = lambda x: torch.as_tensor(x, dtype=F64, device=dev)
        cs, cp = t(sh[0].coefs), t(sh[1].coefs)
        s_e, p_e = t(self.s), t(self.p)
        # AO rows of each (l, cartesian component): s, then px, py, pz interleaved
        rows = {0: [torch.arange(ns, device=dev)],
                1: [ns + c + 3 * torch.arange(npr, device=dev) for c in range(3)]}

        def one_electron(fn):
            out = torch.zeros((n, n), dtype=F64, device=dev)
            out[:ns, :ns] = fn(0, 0, s_e[:, None], s_e[None, :])[0, 0] * torch.outer(cs, cs)
            blk = fn(1, 1, p_e[:, None], p_e[None, :])
            w = torch.outer(cp, cp)
            for ci in range(3):     # the s-p blocks vanish by parity at one center
                for cj in range(3):
                    out[rows[1][ci][:, None], rows[1][cj][None, :]] = blk[ci, cj] * w
            return out

        s_mat = one_electron(_overlap_cart)
        t_mat = one_electron(_kinetic_cart)
        v_mat = one_electron(lambda l1, l2, a, b: _nuclear_cart(l1, l2, a, b, self.z))
        eri = torch.zeros((n, n, n, n), dtype=F64, device=dev)
        for la in (0, 1):
            for lb in (0, 1):
                for lc in (0, 1):
                    for ld in (0, 1):
                        if (la + lb + lc + ld) % 2:   # odd total parity vanishes
                            continue
                        blk = _same_center_eri(sh[la], sh[lb], sh[lc], sh[ld], dev)
                        for ia, ra in enumerate(rows[la]):
                            for ib, rb in enumerate(rows[lb]):
                                for ic, rc in enumerate(rows[lc]):
                                    for id_, rd in enumerate(rows[ld]):
                                        eri[ra[:, None, None, None], rb[None, :, None, None],
                                            rc[None, None, :, None],
                                            rd[None, None, None, :]] = blk[..., ia, ib, ic, id_]
        return _normalized(s_mat, t_mat, v_mat, eri)


def rhf(s_mat, t_mat, v_mat, eri, n_elec, max_iter=300, tol=1e-12):
    """Damped closed-shell RHF (density mixing 0.7 / 0.3, canonical
    orthogonalization dropping overlap eigenvalues below 1e-10 of the
    largest).  Returns (E_elec, C, MO energies)."""
    hcore = t_mat + v_mat
    nocc = n_elec // 2
    ev, u = torch.linalg.eigh(s_mat)
    keep = ev > 1e-10 * ev.max()
    x = u[:, keep] * ev[keep] ** -0.5
    f, dm, e_old = hcore, None, 0.0
    for it in range(max_iter):
        mo_e, c = torch.linalg.eigh(x.T @ f @ x)
        c = x @ c
        dm_new = 2.0 * c[:, :nocc] @ c[:, :nocc].T
        dm = dm_new if dm is None else 0.7 * dm_new + 0.3 * dm
        j = torch.einsum("ijkl,kl->ij", eri, dm)
        k = torch.einsum("ikjl,kl->ij", eri, dm)
        f = hcore + j - 0.5 * k
        e = float(0.5 * torch.sum(dm * (hcore + f)))
        if abs(e - e_old) < tol and it > 5:
            break
        e_old = e
    return e, c, mo_e


def atom_energy(s_exps, p_exps, z=10, n_elec=10, device=CUDA):
    """The RHF energy of an atom of charge ``z`` in an uncontracted (s, p)
    set."""
    return rhf(*AtomSPBasis(s_exps, p_exps, z, device).integrals(), n_elec)[0]
