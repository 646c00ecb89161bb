"""Contracted-Gaussian molecular integrals (McMurchie-Davidson) on torch
tensors: STO-3G s/p shells and the correlation-consistent bases up to g.

Counterpart of ``fries_tpu/gto.py``.  The reference evaluates one AO pair
(one-electron) or one shell quartet (ERIs) at a time in numpy; here every
integral of one angular-momentum class is one batch of tensor operations
on the device, so a build costs a few hundred passes per class, not per
quartet:

* a shell pair's primitive pairs carry their Hermite expansion
  coefficients ``E[t, u, v]`` with the contraction coefficients folded in
  (:class:`_PairData`, one object per class (la, lb) holding every shell
  pair of that class, flattened over primitive pairs);
* an ERI class (la, lb | lc, ld) forms the Hermite Coulomb integrals
  ``R[t+t', u+u', v+v']`` of every primitive quartet (the reference's
  recursion, vectorized over the quartets and, per recursion step, over
  the auxiliary index), then contracts the ket's and the bra's
  coefficients as two matrix products whose inner dimension runs over
  (primitive pair, Hermite index): the segment sum over a shell pair's
  primitive pairs is a zero-padded block of those matrices
  (:func:`_eri_class`).

Per element the arithmetic is the reference's (the Boys series, the E and
R recursions), only the order of the final sums differs.  Every function
computes in float64 on the device of its inputs or the ``device`` it is
given; entry points default to the card.  The AO order is PySCF's
(spherical m from -l to l) and ``_SPH_PARITY`` gives each harmonic's
per-axis parity, which :mod:`fries_tpu_torch.scf` reads for the point
group.

Anchor: H2O at the Crawford-programming-projects STO-3G geometry gives the
published E_SCF = -74.942079928192 Ha and E_nuc = 8.0023670618 Ha.
"""

from __future__ import annotations

from math import prod

import numpy as np
import torch

from fries_tpu_torch import basis as basis_data
from fries_tpu_torch.ops import molecule as mol
from fries_tpu_torch.ops import ordered

F64 = torch.float64
CUDA = "cuda"

# ---------------------------------------------------------------------------
# STO-3G basis data (EMSL tabulation).  All first-row atoms share the same
# contraction coefficient sets; exponents are per-atom scaled.
# ---------------------------------------------------------------------------

_C1S = [0.15432897, 0.53532814, 0.44463454]
_C2S = [-0.09996723, 0.39951283, 0.70011547]
_C2P = [0.15591627, 0.60768372, 0.39195739]

# symbol -> (charge, [(l, exps, coefs), ...]); an l=1 entry expands to
# px, py, pz AOs sharing its radial part
BASIS = {
    "H": (1, [(0, [3.42525091, 0.62391373, 0.16885540], _C1S)]),
    "Li": (3, [(0, [16.1195750, 2.9362007, 0.7946505], _C1S),
               (0, [0.6362897, 0.1478601, 0.0480887], _C2S),
               (1, [0.6362897, 0.1478601, 0.0480887], _C2P)]),
    "C": (6, [(0, [71.6168370, 13.0450960, 3.5305122], _C1S),
              (0, [2.9412494, 0.6834831, 0.2222899], _C2S),
              (1, [2.9412494, 0.6834831, 0.2222899], _C2P)]),
    "N": (7, [(0, [99.1061690, 18.0523120, 4.8856602], _C1S),
              (0, [3.7804559, 0.8784966, 0.2857144], _C2S),
              (1, [3.7804559, 0.8784966, 0.2857144], _C2P)]),
    "O": (8, [(0, [130.7093200, 23.8088610, 6.4436083], _C1S),
              (0, [5.0331513, 1.1695961, 0.3803890], _C2S),
              (1, [5.0331513, 1.1695961, 0.3803890], _C2P)]),
}


# ---------------------------------------------------------------------------
# Normalization and spherical-harmonic tables (host data)
# ---------------------------------------------------------------------------

def _dfact(k):
    """(2k-1)!!"""
    r = 1
    for i in range(2 * k - 1, 0, -2):
        r *= i
    return r


def _prim_norm(l, m, n, a):
    """Normalization of a cartesian primitive x^l y^m z^n exp(-a r^2)."""
    return ((2 * a / np.pi) ** 0.75
            * np.sqrt((4 * a) ** (l + m + n) / (_dfact(l) * _dfact(m) * _dfact(n))))


def _cart_comps(l):
    """Cartesian components of shell ``l``, x-major."""
    return [(lx, ly, l - lx - ly)
            for lx in range(l, -1, -1) for ly in range(l - lx, -1, -1)]


_CART_COMPS = {l: _cart_comps(l) for l in range(5)}


def _comp_w(l, lmn):
    """Norm ratio N(lmn)/N(l00): scales raw (l00-normalized) cartesian
    components to unit-normalized ones.  Exponent-independent."""
    return np.sqrt(_dfact(l) / prod(_dfact(c) for c in lmn))


# Real solid harmonics as cartesian monomial polynomials, PySCF m-order
# (-l..l), each up to overall scale (the AOs are renormalized numerically).
_SOLID_MONOMIALS = {
    0: [{(0, 0, 0): 1.0}],
    1: [{(1, 0, 0): 1.0}, {(0, 1, 0): 1.0}, {(0, 0, 1): 1.0}],
    2: [
        {(1, 1, 0): 1.0},                                       # m=-2: xy
        {(0, 1, 1): 1.0},                                       # m=-1: yz
        {(0, 0, 2): 2.0, (2, 0, 0): -1.0, (0, 2, 0): -1.0},     # m=0
        {(1, 0, 1): 1.0},                                       # m=+1: xz
        {(2, 0, 0): 1.0, (0, 2, 0): -1.0},                      # m=+2
    ],
    3: [
        {(2, 1, 0): 3.0, (0, 3, 0): -1.0},                      # y(3x^2-y^2)
        {(1, 1, 1): 1.0},                                       # xyz
        {(0, 1, 2): 4.0, (2, 1, 0): -1.0, (0, 3, 0): -1.0},     # y(4z^2-x^2-y^2)
        {(0, 0, 3): 2.0, (2, 0, 1): -3.0, (0, 2, 1): -3.0},     # z(2z^2-3x^2-3y^2)
        {(1, 0, 2): 4.0, (3, 0, 0): -1.0, (1, 2, 0): -1.0},     # x(4z^2-x^2-y^2)
        {(2, 0, 1): 1.0, (0, 2, 1): -1.0},                      # z(x^2-y^2)
        {(3, 0, 0): 1.0, (1, 2, 0): -3.0},                      # x(x^2-3y^2)
    ],
    4: [
        {(3, 1, 0): 1.0, (1, 3, 0): -1.0},                      # xy(x^2-y^2)
        {(2, 1, 1): 3.0, (0, 3, 1): -1.0},                      # yz(3x^2-y^2)
        {(1, 1, 2): 6.0, (3, 1, 0): -1.0, (1, 3, 0): -1.0},     # xy(6z^2-x^2-y^2)
        {(0, 1, 3): 4.0, (2, 1, 1): -3.0, (0, 3, 1): -3.0},     # yz(4z^2-3x^2-3y^2)
        {(4, 0, 0): 3.0, (0, 4, 0): 3.0, (0, 0, 4): 8.0,        # 35z^4-30z^2r^2+3r^4
         (2, 2, 0): 6.0, (2, 0, 2): -24.0, (0, 2, 2): -24.0},
        {(1, 0, 3): 4.0, (3, 0, 1): -3.0, (1, 2, 1): -3.0},     # xz(4z^2-3x^2-3y^2)
        {(2, 0, 2): 6.0, (0, 2, 2): -6.0,                       # (x^2-y^2)(6z^2-x^2-y^2)
         (4, 0, 0): -1.0, (0, 4, 0): 1.0},
        {(3, 0, 1): 1.0, (1, 2, 1): -3.0},                      # xz(x^2-3y^2)
        {(4, 0, 0): 1.0, (0, 4, 0): 1.0, (2, 2, 0): -6.0},      # x^4-6x^2y^2+y^4
    ],
}


def _build_sph_coef(l):
    """(n_cart, 2l+1) transform over unit-normalized cartesian components:
    monomial coefficient / w(lmn)."""
    comps = _CART_COMPS[l]
    mat = np.zeros((len(comps), 2 * l + 1))
    for m_i, mono in enumerate(_SOLID_MONOMIALS[l]):
        for lmn, c in mono.items():
            mat[comps.index(lmn), m_i] = c / _comp_w(l, lmn)
    return mat


_SPH_COEF = {l: _build_sph_coef(l) for l in range(5)}


def _sph_parity(l):
    """Per-axis parity (mod 2) of each real solid harmonic (all monomials of
    one harmonic share it), for the point-group operations."""
    return [tuple(c % 2 for c in next(iter(mono))) for mono in _SOLID_MONOMIALS[l]]


_SPH_PARITY = {l: _sph_parity(l) for l in range(5)}


# ---------------------------------------------------------------------------
# Shells
# ---------------------------------------------------------------------------

class Shell:
    """One contracted shell: all cartesian components share the radial part.

    ``coefs`` carry the (l,0,0)-cartesian primitive normalization (host
    numpy; the device tensors are made per class in :class:`_PairData`)."""

    __slots__ = ("l", "center", "exps", "coefs", "atom")

    def __init__(self, l, center, exps, coefs, atom):
        self.l = l
        self.center = np.asarray(center, float)
        self.exps = np.asarray(exps, float)
        self.coefs = np.asarray(coefs, float) * np.array(
            [_prim_norm(l, 0, 0, a) for a in self.exps])
        self.atom = atom


def build_shells(symbols, centers, basis_name):
    """(shells, charges) for a molecule in a correlation-consistent basis."""
    centers = np.atleast_2d(np.asarray(centers, float))
    shells, charges = [], []
    for ai, (sym, cen) in enumerate(zip(symbols, centers)):
        z, shell_list = basis_data.get_shells(basis_name, sym)
        charges.append(float(z))
        for l, prims in shell_list:
            shells.append(Shell(l, cen, [e for e, _ in prims], [c for _, c in prims], ai))
    return shells, np.asarray(charges)


def build_sto3g_shells(symbols, centers):
    """(shells, charges) for a molecule in STO-3G."""
    centers = np.atleast_2d(np.asarray(centers, float))
    shells, charges = [], []
    for ai, (sym, cen) in enumerate(zip(symbols, centers)):
        z, shell_list = BASIS[sym]
        charges.append(float(z))
        for l, exps, coefs in shell_list:
            shells.append(Shell(l, cen, exps, coefs, ai))
    return shells, np.asarray(charges)


# ---------------------------------------------------------------------------
# Boys function, Hermite expansion and Coulomb recursions (batched)
# ---------------------------------------------------------------------------

def _boys_vec(nmax, x):
    """Boys functions F_0..F_nmax of a float64 tensor ``x``: (nmax+1,
    *x.shape).  Below 35 a 220-term all-positive series for F_nmax, then
    downward recursion; above, erf for F_0, then upward recursion."""
    small = x < 35.0
    xs = torch.where(small, x, 1.0)
    s = torch.full_like(xs, 1.0 / (2 * nmax + 1))
    term = s.clone()
    for k in range(1, 220):
        term = term * (2.0 * xs) / (2 * nmax + 2 * k + 1)
        s = s + term
    ex = torch.exp(-xs)
    fs = [None] * (nmax + 1)
    fs[nmax] = ex * s
    for n in range(nmax, 0, -1):
        fs[n - 1] = (2.0 * xs * fs[n] + ex) / (2 * n - 1)
    xl = torch.where(small, 1.0, x)
    fl = [0.5 * torch.sqrt(np.pi / xl) * torch.special.erf(torch.sqrt(xl))]
    exl = torch.exp(-xl)
    for n in range(nmax):
        fl.append(((2 * n + 1) * fl[n] - exl) / (2.0 * xl))
    return torch.stack([torch.where(small, fs[n], fl[n]) for n in range(nmax + 1)])


def _e_tables(la, lb, a, b, ab):
    """Hermite expansion coefficients E_t^{ij} of one cartesian direction
    for every primitive pair: (P, la+1, lb+1, la+lb+2); ``a``, ``b``, ``ab``
    (= A_x - B_x) are (P,) tensors."""
    p = a + b
    q = a * b / p
    width = la + lb + 2
    e = a.new_zeros((a.shape[0], la + 1, lb + 1, width + 1))
    e[:, 0, 0, 0] = torch.exp(-q * ab * ab)
    tp1 = torch.arange(1, width + 1, dtype=F64, device=a.device)   # t + 1
    ka = (q * ab / a)[:, None]
    kb = (q * ab / b)[:, None]
    two_p = (2 * p)[:, None]
    for i in range(1, la + 1):
        prev = e[:, i - 1, 0]
        down = torch.cat([prev.new_zeros((prev.shape[0], 1)), prev[:, :width - 1]], 1)
        e[:, i, 0, :width] = down / two_p - ka * prev[:, :width] + tp1 * prev[:, 1:]
    for j in range(1, lb + 1):
        prev = e[:, :, j - 1]
        down = torch.cat([prev.new_zeros(prev.shape[:2] + (1,)), prev[..., :width - 1]], 2)
        e[:, :, j, :width] = (down / two_p[..., None] + kb[..., None] * prev[..., :width]
                              + tp1 * prev[..., 1:])
    return e[..., :width]


def _r_tables(ltot, tmax, alpha_x, pq, pref):
    """Hermite Coulomb integrals R_{tuv} (prefactor ``pref`` folded in) of
    every row: ``alpha_x`` = (alpha, alpha * |PQ|^2) and ``pq`` (Q, 3) ->
    (Q, tmax+1, tmax+1, tmax+1).  The reference's recursion, each step
    vectorized over the auxiliary index n (and t, u); entries beyond
    t + u + v <= ltot are never read with a non-zero weight."""
    alpha, x = alpha_x
    f = _boys_vec(ltot, x)
    rn = torch.stack([(-2.0 * alpha) ** n * f[n] for n in range(ltot + 1)]) * pref
    t1 = tmax + 1
    r = rn.new_zeros((ltot + 1, t1, t1, t1) + rn.shape[1:])
    r[:, 0, 0, 0] = rn
    px, py, pz = pq[:, 0], pq[:, 1], pq[:, 2]
    for t in range(min(tmax, ltot)):
        nn = ltot - t
        r[:nn, t + 1, 0, 0] = (px * r[1:nn + 1, t, 0, 0] if t == 0 else
                               t * r[1:nn + 1, t - 1, 0, 0] + px * r[1:nn + 1, t, 0, 0])
    for u in range(min(tmax, ltot)):
        nn = ltot - u
        r[:nn, :, u + 1, 0] = (py * r[1:nn + 1, :, u, 0] if u == 0 else
                               u * r[1:nn + 1, :, u - 1, 0] + py * r[1:nn + 1, :, u, 0])
    for v in range(min(tmax, ltot)):
        nn = ltot - v
        r[:nn, :, :, v + 1] = (pz * r[1:nn + 1, :, :, v] if v == 0 else
                               v * r[1:nn + 1, :, :, v - 1] + pz * r[1:nn + 1, :, :, v])
    return r[0].movedim(-1, 0)


# ---------------------------------------------------------------------------
# Shell-pair tables
# ---------------------------------------------------------------------------

class _PairData:
    """Primitive-pair tables of every shell pair of one class (la, lb),
    flattened over (shell pair, primitive i, primitive j).

    ``p`` (P,), ``pcen`` (P, 3), ``coef`` (P,), ``seg`` (P,) the shell
    pair's position in ``pairs``; ``efull`` (P, nca, ncb, box^3) the
    Hermite coefficients with the contraction coefficients folded in;
    ``ex`` the per-direction tables (3 x (P, la+1, lb+1+shift, ...)) for
    the one-electron integrals.  ``shift`` raises lb's table by that much
    (the kinetic integrals need lb + 2)."""

    def __init__(self, pairs, device, shift=0):
        sha0, shb0 = pairs[0]
        la, lb = sha0.l, shb0.l
        a, b, coef, ca, cb, seg = [], [], [], [], [], []
        for k, (sha, shb) in enumerate(pairs):
            na, nb = len(sha.exps), len(shb.exps)
            a.append(np.repeat(sha.exps, nb))
            b.append(np.tile(shb.exps, na))
            coef.append(np.repeat(sha.coefs, nb) * np.tile(shb.coefs, na))
            ca.append(np.tile(sha.center, (na * nb, 1)))
            cb.append(np.tile(shb.center, (na * nb, 1)))
            seg.append(np.full(na * nb, k))
        t = lambda x: torch.tensor(np.concatenate(x), dtype=F64, device=device)
        a, b, coef, ca, cb = t(a), t(b), t(coef), t(ca), t(cb)
        self.seg = torch.tensor(np.concatenate(seg), device=device)
        self.pairs, self.la, self.lb = pairs, la, lb
        self.n_pairs = len(pairs)
        p = a + b
        self.a, self.b, self.p, self.coef = a, b, p, coef
        self.pcen = (a[:, None] * ca + b[:, None] * cb) / p[:, None]
        ab = ca - cb
        self.ex = [_e_tables(la, lb + shift, a, b, ab[:, d]) for d in range(3)]
        nh = la + lb + 1
        comps_a, comps_b = _CART_COMPS[la], _CART_COMPS[lb]
        sel = []
        for d in range(3):
            ia = torch.tensor([c[d] for c in comps_a], device=device)
            ib = torch.tensor([c[d] for c in comps_b], device=device)
            sel.append(self.ex[d][:, ia[:, None], ib[None, :], :nh])   # (P, nca, ncb, nh)
        eraw = (sel[0][..., :, None, None] * sel[1][..., None, :, None]
                * sel[2][..., None, None, :]).reshape(sel[0].shape[:3] + (nh ** 3,))
        self.eraw = eraw
        self.efull = eraw * coef[:, None, None, None]
        self.box = nh


def _pair_classes(shells, device, shift=0):
    """{(la, lb): _PairData} over the shell pairs (i, j), j <= i."""
    by_class = {}
    for i in range(len(shells)):
        for j in range(i + 1):
            by_class.setdefault((shells[i].l, shells[j].l), []).append((i, j))
    return {cls: (idx, _PairData([(shells[i], shells[j]) for i, j in idx], device, shift))
            for cls, idx in by_class.items()}


# ---------------------------------------------------------------------------
# Two-electron integrals
# ---------------------------------------------------------------------------

def _hermite_index(b1, b2, tmax, device):
    """Flat index of R[t+t', u+u', v+v'] in a (tmax+1)^3 box, (b1^3, b2^3),
    and the ket's sign (-1)^(t'+u'+v'), (b2^3,)."""
    g1 = torch.stack(torch.meshgrid(*[torch.arange(b1, device=device)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
    g2 = torch.stack(torch.meshgrid(*[torch.arange(b2, device=device)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
    s = g1[:, None, :] + g2[None, :, :]
    t1 = tmax + 1
    idx = (s[..., 0] * t1 + s[..., 1]) * t1 + s[..., 2]
    sign = 1.0 - 2.0 * (g2.sum(-1) % 2).to(F64)
    return idx, sign


def _segment_matrix(seg, n_pairs, weights):
    """(P * B, n_pairs * nc) block matrix: row (primitive pair, Hermite
    index), column (shell pair, component pair); each primitive pair's
    coefficients ``weights`` (P, nc, B) sit in the block of its shell pair
    ``seg`` (P,)."""
    n_p, nc, nb = weights.shape
    m = weights.new_zeros((n_p, nb, n_pairs, nc))
    m[torch.arange(n_p, device=weights.device), :, seg, :] = weights.transpose(1, 2)
    return m.reshape(n_p * nb, n_pairs * nc)


_MAX_ELEMENTS = 1 << 26   # of one chunk's R table or gathered R, per ERI class


def _eri_class(pd1, pd2):
    """Contracted cartesian ERIs of every shell pair of ``pd1`` with every
    one of ``pd2``: (n_pairs1, nca, ncb, n_pairs2, ncc, ncd)."""
    dev = pd1.p.device
    ltot = pd1.la + pd1.lb + pd2.la + pd2.lb
    b1, b2 = pd1.box, pd2.box
    tmax = b1 + b2 - 2
    idx, sign = _hermite_index(b1, b2, tmax, dev)
    nca, ncb = pd1.efull.shape[1:3]
    ncc, ncd = pd2.efull.shape[1:3]
    e2 = (pd2.efull * sign).reshape(len(pd2.p), ncc * ncd, -1)
    m2 = _segment_matrix(pd2.seg, pd2.n_pairs, e2)                   # (P2 B2, S2 ncd)
    e1 = pd1.efull.reshape(len(pd1.p), nca * ncb, -1)
    n2 = len(pd2.p)
    per_row = n2 * max((ltot + 1) * (tmax + 1) ** 3, idx.numel())
    step = max(1, _MAX_ELEMENTS // per_row)
    out = None
    for s in range(0, len(pd1.p), step):
        sl = slice(s, s + step)
        p1, p2 = pd1.p[sl, None], pd2.p[None, :]
        alpha = p1 * p2 / (p1 + p2)
        pq = pd1.pcen[sl, None, :] - pd2.pcen[None, :, :]
        x = alpha * (pq * pq).sum(-1)
        pref = 2.0 * np.pi ** 2.5 / (p1 * p2 * torch.sqrt(p1 + p2))
        n1 = alpha.shape[0]
        r0 = _r_tables(ltot, tmax, (alpha.reshape(-1), x.reshape(-1)), pq.reshape(-1, 3),
                       pref.reshape(-1))
        rg = r0.reshape(n1, n2, -1)[:, :, idx]                       # (n1, P2, B1, B2)
        g = rg.permute(0, 2, 1, 3).reshape(n1 * b1 ** 3, n2 * b2 ** 3) @ m2
        part = _segment_matrix(pd1.seg[sl], pd1.n_pairs, e1[sl]).T @ g   # (S1 nab, S2 ncd)
        out = part if out is None else out + part
    return out.reshape(pd1.n_pairs, nca, ncb, pd2.n_pairs, ncc, ncd)


def _eri_quartet(pd1, pd2):
    """Contracted cartesian ERI block (nca, ncb, ncc, ncd) of the first
    shell pair of ``pd1`` with the first of ``pd2``."""
    return _eri_class(pd1, pd2)[0, :, :, 0]


def _offsets(shells):
    offs, n = [], 0
    for sh in shells:
        offs.append(n)
        n += len(_CART_COMPS[sh.l])
    return offs, n


def _ao_index(idx, offs, shells, side, device):
    """(n_pairs, nc) AO indices of side 0 (i) or 1 (j) of the pairs ``idx``."""
    rows = [offs[pair[side]] + np.arange(len(_CART_COMPS[shells[pair[side]].l]))
            for pair in idx]
    return torch.tensor(np.stack(rows), device=device)


def eri_cart(shells, device=CUDA, classes=None):
    """Full cartesian contracted-ERI tensor (chemist (ij|kl)) over the raw
    (l00-normalized) cartesian AO components of ``shells``."""
    offs, n = _offsets(shells)
    classes = classes if classes is not None else _pair_classes(shells, device)
    eri = torch.zeros((n, n, n, n), dtype=F64, device=device)
    items = list(classes.items())
    for c1, (_, (idx1, pd1)) in enumerate(items):
        i1, j1 = _ao_index(idx1, offs, shells, 0, device), _ao_index(idx1, offs, shells, 1, device)
        for _, (idx2, pd2) in items[:c1 + 1]:
            k2 = _ao_index(idx2, offs, shells, 0, device)
            l2 = _ao_index(idx2, offs, shells, 1, device)
            blk = _eri_class(pd1, pd2)
            ii = i1[:, :, None, None, None, None]
            jj = j1[:, None, :, None, None, None]
            kk = k2[None, None, None, :, :, None]
            ll = l2[None, None, None, :, None, :]
            for a, b in ((ii, jj), (jj, ii)):
                for c, d in ((kk, ll), (ll, kk)):
                    eri[a, b, c, d] = blk
                    eri[c, d, a, b] = blk
    return eri


# ---------------------------------------------------------------------------
# One-electron integrals
# ---------------------------------------------------------------------------

def _one_electron(shells, centers, charges, device):
    """(S, T, V) over the raw (l00-normalized) cartesian components."""
    offs, n = _offsets(shells)
    s_ao, t_ao, v_ao = (torch.zeros((n, n), dtype=F64, device=device) for _ in range(3))
    cen = torch.tensor(np.atleast_2d(centers), dtype=F64, device=device)
    for idx, pd in _pair_classes(shells, device, shift=2).values():
        la, lb = pd.la, pd.lb
        comps_a, comps_b = _CART_COMPS[la], _CART_COMPS[lb]
        pre = (np.pi / pd.p) ** 1.5
        ov = lambda ax, bx: pd.ex[0][:, ax[0], bx[0], 0] * pd.ex[1][:, ax[1], bx[1], 0] \
            * pd.ex[2][:, ax[2], bx[2], 0]
        n_p = len(pd.p)
        sv = pd.p.new_zeros((n_p, len(comps_a), len(comps_b)))
        tv = torch.zeros_like(sv)
        for ia, ca in enumerate(comps_a):
            for ib, cb in enumerate(comps_b):
                sv[:, ia, ib] = pre * ov(ca, cb)
                t = pd.b * (2 * sum(cb) + 3) * (pre * ov(ca, cb))
                for d in range(3):
                    up = list(cb)
                    up[d] += 2
                    t = t - 2.0 * pd.b * pd.b * (pre * ov(ca, up))
                    if cb[d] >= 2:
                        dn = list(cb)
                        dn[d] -= 2
                        t = t - 0.5 * cb[d] * (cb[d] - 1) * (pre * ov(ca, dn))
                tv[:, ia, ib] = t
        # nuclear attraction: -Z 2 pi / p sum_tuv E_tuv R_tuv(p, P - C)
        ltot = la + lb
        vv = torch.zeros_like(sv)
        for c, z in zip(cen, charges):
            r = _r_tables(ltot, ltot, (pd.p, pd.p * ((pd.pcen - c) ** 2).sum(-1)),
                          pd.pcen - c, torch.ones_like(pd.p))
            acc = torch.einsum("pabt,pt->pab", pd.eraw, r.reshape(n_p, -1))
            vv = vv - z * 2.0 * np.pi / pd.p[:, None, None] * acc
        w = pd.coef[:, None, None]
        ai = _ao_index(idx, offs, shells, 0, device)
        bj = _ao_index(idx, offs, shells, 1, device)
        for m, vals in ((s_ao, sv), (t_ao, tv), (v_ao, vv)):
            blk = torch.zeros((pd.n_pairs,) + vals.shape[1:], dtype=F64, device=device)
            ordered.index_add(blk, pd.seg, w * vals)
            m[ai[:, :, None], bj[:, None, :]] = blk
    # the lower triangle (i >= j) is the computed one, as in the reference
    sym = lambda m: torch.tril(m) + torch.tril(m, -1).T
    return sym(s_ao), sym(t_ao), sym(v_ao)


def _nuclear_repulsion(centers, charges):
    centers = np.atleast_2d(np.asarray(centers, float))
    e_nuc = 0.0
    for i in range(len(centers)):
        for j in range(i):
            e_nuc += charges[i] * charges[j] / np.linalg.norm(centers[i] - centers[j])
    return e_nuc


def _scale4(eri, scale):
    return eri * (scale[:, None, None, None] * scale[None, :, None, None]
                  * scale[None, None, :, None] * scale[None, None, None, :])


def integrals(symbols, centers, device=CUDA):
    """STO-3G (S, T, V, ERI-chemist, E_nuc) in the contraction-normalized
    cartesian AO basis (an l = 1 shell is px, py, pz)."""
    centers = np.atleast_2d(np.asarray(centers, float))
    shells, charges = build_sto3g_shells(symbols, centers)
    s_ao, t_ao, v_ao = _one_electron(shells, centers, charges, device)
    eri = eri_cart(shells, device)
    # renormalize contractions (published STO-3G coefs are near- but not
    # exactly normalized in cartesian convention)
    scale = 1.0 / torch.sqrt(torch.diagonal(s_ao))
    outer = scale[:, None] * scale[None, :]
    return (s_ao * outer, t_ao * outer, v_ao * outer, _scale4(eri, scale),
            _nuclear_repulsion(centers, charges))


def molecule(symbols, centers, n_frozen: int = 0, device=CUDA):
    """STO-3G (MolecularHamiltonian in canonical RHF MOs, core_energy).

    ``n_frozen`` doubly-occupied lowest MOs are folded into the core energy
    and an effective one-electron operator."""
    from fries_tpu_torch import sto3g

    s, t, v, eri_chem, e_nuc = integrals(symbols, centers, device)
    n_elec = int(sum(BASIS[sym][0] for sym in symbols))
    c, _ = sto3g.rhf(s, t + v, eri_chem, n_elec)
    hmo = c.T @ (t + v) @ c
    eri = torch.einsum("ijkl,ip,jq,kr,ls->pqrs", eri_chem, c, c, c, c)
    core = e_nuc
    if n_frozen:
        f = n_frozen
        core += float(2.0 * torch.trace(hmo[:f, :f]))
        core += float(2.0 * torch.einsum("iijj->", eri[:f, :f, :f, :f])
                      - torch.einsum("ijji->", eri[:f, :f, :f, :f]))
        heff = (hmo + 2.0 * torch.einsum("pqii->pq", eri[:, :, :f, :f])
                - torch.einsum("piiq->pq", eri[:, :f, :f, :]))
        hmo = heff[f:, f:]
        eri = eri[f:, f:, f:, f:]
        n_elec -= 2 * f
    n_orb = hmo.shape[0]
    ham = mol.MolecularHamiltonian(
        hcore=hmo.contiguous(), eris=eri.permute(0, 2, 1, 3).contiguous(),
        symm=torch.zeros(n_orb, dtype=torch.int64, device=hmo.device),
        n_orb=n_orb, n_elec=n_elec)
    return ham, core


# ---------------------------------------------------------------------------
# Correlation-consistent bases: spherical AOs
# ---------------------------------------------------------------------------

def _shell_aos(shells):
    """Per-cartesian-AO metadata (shell index, lmn)."""
    return [(si, lmn) for si, sh in enumerate(shells) for lmn in _CART_COMPS[sh.l]]


def sph_transform(shells, device=CUDA):
    """(ncart, nsph) block-diagonal cart->spherical matrix acting on
    *unit-normalized* cartesian components, plus per-sph-AO metadata
    (atom, l, m_index, parity)."""
    blocks, meta = [], []
    for sh in shells:
        blocks.append(_SPH_COEF[sh.l])
        for mi, par in enumerate(_SPH_PARITY[sh.l]):
            meta.append((sh.atom, sh.l, mi, par))
    ncart = sum(b.shape[0] for b in blocks)
    nsph = sum(b.shape[1] for b in blocks)
    m = np.zeros((ncart, nsph))
    r = c = 0
    for b in blocks:
        m[r:r + b.shape[0], c:c + b.shape[1]] = b
        r += b.shape[0]
        c += b.shape[1]
    return torch.tensor(m, dtype=F64, device=device), meta


def sh_l_from(meta):
    """cart_meta entry -> its shell's l (helper for the w scaling)."""
    return sum(meta[1])


def sync(device):
    """Wait for the card's queue (a host clock around device work)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def integrals_cc(symbols, centers, basis_name, spherical=True, device=CUDA, timings=None):
    """(S, T, V, ERI-chemist, E_nuc, ao_meta) in the normalized spherical
    (or cartesian) AO basis of a correlation-consistent basis set, as
    float64 tensors on ``device``.  ``timings``, a dict, receives the
    seconds of the one-electron part (``one_electron``) and of the ERIs
    (``eri``)."""
    centers = np.atleast_2d(np.asarray(centers, float))
    shells, charges = build_shells(symbols, centers, basis_name)
    return shell_integrals(shells, centers, charges, spherical, device, timings)


def shell_integrals(shells, centers, charges, spherical=True, device=CUDA, timings=None):
    """:func:`integrals_cc` over a list of :class:`Shell` on nuclei at
    ``centers`` with ``charges``."""
    import time

    cart_meta = _shell_aos(shells)
    t0 = time.perf_counter()
    s_ao, t_ao, v_ao = _one_electron(shells, centers, charges, device)
    sync(device)
    t1 = time.perf_counter()
    eri = eri_cart(shells, device)
    sync(device)
    if timings is not None:
        timings.update(one_electron=t1 - t0, eri=time.perf_counter() - t1)

    # raw l00-normalization -> unit-normalized cartesian components
    w = torch.tensor([_comp_w(sh_l_from(meta), meta[1]) for meta in cart_meta],
                     dtype=F64, device=device)
    ww = w[:, None] * w[None, :]
    s_ao, t_ao, v_ao = s_ao * ww, t_ao * ww, v_ao * ww
    eri = _scale4(eri, w)
    if spherical:
        m, ao_meta = sph_transform(shells, device)
        s_ao, t_ao, v_ao = (m.T @ x @ m for x in (s_ao, t_ao, v_ao))
        eri = torch.einsum("ijkl,ip,jq,kr,ls->pqrs", eri, m, m, m, m)
    else:
        ao_meta = [(shells[si].atom, shells[si].l, ci, tuple(c % 2 for c in lmn))
                   for ci, (si, lmn) in enumerate(cart_meta)]
    # exact contracted normalization (PySCF normalizes contractions too)
    scale = 1.0 / torch.sqrt(torch.diagonal(s_ao))
    outer = scale[:, None] * scale[None, :]
    return (s_ao * outer, t_ao * outer, v_ao * outer, _scale4(eri, scale).contiguous(),
            _nuclear_repulsion(centers, charges), ao_meta)


# Crawford programming-projects STO-3G water geometry (bohr):
# published E_SCF = -74.942079928192, E_nuc = 8.002367061811 Ha
WATER_GEOM = (
    ("O", "H", "H"),
    np.array([[0.0, 0.0, -0.143225816552],
              [0.0, 1.638036840407, 1.136548822547],
              [0.0, -1.638036840407, 1.136548822547]]),
)


def water(n_frozen: int = 0, device=CUDA):
    """H2O/STO-3G at the Crawford geometry (7 orbitals, 10 electrons)."""
    return molecule(*WATER_GEOM, n_frozen=n_frozen, device=device)


def n2(r: float = 2.074, n_frozen: int = 0, device=CUDA):
    """N2/STO-3G at bond length ``r`` bohr (10 orbitals, 14 electrons)."""
    return molecule(("N", "N"), np.array([[0.0, 0.0, 0.0], [0.0, 0.0, r]]),
                    n_frozen=n_frozen, device=device)


def lih(r: float = 3.015, n_frozen: int = 0, device=CUDA):
    """LiH/STO-3G at bond length ``r`` bohr (6 orbitals, 4 electrons)."""
    return molecule(("Li", "H"), np.array([[0.0, 0.0, 0.0], [0.0, 0.0, r]]),
                    n_frozen=n_frozen, device=device)
