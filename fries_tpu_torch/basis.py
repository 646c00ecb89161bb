"""Correlation-consistent basis-set data (cc-pVDZ, aug-cc-pVDZ for H, N,
O, Ne; cc-pVQZ for Ne).

Counterpart of ``fries_tpu/basis.py``, whose tables this module copies
number for number (the port imports nothing of the JAX package).  Layout:
``TABLE[symbol] = (Z, [(l, [(exp, coef), ...]), ...])`` per basis name.
The cc-pVDZ / aug-cc-pVDZ values are the standard Dunning tabulations
(Dunning, JCP 90, 1007 (1989); Kendall et al., JCP 96, 6796 (1992)); the
Ne cc-pVQZ (12s,6p) set is the re-derived one described below.

Every table is a plain ``dict``: ``in``, ``.get`` and ``[]`` agree (the
cc-pVQZ table holds its one element, Ne, built at import).
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# cc-pVDZ
# ---------------------------------------------------------------------------

# H: (4s,1p) -> [2s,1p]
_H_DZ = [
    (0, [(13.0100000, 0.0196850),
         (1.9620000, 0.1379770),
         (0.4446000, 0.4781480),
         (0.1220000, 0.5012400)]),
    (0, [(0.1220000, 1.0)]),
    (1, [(0.7270000, 1.0)]),
]

# N: (9s,4p,1d) -> [3s,2p,1d]; the two general s contractions are stored as
# separate shells sharing the exponent set.
_N_S_EXP = [9046.0000000, 1357.0000000, 309.3000000, 87.7300000, 28.5600000,
            10.2100000, 3.8380000, 0.7466000, 0.2248000]
_N_DZ = [
    (0, list(zip(_N_S_EXP, [0.0007000, 0.0053890, 0.0274060, 0.1032070,
                            0.2787230, 0.4485400, 0.2782380, 0.0154400,
                            -0.0028640]))),
    (0, list(zip(_N_S_EXP, [-0.0001530, -0.0012080, -0.0059920, -0.0245440,
                            -0.0674590, -0.1580780, -0.1218310, 0.5490030,
                            0.5788150]))),
    (0, [(0.2248000, 1.0)]),
    (1, [(13.5500000, 0.0399190),
         (2.9170000, 0.2171690),
         (0.7973000, 0.5103190),
         (0.2185000, 0.4622140)]),
    (1, [(0.2185000, 1.0)]),
    (2, [(0.8170000, 1.0)]),
]

_O_S_EXP = [11720.0000000, 1759.0000000, 400.8000000, 113.7000000,
            37.0300000, 13.2700000, 5.0250000, 1.0130000, 0.3023000]
_O_DZ = [
    (0, list(zip(_O_S_EXP, [0.0007100, 0.0054700, 0.0278370, 0.1048000,
                            0.2830620, 0.4487190, 0.2709520, 0.0154580,
                            -0.0025850]))),
    (0, list(zip(_O_S_EXP, [-0.0001600, -0.0012630, -0.0062670, -0.0257160,
                            -0.0709240, -0.1654110, -0.1169550, 0.5573680,
                            0.5727590]))),
    (0, [(0.3023000, 1.0)]),
    (1, [(17.7000000, 0.0430180),
         (3.8540000, 0.2289130),
         (1.0460000, 0.5087280),
         (0.2753000, 0.4605310)]),
    (1, [(0.2753000, 1.0)]),
    (2, [(1.1850000, 1.0)]),
]

_NE_S_EXP = [17880.0000000, 2683.0000000, 611.5000000, 173.5000000,
             56.6400000, 20.4200000, 7.8100000, 1.6530000, 0.4869000]
_NE_DZ = [
    (0, list(zip(_NE_S_EXP, [0.0007380, 0.0056770, 0.0288830, 0.1085400,
                             0.2909070, 0.4483240, 0.2580260, 0.0150630,
                             -0.0021000]))),
    # 2s contraction re-derived as the atomic-HF 2s orbital of the
    # uncontracted (9s4p) set (the Dunning construction; validated: the same
    # derivation reproduces the published 1s/2p rows to <5e-7)
    (0, list(zip(_NE_S_EXP, [-0.0001716, -0.0013570, -0.0067369, -0.0276633,
                             -0.0762077, -0.1752269, -0.1070382, 0.5670499,
                             0.5652162]))),
    (0, [(0.4869000, 1.0)]),
    (1, [(28.3900000, 0.0460870),
         (6.2700000, 0.2401810),
         (1.6950000, 0.5087440),
         (0.4317000, 0.4556600)]),
    (1, [(0.4317000, 1.0)]),
    (2, [(2.2020000, 1.0)]),
]

CCPVDZ = {
    "H": (1, _H_DZ),
    "N": (7, _N_DZ),
    "O": (8, _O_DZ),
    "Ne": (10, _NE_DZ),
}

# ---------------------------------------------------------------------------
# aug-cc-pVDZ: cc-pVDZ + one diffuse function per angular momentum
# ---------------------------------------------------------------------------

_AUG = {
    "H": [(0, 0.0297400), (1, 0.1410000)],
    "N": [(0, 0.0612400), (1, 0.0561100), (2, 0.2300000)],
    "O": [(0, 0.0789600), (1, 0.0685600), (2, 0.3320000)],
    "Ne": [(0, 0.1230000), (1, 0.1064000), (2, 0.6310000)],
}

AUG_CCPVDZ = {
    sym: (z, shells + [(l, [(e, 1.0)]) for l, e in _AUG[sym]])
    for sym, (z, shells) in CCPVDZ.items()
}

# ---------------------------------------------------------------------------
# cc-pVQZ (Ne): (12s,6p,3d,2f,1g) -> [5s,4p,3d,2f,1g]
#
# The reference's Neon_ccpvqz input archive (Results.tex:84-90) is not in
# the repo, so the (12s,6p) HF set below is RE-DERIVED by the defining
# Dunning construction: log-exponents optimized to the atomic-RHF energy
# minimum (tools/atomic_hf.py closed-form same-center integrals +
# L-BFGS; converged E_HF(Ne) = -128.5434701 vs the literature cc-pVQZ
# value -128.543470 - 0.1 uEh agreement), then the 1s/2s/2p
# general-contraction coefficients taken as the atomic-HF orbitals of the
# uncontracted set (tools/derive_ccpvqz.py; the same derivation
# reproduced the published cc-pVDZ rows to < 5e-7).  Residual differences
# from the lost published exponents enter all energies only at second
# order about this common stationary point.
# ---------------------------------------------------------------------------

_NE_QZ_S_EXP = [99777.5264, 14934.9460, 3388.8290, 957.0318, 311.6157,
                112.2774, 43.5688, 17.8727, 7.5158, 2.3364, 0.8997, 0.3300]
_NE_QZ_P_EXP = [99.7430, 23.1637, 7.1131, 2.4418, 0.8340, 0.2661]

# atomic-HF orbital rows from tools/derive_ccpvqz.py (E = -128.5434701,
# eps(1s/2s/2p) = -32.7715 / -1.9294 / -0.8490 vs HF-limit -32.7724 /
# -1.9304 / -0.8504); contraction scale is arbitrary (integrals_cc
# renormalizes every AO)
_NE_QZ_1S = [0.0000863, 0.0006714, 0.0035309, 0.0146772, 0.0506748,
             0.1426512, 0.3036701, 0.4011915, 0.2198006, 0.0186578,
             -0.0021530, 0.0009457]
_NE_QZ_2S = [-0.0000202, -0.0001583, -0.0008274, -0.0035032, -0.0121610,
             -0.0367303, -0.0857439, -0.1585233, -0.1148736, 0.2984301,
             0.5857548, 0.2722653]
_NE_QZ_2P = [0.0101765, 0.0712382, 0.2688451, 0.5655605, 0.6798337,
             0.3748485]


def _ne_qz_shells():
    return [
        (0, list(zip(_NE_QZ_S_EXP, _NE_QZ_1S))),
        (0, list(zip(_NE_QZ_S_EXP, _NE_QZ_2S))),
        (0, [(_NE_QZ_S_EXP[-3], 1.0)]),
        (0, [(_NE_QZ_S_EXP[-2], 1.0)]),
        (0, [(_NE_QZ_S_EXP[-1], 1.0)]),
        (1, list(zip(_NE_QZ_P_EXP, _NE_QZ_2P))),
        (1, [(_NE_QZ_P_EXP[-3], 1.0)]),
        (1, [(_NE_QZ_P_EXP[-2], 1.0)]),
        (1, [(_NE_QZ_P_EXP[-1], 1.0)]),
        (2, [(6.471, 1.0)]),
        (2, [(2.213, 1.0)]),
        (2, [(0.7470, 1.0)]),
        (3, [(4.657, 1.0)]),
        (3, [(1.524, 1.0)]),
        (4, [(2.983, 1.0)]),
    ]


CCPVQZ = {"Ne": (10, _ne_qz_shells())}

BASIS_SETS = {
    "cc-pvdz": CCPVDZ,
    "aug-cc-pvdz": AUG_CCPVDZ,
    "cc-pvqz": CCPVQZ,
}


def get_shells(basis: str, symbol: str):
    """(Z, [(l, [(exp, coef), ...]), ...]) for ``symbol`` in ``basis``."""
    table = BASIS_SETS[basis.lower()]
    return table[symbol]
