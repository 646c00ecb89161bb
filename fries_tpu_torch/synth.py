"""Synthetic molecular systems of benchmark size.

Counterpart of ``fries_tpu/synth.py``: the integrals are pure numpy drawn from
``np.random.default_rng(seed)`` with the same calls, so a seed gives arrays
bit-identical to the reference package's.
"""

from __future__ import annotations

import numpy as np
import torch

from fries_tpu_torch.ops import molecule as mol


def random_symmetric_integrals(rng, n_orb, scale_two=0.15, diag_spread=3.0):
    """Random Hermitian hcore + 8-fold-symmetric ERIs (physicist notation)."""
    h = rng.standard_normal((n_orb, n_orb)) * 0.05
    h = (h + h.T) / 2
    h += np.diag(np.linspace(-diag_spread, diag_spread, n_orb))
    v = rng.standard_normal((n_orb,) * 4) * scale_two
    acc = np.zeros_like(v)
    for perm in [
        (0, 1, 2, 3), (1, 0, 3, 2), (2, 3, 0, 1), (3, 2, 1, 0),
        (1, 0, 2, 3), (0, 1, 3, 2), (3, 2, 0, 1), (2, 3, 1, 0),
    ]:
        acc += np.transpose(v, perm)
    acc /= 8.0
    return h, np.transpose(acc, (0, 2, 1, 3))


def project_symmetry(h, eris, symm):
    """Zero the integrals that break the abelian point-group symmetry."""
    g = np.asarray(symm)
    h = np.where(g[:, None] == g[None, :], h, 0.0)
    allowed = (
        g[:, None, None, None] ^ g[None, :, None, None]
        ^ g[None, None, :, None] ^ g[None, None, None, :]
    ) == 0
    return h, np.where(allowed, eris, 0.0)


def make_system(n_orb, n_elec, symm=None, seed=0, scale_two=0.15,
                device=None) -> mol.MolecularHamiltonian:
    rng = np.random.default_rng(seed)
    h, eris = random_symmetric_integrals(rng, n_orb, scale_two=scale_two)
    if symm is None:
        symm = np.zeros(n_orb, np.int64)
    h, eris = project_symmetry(h, eris, symm)
    return mol.MolecularHamiltonian(
        hcore=torch.as_tensor(h, device=device),
        eris=torch.as_tensor(np.ascontiguousarray(eris), device=device),
        symm=torch.as_tensor(np.asarray(symm, np.int64), device=device),
        n_orb=n_orb,
        n_elec=n_elec,
    )


def n2_ccpvdz_like(seed=0, device=None) -> mol.MolecularHamiltonian:
    """N2/cc-pVDZ-sized system: 28 spatial orbitals, 14 electrons, D2h irrep
    distribution (ag 7, b1u 7, b2u/b3u/b2g/b3g 3 each, b1g/au 1 each)."""
    symm = np.array(
        [0] * 7 + [5] * 7 + [2] * 3 + [3] * 3 + [6] * 3 + [7] * 3 + [1] + [4],
        np.int64,
    )
    return make_system(28, 14, symm=symm, seed=seed, scale_two=0.08,
                       device=device)
