"""Real-molecule Hamiltonians built from geometry: AO integrals, RHF and
the MO transform on the device.

Counterpart of ``tools/real_systems.py``, with the same geometries, bases
and frozen cores:

  h2o_ccpvdz()        H2O at r = 1.84345 a0, 110.6 degrees, cc-pVDZ, all electrons
  n2_ccpvdz()         N2 at r = 2.068 a0 (the flagship), cc-pVDZ, 4 frozen
  n2_stretched()      N2 at r = 4.2 a0, cc-pVDZ, 4 frozen
  ne_augccpvdz()      Ne, aug-cc-pVDZ, 1s frozen
  ne_ccpvqz()         Ne, cc-pVQZ (the re-derived basis), 1s frozen

Every system is built afresh on the ``device`` given (default the card);
nothing is cached on disk.  ``build(name, device)`` also returns the SCF's
information (energies, irreps, MO coefficients, overlap, seconds).
"""

from __future__ import annotations

import numpy as np

from fries_tpu_torch import scf


def _h2o_centers():
    r, th = 1.84345, np.deg2rad(110.6)
    y, z = r * np.sin(th / 2), r * np.cos(th / 2)
    return np.array([[0.0, 0.0, 0.0], [0.0, y, z], [0.0, -y, z]])


def _n2_centers(r):
    return np.array([[0.0, 0.0, -r / 2], [0.0, 0.0, r / 2]])


# name: (symbols, centers (bohr), basis, frozen electrons)
SYSTEMS = {
    "h2o_ccpvdz": (("O", "H", "H"), _h2o_centers(), "cc-pvdz", 0),
    "n2_ccpvdz": (("N", "N"), _n2_centers(2.068), "cc-pvdz", 4),
    "n2_stretched": (("N", "N"), _n2_centers(4.2), "cc-pvdz", 4),
    "ne_augccpvdz": (("Ne",), np.zeros((1, 3)), "aug-cc-pvdz", 2),
    "ne_ccpvqz": (("Ne",), np.zeros((1, 3)), "cc-pvqz", 2),
}


def build(name: str, device="cuda"):
    """(MolecularHamiltonian, info) of system ``name`` on ``device``
    (:func:`fries_tpu_torch.scf.build_molecule`'s info)."""
    symbols, centers, basis, n_frozen = SYSTEMS[name]
    return scf.build_molecule(symbols, centers, basis=basis, n_frozen=n_frozen, device=device)


def h2o_ccpvdz(device="cuda"):
    return build("h2o_ccpvdz", device)[0]


def n2_ccpvdz(device="cuda"):
    return build("n2_ccpvdz", device)[0]


def n2_stretched(device="cuda"):
    """Stretched N2 (r = 4.2 a0), cc-pVDZ, 4 frozen."""
    return build("n2_stretched", device)[0]


def ne_augccpvdz(device="cuda"):
    return build("ne_augccpvdz", device)[0]


def ne_ccpvqz(device="cuda"):
    return build("ne_ccpvqz", device)[0]
