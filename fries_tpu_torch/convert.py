"""Carry the reference package's parameters and state into the port.

Every function takes plain numpy arrays (what ``np.asarray`` gives for the
reference package's arrays), so this module imports nothing of the reference
package: a Hamiltonian's integrals, an arena's sorted keys and value rows,
and the power state's scalars map one to one onto the port's containers.
"""

from __future__ import annotations

import numpy as np
import torch

from fries_tpu_torch.drivers import power
from fries_tpu_torch.ops import molecule as mol
from fries_tpu_torch.runtime import arena as ar

F64 = torch.float64


def hamiltonian(hcore, eris, symm, n_orb: int, n_elec: int, n_frozen: int = 0,
                device=None) -> mol.MolecularHamiltonian:
    """A ``MolecularHamiltonian`` from (hcore, eris, symm, sizes)."""
    return mol.MolecularHamiltonian(
        hcore=torch.tensor(np.asarray(hcore, np.float64), device=device),
        eris=torch.tensor(np.asarray(eris, np.float64), device=device),
        symm=torch.tensor(np.asarray(symm, np.int64), device=device),
        n_orb=int(n_orb), n_elec=int(n_elec), n_frozen=int(n_frozen))


def arena(keys, vals, n_used, device=None) -> ar.Arena:
    """An ``Arena`` from uint32 key words (C, W), value rows (R, C) and the
    occupied count."""
    return ar.Arena(
        keys=torch.tensor(np.asarray(keys).astype(np.int64), device=device),
        vals=torch.tensor(np.asarray(vals, np.float64), device=device),
        n_used=torch.tensor(np.asarray(n_used, np.int64).reshape(1), device=device))


def power_state(a: ar.Arena, en_shift, last_norm, iterat, seed: int = 0
                ) -> power.PowerState:
    """A ``PowerState`` from an arena and the scalars (en_shift, last_norm,
    iterat).  The generator is seeded with ``seed``; the reference's JAX key
    does not carry over, so tests inject the reference's uniforms."""
    state = power.fresh_state(a, seed)
    state.en_shift = torch.tensor(float(np.asarray(en_shift)), dtype=F64, device=a.device)
    state.last_norm = torch.tensor(float(np.asarray(last_norm)), dtype=F64, device=a.device)
    state.iterat = int(np.asarray(iterat))
    return state


def arena_to_numpy(a: ar.Arena):
    """(keys uint32 (C, W), vals (R, C), n_used int) of a port arena."""
    return (a.keys.cpu().numpy().astype(np.uint32), a.vals.cpu().numpy(),
            int(a.n_used.sum()))
