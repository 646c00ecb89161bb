"""Carry the reference package's parameters and state into the port.

Every function takes plain numpy arrays (what ``np.asarray`` gives for the
reference package's arrays), so this module imports nothing of the reference
package: a Hamiltonian's integrals, an arena's sorted keys and value rows,
and the power, FCIQMC and subspace states' scalars map one to one onto the
port's containers.  A sharded state of the reference (the stacked layout:
keys (n*C, W), vals (R, n*C), n_used (n,)) becomes one state per rank.
"""

from __future__ import annotations

import numpy as np
import torch

from fries_tpu_torch import parallel
from fries_tpu_torch.drivers import fciqmc, power, subspace
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


def power_state(a: ar.Arena, en_shift, last_norm, iterat, seed: int = 0, key=None
                ) -> power.PowerState:
    """A ``PowerState`` from an arena and the scalars (en_shift, last_norm,
    iterat).  The generator is seeded with ``seed``; the reference's JAX key
    does not carry over, so tests inject the reference's uniforms, or give a
    keyed stepper's state the reference's key tree as ``key``."""
    state = power.fresh_state(a, seed, key=key)
    state.en_shift = torch.tensor(float(np.asarray(en_shift)), dtype=F64, device=a.device)
    state.last_norm = torch.tensor(float(np.asarray(last_norm)), dtype=F64, device=a.device)
    state.iterat = int(np.asarray(iterat))
    return state


def fciqmc_state(a: ar.Arena, en_shift, last_norm, iterat, key) -> fciqmc.FciqmcState:
    """An ``FciqmcState`` from a one-row arena, the scalars (en_shift,
    last_norm, iterat) and the key tree node the run draws from
    (:class:`fries_tpu_torch.rng.KeyTree`, or in tests the reference's key
    behind the same interface)."""
    as_t = lambda x: torch.tensor(float(np.asarray(x)), dtype=F64, device=a.device)
    return fciqmc.FciqmcState(arena=a, en_shift=as_t(en_shift), last_norm=as_t(last_norm),
                              key=key, iterat=int(np.asarray(iterat)))


def subspace_state(a: ar.Arena, norm_factors, last_norms, iterat, key
                   ) -> subspace.SubspaceState:
    """A ``SubspaceState`` from an arena, the per-row norm factors and last
    norms (T,) and the iteration count.  ``key`` is the key tree node the
    run draws from (:class:`fries_tpu_torch.rng.KeyTree`, or in tests the
    reference's key behind the same interface)."""
    as_t = lambda x: torch.tensor(np.asarray(x, np.float64), device=a.device)
    return subspace.SubspaceState(arena=a, norm_factors=as_t(norm_factors),
                                  last_norms=as_t(last_norms), key=key,
                                  iterat=int(np.asarray(iterat)))


def arena_to_numpy(a: ar.Arena):
    """(keys uint32 (C, W), vals (R, C), n_used int) of a port arena."""
    return (a.keys.cpu().numpy().astype(np.uint32), a.vals.cpu().numpy(),
            int(a.n_used.sum()))


def sharded_power_state(st: dict, rank: int, seed: int = 0, key=None, device=None
                        ) -> power.PowerState:
    """Rank ``rank``'s power state of a reference sharded power state given
    as a dict of numpy arrays (``keys``, ``vals``, ``n_used``, ``en_shift``,
    ``last_norm``, ``iterat``); the scalars are replicated."""
    a = parallel.unstack(st["keys"], st["vals"], np.asarray(st["n_used"]).reshape(-1), rank,
                         device)
    return power_state(a, st["en_shift"], st["last_norm"], st["iterat"], seed, key)
