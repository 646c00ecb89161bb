"""The benchmark's inputs: a molecular system's integrals made from a seed.

The generator is that of the port's ``synth.py`` (random Hermitian
one-electron integrals with a spread diagonal, random ERIs averaged over
the eight real-orbital permutations, then the integrals that break the
point group zeroed), drawn on the device with one ``torch.Generator`` in a
few large calls.  The configuration file fixes their seed, so that every
run of a cell steps the same system and ``--seed`` draws the steps' random
numbers alone.  The same tensors go to the program and to the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

# the eight index permutations of real-orbital ERIs (chemist notation)
PERMS = ((0, 1, 2, 3), (1, 0, 3, 2), (2, 3, 0, 1), (3, 2, 1, 0),
         (1, 0, 2, 3), (0, 1, 3, 2), (3, 2, 0, 1), (2, 3, 1, 0))


@dataclass(frozen=True)
class System:
    hcore: torch.Tensor   # (n, n) f64
    eris: torch.Tensor    # (n, n, n, n) f64, physicist notation <pq|rs>
    symm: torch.Tensor    # (n,) int64 irreps, XOR labels
    n_orb: int
    n_elec: int

    def to(self, device) -> "System":
        return System(self.hcore.to(device), self.eris.to(device), self.symm.to(device),
                      self.n_orb, self.n_elec)


def integrals(n_orb: int, symm, seed: int, scale_two: float, diag_spread: float,
              offdiag: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(hcore, eris) in f64 on ``device`` from ``seed``; the irreps ``symm``
    are projected."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    f64 = torch.float64
    h = torch.randn((n_orb, n_orb), generator=gen, dtype=f64, device=device) * offdiag
    h = (h + h.T) / 2 + torch.diag(torch.linspace(-diag_spread, diag_spread, n_orb,
                                                  dtype=f64, device=device))
    v = torch.randn((n_orb,) * 4, generator=gen, dtype=f64, device=device) * scale_two
    acc = torch.zeros_like(v)
    for perm in PERMS:
        acc += v.permute(perm)
    eris = (acc / 8.0).permute(0, 2, 1, 3).contiguous()
    g = torch.as_tensor(symm, dtype=torch.int64, device=device)
    h = torch.where(g[:, None] == g[None, :], h, 0.0)
    allowed = (g[:, None, None, None] ^ g[None, :, None, None]
               ^ g[None, None, :, None] ^ g[None, None, None, :]) == 0
    return h, torch.where(allowed, eris, 0.0)


def make_system(config: dict, device) -> System:
    """The configuration's system (``n_orb``, ``n_elec``, ``symm`` and its
    ``integrals``: their seed and parameters)."""
    ints = config["integrals"]
    h, eris = integrals(config["n_orb"], config["symm"], ints["seed"], ints["scale_two"],
                        ints["diag_spread"], ints["offdiag"], device)
    return System(h, eris, torch.as_tensor(config["symm"], dtype=torch.int64, device=device),
                  int(config["n_orb"]), int(config["n_elec"]))
