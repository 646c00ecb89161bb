"""Systematic HB-PP FCI-FRI: the program's step is the ``step`` that
``fries_tpu_torch.drivers.frisys.build`` returns (``power.make_stepper``),
the reference's is :mod:`benchmark.reference.fri`'s.

The cell file's ``params`` are the ``FrisysConfig`` fields; ``init_val`` is
HF's starting value.  Each step takes the seven uniforms of the systematic
step (six for the spawner's rounds, one for the vector's compression),
drawn from the seed's stream, and both sides get the same ones.
"""

from __future__ import annotations

import numpy as np
import torch

STREAM = 1   # the uniforms' stream of the seed


class Program:
    def __init__(self, system, cell, seed, device):
        from fries_tpu_torch.drivers import frisys
        from fries_tpu_torch.ops import molecule

        ham = molecule.MolecularHamiltonian(hcore=system.hcore, eris=system.eris,
                                            symm=system.symm, n_orb=system.n_orb,
                                            n_elec=system.n_elec)
        cfg = frisys.FrisysConfig(**cell["params"])
        self._step, _, self.state, aux = frisys.build(ham, cfg, seed=seed % 2**63,
                                                      init_val=cell["init_val"])
        self.est = (aux["num_keys"], aux["num_vals"], aux["den_keys"], aux["den_vals"],
                    aux["ref_key"])
        self.draws = np.random.default_rng([seed, STREAM])

    def advance(self, state):
        """(new state, metrics, the step's uniforms)."""
        u = self.draws.random(7)
        new, metrics = self._step(state, *self.est, rns=u[:6], rn_vec=u[6])
        return new, metrics, u


class Reference:
    def __init__(self, system, cell, seed, device):
        from benchmark.reference import fri
        from benchmark.reference.system import System

        self.sys = System(system.hcore, system.eris, system.symm, system.n_orb,
                          system.n_elec)
        self.fri = fri.FRI(self.sys, cell["params"], cell["init_val"])

    def start(self):
        """(columns, values, shift, last norm) of the reference's initial state."""
        return self.fri.start()

    def read(self, snap: dict):
        return self.sys.read(snap)

    def advance(self, state, iterat: int, u):
        """One step from ``state`` (as :meth:`start` gives it) with the
        uniforms ``u``: (columns, values, metrics)."""
        return self.fri.step(*state, iterat, u[:6], u[6])
