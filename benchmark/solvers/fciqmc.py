"""Initiator FCIQMC with integer walkers and the heat-bath distribution: the
program's step is the ``step`` of ``fries_tpu_torch.drivers.fciqmc.build``,
the reference's is :mod:`benchmark.reference.fciqmc`'s.

The cell file's ``params`` are the ``FciqmcConfig`` fields;
``init_walkers`` start on HF.  Both sides draw from the key tree of the
seed on the device (the program's ``rng.KeyTree`` and the reference's copy
of its generator), so they draw the same numbers.
"""

from __future__ import annotations

import torch


class Program:
    def __init__(self, system, cell, seed, device):
        from fries_tpu_torch.drivers import fciqmc
        from fries_tpu_torch.ops import molecule

        ham = molecule.MolecularHamiltonian(hcore=system.hcore, eris=system.eris,
                                            symm=system.symm, n_orb=system.n_orb,
                                            n_elec=system.n_elec)
        cfg = fciqmc.FciqmcConfig(distribution="HB", integer_walkers=True, **cell["params"])
        self._step, _, self.state, aux = fciqmc.build(ham, cfg, seed=seed,
                                                      init_walkers=cell["init_walkers"])
        self.est = (aux["num_keys"], aux["num_vals"], aux["den_keys"], aux["den_vals"],
                    aux["ref_key"])

    def advance(self, state):
        """(new state, metrics, None: the draws are the state's key tree's)."""
        new, metrics = self._step(state, *self.est)
        return new, metrics, None


class Reference:
    def __init__(self, system, cell, seed, device):
        from benchmark.reference import fciqmc, rng
        from benchmark.reference.system import System

        self.sys = System(system.hcore, system.eris, system.symm, system.n_orb,
                          system.n_elec)
        self.fciqmc = fciqmc.FCIQMC(self.sys, cell["params"], cell["init_walkers"],
                                    rng.KeyTree(seed, device))

    def start(self):
        """(columns, values, shift, last norm) of the reference's initial state."""
        return self.fciqmc.start()

    def read(self, snap: dict):
        return self.sys.read(snap)

    def advance(self, state, iterat: int, _u):
        """One step from ``state`` (as :meth:`start` gives it): (columns,
        values, metrics)."""
        return self.fciqmc.step(*state, iterat)
