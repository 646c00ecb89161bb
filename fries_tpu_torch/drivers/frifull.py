"""frifull_mol: exact-Hamiltonian FRI power method for molecules.

Counterpart of ``fries_tpu/drivers/frifull.py``: the exact
off-diagonal spawner (:func:`fries_tpu_torch.ops.molecule.exact_offdiag_batch`)
bound to the power core (:mod:`fries_tpu_torch.drivers.power`).  A
deterministic full H * v each iteration, systematic vector compression, the
HF diagonal as the energy origin and the before/after projected-energy
estimator.  With ``cfg.batch`` set, the step spawns and merges ``batch``
rows at a time, so the candidate stream (kept determinants x template
excitations) never exists as a whole; each chunk's merge goes through the
sorted-merge kernel on the card.  With ``cfg.batch`` unset the whole stream
is spawned at once and merged once.  :func:`build_sharded` runs one rank of
a hash-sharded world: the whole stream is spawned (``batch`` rows at a
time), exchanged and merged once, as the reference's sharded step does.
"""

from __future__ import annotations

import torch

from fries_tpu_torch import dets, parallel
from fries_tpu_torch.drivers import frisys, power
from fries_tpu_torch.ops import molecule as mol
from fries_tpu_torch.ops import time_reversal as tr_mod
from fries_tpu_torch.runtime import arena as ar

F64 = torch.float64
FrifullConfig = power.PowerConfig


def build(ham: mol.MolecularHamiltonian, cfg: power.PowerConfig, seed: int,
          init_val: float = 100.0, spin_parity: int = 0, shards=None):
    """Returns (step, run_steps, state, aux) on ``ham``'s device; ``aux``
    holds the HF trial vector, the reference key, ``e_ref`` (the HF diagonal
    energy) and the exact spawner of one chunk (``aux["spawn"]``).

    ``spin_parity`` in {0, +1, -1}: 0 = no time-reversal folding; otherwise
    the vector lives on the spin-flip canonical representatives of that
    sector (:mod:`fries_tpu_torch.ops.time_reversal`).  ``shards``: see
    :func:`build_sharded`."""
    dev = ham.device
    tmpl = mol.ExcitationTemplate.build(ham.n_orb, ham.n_elec)
    hf_words, hf_occ, hf_en = mol.hf_reference(ham)
    hf_en = float(hf_en)

    def spawn_one(keys, vals, h_fac, rns):
        occ = dets.occ_list(keys, ham.n_bits, ham.n_elec)
        new_words, amps = mol.exact_offdiag_batch(ham, tmpl, keys, occ, vals, h_fac)
        nc = amps.shape[1]
        flat_words = new_words.reshape(-1, ham.n_words)
        flat_amps = amps.reshape(-1)
        if spin_parity:
            flat_words, flat_amps = tr_mod.adjust_exact(
                ham, keys.repeat_interleave(nc, 0), occ.repeat_interleave(nc, 0),
                flat_words, flat_amps, spin_parity,
                scale=vals.repeat_interleave(nc) * h_fac)
        return flat_words, flat_amps, power.per_parent_ini(vals, cfg.init_thresh, nc)

    # cfg.batch set: one spawn and one merge per chunk (spawn_chunk_fn);
    # unset: one spawn of the whole prefix and one merge (spawn_fn)
    diag_fn = frisys.make_diag_fn(ham, hf_en, spin_parity)
    if shards is not None:
        step, run_steps = power.make_stepper(
            power.chunked(spawn_one, cfg.capacity, cfg.batch, ham.n_words), diag_fn, cfg,
            shards=shards)
    else:
        step, run_steps = power.make_stepper(
            spawn_one, diag_fn, cfg, spawn_chunk_fn=spawn_one if cfg.batch else None)

    if spin_parity:
        _, forbid = tr_mod.tr_diag(ham, hf_words[None], hf_occ[None], spin_parity)
        if bool(forbid[0]):
            raise ValueError("the HF determinant is spin-flip self-conjugate; start "
                             "the odd sector from an open-shell determinant")
    init_rows = torch.tensor([[init_val], [0.0]], dtype=F64, device=dev)
    if shards is not None:
        a = parallel.distribute_rows(hf_words[None].cpu(), init_rows.cpu(), shards.size,
                                     cfg.capacity, shards.rank, dev)
    else:
        a = ar.from_unsorted(ar.make(cfg.capacity, ham.n_words, 2, device=dev),
                             hf_words[None], init_rows)
    aux = {
        "e_ref": hf_en,
        "num_keys": hf_words[None],
        "num_vals": torch.ones(1, dtype=F64, device=dev),
        "den_keys": hf_words[None],
        "den_vals": torch.ones(1, dtype=F64, device=dev),
        "ref_key": hf_words,
        "spawn": spawn_one,
    }
    return step, run_steps, power.fresh_state(a, seed), aux


def build_sharded(ham: mol.MolecularHamiltonian, cfg: power.PowerConfig, seed: int, shards,
                  init_val: float = 100.0, spin_parity: int = 0):
    """Hash-sharded exact-H FRI on this rank (``shards``, ``cfg.n_shards``
    ranks): deterministic given its budgets, so a sharded and a single run
    agree to round-off when the compression keeps everything.
    ``cfg.capacity`` is per rank.  Returns (step, run_steps, state, aux) as
    :func:`build` does, for this rank."""
    return build(ham, cfg, seed, init_val=init_val, spin_parity=spin_parity, shards=shards)
