"""frimulti_mol: FRI with multinomial Hamiltonian compression.

Counterpart of ``fries_tpu/drivers/frimulti.py``.  Each iteration spreads
``matr_samp`` column samples over the occupied determinants on one shared
systematic grid on |v| (the grid counting of systematic vector
compression); sample slots map to their parents as FCIQMC's attempt slots
do (:func:`fries_tpu_torch.drivers.fciqmc._attempt_parents`), and each
sample draws one excitation from the near-uniform or heat-bath generators
(:mod:`fries_tpu_torch.ops.near_uniform`) and spawns

    h_fac * H_el / p_gen / p_channel / n_samples(det) * v(det) * parity
    / min(1, |v| / sampling_unit).

Death and systematic vector compression are the power core's
(:mod:`fries_tpu_torch.drivers.power`), which runs this spawner keyed: it
gets ``split(2)[0]`` of the state's key node folded with the iteration and
splits it 3 ways (grid, channel, excitations), as the reference does.  Like
the reference's, the spawner raises no flag when the samples exceed
``spawn_cap`` (the grid places ``matr_samp`` of them, and ``spawn_cap`` is
1.4 times that on the command line).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fries_tpu_torch import compress, dets, profiling, rng
from fries_tpu_torch.drivers import fciqmc, frisys, power
from fries_tpu_torch.ops import heat_bath as hb
from fries_tpu_torch.ops import molecule as mol
from fries_tpu_torch.ops import near_uniform as nu
from fries_tpu_torch.ops import ordered
from fries_tpu_torch.runtime import arena as ar

F64 = torch.float64


@dataclass(frozen=True)
class FrimultiConfig:
    eps: float
    vec_nonz: int
    matr_samp: int
    capacity: int
    spawn_cap: int          # sample slots per step (>= matr_samp + slack)
    init_thresh: float = 0.0
    target_norm: float = 0.0
    shift_interval: int = 10
    shift_damping: float = 0.05
    distribution: str = "NU"   # "NU" | "HB"

    def power(self) -> power.PowerConfig:
        return power.PowerConfig(
            eps=self.eps, target_nonz=self.vec_nonz, capacity=self.capacity,
            init_thresh=self.init_thresh, target_norm=self.target_norm,
            shift_interval=self.shift_interval, shift_damping=self.shift_damping)


def make_spawner(ham: mol.MolecularHamiltonian, syminfo: mol.SymmInfo, p_doub: float,
                 cfg: FrimultiConfig):
    """The multinomial spawner ``spawn(keys, vals, h_fac, key) -> (words,
    amps, ini)`` of the power core's keyed interface."""
    if cfg.distribution not in ("NU", "HB"):
        raise ValueError(f"unknown distribution {cfg.distribution!r}")
    dev = ham.device
    n_orb, n_elec = ham.n_orb, ham.n_elec
    n_bits = 2 * n_orb
    lookup = torch.as_tensor(syminfo.lookup, device=dev)
    symm = torch.as_tensor(syminfo.symm, device=dev)
    symm_counts = torch.as_tensor(syminfo.counts, device=dev)
    tens = hb.setup(ham) if cfg.distribution == "HB" else None
    a_cap, m_samp = cfg.spawn_cap, cfg.matr_samp
    sentinel = dets.invalid_det(ham.n_words, dev)

    @profiling.spanned("fries.spawn")
    def spawn(keys, vals, h_fac, key):
        occ = dets.occ_list(keys, n_bits, n_elec)
        absv = vals.abs()
        unit = absv.sum() / m_samp
        k_rn, k_split, k_spawn = key.split(3)
        rn = k_rn.uniform(()).to(dev)
        cum = ordered.cumsum(absv) - absv
        hits = (compress._grid_count_below(cum + absv, rn, unit)
                - compress._grid_count_below(cum, rn, unit))
        colsamp_wt = (absv / unit.clamp_min(1e-300)).clamp_max(1.0)
        parent, valid, _ = fciqmc._attempt_parents(hits, a_cap)

        p_occ = occ[parent]
        p_keys = keys[parent]
        p_bits = dets.unpack_bits(p_keys, n_bits)
        counts = hb.unocc_symm_counts(n_orb, n_elec, symm, symm_counts, p_occ)
        is_doub = k_split.uniform((a_cap,)).to(dev) < p_doub
        kd, ks = k_spawn.split(2)
        if tens is not None:
            d = nu.sample_doubles_heat_bath(kd, tens, n_orb, n_elec, symm, lookup, p_occ,
                                            p_bits)
        else:
            d = nu.sample_doubles(kd, n_orb, n_elec, symm, lookup, p_occ, p_bits, counts)
        s = nu.sample_singles(ks, n_orb, n_elec, symm, lookup, p_occ, p_bits, counts)

        base = (vals[parent] / hits[parent].clamp_min(1)
                / colsamp_wt[parent].clamp_min(1e-300))
        dmel = mol.doub_matr_el(ham, d["o1"], d["o2"], d["u1"], d["u2"])
        dwords, dsign = dets.double_parity(p_keys, d["o1"], d["o2"], d["u1"], d["u2"])
        damp = h_fac * dmel / d["prob"] / p_doub * base * dsign
        dmask = valid & is_doub & d["valid"]
        smel = mol.sing_matr_el(ham, s["o"], s["u"], p_occ)
        swords, ssign = dets.single_parity(p_keys, s["o"], s["u"])
        samp = h_fac * smel / s["prob"] / (1 - p_doub) * base * ssign
        smask = valid & ~is_doub & s["valid"]

        amps = torch.where(dmask, damp, torch.where(smask, samp, 0.0))
        words = torch.where(dmask[:, None], dwords, swords)
        words = torch.where((amps != 0)[:, None], words, sentinel)
        return words, amps, vals[parent].abs() > cfg.init_thresh

    return spawn


def build(ham: mol.MolecularHamiltonian, cfg: FrimultiConfig, seed: int,
          init_val: float = 100.0, trial=None, init_vec=None, e_ref=None):
    """frimulti on ``ham``'s device: the multinomial spawner on the power
    core with the direct estimator.  ``trial`` / ``init_vec``: (keys, vals)
    of the estimator's trial vector and the starting vector (default HF, and
    HF * ``init_val``); ``e_ref`` overrides the HF diagonal energy.  Returns
    (step, run_steps, state, aux) as :func:`fries_tpu_torch.drivers.frisys.build`
    does; the state's key node is ``rng.KeyTree(seed)`` on the device."""
    dev = ham.device
    syminfo = mol.SymmInfo.build(ham.symm.cpu().numpy())
    p_doub = frisys.hf_p_doub(ham, syminfo)
    hf_words, _, hf_en = mol.hf_reference(ham)
    hf_en = float(hf_en) if e_ref is None else float(e_ref)
    spawn = make_spawner(ham, syminfo, p_doub, cfg)
    step, run_steps = power.make_stepper(spawn, frisys.make_diag_fn(ham, hf_en), cfg.power(),
                                         estimator="direct", keyed=True)

    hf_np = hf_words.cpu().numpy()
    if trial is None:
        trial_keys, trial_vals = hf_np[None], np.ones(1)
    else:
        trial_keys = np.asarray(trial[0]).astype(np.int64)
        trial_vals = np.asarray(trial[1], np.float64)
    htrial_keys, htrial_vals = frisys.compute_htrial(ham, trial_keys, trial_vals, e_ref=hf_en)
    if init_vec is None:
        init_keys, init_vals = hf_np[None], np.array([init_val], np.float64)
    else:
        init_keys = np.asarray(init_vec[0]).astype(np.int64)
        init_vals = np.asarray(init_vec[1], np.float64)
    a = ar.from_unsorted(
        ar.make(cfg.capacity, ham.n_words, 2, device=dev), torch.as_tensor(init_keys),
        torch.as_tensor(np.stack([init_vals, np.zeros_like(init_vals)])))
    aux = {
        "e_ref": hf_en,
        "num_keys": torch.as_tensor(htrial_keys, device=dev),
        "num_vals": torch.as_tensor(htrial_vals, device=dev),
        "den_keys": torch.as_tensor(trial_keys, device=dev),
        "den_vals": torch.as_tensor(trial_vals, device=dev),
        "ref_key": hf_words,
        "p_doub": p_doub,
        "spawn": spawn,
    }
    return step, run_steps, power.fresh_state(a, seed, key=rng.KeyTree(seed, dev)), aux
