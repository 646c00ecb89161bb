"""frisys_hh: systematic FRI with a two-level factorized compression of the
Hubbard-Holstein Hamiltonian.

Counterpart of ``fries_tpu/drivers/frisys_hh.py``.  Each
step's off-diagonal spawn is two ``comp_sub`` levels (the comp_sub emission
kernel on the card for both) and a finalization:

1. level 1 splits each determinant's |v| between the hop channel (weight
   t) and the phonon channel (weight g): K = 2 weighted rows with
   unnormalized sub-weights, so the surviving values approximate |v| |H|;
2. level 2 divides each channel uniformly over its branches, K = 1 rows
   whose parents are all uniform: the allowed hops, or 2 * n_elec
   (electron, lower / raise) pairs, so a doubly occupied site gets its
   factor n_i; the value is multiplied by the branch count first;
3. finalize: the branch's target, the -1 of the hops and the sqrt(ph)
   factors of the phonons, the parent's sign, sentinel keys where the
   amplitude is zero.

The levels consume the uniforms ``rns[0]`` and ``rns[1]`` of the step.  As
in the reference, the levels' overflow flags are not reported: each level
places at most ``matr_samp`` samples in ``spawn_cap`` slots.  With a
``shards`` handle the two levels compress over the ranks with global
budgets, as the reference passes ``axis_name`` to them; like the reference,
this module has no ``build_sharded``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from fries_tpu_torch import compress, dets, profiling
from fries_tpu_torch.drivers import frifull_hh, power
from fries_tpu_torch.drivers.frisys import _at, _rank_to_index
from fries_tpu_torch.ops import hubbard as hub

F64 = torch.float64


@dataclass(frozen=True)
class FrisysHHConfig:
    eps: float
    vec_nonz: int
    matr_samp: int          # matrix budget
    capacity: int
    spawn_cap: int
    init_thresh: float = 0.0
    target_norm: float = 0.0
    shift_interval: int = 10
    shift_damping: float = 0.05
    axis_name: str | None = None   # the reference's mesh axis (unused here)
    n_shards: int = 1
    exchange_cap: int = 0

    def power(self) -> power.PowerConfig:
        return power.PowerConfig(
            eps=self.eps, target_nonz=self.vec_nonz, capacity=self.capacity,
            init_thresh=self.init_thresh, target_norm=self.target_norm,
            shift_interval=self.shift_interval, shift_damping=self.shift_damping,
            n_shards=self.n_shards, exchange_cap=self.exchange_cap)


@profiling.spanned("fries.hh.level1")
def level_one(absv, chan_w, m_samp: int, rn, s_cap: int, shards=None):
    """Level 1: each parent's |v| over the (t, g) channel row.  Returns
    (values, parent, is_phonon, live) of the ``s_cap`` slots."""
    c = absv.shape[0]
    dev = absv.device
    val, parent, sub, _, _ = compress.comp_sub(
        absv, torch.zeros(c, dtype=torch.int64, device=dev), chan_w.expand(c, 2),
        torch.ones((c, 2), dtype=torch.bool, device=dev), m_samp, rn, s_cap, shards=shards)
    live = parent >= 0
    return val, torch.where(live, parent, 0), (sub == 1) & live, live


@profiling.spanned("fries.hh.level2")
def level_two(ham: hub.HubbardHolstein, keys, val, det_idx, is_ph, live, from_bit, to_bit,
              m_samp: int, rn, s_cap: int, shards=None):
    """Level 2: each slot's value times its branch count, divided
    uniformly over the allowed hops or the 2 n_elec phonon branches.
    Returns (values, determinant index, is_phonon, live, branch)."""
    dev = keys.device
    n_hops = hub.hops_allowed(ham, hub.rows(ham, keys[det_idx]), from_bit, to_bit).sum(-1)
    ndiv2 = torch.where(is_ph, 2 * ham.n_elec, n_hops.clamp_min(1))
    val2 = torch.where(live & (is_ph | (n_hops > 0)), val * ndiv2, 0.0)
    val, parent, sub, _, _ = compress.comp_sub(
        val2, ndiv2, torch.zeros((s_cap, 1), dtype=F64, device=dev),
        torch.zeros((s_cap, 1), dtype=torch.bool, device=dev), m_samp, rn, s_cap,
        shards=shards)
    live = parent >= 0
    pidx = torch.where(live, parent, 0)
    return (val, det_idx[pidx], is_ph[pidx] & live, live, torch.where(live, sub, 0))


@profiling.spanned("fries.finalize")
def finalize(ham: hub.HubbardHolstein, keys, vals, occ, h_fac, val, det_idx, is_ph, live,
             branch, from_bit, to_bit):
    """The sampled branches' targets and amplitudes: (words, amps), the
    sentinel key where the amplitude is zero."""
    n, n_elec = ham.n_sites, ham.n_elec
    s_keys = keys[det_idx]
    s_bits = hub.rows(ham, s_keys)
    sign = torch.sign(vals[det_idx])

    # hops: the branch-th allowed hop
    hop_col, hop_found = _rank_to_index(hub.hops_allowed(ham, s_bits, from_bit, to_bit), branch)
    col = hop_col.clamp(0, from_bit.shape[0] - 1)
    hop_bits = hub.hop(ham, s_bits, from_bit[col], to_bit[col])
    hop_amp = torch.where(~is_ph & live & hop_found, h_fac * (-1.0) * val * sign, 0.0)

    # phonons: branch = electron index + n_elec * (0 = lower, 1 = raise)
    raise_ = branch >= n_elec
    site = _at(occ[det_idx], branch % n_elec) % n
    ph_at = _at(hub.phonon_nums(ham, s_keys), site)
    ph_ok = is_ph & ((~raise_ & (ph_at > 0)) | (raise_ & (ph_at + 1 <= ham.max_ph)))
    new_num = torch.where(raise_, ph_at + 1, ph_at - 1).clamp(0, ham.max_ph)
    ph_bits = hub.set_counter(ham, s_bits, site, new_num) if ham.ph_bits else s_bits
    sqrt_fac = torch.sqrt(torch.where(raise_, ph_at + 1, ph_at.clamp_min(1)).to(F64))
    ph_amp = torch.where(ph_ok, h_fac * val * sign * sqrt_fac, 0.0)

    amps = torch.where(is_ph, ph_amp, hop_amp)
    words = hub.to_words(ham, hub.select(ham, is_ph, ph_bits, hop_bits))
    return torch.where((amps != 0)[:, None], words, dets.invalid_det(ham.n_words, keys.device)), amps


def make_spawner(ham: hub.HubbardHolstein, cfg: FrisysHHConfig, e_ref=None, device=None,
                 shards=None):
    """The compressed H application, ``spawn(keys, vals, h_fac, rns) ->
    (words, amps, ini)`` in the power core's interface: :func:`level_one`,
    :func:`level_two`, :func:`finalize`.  ``e_ref`` is unused, as in the
    reference (the diagonal carries it).  ``shards``: the levels compress
    over these ranks."""
    from_bit, to_bit = hub.hop_tensors(ham.n_sites, torch.device(device or "cpu"))
    chan_w = torch.tensor([[ham.t, ham.g]], dtype=F64, device=device)

    @profiling.spanned("fries.spawn")
    def spawn(keys, vals, h_fac, rns):
        occ = hub.occ_list(ham, keys)
        val, det_idx, is_ph, live = level_one(vals.abs(), chan_w, cfg.matr_samp, rns[0],
                                              cfg.spawn_cap, shards)
        val, det_idx, is_ph, live, branch = level_two(
            ham, keys, val, det_idx, is_ph, live, from_bit, to_bit, cfg.matr_samp,
            rns[1], cfg.spawn_cap, shards)
        words, amps = finalize(ham, keys, vals, occ, h_fac, val, det_idx, is_ph, live, branch,
                               from_bit, to_bit)
        return words, amps, vals[det_idx].abs() >= cfg.init_thresh

    return spawn


def build(ham: hub.HubbardHolstein, e_ref: float, cfg: FrisysHHConfig, seed: int,
          init_val: float = 100.0, device=None):
    """Returns (step, run_steps, state, aux) on ``device``, as
    :func:`fries_tpu_torch.drivers.frifull_hh.build` does."""
    neel = frifull_hh.neel_state(ham, device)
    spawn = make_spawner(ham, cfg, e_ref, device=neel.device)
    step, run_steps = power.make_stepper(
        spawn, lambda keys: hub.diag_matrel(ham, keys) - e_ref, cfg.power(),
        estimator="direct")
    aux = {**frifull_hh.estimator_aux(ham, neel, e_ref), "spawn": spawn}
    return step, run_steps, frifull_hh.start_state(ham, cfg.capacity, neel, seed, init_val), aux
