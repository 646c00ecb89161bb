"""Time-reversal (spin-flip) symmetry folding.

Counterpart of ``fries_tpu/ops/time_reversal.py``.  For MS = 0 systems the
Hamiltonian commutes with the spin flip T (alpha <-> beta), so determinants
fold onto spin-flip canonical representatives and the iteration runs in the
even (+1) or odd (-1) sector.

Symmetrized basis: for i != T(i), |i;p> = (|i> + p |T(i)>) / sqrt(2); for a
self-conjugate i, |i;+> = |i>.  A vector is stored on canonical
representatives (the smaller of i and T(i) in the arena's key order); matrix
elements between symmetrized states combine the direct and the spin-flipped
excitation with sqrt(2) / 2 norm factors and the parity p.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fries_tpu_torch import dets
from fries_tpu_torch.ops import heat_bath as hb
from fries_tpu_torch.ops import molecule as mol

F64 = torch.float64


def _pick(cond, a: float, b: float):
    """f64 ``a`` where ``cond`` else ``b`` (two Python scalars would give
    f32)."""
    return torch.where(cond, torch.full((), a, dtype=F64, device=cond.device), b)


def flip(ham: mol.MolecularHamiltonian, words):
    return dets.flip_spins(words, ham.n_orb, ham.n_bits)


def canonicalize(ham: mol.MolecularHamiltonian, words, spin_parity: int):
    """(canonical_words, factor, self_conj): the smaller of (det, T det); the
    amplitude factor is ``spin_parity`` where the flip was taken."""
    flipped = flip(ham, words)
    take_flip = dets.det_less(flipped, words)
    canon = torch.where(take_flip[..., None], flipped, words)
    factor = _pick(take_flip, float(spin_parity), 1.0)
    return canon, factor, dets.det_eq(words, flipped)


def _excitation_between(ham: mol.MolecularHamiltonian, from_words, to_words):
    """The (at most double) excitation connecting two determinants:
    dict(o1, o2, u1, u2, n_diff); o* occupied in ``from`` only, u* in ``to``
    only (ascending, missing ones ``n_bits``); ``n_diff`` counts the
    orbitals that leave."""
    fb = dets.unpack_bits(from_words, ham.n_bits)
    tb = dets.unpack_bits(to_words, ham.n_bits)
    removed = fb & ~tb
    o_pos = dets.occ_list_from_bits(removed, 2)
    u_pos = dets.occ_list_from_bits(tb & ~fb, 2)
    return {"o1": o_pos[..., 0], "o2": o_pos[..., 1],
            "u1": u_pos[..., 0], "u2": u_pos[..., 1], "n_diff": removed.sum(-1)}


def _clipped(ham, ex):
    """The excitation's four orbitals clipped into range, and whether it is
    an allowed single / an allowed double by symmetry."""
    n_orb, top = ham.n_orb, ham.n_bits - 1
    o1, o2, u1, u2 = (ex[k].clamp(0, top) for k in ("o1", "o2", "u1", "u2"))
    g = [ham.symm[x % n_orb] for x in (o1, o2, u1, u2)]
    sing = (ex["n_diff"] == 1) & (g[0] == g[2])
    doub = (ex["n_diff"] == 2) & ((g[0] ^ g[1] ^ g[2] ^ g[3]) == 0)
    return o1, o2, u1, u2, sing, doub


def _element_between(ham, from_words, from_occ, ex):
    """Sign-carrying H element of the excitation ``ex`` (0 if it moves more
    than two electrons or is forbidden by symmetry)."""
    o1, o2, u1, u2, sing, doub = _clipped(ham, ex)
    smel = mol.sing_matr_el(ham, o1, u1, from_occ)
    _, ssign = dets.single_parity(from_words, o1, u1)
    dmel = mol.doub_matr_el(ham, o1, o2, u1, u2)
    _, dsign = dets.double_parity(from_words, o1, o2, u1, u2)
    return torch.where(sing, smel * ssign, torch.where(doub, dmel * dsign, 0.0))


def adjust_exact(ham: mol.MolecularHamiltonian, parent_words, parent_occ,
                 new_words, mel, spin_parity: int, scale=None):
    """Fold an exact spawn (parent -> new, amplitude ``mel``) onto the
    symmetrized basis.  The bare matrix element is what folds; when ``mel``
    already carries the parent's value and the step factor, pass them as the
    per-row ``scale`` so that the reverse excitation's element is scaled to
    match.  Returns (target_words, adjusted_mel); dropped spawns get 0."""
    if scale is None:
        scale = torch.ones_like(mel)
    flipped_parent = flip(ham, parent_words)
    norm = _pick(dets.det_eq(parent_words, flipped_parent), math.sqrt(2.0), 1.0)

    flipped_new = flip(ham, new_words)
    # a target equal to the parent's conjugate is diagonal in the folded
    # basis (the death step's): dropped
    drop_conj = dets.det_eq(flipped_new, parent_words)
    new_self = dets.det_eq(new_words, flipped_new)
    # self-conjugate target: both excitations coincide
    mel_self = torch.zeros_like(mel) if spin_parity == -1 else 2.0 * mel

    # generic target: add the reverse (spin-flipped) excitation's element;
    # the norm doubles where that excitation is allowed
    ex = _excitation_between(ham, parent_words, flipped_new)
    *_, sing, doub = _clipped(ham, ex)
    rev_allowed = sing | doub
    rev_mel = _element_between(ham, parent_words, parent_occ, ex)
    mel_gen = mel + torch.where(rev_allowed, rev_mel * spin_parity * scale, 0.0)
    norm_gen = norm * _pick(rev_allowed, 2.0, 1.0)

    mel_out = torch.where(new_self, mel_self, mel_gen)
    norm_out = torch.where(new_self, norm * math.sqrt(2.0), norm_gen)
    take_flip = dets.det_less(flipped_new, new_words)
    target = torch.where(take_flip[..., None], flipped_new, new_words)
    mel_out = torch.where(take_flip, mel_out * spin_parity, mel_out) / norm_out
    return target, torch.where(drop_conj, 0.0, mel_out)


def adjust_sampled(ham: mol.MolecularHamiltonian, tens, symm, counts,
                   n_occ_allowed, parent_words, parent_occ, occ_bits,
                   new_words, mel_signed, sel_w, spin_parity: int,
                   p_doub, unnorm: bool):
    """Fold a *sampled* excitation onto the symmetrized basis.  Unlike the
    exact fold, the estimator must account for the reverse (spin-flipped)
    excitation being sampled on its own: its selection weight is added, so
    either sampled path contributes the full folded element over the union
    probability.

    ``counts`` (B, 8, 2) unoccupied orbitals per (irrep, spin);
    ``n_occ_allowed`` (B,) electrons with any single; ``mel_signed`` (B,)
    the signed H element; ``sel_w`` (B,) the direct selection weight
    (p_doub * tot for doubles, (1 - p_doub) / (n_occ * n_virt) for singles).

    Returns (target_words, mel_out, w_out, keep): amp = value * mel_out /
    w_out for kept rows; the target is the canonical representative."""
    n_orb = ham.n_orb
    flipped_parent = flip(ham, parent_words)
    norm = _pick(dets.det_eq(parent_words, flipped_parent), math.sqrt(2.0), 1.0)
    flipped_new = flip(ham, new_words)
    drop_conj = dets.det_eq(flipped_new, parent_words)
    new_self = dets.det_eq(new_words, flipped_new)

    # the reverse excitation parent -> T(new)
    ex = _excitation_between(ham, parent_words, flipped_new)
    o1, o2, u1, u2, rev_sing, rev_doub = _clipped(ham, ex)
    rev_allowed = (rev_sing | rev_doub) & ~new_self
    rev_mel = _element_between(ham, parent_words, parent_occ, ex)

    # its selection weight under the same distribution
    if unnorm:
        rev_tot_d = hb.unnorm_weight(tens, n_orb, o1, o2, u1, u2)
    else:
        rev_tot_d = hb.norm_weight(tens, n_orb, ham.n_elec, symm, None, parent_occ,
                                   occ_bits, o1, o2, u1, u2)
    key16 = symm[u1 % n_orb] * 2 + o1 // n_orb
    n_virt_rev = counts.reshape(counts.shape[0], 16).gather(-1, key16[:, None])[:, 0]
    rev_w_s = (1.0 - p_doub) / (n_occ_allowed.to(torch.float64)
                                * n_virt_rev.to(torch.float64)).clamp_min(1e-300)
    rev_w = torch.where(rev_sing, rev_w_s, rev_tot_d * p_doub)

    mel_out = mel_signed + torch.where(rev_allowed, rev_mel * float(spin_parity), 0.0)
    w_out = sel_w + torch.where(rev_allowed, rev_w, 0.0)
    # self-conjugate target: both excitations coincide (twice the element,
    # sqrt(2) more norm); it does not exist in the odd sector
    mel_out = torch.where(new_self, 2.0 * mel_signed, mel_out)
    norm = norm * _pick(new_self, math.sqrt(2.0), 1.0)
    keep = ~drop_conj
    if spin_parity == -1:
        keep = keep & ~new_self

    take_flip = dets.det_less(flipped_new, new_words)
    target = torch.where(take_flip[..., None], flipped_new, new_words)
    mel_out = torch.where(take_flip, mel_out * float(spin_parity), mel_out)
    return target, mel_out / norm, w_out, keep


def tr_diag(ham: mol.MolecularHamiltonian, words, occ, spin_parity: int):
    """Folded-basis diagonal adjustment:

      <i;p| H |i;p> = H_ii + p <i|H|T(i)>   where i and T(i) are doubly
      connected (exactly one alpha / beta open-shell swap); self-conjugate
      determinants do not exist in the odd sector.

    Returns (delta, forbid): the caller adds ``delta`` to the bare diagonal
    and masks the determinants with ``forbid`` True."""
    n_orb = ham.n_orb
    half = ham.n_elec // 2
    alpha = occ[..., :half]                 # spatial orbitals of each spin
    beta = occ[..., half:] - n_orb
    in_beta = (alpha[..., :, None] == beta[..., None, :]).any(-1)
    in_alpha = (beta[..., :, None] == alpha[..., None, :]).any(-1)
    n_open_a = (~in_beta).sum(-1)
    # the open-shell spatial orbitals x (alpha only) and y (beta only)
    x = torch.where(~in_beta, alpha, 0).sum(-1)
    y = torch.where(~in_alpha, beta, 0).sum(-1)
    o1, o2, u1, u2 = x, y + n_orb, y, x + n_orb
    mel = mol.doub_matr_el(ham, o1, o2, u1, u2)
    _, sign = dets.double_parity(words, o1, o2, u1, u2)
    delta = torch.where(n_open_a == 1, spin_parity * mel * sign, 0.0)
    forbid = (n_open_a == 0) & (spin_parity == -1)
    return delta, forbid


def fold_vector_host(ham: mol.MolecularHamiltonian, keys, vals, spin_parity: int):
    """Fold a sparse vector onto canonical representatives on the host:
    canonical = min(det, T det); the amplitude picks up the parity where the
    flip is canonical and 1 / sqrt(2) for entries that are not
    self-conjugate; equal canonical keys merge (in order of first
    appearance); self-conjugate entries are dropped in the odd sector.
    Returns (keys (M, W) int64, vals (M,)) numpy arrays."""
    keys = np.asarray(keys).astype(np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    keys, vals = keys[vals != 0], vals[vals != 0]
    words = torch.as_tensor(keys)
    flipped = dets.flip_spins(words, ham.n_orb, ham.n_bits)
    self_conj = dets.det_eq(words, flipped).numpy()
    flip_less = dets.det_less(flipped, words).numpy()
    flipped = flipped.numpy()
    merged: dict = {}
    for i in range(keys.shape[0]):
        v = vals[i]
        if self_conj[i]:
            if spin_parity == -1:
                continue
            canon = keys[i]
        else:
            v = v / np.sqrt(2.0)
            if flip_less[i]:
                canon, v = flipped[i], v * spin_parity
            else:
                canon = keys[i]
        tk = tuple(int(x) for x in canon)
        merged[tk] = merged.get(tk, 0.0) + v
    if not merged:
        return np.zeros((0, keys.shape[1]), np.int64), np.zeros((0,), np.float64)
    return np.asarray(list(merged.keys()), np.int64), np.asarray(list(merged.values()))
