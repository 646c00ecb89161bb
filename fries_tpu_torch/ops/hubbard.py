"""The Hubbard-Holstein lattice model in the site basis.

Counterpart of ``fries_tpu/ops/hubbard.py``:

* state layout: bits 0..n-1 spin-up site occupation, bits n..2n-1 spin-down,
  then ``ph_bits`` phonon-counter bits per site from bit 2n; a 1-D open
  chain, of any width.  The bit operations work on a row form
  (:func:`rows`): up to 64 bits (two words) the row's 64-bit value in one
  int64, with shifts and masks; wider rows on their (..., W) words, a
  field read across a word boundary from the two words it touches
  (:func:`field`).  A counter may straddle a word boundary in either form;
* hops are a static candidate grid (spin x bond x direction,
  :func:`hop_grid`) with an occupancy mask.  Nearest-neighbour hops on an
  open chain never pass another electron of the same spin, so their
  fermionic sign is always +1, as in the reference;
* the diagonal is U * (doubly occupied sites) + omega * (total phonons);
* the reference-overlap estimator is a static connected set: the
  phonon-free reference state, its single hops and its one-phonon
  satellites with their matrix elements (:func:`reference_connections`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from fries_tpu_torch import dets, profiling

F64 = torch.float64


@dataclass(frozen=True)
class HubbardHolstein:
    n_sites: int
    n_elec: int
    ph_bits: int = 0
    u: float = 0.0
    omega: float = 0.0
    g: float = 0.0
    t: float = 1.0

    @property
    def n_bits(self) -> int:
        return 2 * self.n_sites + self.ph_bits * self.n_sites

    @property
    def n_words(self) -> int:
        return dets.n_words(self.n_bits)

    @property
    def max_ph(self) -> int:
        return (1 << self.ph_bits) - 1 if self.ph_bits else 0


def _bits64(words):
    """The 64-bit value of each row of (..., W <= 2) words, as int64."""
    return dets.pack_key(words) ^ dets.INT64_MIN


def _words(bits, n_words: int):
    """Inverse of :func:`_bits64`: (...,) int64 -> (..., W) words."""
    return dets.unpack_key(bits ^ dets.INT64_MIN, n_words)


def rows(ham: HubbardHolstein, words):
    """The row form of (..., W) words that the bit helpers take: the 64-bit
    value (...,) where W <= 2, else the words themselves."""
    return _bits64(words) if dets.packable(ham.n_words) else words


def to_words(ham: HubbardHolstein, r):
    """Inverse of :func:`rows`: (..., W) words."""
    return _words(r, ham.n_words) if dets.packable(ham.n_words) else r


def expand(ham: HubbardHolstein, r):
    """Row forms with a new axis before the row, to broadcast against a
    grid of positions."""
    return r[..., None] if dets.packable(ham.n_words) else r[..., None, :]


def select(ham: HubbardHolstein, cond, a, b):
    """``torch.where`` over row forms: ``a`` where ``cond`` (the rows'
    shape), else ``b``."""
    return torch.where(cond if dets.packable(ham.n_words) else cond[..., None], a, b)


def field(ham: HubbardHolstein, r, pos, width: int):
    """The ``width``-bit field (width <= 32) starting at bit ``pos`` of the
    row forms ``r``; ``pos`` broadcasts against the rows.  Wide rows read
    the field's word and the next one (the last word alone at the top: a
    field inside the row ends in it)."""
    mask = (1 << width) - 1
    if dets.packable(ham.n_words):
        return (r >> pos) & mask
    pos = torch.as_tensor(pos, dtype=torch.int64, device=r.device)
    shape = torch.broadcast_shapes(r.shape[:-1], pos.shape)
    words = r.expand(shape + r.shape[-1:])
    k = (pos // dets.WORD_BITS).expand(shape)[..., None]
    lo = torch.gather(words, -1, k)[..., 0]
    hi = torch.gather(words, -1, (k + 1).clamp_max(r.shape[-1] - 1))[..., 0]
    return (((hi << dets.WORD_BITS) | lo) >> (pos % dets.WORD_BITS)) & mask


def hop(ham: HubbardHolstein, r, from_bit, to_bit):
    """Row forms with bit ``from_bit`` cleared and ``to_bit`` set (the
    positions broadcast against the rows)."""
    if dets.packable(ham.n_words):
        one = torch.ones((), dtype=torch.int64, device=r.device)
        return (r & ~(one << from_bit)) | (one << to_bit)
    return dets.set_bit(dets.clear_bit(r, from_bit), to_bit)


def hop_grid(n_sites: int):
    """The static hop candidates (spin, bond, direction) as (from_bit,
    to_bit) numpy arrays of 4 (n_sites - 1) entries, in the reference's
    order."""
    froms, tos = [], []
    for s in range(2):
        for i in range(n_sites - 1):
            froms += [i + s * n_sites, i + 1 + s * n_sites]
            tos += [i + 1 + s * n_sites, i + s * n_sites]
    return np.asarray(froms, np.int64), np.asarray(tos, np.int64)


@functools.lru_cache(maxsize=None)
def hop_tensors(n_sites: int, device):
    """:func:`hop_grid` as int64 tensors on ``device``, copied there once."""
    return tuple(torch.as_tensor(x, device=device) for x in hop_grid(n_sites))


def hops_allowed(ham: HubbardHolstein, r, from_bit, to_bit):
    """(..., n_hop) bools: the hop's source occupied and its target empty,
    for the row forms ``r`` and the grid's tensors."""
    b = expand(ham, r)
    return (field(ham, b, from_bit, 1) == 1) & (field(ham, b, to_bit, 1) == 0)


# ---------------------------------------------------------------------------
# phonon counters
# ---------------------------------------------------------------------------

def phonon_nums(ham: HubbardHolstein, words) -> torch.Tensor:
    """Per-site phonon numbers: (..., W) words -> (..., n_sites) int64."""
    if ham.ph_bits == 0:
        return torch.zeros(words.shape[:-1] + (ham.n_sites,), dtype=torch.int64,
                           device=words.device)
    pos = 2 * ham.n_sites + ham.ph_bits * torch.arange(ham.n_sites, device=words.device)
    return field(ham, expand(ham, rows(ham, words)), pos, ham.ph_bits)


def set_counter(ham: HubbardHolstein, r, site, new_num):
    """Row forms ``r`` with site ``site``'s counter set to ``new_num`` (low
    ``ph_bits`` bits; ``site`` and ``new_num`` broadcast against the rows).
    Wide rows mask each word with its share of the counter's bits."""
    dev = r.device
    pos = 2 * ham.n_sites + ham.ph_bits * torch.as_tensor(site, device=dev)
    new = torch.as_tensor(new_num, dtype=torch.int64, device=dev) & ham.max_ph
    if dets.packable(ham.n_words):
        mask = torch.full((), ham.max_ph, dtype=torch.int64, device=dev) << pos
        return (r & ~mask) | (new << pos)
    # word j holds bits [32 j, 32 j + 32): the counter shifted by pos - 32 j
    shift = pos[..., None] - dets.WORD_BITS * torch.arange(r.shape[-1], device=dev)
    left, right = shift.clamp(0, dets.WORD_BITS), (-shift).clamp(0, dets.WORD_BITS)
    place = lambda x: torch.where(shift >= 0, (x << left) & dets.WORD_MASK, x >> right)
    return (r & ~place(torch.full((), ham.max_ph, dtype=torch.int64, device=dev))) | \
        place(new[..., None])


def with_phonon(ham: HubbardHolstein, words, site, new_num) -> torch.Tensor:
    """``words`` with site ``site``'s phonon counter set to ``new_num``
    (batched; ``site`` and ``new_num`` broadcast against the rows).  With no
    phonon bits the words come back unchanged."""
    if ham.ph_bits == 0:
        return words
    return to_words(ham, set_counter(ham, rows(ham, words), site, new_num))


# ---------------------------------------------------------------------------
# diagonal
# ---------------------------------------------------------------------------

@profiling.spanned("fries.diagonal")
def diag_matrel(ham: HubbardHolstein, words) -> torch.Tensor:
    """U * n_doubly_occupied + omega * n_phonons (absolute, unshifted)."""
    n = ham.n_sites
    if dets.packable(ham.n_words):
        bits = _bits64(words)
        n_doub = dets.popcount32(field(ham, bits, 0, n) & field(ham, bits, n, n)).to(F64)
    else:
        occ = dets.unpack_bits(words, 2 * n)
        n_doub = (occ[..., :n] & occ[..., n:]).sum(-1).to(F64)
    ph = phonon_nums(ham, words).sum(-1).to(F64)
    return ham.u * n_doub + ham.omega * ph


# ---------------------------------------------------------------------------
# spawning: every off-diagonal term as a static masked candidate grid
# ---------------------------------------------------------------------------

@profiling.spanned("fries.offdiag")
def offdiag_batch(ham: HubbardHolstein, words, vals, h_fac):
    """All off-diagonal spawns of a batch of determinants.

    Candidates per determinant (:func:`n_candidates`): the hops, amplitude
    h_fac * (-t) * v; then, when ph_bits > 0, a phonon lowering for every
    site, then a raising for every site, amplitude h_fac * g * sqrt(ph or
    ph + 1) * n_elec(site) * v.  Returns (new_words (B, NC, W), amps (B,
    NC)); slots of zero amplitude carry the sentinel key."""
    n = ham.n_sites
    dev = words.device
    vals = torch.as_tensor(vals, dtype=F64, device=dev)
    r = rows(ham, words)
    rb = expand(ham, r)
    from_bit, to_bit = hop_tensors(n, dev)
    hop_ok = hops_allowed(ham, r, from_bit, to_bit)
    out_bits = [hop(ham, rb, from_bit, to_bit)]
    out_amps = [torch.where(hop_ok, h_fac * (-ham.t) * vals[:, None], 0.0)]

    if ham.ph_bits:
        ph = phonon_nums(ham, words)
        n_at_site = field(ham, rb, torch.arange(n, device=dev), 1) + \
            field(ham, rb, torch.arange(n, 2 * n, device=dev), 1)
        site = torch.arange(n, device=dev)
        for direction in (-1, +1):
            new_num = ph + direction
            ok = (new_num >= 0) & (new_num <= ham.max_ph) & (n_at_site > 0)
            sqrt_fac = torch.sqrt((ph if direction < 0 else ph + 1).to(F64))
            out_amps.append(torch.where(
                ok, h_fac * ham.g * sqrt_fac * n_at_site * vals[:, None], 0.0))
            out_bits.append(set_counter(ham, rb, site, new_num.clamp(0, ham.max_ph)))

    amps = torch.cat(out_amps, dim=1)
    new_words = to_words(ham, torch.cat(out_bits, dim=1))
    sentinel = dets.invalid_det(ham.n_words, dev)
    return torch.where((amps != 0)[..., None], new_words, sentinel), amps


def n_candidates(ham: HubbardHolstein) -> int:
    return 4 * (ham.n_sites - 1) + (2 * ham.n_sites if ham.ph_bits else 0)


def occ_list(ham: HubbardHolstein, words) -> torch.Tensor:
    """Occupied electron spin-orbitals (phonon bits excluded)."""
    bits = dets.unpack_bits(words, ham.n_bits)[..., : 2 * ham.n_sites]
    return dets.occ_list_from_bits(bits, ham.n_elec)


# ---------------------------------------------------------------------------
# the reference-overlap estimator as a static connected set
# ---------------------------------------------------------------------------

def reference_connections(ham: HubbardHolstein, ref_words, e_ref: float, device=None):
    """(conn_keys (K, W) int64, conn_mels (K,) f64): <ref|(H - e_ref)|det>
    for every determinant coupled to the phonon-free reference state, in the
    reference's order (the state itself, its hops, its one-phonon
    satellites).  Built on the host."""
    n = ham.n_sites
    ref = np.asarray(torch.as_tensor(ref_words).cpu()).astype(np.int64).reshape(-1)
    value = sum(int(w) << (32 * i) for i, w in enumerate(ref))
    occ = lambda b: (value >> int(b)) & 1

    def words_of(v):
        return [(v >> (32 * i)) & dets.WORD_MASK for i in range(ham.n_words)]

    keys = [words_of(value)]
    mels = [ham.u * float(sum(occ(i) & occ(n + i) for i in range(n))) - e_ref]
    for frm, to in zip(*hop_grid(n)):
        if occ(frm) and not occ(to):
            keys.append(words_of(value & ~(1 << int(frm)) | (1 << int(to))))
            mels.append(-ham.t)
    if ham.ph_bits:
        for site in range(n):
            n_at = occ(site) + occ(n + site)
            if n_at:
                keys.append(words_of(value | (1 << (2 * n + site * ham.ph_bits))))
                mels.append(ham.g * n_at)
    return (torch.tensor(keys, dtype=torch.int64, device=device),
            torch.tensor(mels, dtype=F64, device=device))
