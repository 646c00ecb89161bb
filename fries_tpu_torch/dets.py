"""Slater-determinant bit strings on torch tensors.

Counterpart of ``fries_tpu/dets.py``.  A determinant is a fixed-width row of
32-bit words, bit ``b`` at ``words[b // 32] >> (b % 32) & 1``; alpha spin
orbitals occupy bits ``0..n_orb-1``, beta ``n_orb..2*n_orb-1``.

The words are held in **int64 tensors that carry the uint32 values**
(0 .. 2**32-1): CPU torch has no right shift for uint32, and int64 gives
native shifts, compares and sorts on both the CPU and the card.  Every
function is vectorized over leading batch dimensions.

The arena's order is lexicographic with the last word the most significant.
Determinants of at most two words (2 * n_orb <= 64) have an order-preserving
scalar key, :func:`pack_key`, one int64.  Wider ones sort on
:func:`key_columns`, one sign-flipped int64 per two words (:func:`n_limbs`
of them, the top one alone at odd W), with one stable sort per column
(:func:`sort_dets`); where an int64 key is needed (a search, a segmented
sum) :func:`order_keys` ranks the rows of all the tensors at hand in one
such sort.  The card's merge kernels take the columns as the limbs of
their key.
"""

from __future__ import annotations

import numpy as np
import torch

from fries_tpu_torch import profiling

WORD_BITS = 32
WORD_MASK = 0xFFFFFFFF
INT64_MIN = -(1 << 63)
INT64_MAX = (1 << 63) - 1
PACK_MAX_WORDS = 2


def n_words(n_bits: int) -> int:
    """Number of 32-bit words needed to store ``n_bits`` bits."""
    return -(-n_bits // WORD_BITS)


def packable(num_words: int) -> bool:
    """True when determinants of ``num_words`` words fit one int64 key."""
    return num_words <= PACK_MAX_WORDS


def require_packable(num_words: int) -> None:
    if not packable(num_words):
        raise NotImplementedError(
            f"determinants of {num_words} words (> {PACK_MAX_WORDS}) are not "
            "ported here: this path keys on one packed int64")


# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------

def pack_bits(bits: torch.Tensor, num_words: int | None = None) -> torch.Tensor:
    """Boolean occupancy ``(..., n_bits)`` -> int64 words ``(..., W)``."""
    n_bits = bits.shape[-1]
    w = num_words if num_words is not None else n_words(n_bits)
    pad = w * WORD_BITS - n_bits
    b = bits.to(torch.int64)
    if pad:
        b = torch.cat([b, b.new_zeros(bits.shape[:-1] + (pad,))], dim=-1)
    b = b.reshape(bits.shape[:-1] + (w, WORD_BITS))
    shifts = torch.arange(WORD_BITS, device=bits.device, dtype=torch.int64)
    return (b << shifts).sum(dim=-1)


def unpack_bits(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """int64 words ``(..., W)`` -> boolean occupancy ``(..., n_bits)``."""
    bit = torch.arange(n_bits, device=words.device, dtype=torch.int64)
    sel = words[..., bit // WORD_BITS]
    return ((sel >> (bit % WORD_BITS)) & 1).to(torch.bool)


# ---------------------------------------------------------------------------
# single-bit ops
# ---------------------------------------------------------------------------

def _word_and_bit(words: torch.Tensor, pos):
    pos = torch.as_tensor(pos, device=words.device, dtype=torch.int64)
    onehot = (torch.arange(words.shape[-1], device=words.device)
              == (pos // WORD_BITS)[..., None])
    bit_val = (torch.ones_like(pos) << (pos % WORD_BITS))[..., None]
    return onehot, bit_val


def read_bit(words: torch.Tensor, pos) -> torch.Tensor:
    onehot, bit_val = _word_and_bit(words, pos)
    return ((words & bit_val) != 0).logical_and(onehot).any(dim=-1)


def set_bit(words: torch.Tensor, pos) -> torch.Tensor:
    onehot, bit_val = _word_and_bit(words, pos)
    return words | torch.where(onehot, bit_val, 0)


def clear_bit(words: torch.Tensor, pos) -> torch.Tensor:
    onehot, bit_val = _word_and_bit(words, pos)
    return words & ~torch.where(onehot, bit_val, 0)


# ---------------------------------------------------------------------------
# popcounts and parity
# ---------------------------------------------------------------------------

def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 tensors holding 32-bit values."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & WORD_MASK) >> 24


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits per determinant ``(...,)``."""
    return popcount32(words).sum(dim=-1)


def bits_below(words: torch.Tensor, pos) -> torch.Tensor:
    """Number of set bits at positions strictly below ``pos``."""
    pos = torch.as_tensor(pos, device=words.device, dtype=torch.int64)
    word_idx = (pos // WORD_BITS)[..., None]
    bit_idx = (pos % WORD_BITS)[..., None]
    word_range = torch.arange(words.shape[-1], device=words.device)
    partial_mask = (torch.ones_like(bit_idx) << bit_idx) - 1
    masked = torch.where(word_range < word_idx, words, 0) | torch.where(
        word_range == word_idx, words & partial_mask, 0)
    return popcount32(masked).sum(dim=-1)


def bits_between(words: torch.Tensor, a, b) -> torch.Tensor:
    """Set bits strictly between positions ``a`` and ``b``."""
    a = torch.as_tensor(a, device=words.device)
    b = torch.as_tensor(b, device=words.device)
    lo = torch.minimum(a, b)
    hi = torch.maximum(a, b)
    return bits_below(words, hi) - bits_below(words, lo + 1)


def excite_sign(words: torch.Tensor, cre, des) -> torch.Tensor:
    """Fermionic sign (+1/-1) of moving one electron ``des -> cre``; ``des``
    must already be cleared in ``words``."""
    n_perm = bits_between(words, cre, des)
    return 1 - 2 * (n_perm % 2)


def single_parity(words, occ, virt):
    """Apply occ -> virt; return (new_words, sign)."""
    cleared = clear_bit(words, occ)
    sign = excite_sign(cleared, virt, occ)
    return set_bit(cleared, virt), sign


def double_parity(words, occ1, occ2, virt1, virt2):
    """Apply (occ1, occ2) -> (virt1, virt2); return (new_words, sign)."""
    cleared = clear_bit(clear_bit(words, occ1), occ2)
    sign = excite_sign(cleared, virt1, occ1) * excite_sign(cleared, virt2, occ2)
    return set_bit(set_bit(cleared, virt1), virt2), sign


# ---------------------------------------------------------------------------
# occupied-orbital lists
# ---------------------------------------------------------------------------

def running_count(mask: torch.Tensor) -> torch.Tensor:
    """Inclusive running count of True along the last axis (int64), as a
    product with a triangular matrix of ones: f32 sums of at most a few
    hundred ones are exact in any order, and on the card a scan along rows
    of a few dozen columns is many times slower than the product."""
    k = mask.shape[-1]
    tri = torch.triu(torch.ones(k, k, dtype=torch.float32, device=mask.device))
    return (mask.to(torch.float32) @ tri).to(torch.int64)


def occ_list_from_bits(bits: torch.Tensor, n_elec: int) -> torch.Tensor:
    """Ascending set-bit positions ``(..., n_bits) -> (..., n_elec)``; missing
    slots hold ``n_bits``, extra set bits are dropped."""
    n_bits = bits.shape[-1]
    rank = running_count(bits) - 1
    slot = torch.where(bits & (rank < n_elec), rank, n_elec)
    pos = torch.arange(n_bits, device=bits.device).expand(bits.shape)
    out = torch.full(bits.shape[:-1] + (n_elec + 1,), n_bits,
                     dtype=torch.int64, device=bits.device)
    out.scatter_(-1, slot, pos)
    out[..., n_elec] = n_bits
    return out[..., :n_elec]


def occ_list(words: torch.Tensor, n_bits: int, n_elec: int) -> torch.Tensor:
    return occ_list_from_bits(unpack_bits(words, n_bits), n_elec)


# ---------------------------------------------------------------------------
# reference determinants
# ---------------------------------------------------------------------------

def hf_bits(n_orb: int, n_elec: int, n_bits: int | None = None,
            device=None) -> torch.Tensor:
    """Aufbau occupancy: lowest n_elec/2 orbitals of each spin."""
    n_bits = 2 * n_orb if n_bits is None else n_bits
    orbs = np.arange(n_bits)
    occ = (orbs < n_elec // 2) | ((orbs >= n_orb) & (orbs < n_orb + n_elec // 2))
    return torch.as_tensor(occ, device=device)


def hf_det(n_orb: int, n_elec: int, n_bits: int | None = None,
           device=None) -> torch.Tensor:
    return pack_bits(hf_bits(n_orb, n_elec, n_bits, device))


def neel_bits_1d(n_sites: int, n_elec: int, n_bits: int | None = None,
                 device=None) -> torch.Tensor:
    """1-D Neel state: alternating up / down spins from up at site 0, the
    phonon bits zero."""
    n_bits = 2 * n_sites if n_bits is None else n_bits
    sites = np.arange(n_sites)
    up = (sites % 2 == 0) & (sites < n_elec + (n_elec % 2 == 1))
    up &= np.cumsum(sites % 2 == 0) <= (n_elec + 1) // 2
    down = (sites % 2 == 1)
    down &= np.cumsum(sites % 2 == 1) <= n_elec // 2
    occ = np.zeros(n_bits, dtype=bool)
    occ[:n_sites] = up
    occ[n_sites:2 * n_sites] = down
    return torch.as_tensor(occ, device=device)


# ---------------------------------------------------------------------------
# spin flip (time reversal)
# ---------------------------------------------------------------------------

def flip_spins_bits(bits: torch.Tensor, n_orb: int) -> torch.Tensor:
    """Exchange the alpha (0..n_orb-1) and beta (n_orb..2n_orb-1) blocks."""
    return torch.cat([bits[..., n_orb:2 * n_orb], bits[..., :n_orb],
                      bits[..., 2 * n_orb:]], dim=-1)


def flip_spins(words: torch.Tensor, n_orb: int, n_bits: int) -> torch.Tensor:
    return pack_bits(flip_spins_bits(unpack_bits(words, n_bits), n_orb), words.shape[-1])


# ---------------------------------------------------------------------------
# comparison and sort keys
# ---------------------------------------------------------------------------

def invalid_det(num_words: int, device=None) -> torch.Tensor:
    """All-ones sentinel row, sorting after every valid determinant."""
    return torch.full((num_words,), WORD_MASK, dtype=torch.int64, device=device)


def is_invalid(words: torch.Tensor) -> torch.Tensor:
    return words[..., -1] == WORD_MASK


def det_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=-1)


def det_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b in the arena's order (the last word is the most significant),
    for any W: lexicographic over :func:`key_columns`, the order of
    :func:`pack_key` where W <= 2 and of ``fries_tpu.dets.det_less``."""
    *low, (ca, cb) = zip(key_columns(a), key_columns(b))
    lt, decided = ca < cb, ca != cb
    for ca, cb in reversed(low):
        lt = torch.where(decided, lt, ca < cb)
        decided = decided | (ca != cb)
    return lt


def key_columns(words: torch.Tensor) -> list[torch.Tensor]:
    """The int64 sort columns of ``(..., W)`` words, least significant
    first: words (2k, 2k + 1) as :func:`pack_key` of the pair (the last
    column alone when W is odd).  Lexicographic order over the columns,
    most significant first, is the arena's order; W <= 2 gives the one
    column :func:`pack_key`, and W = 3 or 4 the two halves of a 128-bit
    key."""
    return [pack_key(words[..., k:k + 2]) for k in range(0, words.shape[-1], 2)]


def n_limbs(num_words: int) -> int:
    """The number of :func:`key_columns` of ``num_words`` words: 64-bit
    limbs, ceil(W / 2)."""
    return -(-num_words // 2)


def sentinel_columns(num_words: int) -> list[int]:
    """The :func:`key_columns` of the all-ones sentinel row, least
    significant first, as Python ints (the top one of an odd W holds one
    word)."""
    return [int(c) for c in key_columns(invalid_det(num_words))]


@profiling.spanned("fries.keys")
def sort_dets(words: torch.Tensor) -> torch.Tensor:
    """The stable permutation that sorts the rows of ``(N, W)`` words in the
    arena's order: one stable sort per :func:`key_columns` column, least
    significant first."""
    cols = key_columns(words)
    perm = torch.sort(cols[0], stable=True).indices
    for col in cols[1:]:
        perm = perm[torch.sort(col[perm], stable=True).indices]
    return perm


@profiling.spanned("fries.keys")
def order_keys(*words: torch.Tensor):
    """Order-preserving int64 keys of the rows of ``(..., W)`` word tensors,
    comparable across them.  Returns (keys, sentinel, decode): one key
    tensor per input (its shape without the last axis), the key of the
    all-ones sentinel row (the largest), and a function from keys back to
    ``(..., W)`` words.

    W <= 2: :func:`pack_key` and :func:`unpack_key`.  Wider: one
    :func:`sort_dets` of all the rows given; a row's key is the position of
    the first equal row in that order (equal rows share it), the sentinel's
    is int64 max, and ``decode`` gathers from the sorted rows.  Nothing is
    read on the host."""
    w = words[0].shape[-1]
    if packable(w):
        return [pack_key(x) for x in words], sentinel_key(w), lambda k: unpack_key(k, w)
    dev = words[0].device
    flat = torch.cat([x.reshape(-1, w) for x in words] + [invalid_det(w, dev)[None]])
    n = flat.shape[0]
    perm = sort_dets(flat)
    srt = flat[perm]
    pos = torch.arange(n, device=dev)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = (srt[1:] != srt[:-1]).any(-1)
    key_sorted = torch.cummax(torch.where(first, pos, 0), 0).values
    key_sorted = torch.where((srt == WORD_MASK).all(-1), INT64_MAX, key_sorted)
    flat_key = torch.empty_like(key_sorted)
    flat_key[perm] = key_sorted
    out, start = [], 0
    for x in words:
        m = x.numel() // w
        out.append(flat_key[start:start + m].reshape(x.shape[:-1]))
        start += m

    def decode(keys):
        rows = srt[keys.clamp_max(n - 1)]
        return torch.where((keys == INT64_MAX)[..., None], WORD_MASK, rows)

    return out, INT64_MAX, decode


def pack_key(words: torch.Tensor) -> torch.Tensor:
    """Order-preserving int64 key of ``(..., W<=2)`` words: the uint64
    ``(hi << 32) | lo`` with its sign bit flipped, so unsigned word order is
    signed int64 order and the two-word sentinel is int64 max.  Equal to
    ``fries_tpu.dets.pack_key``."""
    require_packable(words.shape[-1])
    u = words[..., 0]
    if words.shape[-1] == 2:
        u = (words[..., 1] << 32) | u
    return u ^ INT64_MIN


def unpack_key(keys: torch.Tensor, num_words: int) -> torch.Tensor:
    """Inverse of :func:`pack_key` -> ``(..., W)`` int64 words."""
    u = keys ^ INT64_MIN
    lo = u & WORD_MASK
    if num_words == 1:
        return lo[..., None]
    return torch.stack([lo, (u >> 32) & WORD_MASK], dim=-1)


def sentinel_key(num_words: int) -> int:
    """Packed key of the all-ones sentinel row (W <= 2)."""
    require_packable(num_words)
    k = ((1 << (WORD_BITS * num_words)) - 1) ^ (1 << 63)
    return k - (1 << 64) if k >= 1 << 63 else k


def searchsorted_dets(sorted_words: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Index of the first row of ``sorted_words`` (N, W) >= each query, for
    any W (keys from :func:`order_keys`)."""
    (k_sorted, k_query), _, _ = order_keys(sorted_words, queries)
    return torch.searchsorted(k_sorted, k_query.contiguous())


@profiling.spanned("fries.keys")
def lookup_dets(sorted_words: torch.Tensor, queries: torch.Tensor):
    """(positions, found) of each query determinant in a sorted table."""
    pos = searchsorted_dets(sorted_words, queries)
    n = sorted_words.shape[0]
    clipped = pos.clamp(0, n - 1)
    found = det_eq(sorted_words[clipped], queries) & (pos < n)
    return clipped, found
