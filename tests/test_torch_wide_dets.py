"""fries_tpu_torch.dets on determinants wider than two words (W = 3, 4)
against fries_tpu.dets: the arena's order (the last word the most
significant), the sort, searches and lookups, the order keys, the bit
functions at 108 bits, and the time-reversal canonical form and host fold
at 72 bits, which compare a determinant with its spin flip.  Rows that differ only in the low word or only in a
word above the 64-bit boundary are in every case.  Exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from fries_tpu import dets as jd, synth as jsynth  # noqa: E402
from fries_tpu.ops import time_reversal as jtr  # noqa: E402
from fries_tpu.runtime import arena as jar  # noqa: E402
from fries_tpu_torch import convert, dets as td  # noqa: E402
from fries_tpu_torch.ops import time_reversal as ttr  # noqa: E402

# word values around the sign bits of the int64 halves and of uint32
EDGE_WORDS = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE,
                       0xFFFFFFFF], np.uint32)


def wide_rows(rng, n, w):
    """(n, w) distinct valid rows (last word not all ones) drawn from few
    values per word, so that rows share words; the last 2 (w + 1) rows are
    pairs that differ in one word only, each word once."""
    rows = EDGE_WORDS[rng.integers(0, len(EDGE_WORDS), size=(4 * n, w))]
    rand = rng.random((4 * n, w)) < 0.3
    rows[rand] = rng.integers(0, 2**32, size=int(rand.sum()), dtype=np.uint32)
    rows[:, -1] &= np.uint32(0x0FFFFFFF)
    rows = np.unique(rows, axis=0)
    rows = rows[rng.permutation(len(rows))[: n - 2 * (w + 1)]]
    pairs = []
    for word in range(w):
        base = rng.integers(0, 2**28, size=w, dtype=np.uint32)
        other = base.copy()
        other[word] ^= np.uint32(0x80000000 if word < w - 1 else 0x08000000)
        pairs += [base, other]
    pairs.append(pairs[0])    # a repeated row
    pairs.append(pairs[1])
    return np.concatenate([rows, np.asarray(pairs, np.uint32)])


def t(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


def ref_order(rows):
    return np.asarray(jar._sort_perm(jnp.asarray(rows)))


@pytest.mark.parametrize("w", [3, 4])
def test_sort_and_det_less_match_reference(w):
    rng = np.random.default_rng(10 + w)
    rows = wide_rows(rng, 300, w)
    np.testing.assert_array_equal(td.sort_dets(t(rows)).numpy(), ref_order(rows))
    a = rows[rng.integers(0, len(rows), 2000)]
    b = rows[rng.integers(0, len(rows), 2000)]
    b[:50] = a[:50]          # equal pairs
    np.testing.assert_array_equal(td.det_less(t(a), t(b)).numpy(),
                                  np.asarray(jd.det_less(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("w", [3, 4])
def test_search_and_lookup_match_reference(w):
    rng = np.random.default_rng(20 + w)
    rows = np.unique(wide_rows(rng, 300, w), axis=0)
    table = rows[ref_order(rows)][:200]
    table = np.concatenate([table, np.full((56, w), 0xFFFFFFFF, np.uint32)])   # sentinel pad
    queries = np.concatenate([rows, table[:20], np.full((3, w), 0xFFFFFFFF, np.uint32)])
    np.testing.assert_array_equal(
        td.searchsorted_dets(t(table), t(queries)).numpy(),
        np.asarray(jd.searchsorted_dets(jnp.asarray(table), jnp.asarray(queries))))
    tpos, tfound = td.lookup_dets(t(table), t(queries))
    jpos, jfound = jd.lookup_dets(jnp.asarray(table), jnp.asarray(queries))
    np.testing.assert_array_equal(tfound.numpy(), np.asarray(jfound))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))


@pytest.mark.parametrize("w", [1, 2, 3, 4])
def test_order_keys(w):
    """Keys order as det_less and agree across tensors, the sentinel's is
    the largest, and decode gives the rows back."""
    rng = np.random.default_rng(30 + w)
    if w <= 2:
        rows = rng.integers(0, 2**28, size=(400, w), dtype=np.uint32)
    else:
        rows = wide_rows(rng, 400, w)
    rows[rng.random(len(rows)) < 0.1] = 0xFFFFFFFF
    x, y = t(rows[:250]), t(rows[150:]).reshape(5, -1, w)
    (kx, ky), sent, decode = td.order_keys(x, y)
    assert ky.shape == y.shape[:-1]
    np.testing.assert_array_equal(decode(kx).numpy(), x.numpy())
    np.testing.assert_array_equal(decode(ky).numpy(), y.numpy())
    np.testing.assert_array_equal((kx == sent).numpy(), td.is_invalid(x).numpy())
    i, j = rng.integers(0, 250, 3000), rng.integers(0, 250, 3000)
    np.testing.assert_array_equal((kx[i] < kx[j]).numpy(), td.det_less(x[i], x[j]).numpy())
    np.testing.assert_array_equal((kx[i] == kx[j]).numpy(), td.det_eq(x[i], x[j]).numpy())
    np.testing.assert_array_equal((kx[150:] == ky.reshape(-1)[:100]).numpy(),
                                  np.ones(100, bool))


def random_dets(rng, n, n_orb, n_elec):
    bits = np.zeros((n, 2 * n_orb), bool)
    for i in range(n):
        for spin in range(2):
            occ = rng.choice(n_orb, n_elec // 2, replace=False)
            bits[i, spin * n_orb + occ] = True
    return np.asarray(jd.pack_bits(jnp.asarray(bits))), bits


@pytest.mark.parametrize("n_orb,n_elec", [(36, 6), (54, 8)])
def test_bits_at_wide_widths(n_orb, n_elec):
    """pack / unpack, occupied lists, running counts and the parities of
    excitations that cross word boundaries, at 72 and 108 bits."""
    rng = np.random.default_rng(n_orb)
    words, bits = random_dets(rng, 80, n_orb, n_elec)
    assert words.shape[1] == td.n_words(2 * n_orb)
    tw, jw = t(words), jnp.asarray(words)
    np.testing.assert_array_equal(td.pack_bits(torch.as_tensor(bits)).numpy(), t(words).numpy())
    np.testing.assert_array_equal(td.unpack_bits(tw, 2 * n_orb).numpy(), bits)
    np.testing.assert_array_equal(td.running_count(torch.as_tensor(bits)).numpy(),
                                  np.cumsum(bits, -1))
    occ = np.asarray(jd.occ_list(jw, 2 * n_orb, n_elec))
    np.testing.assert_array_equal(td.occ_list(tw, 2 * n_orb, n_elec).numpy(), occ)
    virt = np.stack([rng.choice(np.flatnonzero(~row), 2, replace=False) for row in bits])
    o1, o2, v1, v2 = occ[:, 0], occ[:, -1], virt[:, 0], virt[:, 1]
    jn, js = jd.double_parity(jw, *(jnp.asarray(x) for x in (o1, o2, v1, v2)))
    tn, ts = td.double_parity(tw, *(t(x) for x in (o1, o2, v1, v2)))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn).astype(np.int64))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jn, js = jd.single_parity(jw, jnp.asarray(o2), jnp.asarray(v1))
    tn, ts = td.single_parity(tw, t(o2), t(v1))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn).astype(np.int64))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        td.flip_spins(tw, n_orb, 2 * n_orb).numpy(),
        np.asarray(jd.flip_spins(jw, n_orb, 2 * n_orb)).astype(np.int64))


@pytest.mark.parametrize("parity", [1, -1])
def test_time_reversal_three_words(parity):
    """canonicalize (through det_less) and fold_vector_host (conjugate
    pairs, duplicates, zeros) at 36 orbitals."""
    j = jsynth.make_system(36, 6, symm=np.arange(36) % 4, seed=2, scale_two=0.1)
    th = convert.hamiltonian(np.asarray(j.hcore), np.asarray(j.eris), np.asarray(j.symm), 36, 6)
    rng = np.random.default_rng(5)
    keys = np.array(random_dets(rng, 120, 36, 6)[0])
    keys[60:90] = np.asarray(jtr.flip(j, jnp.asarray(keys[:30])))
    keys[90:95] = keys[:5]
    jc, jf, js = jtr.canonicalize(j, jnp.asarray(keys), parity)
    tc, tf, ts = ttr.canonicalize(th, t(keys), parity)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).astype(np.int64))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    vals = rng.standard_normal(120)
    vals[::7] = 0.0
    jk, jv = jtr.fold_vector_host(j, keys, vals, parity)
    tk, tv = ttr.fold_vector_host(th, keys, vals, parity)
    np.testing.assert_array_equal(tk, jk.astype(np.int64))
    np.testing.assert_allclose(tv, jv, rtol=1e-12, atol=0)
