"""fries_tpu_torch.dets against fries_tpu.dets: bit packing, popcounts,
parities, occupied lists, packed keys and lookups.  Exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from fries_tpu import dets as jd  # noqa: E402
from fries_tpu_torch import dets as td  # noqa: E402


def random_dets(rng, n, n_orb, n_elec):
    """(n, W) uint32 words of random determinants with n_elec/2 per spin."""
    bits = np.zeros((n, 2 * n_orb), bool)
    for i in range(n):
        for spin in range(2):
            occ = rng.choice(n_orb, n_elec // 2, replace=False)
            bits[i, spin * n_orb + occ] = True
    return np.asarray(jd.pack_bits(jnp.asarray(bits))), bits


def t(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


@pytest.mark.parametrize("n_orb,n_elec", [(5, 4), (20, 6), (28, 14)])
def test_pack_unpack_popcount(n_orb, n_elec):
    rng = np.random.default_rng(n_orb)
    words, bits = random_dets(rng, 50, n_orb, n_elec)
    np.testing.assert_array_equal(td.pack_bits(torch.as_tensor(bits)).numpy(),
                                  words.astype(np.int64))
    np.testing.assert_array_equal(td.unpack_bits(t(words), 2 * n_orb).numpy(), bits)
    raw = rng.integers(0, 2**32, size=(64, 2), dtype=np.uint32)
    np.testing.assert_array_equal(td.popcount(t(raw)).numpy(),
                                  np.asarray(jd.popcount(jnp.asarray(raw))))


@pytest.mark.parametrize("n_orb,n_elec", [(6, 4), (28, 14)])
def test_bit_counts_and_parities(n_orb, n_elec):
    rng = np.random.default_rng(7 + n_orb)
    words, bits = random_dets(rng, 60, n_orb, n_elec)
    jw, tw = jnp.asarray(words), t(words)
    a = rng.integers(0, 2 * n_orb, 60)
    b = rng.integers(0, 2 * n_orb, 60)
    np.testing.assert_array_equal(td.bits_below(tw, t(a)).numpy(),
                                  np.asarray(jd.bits_below(jw, jnp.asarray(a))))
    np.testing.assert_array_equal(td.bits_between(tw, t(a), t(b)).numpy(),
                                  np.asarray(jd.bits_between(jw, jnp.asarray(a), jnp.asarray(b))))
    occ = np.asarray(jd.occ_list(jw, 2 * n_orb, n_elec))
    np.testing.assert_array_equal(td.occ_list(tw, 2 * n_orb, n_elec).numpy(), occ)
    # single and double excitations from occupied to unoccupied orbitals
    virt = np.stack([np.flatnonzero(~row)[: 2] for row in bits])
    o1, o2, v1, v2 = occ[:, 0], occ[:, -1], virt[:, 0], virt[:, 1]
    jn, js = jd.single_parity(jw, jnp.asarray(o1), jnp.asarray(v1))
    tn, ts = td.single_parity(tw, t(o1), t(v1))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn).astype(np.int64))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jn, js = jd.double_parity(jw, *(jnp.asarray(x) for x in (o1, o2, v1, v2)))
    tn, ts = td.double_parity(tw, *(t(x) for x in (o1, o2, v1, v2)))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn).astype(np.int64))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("n_words", [1, 2])
def test_pack_key_and_lookup(n_words):
    rng = np.random.default_rng(11 + n_words)
    raw = rng.integers(0, 2**32, size=(300, n_words), dtype=np.uint32)
    raw[:5] = 0xFFFFFFFF
    np.testing.assert_array_equal(td.pack_key(t(raw)).numpy(),
                                  np.asarray(jd.pack_key(jnp.asarray(raw))))
    np.testing.assert_array_equal(td.unpack_key(td.pack_key(t(raw)), n_words).numpy(),
                                  raw.astype(np.int64))
    assert td.sentinel_key(n_words) == int(
        np.asarray(jd.pack_key(jd.invalid_det(n_words)[None]))[0])
    table = raw[np.argsort(np.asarray(jd.pack_key(jnp.asarray(raw))), kind="stable")]
    queries = np.concatenate([raw[rng.integers(0, 300, 40)],
                              rng.integers(0, 2**32, size=(40, n_words), dtype=np.uint32)])
    jpos, jfound = jd.lookup_dets(jnp.asarray(table), jnp.asarray(queries))
    tpos, tfound = td.lookup_dets(t(table), t(queries))
    np.testing.assert_array_equal(tfound.numpy(), np.asarray(jfound))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))


def test_reference_dets():
    for n_orb, n_elec in ((5, 4), (28, 14)):
        np.testing.assert_array_equal(td.hf_det(n_orb, n_elec).numpy(),
                                      np.asarray(jd.hf_det(n_orb, n_elec)).astype(np.int64))
        w = td.n_words(2 * n_orb)
        inv = td.invalid_det(w)
        assert bool(td.is_invalid(inv)) and bool(jd.is_invalid(jd.invalid_det(w)))
        assert bool(td.det_eq(inv, inv))
    with pytest.raises(NotImplementedError):
        td.pack_key(torch.zeros((2, 3), dtype=torch.int64))
