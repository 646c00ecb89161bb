"""fries_tpu_torch on determinants wider than four words (W = 5, 6, 7, 8 and
16: 65-256 orbitals) against the reference package: the key columns, the
sort, the order keys, searches and lookups (fries_tpu.dets), and the merges'
plain versions (accumulate_plain at (1, 0, 0) and (2, 0, 1), with and
without a keep mask, and accumulate_multi, against fries_tpu.runtime.arena's
XLA path), the card merges' spawn sort (one stable sort per 64-bit limb,
L = ceil(W / 2) of them) and the card's width limit.  Every row set holds
pairs that differ only in the lowest word, only in the top word (alone in
its limb at odd W) and only across a limb boundary (words 2j + 1 and
2j + 2), and sentinel rows.  Keys, counts and flags exact; values at rtol
1e-12 (segment sums in another order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from fries_tpu import dets as jd  # noqa: E402
from fries_tpu.runtime import arena as jar  # noqa: E402
from fries_tpu_torch import dets as td  # noqa: E402
from fries_tpu_torch.runtime import arena as tar  # noqa: E402
from fries_tpu_torch.runtime import merge, merge_multi  # noqa: E402
from test_torch_wide_arena import assert_same, port_arena  # noqa: E402
from test_torch_wide_dets import ref_order, t, wide_rows  # noqa: E402

WIDTHS = [5, 6, 7, 8, 16]
SENT = 0xFFFFFFFF


def wider_rows(rng, n, w):
    """:func:`wide_rows` (pairs that differ in one word, each word once)
    plus pairs that differ only in the two words around each limb boundary."""
    rows = wide_rows(rng, n, w)
    pairs = []
    for j in range(1, w - 1, 2):          # words j, j + 1 sit in limbs j // 2, j // 2 + 1
        base = rng.integers(0, 2**28, size=w, dtype=np.uint32)
        other = base.copy()
        other[j] ^= np.uint32(0x80000000)
        other[j + 1] ^= np.uint32(0x00000001)
        pairs += [base, other]
    return np.concatenate([rows, np.asarray(pairs, np.uint32).reshape(-1, w)])


def with_sentinels(rng, rows, frac):
    rows = rows.copy()
    rows[rng.random(len(rows)) < frac] = SENT
    return rows


@pytest.mark.parametrize("w", WIDTHS)
def test_key_columns_and_sentinel(w):
    """One sign-flipped int64 per two words (the top one alone at odd W),
    ordered as the reference's det_less; the sentinel's columns are the
    largest."""
    rng = np.random.default_rng(300 + w)
    rows = wider_rows(rng, 200, w)
    cols = td.key_columns(t(rows))
    assert len(cols) == td.n_limbs(w) == -(-w // 2)
    for k, col in enumerate(cols):
        lo = rows[:, 2 * k].astype(np.uint64)
        hi = rows[:, 2 * k + 1].astype(np.uint64) if 2 * k + 1 < w else np.uint64(0)
        want = ((hi << np.uint64(32)) | lo) ^ np.uint64(1 << 63)
        np.testing.assert_array_equal(col.numpy(), want.view(np.int64))
    sent = td.sentinel_columns(w)
    assert sent == [int(c) for c in td.key_columns(t(np.full((1, w), SENT, np.uint32)))]
    assert sent[-1] == (2**63 - 1 if w % 2 == 0 else (SENT ^ (1 << 63)) - 2**64)
    a, b = rows[rng.integers(0, len(rows), 3000)], rows[rng.integers(0, len(rows), 3000)]
    b[:40] = a[:40]
    np.testing.assert_array_equal(td.det_less(t(a), t(b)).numpy(),
                                  np.asarray(jd.det_less(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("w", WIDTHS)
def test_sort_and_spawn_sort_match_reference(w):
    """sort_dets and the card merges' L-pass spawn sort give the reference's
    stable order, 90% sentinel rows included; the sorted columns are the
    sorted rows' key columns."""
    rng = np.random.default_rng(310 + w)
    rows = wider_rows(rng, 300, w)
    for frac in (0.1, 0.9):
        sk = with_sentinels(rng, rows[rng.integers(0, len(rows), 1500)], frac)
        order = ref_order(sk)
        np.testing.assert_array_equal(td.sort_dets(t(sk)).numpy(), order)
        skey, perm = merge.sort_spawns(t(sk))
        np.testing.assert_array_equal(perm.numpy(), order)
        assert skey.shape == (len(sk), td.n_limbs(w))
        np.testing.assert_array_equal(
            skey.numpy(), torch.stack(td.key_columns(t(sk[order])), -1).numpy())
        n_sent = int((sk == SENT).all(1).sum())
        np.testing.assert_array_equal(skey.numpy()[len(sk) - n_sent:],
                                      np.tile(td.sentinel_columns(w), (n_sent, 1)))


@pytest.mark.parametrize("w", WIDTHS)
def test_order_keys_search_and_lookup(w):
    """order_keys (keys ordered as det_less, comparable across tensors,
    decoded back), searchsorted_dets and lookup_dets against the
    reference."""
    rng = np.random.default_rng(320 + w)
    rows = np.unique(wider_rows(rng, 300, w), axis=0)
    x = t(with_sentinels(rng, rows[:200], 0.1))
    y = t(rows[100:]).reshape(-1, 1, w)
    (kx, ky), sent, decode = td.order_keys(x, y)
    np.testing.assert_array_equal(decode(kx).numpy(), x.numpy())
    np.testing.assert_array_equal(decode(ky).numpy(), y.numpy())
    np.testing.assert_array_equal((kx == sent).numpy(), td.is_invalid(x).numpy())
    i, j = rng.integers(0, len(x), 3000), rng.integers(0, len(x), 3000)
    np.testing.assert_array_equal((kx[i] < kx[j]).numpy(), td.det_less(x[i], x[j]).numpy())
    np.testing.assert_array_equal((kx[i] == kx[j]).numpy(), td.det_eq(x[i], x[j]).numpy())
    table = np.concatenate([rows[ref_order(rows)][:180], np.full((60, w), SENT, np.uint32)])
    queries = np.concatenate([rows, table[:30], np.full((3, w), SENT, np.uint32)])
    np.testing.assert_array_equal(
        td.searchsorted_dets(t(table), t(queries)).numpy(),
        np.asarray(jd.searchsorted_dets(jnp.asarray(table), jnp.asarray(queries))))
    tpos, tfound = td.lookup_dets(t(table), t(queries))
    jpos, jfound = jd.lookup_dets(jnp.asarray(table), jnp.asarray(queries))
    np.testing.assert_array_equal(tfound.numpy(), np.asarray(jfound))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))


def wider_case(rng, w, case, capacity=384, n_occ=150, n_spawn=600, n_rows=1):
    """A sorted arena of ``n_rows`` value rows over :func:`wider_rows` keys
    and a spawn stream onto them: a tenth sentinel rows ("random"), nine
    tenths ("sentinels"), or more new keys than free rows ("overflow")."""
    uni = np.unique(wider_rows(rng, 500, w), axis=0)
    uni = uni[ref_order(uni)]
    occ = np.sort(rng.choice(len(uni), n_occ, replace=False))
    keys = np.full((capacity, w), SENT, np.uint32)
    keys[:n_occ] = uni[occ]
    vals = np.zeros((n_rows, capacity))
    vals[:, :n_occ] = rng.standard_normal((n_rows, n_occ))
    vals[:, :n_occ][rng.random((n_rows, n_occ)) < 0.2] = 0.0
    a = jar.Arena(keys=jnp.asarray(keys), vals=jnp.asarray(vals),
                  n_used=jnp.asarray([n_occ], jnp.int32))
    if case == "overflow":
        sk = uni[rng.choice(len(uni), n_spawn, replace=len(uni) < n_spawn)]
    else:
        sk = with_sentinels(rng, uni[rng.integers(0, len(uni), n_spawn)],
                            0.9 if case == "sentinels" else 0.1)
    sv = rng.standard_normal(n_spawn) * 0.3
    si = rng.random(n_spawn) < (1.0 if case == "overflow" else 0.6)
    return a, sk, sv, si


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("case", ["random", "sentinels", "overflow"])
def test_accumulate_plain_matches_reference(w, case):
    """Layout (1, 0, 0) without a keep mask."""
    rng = np.random.default_rng(330 + w + 7 * len(case))
    a, sk, sv, si = wider_case(rng, w, case, capacity=160 if case == "overflow" else 384)
    got, gstats = merge.accumulate_plain(port_arena(a), t(sk), torch.as_tensor(sv),
                                         torch.as_tensor(si))
    ref, rstats = jar.accumulate(a, jnp.asarray(sk), jnp.asarray(sv), jnp.asarray(si))
    assert_same(got, gstats, ref, rstats)
    assert bool(gstats["overflow"]) == (case == "overflow")


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("keep", [False, True])
def test_accumulate_plain_two_rows(w, keep):
    """The power step's layout (2, 0, 1), with the fused compaction of a
    keep mask (compact, then merge into row 1) and without one."""
    rng = np.random.default_rng(340 + w + 50 * keep)
    a, sk, sv, si = wider_case(rng, w, "random", n_rows=2)
    a = jar.Arena(keys=a.keys, vals=a.vals.at[1].set(0.0), n_used=a.n_used)
    mask = rng.random(a.capacity) < 0.05
    got, gstats = merge.accumulate_plain(port_arena(a), t(sk), torch.as_tensor(sv),
                                         torch.as_tensor(si), 0, 1,
                                         torch.as_tensor(mask) if keep else None)
    ja = jar.compact(a, (a.vals[0] != 0) | jnp.asarray(mask)) if keep else a
    ref, rstats = jar.accumulate(ja, jnp.asarray(sk), jnp.asarray(sv), jnp.asarray(si), 0, 1)
    assert_same(got, gstats, ref, rstats)


@pytest.mark.parametrize("w", WIDTHS)
def test_accumulate_multi_matches_reference(w):
    """Kernel C's plain version, three value rows."""
    rng = np.random.default_rng(350 + w)
    a, sk, sv, si = wider_case(rng, w, "random", n_rows=3)
    sr = rng.integers(0, 3, sk.shape[0]).astype(np.int32)
    got, gstats = merge_multi.accumulate(port_arena(a), t(sk), torch.as_tensor(sv),
                                         torch.as_tensor(sr), torch.as_tensor(si))
    ref, rstats = jar.accumulate_multi(a, jnp.asarray(sk), jnp.asarray(sv), jnp.asarray(sr),
                                       jnp.asarray(si))
    assert_same(got, gstats, ref, rstats)


def test_card_merge_width_limit():
    """merge.launch takes W = 16 past its width check (it stops at the CPU
    tensor, the first thing it checks after the width) and refuses W = 17
    before anything is touched."""
    for w, error, match in ((16, ValueError, "CUDA tensor"), (17, NotImplementedError,
                                                              "17 words")):
        a = tar.make(16, w, 1)
        sk = td.invalid_det(w).repeat(4, 1)
        with pytest.raises(error, match=match):
            merge.launch("merge", "fries_merge", a, sk, torch.zeros(4, dtype=torch.float64),
                         torch.ones(4, dtype=torch.bool), 1)
