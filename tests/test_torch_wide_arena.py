"""The port's arena and its plain merges at W = 3 and 4 words against
fries_tpu.runtime.arena's wide (XLA) path: from_unsorted, compact, lookup,
accumulate with and without a keep mask, accumulate_multi, dedup_spawns, and
the card merges' spawn sort (128-bit keys as two sign-flipped int64 halves).
The keys share words and differ across the 64-bit boundary; the streams
hold sentinel rows, runs of one key and the overflow, empty-arena and
empty-stream cases.  Keys, counts and flags exact; values at 1e-12 (the
reference sums segments by cumsum differences, the port in sorted order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from fries_tpu.runtime import arena as jar  # noqa: E402
from fries_tpu_torch import convert, dets as td  # noqa: E402
from fries_tpu_torch.runtime import arena as tar  # noqa: E402
from fries_tpu_torch.runtime import merge, merge_multi  # noqa: E402
from test_torch_wide_dets import t, wide_rows  # noqa: E402

SENT = np.iinfo(np.uint32).max
CASES = ["random", "one_key", "overflow", "empty_arena", "empty_spawns"]


def wide_case(rng, w, case, capacity=512, n_occ=200, n_spawn=700, n_rows=1):
    """A sorted arena of ``n_rows`` value rows over wide keys and a spawn
    stream onto them (a tenth sentinel rows), reshaped into ``case``."""
    uni = wide_rows(rng, 600, w)
    uni = np.unique(uni, axis=0)
    uni = uni[np.asarray(jar._sort_perm(jnp.asarray(uni)))]
    n_occ = 0 if case == "empty_arena" else min(n_occ, capacity)
    occ = np.sort(rng.choice(len(uni), n_occ, replace=False))
    keys = np.full((capacity, w), SENT, np.uint32)
    keys[:n_occ] = uni[occ]
    vals = np.zeros((n_rows, capacity))
    vals[:, :n_occ] = rng.standard_normal((n_rows, n_occ))
    vals[:, :n_occ][rng.random((n_rows, n_occ)) < 0.2] = 0.0
    a = jar.Arena(keys=jnp.asarray(keys), vals=jnp.asarray(vals),
                  n_used=jnp.asarray([n_occ], jnp.int32))
    sk = uni[rng.integers(0, len(uni), n_spawn)].copy()
    if case == "one_key":
        sk[: n_spawn // 2] = uni[occ[n_occ // 2]]
    if case == "overflow":
        sk = uni[rng.choice(len(uni), n_spawn, replace=len(uni) < n_spawn)]
    sk[rng.random(n_spawn) < (1.0 if case == "empty_spawns" else 0.1)] = SENT
    sv = rng.standard_normal(n_spawn) * 0.3
    si = rng.random(n_spawn) < (1.0 if case == "overflow" else 0.6)
    return a, sk, sv, si


def port_arena(a):
    return convert.arena(np.asarray(a.keys), np.asarray(a.vals), np.asarray(a.n_used))


def assert_same(got, gstats, ref, rstats):
    assert bool(gstats["overflow"]) == bool(rstats["overflow"])
    assert int(gstats["nonini_occ_add"]) == int(rstats["nonini_occ_add"])
    assert int(got.n_used[0]) == int(ref.n_used[0])
    np.testing.assert_array_equal(got.keys.numpy(), np.asarray(ref.keys).astype(np.int64))
    np.testing.assert_allclose(got.vals.numpy(), np.asarray(ref.vals), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("w", [3, 4])
@pytest.mark.parametrize("case", CASES)
def test_accumulate_matches_reference(w, case):
    rng = np.random.default_rng(100 * w + CASES.index(case))
    capacity = 300 if case == "overflow" else 512
    a, sk, sv, si = wide_case(rng, w, case, capacity=capacity)
    got, gstats = merge.accumulate(port_arena(a), t(sk), torch.as_tensor(sv),
                                   torch.as_tensor(si))
    ref, rstats = jar.accumulate(a, jnp.asarray(sk), jnp.asarray(sv), jnp.asarray(si))
    assert_same(got, gstats, ref, rstats)
    assert bool(gstats["overflow"]) == (case == "overflow")


@pytest.mark.parametrize("w", [3, 4])
def test_fused_compaction_two_rows(w):
    """The power step's layout (2, 0, 1) with a keep mask: compact, then
    merge into row 1."""
    rng = np.random.default_rng(40 + w)
    a, sk, sv, si = wide_case(rng, w, "random", n_rows=2)
    a = jar.Arena(keys=a.keys, vals=a.vals.at[1].set(0.0), n_used=a.n_used)
    keep = rng.random(a.capacity) < 0.05
    got, gstats = merge.accumulate(port_arena(a), t(sk), torch.as_tensor(sv),
                                   torch.as_tensor(si), 0, 1, keep_mask=torch.as_tensor(keep))
    ja = jar.compact(a, (a.vals[0] != 0) | jnp.asarray(keep))
    ref, rstats = jar.accumulate(ja, jnp.asarray(sk), jnp.asarray(sv), jnp.asarray(si), 0, 1)
    assert_same(got, gstats, ref, rstats)


@pytest.mark.parametrize("w", [3, 4])
@pytest.mark.parametrize("case", ["random", "one_key", "overflow", "empty_arena"])
def test_accumulate_multi_matches_reference(w, case):
    rng = np.random.default_rng(200 * w + len(case))
    capacity = 300 if case == "overflow" else 512
    a, sk, sv, si = wide_case(rng, w, case, capacity=capacity, n_rows=3)
    sr = rng.integers(0, 3, sk.shape[0]).astype(np.int32)
    got, gstats = merge_multi.accumulate(port_arena(a), t(sk), torch.as_tensor(sv),
                                         torch.as_tensor(sr), torch.as_tensor(si))
    ref, rstats = jar.accumulate_multi(a, jnp.asarray(sk), jnp.asarray(sv), jnp.asarray(sr),
                                       jnp.asarray(si))
    assert_same(got, gstats, ref, rstats)


@pytest.mark.parametrize("w", [3, 4])
def test_arena_helpers(w):
    """from_unsorted, compact, lookup and occupancy_stats."""
    rng = np.random.default_rng(50 + w)
    keys = np.unique(wide_rows(rng, 80, w), axis=0)
    rng.shuffle(keys)
    vals = rng.standard_normal((2, len(keys)))
    ja = jar.from_unsorted(jar.make(96, w, 2), jnp.asarray(keys), jnp.asarray(vals))
    ta = tar.from_unsorted(tar.make(96, w, 2), t(keys), torch.as_tensor(vals))
    np.testing.assert_array_equal(ta.keys.numpy(), np.asarray(ja.keys).astype(np.int64))
    np.testing.assert_array_equal(ta.vals.numpy(), np.asarray(ja.vals))
    assert int(ta.n_used[0]) == int(ja.n_used[0])
    mask = rng.random(96) < 0.5
    jc, tc = jar.compact(ja, jnp.asarray(mask)), tar.compact(ta, torch.as_tensor(mask))
    np.testing.assert_array_equal(tc.keys.numpy(), np.asarray(jc.keys).astype(np.int64))
    np.testing.assert_array_equal(tc.vals.numpy(), np.asarray(jc.vals))
    assert int(tc.n_used[0]) == int(jc.n_used[0])
    q = np.concatenate([keys[:20], wide_rows(rng, 30, w), np.full((2, w), SENT, np.uint32)])
    jpos, jfound = jar.lookup(ja, jnp.asarray(q))
    tpos, tfound = tar.lookup(ta, t(q))
    np.testing.assert_array_equal(tfound.numpy(), np.asarray(jfound))
    np.testing.assert_array_equal(tpos.numpy()[tfound.numpy()],
                                  np.asarray(jpos)[np.asarray(jfound)])
    assert tar.occupancy_stats(ta) == jar.occupancy_stats(ja)


@pytest.mark.parametrize("w", [3, 4])
def test_dedup_spawns_matches_reference(w):
    rng = np.random.default_rng(60 + w)
    uni = wide_rows(rng, 120, w)
    s = 3000
    sk = uni[rng.integers(0, len(uni), s)]
    sv = rng.standard_normal(s)
    si = rng.random(s) < 0.5
    kill = rng.random(s) < 0.1
    sk[kill] = SENT
    sv[kill] = 0.0
    sv[rng.random(s) < 0.05] = 0.0
    for cap in (300, 100):       # room for every segment, then overflow
        jk, jv, ji, jovf = jar.dedup_spawns(jnp.asarray(sk), jnp.asarray(sv),
                                            jnp.asarray(si), cap)
        tk, tv, ti, tovf = tar.dedup_spawns(t(sk), torch.as_tensor(sv), torch.as_tensor(si),
                                            cap)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        # on overflow the reference's last kept row sums every later segment
        # too (its segment end is the stream's end); the port's sums its own
        n = cap - 1 if cap == 100 else cap
        np.testing.assert_allclose(tv.numpy()[:n], np.asarray(jv)[:n], rtol=0,
                                   atol=1e-12 * np.abs(sv).sum())
        assert bool(tovf) == bool(jovf) == (cap == 100)


@pytest.mark.parametrize("w", [3, 4])
def test_sort_spawns_wide(w):
    """The card merges' spawn sort: the (lo, hi) halves of each sorted key
    are the sorted rows' key columns, the permutation is the reference's
    stable sort."""
    rng = np.random.default_rng(70 + w)
    sk = wide_rows(rng, 500, w)[rng.integers(0, 500, 2000)]
    sk[rng.random(2000) < 0.1] = SENT
    skey, perm = merge.sort_spawns(t(sk))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jar._sort_perm(jnp.asarray(sk))))
    lo, hi = td.key_columns(t(sk[perm.numpy()]))
    np.testing.assert_array_equal(skey.numpy(), torch.stack([lo, hi], -1).numpy())


def test_card_merge_refuses_more_than_four_words():
    """The card merges' width limit, now W = 16 words (256 orbitals): W = 17
    raises before anything is launched."""
    a = tar.make(16, 17, 1)
    sk = td.invalid_det(17).repeat(4, 1)
    with pytest.raises(NotImplementedError, match="17 words"):
        merge.launch("merge", "fries_merge", a, sk, torch.zeros(4, dtype=torch.float64),
                     torch.ones(4, dtype=torch.bool), 1)
