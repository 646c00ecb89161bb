"""The port's arena and its plain merges (the CPU side of the sorted-merge
kernels) against fries_tpu.runtime.arena.accumulate (+ compact) /
accumulate_multi and the reference's Pallas merges in interpret mode, on the
cases of tests/test_pallas_merge.py.  Exact keys and counts; values at 1e-12
(the reference sums segments by cumsum differences, the port in sorted
order).  The Pallas merges leave the slots past n_used unspecified, so only
the valid rows are compared with them."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from fries_tpu import dets as jd  # noqa: E402
from fries_tpu.runtime import arena as jar  # noqa: E402
from fries_tpu.runtime import pallas_merge  # noqa: E402
from fries_tpu_torch import convert  # noqa: E402
from fries_tpu_torch.runtime import arena as tar  # noqa: E402
from fries_tpu_torch.runtime import merge, merge_multi  # noqa: E402


def rand_case(rng, n_words, capacity, n_occ, n_spawn, n_universe, ini_frac=0.6,
              invalid_frac=0.1, n_vecs=1):
    uni = rng.integers(0, 2**20, size=(n_universe, n_words), dtype=np.uint32)
    uni[:, -1] &= np.uint32(0x0FFFFFFF)
    pk = np.asarray(jd.pack_key(jnp.asarray(uni)))
    uni = uni[np.unique(pk, return_index=True)[1]]
    okeys = uni[np.sort(rng.choice(uni.shape[0], min(n_occ, uni.shape[0]), replace=False))]
    okeys = okeys[np.argsort(np.asarray(jd.pack_key(jnp.asarray(okeys))), kind="stable")]
    ovals = rng.standard_normal(okeys.shape[0])
    ovals[rng.random(okeys.shape[0]) < 0.2] = 0.0
    a = jar.make(capacity, n_words, 1)
    keys = a.keys.at[: len(okeys)].set(jnp.asarray(okeys))
    vals = a.vals.at[0, : len(okeys)].set(jnp.asarray(ovals))
    if n_vecs == 2:
        vals = jnp.concatenate([vals, jnp.zeros_like(vals)])
    a = jar.Arena(keys=keys, vals=vals, n_used=jnp.asarray([len(okeys)], jnp.int32))
    skeys = uni[rng.integers(0, uni.shape[0], n_spawn)].copy()
    skeys[rng.random(n_spawn) < invalid_frac] = np.iinfo(np.uint32).max
    svals = rng.standard_normal(n_spawn) * 0.3
    sini = rng.random(n_spawn) < ini_frac
    return a, skeys, svals, sini


def port_merge(a, skeys, svals, sini, origin, dest, keep=None):
    ta = convert.arena(np.asarray(a.keys), np.asarray(a.vals), np.asarray(a.n_used))
    return merge.accumulate(ta, torch.as_tensor(skeys.astype(np.int64)),
                            torch.as_tensor(svals), torch.as_tensor(sini), origin, dest,
                            keep_mask=None if keep is None else torch.as_tensor(keep))


def assert_same(got, gstats, ref, rstats):
    assert bool(gstats["overflow"]) == bool(rstats["overflow"])
    assert int(gstats["nonini_occ_add"]) == int(rstats["nonini_occ_add"])
    assert int(got.n_used[0]) == int(ref.n_used[0])
    np.testing.assert_array_equal(got.keys.numpy(), np.asarray(ref.keys).astype(np.int64))
    np.testing.assert_allclose(got.vals.numpy(), np.asarray(ref.vals), rtol=1e-12, atol=1e-12)


def both_references(a, sk, sv, si, origin, dest, keep=None):
    ja = a if keep is None else jar.compact(a, (a.vals[origin] != 0) | jnp.asarray(keep))
    yield jar.accumulate(ja, jnp.asarray(sk), jnp.asarray(sv), jnp.asarray(si), origin, dest)
    yield pallas_merge.accumulate_pallas(
        a, jnp.asarray(sk), jnp.asarray(sv), jnp.asarray(si), origin, dest,
        keep_mask=None if keep is None else jnp.asarray(keep), interpret=True)


@pytest.mark.parametrize("n_words", [1, 2])
@pytest.mark.parametrize("trial", range(2))
def test_merge_matches_reference(n_words, trial):
    rng = np.random.default_rng(100 * n_words + trial)
    a, sk, sv, si = rand_case(rng, n_words, 1024, 400, 700, 800)
    got, gstats = port_merge(a, sk, sv, si, 0, 0)
    for ref, rstats in both_references(a, sk, sv, si, 0, 0):
        assert_same(got, gstats, ref, rstats)


@pytest.mark.parametrize("fused", [False, True])
def test_two_row_power_layout(fused):
    rng = np.random.default_rng(40 + fused)
    a, sk, sv, si = rand_case(rng, 2, 1024, 400, 700, 800, n_vecs=2)
    keep = rng.random(1024) < 0.05 if fused else None
    got, gstats = port_merge(a, sk, sv, si, 0, 1, keep)
    for ref, rstats in both_references(a, sk, sv, si, 0, 1, keep):
        assert_same(got, gstats, ref, rstats)


@pytest.mark.parametrize("case", ["empty_spawns", "empty_arena", "overflow"])
def test_merge_edge_cases(case):
    rng = np.random.default_rng(7)
    if case == "empty_spawns":
        a, sk, sv, si = rand_case(rng, 2, 128, 40, 32, 64, invalid_frac=1.0)
    elif case == "empty_arena":
        a = jar.make(128, 2, 1)
        sk = rng.integers(0, 2**16, size=(64, 2), dtype=np.uint32)
        sv = rng.standard_normal(64)
        si = np.ones(64, bool)
    else:
        a, sk, sv, si = rand_case(rng, 2, 64, 60, 200, 400, ini_frac=1.0, invalid_frac=0.0)
    got, gstats = port_merge(a, sk, sv, si, 0, 0)
    for ref, rstats in both_references(a, sk, sv, si, 0, 0):
        assert_same(got, gstats, ref, rstats)
    assert bool(gstats["overflow"]) == (case == "overflow")


def test_arena_helpers():
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 2**20, size=(50, 2), dtype=np.uint32)
    keys = keys[np.unique(np.asarray(jd.pack_key(jnp.asarray(keys))), return_index=True)[1]]
    rng.shuffle(keys)
    vals = rng.standard_normal((2, len(keys)))
    ja = jar.from_unsorted(jar.make(64, 2, 2), jnp.asarray(keys), jnp.asarray(vals))
    ta = tar.from_unsorted(tar.make(64, 2, 2), torch.as_tensor(keys.astype(np.int64)),
                           torch.as_tensor(vals))
    np.testing.assert_array_equal(ta.keys.numpy(), np.asarray(ja.keys).astype(np.int64))
    np.testing.assert_array_equal(ta.vals.numpy(), np.asarray(ja.vals))
    assert int(ta.n_used[0]) == int(ja.n_used[0])
    mask = rng.random(64) < 0.5
    jc = jar.compact(ja, jnp.asarray(mask))
    tc = tar.compact(ta, torch.as_tensor(mask))
    np.testing.assert_array_equal(tc.keys.numpy(), np.asarray(jc.keys).astype(np.int64))
    np.testing.assert_array_equal(tc.vals.numpy(), np.asarray(jc.vals))
    assert int(tc.n_used[0]) == int(jc.n_used[0])
    q = np.concatenate([keys[:10], rng.integers(0, 2**20, size=(10, 2), dtype=np.uint32)])
    jpos, jfound = jar.lookup(ja, jnp.asarray(q))
    tpos, tfound = tar.lookup(ta, torch.as_tensor(q.astype(np.int64)))
    np.testing.assert_array_equal(tfound.numpy(), np.asarray(jfound))
    np.testing.assert_array_equal(tpos.numpy()[tfound.numpy()], np.asarray(jpos)[np.asarray(jfound)])
    assert tar.occupancy_stats(ta) == jar.occupancy_stats(ja)
    row = torch.arange(64, dtype=torch.float64)
    np.testing.assert_array_equal(tar.set_row(ta, 1, row).vals[1].numpy(), row.numpy())


def multi_case(rng, n_words, n_rows, capacity=1024, n_occ=400, n_spawn=700,
               n_universe=800, **kw):
    """tests/test_pallas_merge.py's multi-row case: per-row arena values with
    a quarter zeroed, a random destination row per spawn."""
    a1, sk, sv, si = rand_case(rng, n_words, capacity, n_occ, n_spawn, n_universe, **kw)
    n = int(a1.n_used[0])
    vals = rng.standard_normal((n_rows, capacity))
    vals[rng.random((n_rows, capacity)) < 0.25] = 0.0
    vals[:, n:] = 0.0
    a = jar.Arena(keys=a1.keys, vals=jnp.asarray(vals), n_used=a1.n_used)
    return a, sk, sv, rng.integers(0, n_rows, n_spawn).astype(np.int32), si


def check_multi(a, sk, sv, sr, si):
    ta = convert.arena(np.asarray(a.keys), np.asarray(a.vals), np.asarray(a.n_used))
    got, gstats = merge_multi.accumulate(
        ta, torch.as_tensor(sk.astype(np.int64)), torch.as_tensor(sv),
        torch.as_tensor(sr), torch.as_tensor(si))
    args = (a, jnp.asarray(sk), jnp.asarray(sv), jnp.asarray(sr), jnp.asarray(si))
    ref, rstats = jar.accumulate_multi(*args)
    assert_same(got, gstats, ref, rstats)
    pref, pstats = pallas_merge.accumulate_multi_pallas(*args, interpret=True)
    assert bool(gstats["overflow"]) == bool(pstats["overflow"])
    assert int(gstats["nonini_occ_add"]) == int(pstats["nonini_occ_add"])
    n = int(pref.n_used[0])
    assert int(got.n_used[0]) == n
    np.testing.assert_array_equal(got.keys.numpy()[:n], np.asarray(pref.keys).astype(np.int64)[:n])
    np.testing.assert_allclose(got.vals.numpy()[:, :n], np.asarray(pref.vals)[:, :n],
                               rtol=1e-12, atol=1e-12)
    return gstats


@pytest.mark.parametrize("n_words", [1, 2])
@pytest.mark.parametrize("n_rows", [1, 2, 5])
def test_multi_row_merge_matches_reference(n_rows, n_words):
    rng = np.random.default_rng(60 + 10 * n_rows + n_words)
    check_multi(*multi_case(rng, n_words, n_rows))


@pytest.mark.parametrize("case", ["empty_spawns", "empty_arena", "overflow"])
def test_multi_row_merge_edge_cases(case):
    rng = np.random.default_rng(8)
    if case == "empty_spawns":
        a, sk, sv, sr, si = multi_case(rng, 2, 2, 128, 40, 32, 64, invalid_frac=1.0)
    elif case == "empty_arena":
        a = jar.make(128, 2, 2)
        sk = rng.integers(0, 2**16, size=(64, 2), dtype=np.uint32)
        sv = rng.standard_normal(64)
        sr = rng.integers(0, 2, 64).astype(np.int32)
        si = np.ones(64, bool)
    else:
        a, sk, sv, sr, si = multi_case(rng, 2, 3, 64, 60, 200, 400, ini_frac=1.0,
                                       invalid_frac=0.0)
    stats = check_multi(a, sk, sv, sr, si)
    assert bool(stats["overflow"]) == (case == "overflow")


# ---------------------------------------------------------------------------
# the regimes the card's merges are sensitive to (runs of one key longer than
# a tile, a full arena, every / no spawn found, one-word keys, many rows)
# ---------------------------------------------------------------------------

REGIMES = ["long_run", "full_arena", "all_found", "none_found", "one_word"]


def packed(keys):
    return np.asarray(jd.pack_key(jnp.asarray(keys)))


def regime_case(rng, regime, n_vecs=1):
    """rand_case's arena and spawns, reshaped into ``regime``."""
    n_words = 1 if regime == "one_word" else 2
    if regime == "full_arena":   # every slot holds a key
        a, sk, sv, si = rand_case(rng, n_words, 512, 512, 700, 1200, n_vecs=n_vecs)
        assert int(a.n_used[0]) == 512
        return a, sk, sv, si
    a, sk, sv, si = rand_case(rng, n_words, 1024, 400, 700, 800, n_vecs=n_vecs)
    n = int(a.n_used[0])
    okeys = np.asarray(a.keys)[:n]
    if regime == "long_run":     # 600 spawns on one arena key: longer than the Pallas TILE
        assert 600 > pallas_merge.TILE
        sk[:600] = okeys[np.argmax(np.abs(np.asarray(a.vals[0])[:n]))]
    elif regime == "all_found":
        sk = okeys[rng.integers(0, n, sk.shape[0])]
    elif regime == "none_found":
        fresh = rng.integers(0, 2**20, size=(4 * sk.shape[0], n_words), dtype=np.uint32)
        fresh = fresh[~np.isin(packed(fresh), packed(okeys))]
        sk = fresh[: sk.shape[0]]
    return a, sk, sv, si


@pytest.mark.parametrize("layout", [(1, 0, 0), (2, 0, 1)])
@pytest.mark.parametrize("regime", REGIMES)
def test_merge_regimes(regime, layout):
    n_vecs, origin, dest = layout
    rng = np.random.default_rng(300 + REGIMES.index(regime))
    a, sk, sv, si = regime_case(rng, regime, n_vecs)
    keep = rng.random(a.capacity) < 0.05 if n_vecs == 2 else None
    got, gstats = port_merge(a, sk, sv, si, origin, dest, keep)
    for ref, rstats in both_references(a, sk, sv, si, origin, dest, keep):
        assert_same(got, gstats, ref, rstats)


@pytest.mark.parametrize("regime", REGIMES + ["rows_14"])
def test_multi_row_merge_regimes(regime):
    rng = np.random.default_rng(400 + len(regime))
    a, sk, sv, si = regime_case(rng, "long_run" if regime == "rows_14" else regime)
    n_rows = 14 if regime == "rows_14" else 3
    n = int(a.n_used[0])
    vals = rng.standard_normal((n_rows, a.capacity))
    vals[rng.random(vals.shape) < 0.25] = 0.0
    vals[:, n:] = 0.0
    a = jar.Arena(keys=a.keys, vals=jnp.asarray(vals), n_used=a.n_used)
    check_multi(a, sk, sv, rng.integers(0, n_rows, sk.shape[0]).astype(np.int32), si)
