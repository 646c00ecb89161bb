"""``arena.dedup_spawns``' fixed-order sum (``ordered.run_sums``, the card's
summation run on the CPU) against the stream's sums taken one row after
another per (key, initiator flag) in stream order, the order of the CPU's
``index_add_``: equal bit for bit; and against the reference's
``dedup_spawns`` (a difference of two running sums): rows and flags exact,
values within 1e-14 of the stream's mass.  Widths of one to five words,
overflow, a stream of dead rows only, and one key repeated across the whole
stream."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from fries_tpu.runtime import arena as jar  # noqa: E402
from fries_tpu_torch import dets as td  # noqa: E402
from fries_tpu_torch.ops import ordered  # noqa: E402
from fries_tpu_torch.runtime import arena as tar  # noqa: E402


def stream(rng, s, w, n_keys, dead=0.1):
    """Heavy duplication, a share of sentinel rows and zero values, values
    over sixteen decades so that the order of a sum shows in its bits."""
    sk = np.zeros((s, w), np.int64)
    sk[:, 0] = rng.choice(n_keys, size=s) + 1
    if w > 2:
        sk[:, -1] = rng.choice(3, size=s)
    sv = rng.standard_normal(s) * 10.0 ** rng.integers(-8, 8, size=s)
    si = rng.random(s) < 0.5
    kill = rng.random(s) < dead
    sk[kill] = td.WORD_MASK
    sv[rng.random(s) < 0.05] = 0.0
    return sk, sv, si


def in_order(sk, sv, si, cap):
    """The dedup by hand: live rows grouped by (key, flag) in key order, each
    group summed one row after another in the stream's order; the first
    ``cap`` groups."""
    live = ~np.all(sk == td.WORD_MASK, axis=1) & (sv != 0)
    groups = {}
    for k, v, f in zip(map(tuple, sk[live]), sv[live], si[live]):
        groups.setdefault((k[::-1], bool(f)), []).append(v)
    keys, vals, ini = [], [], []
    for (k, f), vs in sorted(groups.items()):
        total = 0.0
        for v in vs:
            total += v
        keys.append(k[::-1])
        vals.append(total)
        ini.append(f)
    n = len(keys)
    out_k = np.full((cap, sk.shape[1]), td.WORD_MASK, np.int64)
    out_v, out_i = np.zeros(cap), np.zeros(cap, bool)
    m = min(n, cap)
    if m:
        out_k[:m], out_v[:m], out_i[:m] = np.array(keys[:m]), vals[:m], ini[:m]
    return out_k, out_v, out_i, n > cap


def port(sk, sv, si, cap):
    return tar.dedup_spawns(torch.as_tensor(sk), torch.as_tensor(sv), torch.as_tensor(si), cap)


CASES = [  # (seed, S, W, distinct keys, cap)
    (1, 4096, 1, 120, 256), (2, 4096, 2, 120, 256), (3, 3000, 3, 90, 600),
    (4, 2000, 5, 60, 400), (5, 5000, 2, 2000, 512), (6, 700, 2, 5, 8)]


@pytest.mark.parametrize("seed,s,w,n_keys,cap", CASES)
def test_dedup_sums_in_stream_order(seed, s, w, n_keys, cap):
    """Bit for bit the sums taken one row after another (overflow included:
    the first ``cap`` segments)."""
    sk, sv, si = stream(np.random.default_rng(seed), s, w, n_keys)
    want = in_order(sk, sv, si, cap)
    got = port(sk, sv, si, cap)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    assert bool(got[3]) == want[3]


@pytest.mark.parametrize("seed,s,w,n_keys,cap", [c for c in CASES if c[-1] >= 2 * c[3]])
def test_dedup_matches_reference(seed, s, w, n_keys, cap):
    """Rows and flags exact; values within 1e-14 of the stream's mass (the
    reference subtracts two running sums)."""
    sk, sv, si = stream(np.random.default_rng(seed), s, w, n_keys)
    jk, jv, ji, jovf = jar.dedup_spawns(jnp.asarray(sk.astype(np.uint32)), jnp.asarray(sv),
                                        jnp.asarray(si), cap)
    tk, tv, ti, tovf = port(sk, sv, si, cap)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                               atol=1e-14 * np.abs(sv).sum())
    assert not bool(tovf) and not bool(jovf)


def test_dedup_dead_stream_and_one_key():
    """Only dead rows: no segment, every row the sentinel.  One key over the
    whole stream: two segments, each the in-order sum."""
    rng = np.random.default_rng(9)
    sk, sv, si = stream(rng, 500, 2, 10, dead=1.0)
    k, v, i, ovf = port(sk, sv, si, 16)
    assert td.is_invalid(k).all() and not v.any() and not i.any() and not bool(ovf)
    sk = np.ones((3000, 2), np.int64)
    sv, si = rng.standard_normal(3000) * 10.0 ** rng.integers(-8, 8, 3000), rng.random(3000) < 0.3
    want = in_order(sk, sv, si, 4)
    got = port(sk, sv, si, 4)
    for g, x in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), x)
    assert int((~td.is_invalid(got[0])).sum()) == 2


@pytest.mark.parametrize("k", [1, 2, 5])
def test_run_sums_order(k):
    """``ordered.run_sums``: run j adds its rows one after another from 0;
    trailing zero lengths give zero rows, and rows past the runs are not
    read (NaN there does not show)."""
    rng = np.random.default_rng(k)
    lengths = rng.integers(0, 40, size=60)
    n = int(lengths.sum())
    x = rng.standard_normal((n + 50, k)) * 10.0 ** rng.integers(-8, 8, size=(n + 50, k))
    x[n:] = np.nan
    lens = np.concatenate([lengths, np.zeros(25, np.int64)])
    got = ordered.run_sums(torch.as_tensor(x), torch.as_tensor(lens)).numpy()
    assert got.shape == (85, k)
    start = 0
    for j, m in enumerate(lens):
        want = np.zeros(k)
        for r in range(start, start + m):
            want = want + x[r]
        np.testing.assert_array_equal(got[j], want)
        start += m
    idx = torch.as_tensor(np.repeat(np.arange(60), lengths))
    via_index_add = torch.zeros((85, k), dtype=torch.float64).index_add_(
        0, idx, torch.as_tensor(x[:n]))
    np.testing.assert_array_equal(got, via_index_add.numpy())
