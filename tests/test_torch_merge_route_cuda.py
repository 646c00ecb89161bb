"""The merge dispatchers past kernels A and C's bounds, and the dedup's
fixed-order sum, on the card.

Marked ``cuda``: every test skips without a CUDA device.  Run on a GPU
machine with ``python -m pytest --noconftest tests/test_torch_merge_route_cuda.py -q``.
``arena.accumulate_multi_best`` at 33 value rows, ``arena.accumulate_best``
on keys of 17 words and with a keep mask at layout (3, 1, 2), each against
the plain merge of the same inputs on the CPU (keys, counts and flags
exact, values at rtol 1e-12), each counting one card route in
``profiling``'s ``merge.plain_on_card``; calls inside the bounds count
none and launch their kernel; ``arena.dedup_spawns`` twice on one stream
on the card, equal bit for bit to each other and to the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fries_tpu_torch import dets, profiling  # noqa: E402
from fries_tpu_torch.runtime import arena as ar, merge  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def case(seed, n_words, n_vecs, capacity=4096, n_occ=1500, n_spawn=20000, n_universe=4000):
    """A sorted arena of ``n_occ`` keys with ``n_vecs`` value rows (a fifth of
    them zero) and a spawn stream over the same universe (a tenth sentinel
    keys, 60% initiators)."""
    rng = np.random.default_rng(seed)
    uni = np.unique(rng.integers(0, 2**20, size=(n_universe, n_words)), axis=0)
    occ = torch.as_tensor(uni[rng.choice(len(uni), n_occ, replace=False)])
    a = ar.make(capacity, n_words, n_vecs)
    vals = rng.standard_normal((n_vecs, n_occ))
    vals[rng.random(vals.shape) < 0.2] = 0.0
    a = ar.from_unsorted(a, occ, torch.as_tensor(vals))
    sk = uni[rng.integers(0, len(uni), n_spawn)]
    sk[rng.random(n_spawn) < 0.1] = dets.WORD_MASK
    return (a, torch.as_tensor(sk), torch.as_tensor(rng.standard_normal(n_spawn)),
            torch.as_tensor(rng.random(n_spawn) < 0.6),
            torch.as_tensor(rng.integers(0, n_vecs, n_spawn)), rng)


def on(x, dev):
    if isinstance(x, ar.Arena):
        return ar.Arena(x.keys.to(dev), x.vals.to(dev), x.n_used.to(dev))
    return x.to(dev)


def assert_same(got, ref):
    (ga, gs), (ra, rs) = got, ref
    np.testing.assert_array_equal(ga.keys.cpu().numpy(), ra.keys.numpy())
    np.testing.assert_allclose(ga.vals.cpu().numpy(), ra.vals.numpy(), rtol=1e-12, atol=1e-12)
    assert int(ga.n_used[0]) == int(ra.n_used[0])
    assert bool(gs["overflow"]) == bool(rs["overflow"])
    assert int(gs["nonini_occ_add"]) == int(rs["nonini_occ_add"])


def counted(fn):
    """(result, card routes, kernel A launches, kernel C launches) of one call."""
    names = ("merge.plain_on_card", "launch.merge", "launch.merge_multi")
    before = [profiling.total(n) for n in names]
    out = fn()
    torch.cuda.synchronize()
    return (out, *(profiling.total(n) - b for n, b in zip(names, before)))


def test_multi_best_33_rows(cuda):
    a, sk, sv, si, sr, _ = case(1, 2, 33)
    ref = ar.accumulate_multi(a, sk, sv, sr, si)
    got, plain, la, lc = counted(lambda: ar.accumulate_multi_best(
        on(a, cuda), on(sk, cuda), on(sv, cuda), on(sr, cuda), on(si, cuda)))
    assert (plain, la, lc) == (1, 0, 0)
    assert_same(got, ref)


def test_best_17_words(cuda):
    a, sk, sv, si, _, rng = case(2, 17, 2)
    keep = torch.as_tensor(rng.random(a.capacity) < 0.5)
    for keep_mask in (None, keep):
        ref = merge.accumulate_plain(a, sk, sv, si, 0, 1, keep_mask)
        got, plain, la, lc = counted(lambda: ar.accumulate_best(
            on(a, cuda), on(sk, cuda), on(sv, cuda), on(si, cuda), 0, 1,
            keep_mask=None if keep_mask is None else on(keep_mask, cuda)))
        assert (plain, la, lc) == (1, 0, 0)
        assert_same(got, ref)


def test_best_keep_mask_layout_312(cuda):
    """Compaction first, then kernel A without a mask."""
    a, sk, sv, si, _, rng = case(3, 2, 3)
    keep = torch.as_tensor(rng.random(a.capacity) < 0.5)
    ref = merge.accumulate_plain(a, sk, sv, si, 1, 2, keep)
    got, plain, la, lc = counted(lambda: ar.accumulate_best(
        on(a, cuda), on(sk, cuda), on(sv, cuda), on(si, cuda), 1, 2,
        keep_mask=on(keep, cuda)))
    assert (plain, la, lc) == (1, 1, 0)
    assert_same(got, ref)
    assert int(ref[0].n_used[0]) < int(a.n_used[0]) + int((~dets.is_invalid(sk)).sum())


def test_in_bounds_calls_take_the_kernels(cuda):
    """The power step's (2, 0, 1) with a keep mask (its dest row zero, as
    the fused compaction requires) and a two-row multi merge."""
    a, sk, sv, si, sr, rng = case(4, 2, 2)
    keep = torch.as_tensor(rng.random(a.capacity) < 0.5)
    a1 = ar.set_row(a, 1, torch.zeros(a.capacity, dtype=torch.float64))
    got, plain, la, lc = counted(lambda: ar.accumulate_best(
        on(a1, cuda), on(sk, cuda), on(sv, cuda), on(si, cuda), 0, 1, keep_mask=on(keep, cuda)))
    assert (plain, la, lc) == (0, 1, 0)
    assert_same(got, merge.accumulate_plain(a1, sk, sv, si, 0, 1, keep))
    got, plain, la, lc = counted(lambda: ar.accumulate_multi_best(
        on(a, cuda), on(sk, cuda), on(sv, cuda), on(sr, cuda), on(si, cuda)))
    assert (plain, la, lc) == (0, 0, 1)
    assert_same(got, ar.accumulate_multi(a, sk, sv, sr, si))


@pytest.mark.parametrize("n_words", [1, 2, 4])
def test_dedup_repeats_and_equals_cpu(cuda, n_words):
    """A stream of 2^20 rows over 5,000 targets, values over sixteen
    decades: two card runs equal bit for bit, and equal to the CPU's."""
    rng = np.random.default_rng(10 + n_words)
    s = 1 << 20
    uni = np.unique(rng.integers(0, 2**20, size=(5000, n_words)), axis=0)
    sk = uni[rng.integers(0, len(uni), s)]
    sk[rng.random(s) < 0.3] = dets.WORD_MASK
    sv = rng.standard_normal(s) * 10.0 ** rng.integers(-8, 8, size=s)
    sv[rng.random(s) < 0.05] = 0.0
    args = (torch.as_tensor(sk), torch.as_tensor(sv), torch.as_tensor(rng.random(s) < 0.5))
    ref = ar.dedup_spawns(*args, 1 << 14)
    runs = [ar.dedup_spawns(*(on(x, cuda) for x in args), 1 << 14) for _ in range(2)]
    for got in runs:
        for g, r in zip(got, ref):
            assert torch.equal(g.cpu(), r)
    assert int((~dets.is_invalid(ref[0])).sum()) > 5000
