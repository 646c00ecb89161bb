"""Run-to-run reproducibility on the card (marked ``cuda``; skips without a
CUDA device).  Kernels A and C merge one stream 50 times, the plain f64
merges the same, and the blocked scan of ``ops.ordered`` runs 50 times:
every output must be equal bit for bit, where a key's spawns span more
than eight of the kernels' 1,024-spawn tiles (before the fixed look-back,
such a key's sum came out in an order that depended on which tiles had
finished).  The anchor's 12-orbital system steps twice from one state
with fixed uniforms in a 1-rank NCCL world: the arenas and metrics must
be equal bit for bit.  Run on a GPU machine with
``python -m pytest --noconftest tests/test_torch_step_repro_cuda.py -q``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fries_tpu_torch import dets, parallel, profiling, rung, synth  # noqa: E402
from fries_tpu_torch.drivers import frisys  # noqa: E402
from fries_tpu_torch.ops import ordered  # noqa: E402
from fries_tpu_torch.runtime import arena as ar  # noqa: E402
from fries_tpu_torch.runtime import merge, merge_multi  # noqa: E402

pytestmark = pytest.mark.cuda
REPEATS = 50
TILE = 1024          # merge_common.cuh kTile
LONG_RUN = 12 * TILE


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def long_run_case(device, n_rows=1, seed=0):
    """An arena of 20,000 two-word keys (some zero-valued) and 80,000
    spawns, ``LONG_RUN`` of them on one key, values over six decades."""
    rng = np.random.default_rng(seed)
    uni = np.unique(rng.integers(0, 2**20, size=(60_000, 2)), axis=0).astype(np.int64)
    occ = uni[np.sort(rng.choice(len(uni), 20_000, replace=False))]
    occ = occ[np.argsort(dets.pack_key(torch.as_tensor(occ)).numpy(), kind="stable")]
    cap = 1 << 17
    a = ar.make(cap, 2, n_rows)
    keys, vals = a.keys.clone(), a.vals.clone()
    keys[: len(occ)] = torch.as_tensor(occ)
    v = rng.standard_normal((n_rows, len(occ)))
    v[rng.random(v.shape) < 0.2] = 0.0
    vals[:, : len(occ)] = torch.as_tensor(v)
    a = ar.Arena(keys=keys.to(device), vals=vals.to(device),
                 n_used=torch.tensor([len(occ)], device=device))
    n_spawn = 80_000
    sk = uni[rng.integers(0, len(uni), n_spawn)]
    sk[:LONG_RUN] = occ[7]
    sk[rng.random(n_spawn) < 0.05] = dets.WORD_MASK
    sv = rng.standard_normal(n_spawn) * 10.0 ** rng.uniform(-3, 3, n_spawn)
    si = rng.random(n_spawn) < 0.6
    sr = rng.integers(0, n_rows, n_spawn)
    t = lambda x: torch.as_tensor(x, device=device)
    return a, t(sk), t(sv), t(si), t(sr)


def bits(x):
    return x.contiguous().view(torch.int64) if x.dtype == torch.float64 else x


def assert_repeatable(fn):
    """``fn()`` -> (arena, stats) ``REPEATS`` times: equal bit for bit."""
    first = fn()
    for _ in range(REPEATS - 1):
        a, st = fn()
        assert torch.equal(a.keys, first[0].keys)
        assert torch.equal(bits(a.vals), bits(first[0].vals))
        assert torch.equal(a.n_used, first[0].n_used)
        for k, v in st.items():
            assert torch.equal(bits(torch.as_tensor(v)), bits(torch.as_tensor(first[1][k]))), k
    return first


def test_kernel_a_repeatable(cuda):
    a, sk, sv, si, _ = long_run_case(cuda)
    before = profiling.total("launch.merge")
    got = assert_repeatable(lambda: merge.accumulate(a, sk, sv, si, 0, 0))
    assert profiling.total("launch.merge") == before + REPEATS
    ref = merge.accumulate_plain(a, sk, sv, si, 0, 0)
    assert torch.equal(got[0].keys, ref[0].keys)
    torch.testing.assert_close(got[0].vals, ref[0].vals, rtol=1e-12, atol=1e-12)


def test_kernel_c_repeatable(cuda):
    a, sk, sv, si, sr = long_run_case(cuda, n_rows=3, seed=1)
    before = profiling.total("launch.merge_multi")
    got = assert_repeatable(lambda: merge_multi.accumulate(a, sk, sv, sr, si))
    assert profiling.total("launch.merge_multi") == before + REPEATS
    ref = ar.accumulate_multi(a, sk, sv, sr, si)
    assert torch.equal(got[0].keys, ref[0].keys)
    torch.testing.assert_close(got[0].vals, ref[0].vals, rtol=1e-12, atol=1e-12)


def test_plain_merges_repeatable(cuda):
    a, sk, sv, si, _ = long_run_case(cuda, seed=2)
    assert_repeatable(lambda: merge.accumulate_plain(a, sk, sv, si, 0, 0))
    a, sk, sv, si, sr = long_run_case(cuda, n_rows=3, seed=3)
    assert_repeatable(lambda: ar.accumulate_multi(a, sk, sv, sr, si))


def test_ordered_cumsum_repeatable(cuda):
    rng = np.random.default_rng(4)
    x = torch.as_tensor(np.abs(rng.standard_normal(3_000_017)) * 10.0 ** rng.uniform(
        -6, 2, 3_000_017), device=cuda)
    first = ordered.cumsum(x)
    for _ in range(REPEATS - 1):
        assert torch.equal(bits(ordered.cumsum(x)), bits(first))
    ref = torch.cumsum(x.cpu(), 0)
    torch.testing.assert_close(first.cpu(), ref, rtol=1e-12, atol=0)


def test_one_rank_step_repeatable(cuda):
    """The anchor's system (12 orbitals, 6 electrons, seed 5) at a tenth of
    its budgets, warmed up 3 steps, then one step from that state twice
    with fixed uniforms."""
    ham = synth.make_system(12, 6, seed=5, scale_two=0.1, device=cuda)
    cfg = frisys.FrisysConfig(eps=0.02, vec_nonz=2_000, matr_samp=10_000, capacity=1 << 15,
                              spawn_cap=40_000, target_norm=4_000.0, init_thresh=1.0)
    shards = parallel.init_world(0, 1, "nccl", cuda)
    try:
        step, _, state, aux = frisys.build_sharded(
            ham, dataclasses.replace(cfg, n_shards=1), 6, shards)
        est = rung.estimator_args(aux)
        for _ in range(3):
            state, _ = step(state, *est)
        rns = torch.rand(6, dtype=torch.float64, generator=torch.Generator().manual_seed(7))
        outs = [step(state, *est, rns=rns, rn_vec=0.37) for _ in range(2)]
    finally:
        parallel.close_world()
    (s0, m0), (s1, m1) = outs
    assert torch.equal(s0.arena.keys, s1.arena.keys)
    assert torch.equal(bits(s0.arena.vals), bits(s1.arena.vals))
    for k in m0:
        assert torch.equal(bits(torch.as_tensor(m0[k])), bits(torch.as_tensor(m1[k]))), k
