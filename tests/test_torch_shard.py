"""fries_tpu_torch.runtime.shard and fries_tpu_torch.parallel against the
reference: the FNV-1a owner hash bit-exact for W = 1..4, each rank's block
of distribute_rows equal to its slice of the reference's stacked arrays,
and both exchanges in a 2-rank gloo world equal to the reference's under
shard_map (``tests/test_sharded.py:_run_exchange``) array for array, with
the ragged and dense paths delivering the same multiset.  Also the launcher:
a rank that fails surfaces in the parent, and the join timeout holds."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import torch_world  # noqa: E402
from fries_tpu import dets as jd  # noqa: E402
from fries_tpu import parallel as jpar  # noqa: E402
from fries_tpu.runtime import shard as jsh  # noqa: E402
from fries_tpu_torch import parallel  # noqa: E402
from fries_tpu_torch.runtime import shard as tsh  # noqa: E402
from test_sharded import _run_exchange  # noqa: E402

N = 2


@pytest.mark.parametrize("n_words", [1, 2, 3, 4])
@pytest.mark.parametrize("n_shards", [2, 3, 8])
def test_shard_of_words_bit_exact(n_words, n_shards):
    rng = np.random.default_rng(n_words * 10 + n_shards)
    words = rng.integers(0, 1 << 32, size=(5000, n_words), dtype=np.uint64).astype(np.uint32)
    words[:4] = 0xFFFFFFFF           # words near the top of the range
    words[4:8] = 0
    for seed in (0, 12345):
        want = np.asarray(jsh.shard_of_words(jnp.asarray(words), n_shards, seed))
        got = tsh.shard_of_words(torch.as_tensor(words.astype(np.int64)), n_shards, seed)
        np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) == n_shards


def exchange_inputs(seed, s_local=256, w=2):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 20, size=(N, s_local, w)).astype(np.uint32)
    inv = rng.random((N, s_local)) < 0.2
    keys[inv] = np.asarray(jd.invalid_det(w))
    amps = rng.standard_normal((N, s_local))
    amps[inv] = 0.0
    return keys, amps


@pytest.fixture(scope="module")
def world():
    """One 2-rank world: both exchanges at a wide and at an overflowing
    buffer, and distribute_rows."""
    keys, amps = exchange_inputs(7)
    rng = np.random.default_rng(9)
    init_keys = np.unique(rng.integers(0, 1 << 16, size=(60, 2)).astype(np.uint32), axis=0)
    init_vals = rng.standard_normal((2, len(init_keys)))
    args = [(keys, amps, 200, 400), (keys, amps, 40, 80)]
    out = parallel.launch(torch_world.shard_world, N, "gloo", "cpu",
                          args=(args, init_keys, init_vals, 64), timeout=60, join_timeout=120)
    return keys, amps, init_keys, init_vals, out


@pytest.mark.parametrize("case", [0, 1])
@pytest.mark.parametrize("mode", ["dense", "ragged"])
def test_exchange_matches_reference(world, mode, case):
    keys, amps, *_, out = world
    cap_dense, cap_ragged = [(200, 400), (40, 80)][case]
    rk, ra, ovf = _run_exchange(mode, jnp.asarray(keys), jnp.asarray(amps), N, cap_dense)
    assert ovf == (case == 1)
    for r in range(N):
        gk, ga, gov = out[r]["exchange"][case][mode]
        assert gov == ovf
        if not ovf:   # past an overflow the rows are not defined, only the flag
            np.testing.assert_array_equal(gk, rk[r].astype(np.int64))
            np.testing.assert_array_equal(ga, ra[r])
    if not ovf:   # every live row sits on the rank its hash names
        for r in range(N):
            gk = out[r]["exchange"][case][mode][0]
            live = gk[:, -1] != 0xFFFFFFFF
            assert live.sum() > 0
            assert (tsh.shard_of_words(torch.as_tensor(gk[live]), N) == r).all()


def test_ragged_and_dense_deliver_the_same_multiset(world):
    out = world[-1]
    for r in range(N):
        rows = {}
        for mode in ("dense", "ragged"):
            gk, ga, _ = out[r]["exchange"][0][mode]
            live = gk[:, -1] != 0xFFFFFFFF
            rows[mode] = sorted(zip(map(tuple, gk[live].tolist()), ga[live].tolist()))
        assert rows["dense"] == rows["ragged"]
    sent = (world[0][..., -1] != 0xFFFFFFFF).sum()
    got = sum((out[r]["exchange"][0]["ragged"][0][:, -1] != 0xFFFFFFFF).sum() for r in range(N))
    assert got == sent


def test_distribute_rows_matches_reference(world):
    _, _, init_keys, init_vals, out = world
    gk, gv, gn = (np.asarray(x) for x in jpar.distribute_rows(
        jnp.asarray(init_keys), jnp.asarray(init_vals), N, 64))
    for r in range(N):
        a = out[r]["distribute"]
        rows = slice(r * 64, (r + 1) * 64)
        np.testing.assert_array_equal(a["keys"], gk[rows].astype(np.int64))
        np.testing.assert_array_equal(a["vals"], gv[:, rows])
        assert a["n_used"] == int(gn[r])


def test_failed_rank_surfaces_in_parent():
    with pytest.raises(Exception, match="rank 1 fails"):
        parallel.launch(torch_world.fail_on_rank_one, N, "gloo", "cpu", timeout=30,
                        join_timeout=120)


def test_default_launch_needs_cards():
    """The default world is NCCL on the cards: without enough of them it
    stops before any rank starts, and never falls back to the CPU."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= N:
        pytest.skip("enough cards are visible")
    with pytest.raises(RuntimeError, match="nccl with 2 ranks needs 2 CUDA devices"):
        parallel.launch(torch_world.fail_on_rank_one, N, timeout=30, join_timeout=60)


def test_join_timeout_kills_ranks():
    with pytest.raises(TimeoutError):
        parallel.launch(torch_world.sleep_forever, N, "gloo", "cpu", timeout=30, join_timeout=8)
