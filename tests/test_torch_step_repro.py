"""Run-to-run reproducibility of the port on the CPU: a sharded frisys
step repeated from one state gives the same bits, in a 2-rank gloo world
and in a 1-rank world (``tests/torch_world.repeat_steps``), and so does a
run from one seed; the fixed-order helpers of ``ops.ordered`` against the
torch calls they stand for on the card.  The card's own checks are in
``tests/test_torch_step_repro_cuda.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_world  # noqa: E402
from fries_tpu_torch import parallel  # noqa: E402
from fries_tpu_torch.ops import ordered  # noqa: E402
from fries_tpu_torch.runtime import emit  # noqa: E402

CFG = dict(eps=0.05, vec_nonz=300, matr_samp=600, capacity=2048, spawn_cap=2400,
           target_norm=600.0, init_thresh=1.0)


def assert_repeats(out):
    assert out["runs"][0] == out["runs"][1]
    assert out["steps"][0] == out["steps"][1]


def test_two_rank_world_repeats():
    ranks = parallel.launch(torch_world.repeat_steps, 2, "gloo", "cpu",
                            args=(dict(CFG, n_shards=2, exchange_cap=2400), 6, 11),
                            timeout=60, join_timeout=90)
    for out in ranks:
        assert_repeats(out)
    assert ranks[0]["steps"][0] != ranks[1]["steps"][0]   # each rank holds its own rows


def test_one_rank_world_repeats():
    shards = parallel.init_world(0, 1, "gloo", "cpu")
    try:
        out = torch_world.repeat_steps(shards, dict(CFG, n_shards=1), 6, 11)
    finally:
        parallel.close_world()
    assert_repeats(out)


@pytest.mark.parametrize("n", [0, 1, 2, 1023, 1024, 1025, 5000, 1_100_000])
def test_blocked_cumsum(n):
    """The card's scan (blocks of 1,024 as rows, the totals carried by the
    same scan) against ``torch.cumsum``: within rtol 1e-12 of the running
    total of |x|, and the same bits twice."""
    x = torch.as_tensor(np.random.default_rng(n).standard_normal(n))
    got = ordered.blocked_cumsum(x)
    assert got.shape == x.shape
    assert torch.equal(got, ordered.blocked_cumsum(x))
    scale = torch.cumsum(x.abs(), 0)
    assert bool(((got - torch.cumsum(x, 0)).abs() <= 1e-12 * scale).all())
    assert torch.equal(ordered.cumsum(x), torch.cumsum(x, 0))   # the CPU's own scan


def test_index_add_on_the_cpu_is_torch_index_add():
    rng = np.random.default_rng(3)
    idx = torch.as_tensor(rng.integers(0, 50, 4000))
    val = torch.as_tensor(rng.standard_normal((4000, 3)))
    got = ordered.index_add(torch.zeros(50, 3, dtype=torch.float64), idx, val)
    assert torch.equal(got, torch.zeros(50, 3, dtype=torch.float64).index_add_(0, idx, val))
    put = torch.zeros(50, 3, dtype=torch.float64).index_put_((idx,), val, accumulate=True)
    torch.testing.assert_close(put, got, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", [(1, 7), (5, 1), (300, 210)])
def test_row_prefix_runs_left_to_right(shape):
    """Kernel B's plain version takes each row's f32 prefix left to right,
    as the kernel walks it: the transposed scan it runs on the card gives
    the row scan's bits."""
    rows = torch.as_tensor(np.random.default_rng(1).random(shape), dtype=torch.float32)
    want = torch.cumsum(rows, -1)
    assert torch.equal(emit._row_prefix(rows), want)
    cols = torch.cat([rows, rows]) if shape[0] == 1 else rows
    assert torch.equal(torch.cumsum(cols.T.contiguous(), 0).T[: shape[0]], want)
