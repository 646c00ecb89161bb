"""Stochastic sharded runs of the port in a 2-rank gloo world, checked as
``tests/test_sharded.py`` checks the reference's (FCIQMC and frisys: no
overflow, a finite correlation energy in (-2, 0) past step 100).  The ranks
run ``tests/torch_world.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_world  # noqa: E402
from fries_tpu_torch import parallel  # noqa: E402
from test_torch_sharded_drivers import ham41  # noqa: E402

N_RANKS = 2


@pytest.fixture(scope="module")
def runs():
    fq = dict(eps=0.02, target_walkers=400.0, capacity=64, attempt_cap=512,
              distribution="NU", n_shards=N_RANKS, exchange_cap=256)
    fs = dict(eps=0.05, vec_nonz=64, matr_samp=128, capacity=64, spawn_cap=256,
              target_norm=300.0, n_shards=N_RANKS, exchange_cap=128)
    runs = [("fciqmc", dict(cfg=fq, n_iter=300, seed=2, init_walkers=80.0)),
            ("frisys", dict(cfg=fs, n_iter=400, seed=1))]
    return parallel.launch(torch_world.equivalences, N_RANKS, "gloo", "cpu", args=(ham41(), runs),
                           timeout=110, join_timeout=120)


@pytest.mark.parametrize("name", ["fciqmc", "frisys"])
def test_sharded_stochastic_runs(runs, name):
    for r in range(1, N_RANKS):   # the metrics are replicated
        for k, v in runs[0][name].items():
            np.testing.assert_array_equal(runs[r][name][k].numpy(), v.numpy(), err_msg=k)
    traj = runs[0][name]
    assert not traj["overflow"].any()
    num, den = traj["proj_num"][100:].numpy(), traj["proj_den"][100:].numpy()
    e = num.sum() / den.sum()
    assert np.isfinite(e) and -2.0 < e < 0.0, e
