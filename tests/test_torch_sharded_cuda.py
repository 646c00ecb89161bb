"""The port's sharding on the card (marked ``cuda``; each test skips without
a CUDA device).  A 2-rank gloo world on one card, which must take all three
collectives the port issues on CUDA tensors (a probe in the same kind of
world checks that first), steps a small system's sharded frisys and the
same 2-rank world on the CPU steps it from the same seed: keys, counts and
flags exact, values within rtol 1e-10 (kernels A and B on the card, their
plain versions on the CPU).  Run on a GPU machine with
``python -m pytest --noconftest tests/test_torch_sharded_cuda.py -q``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_world  # noqa: E402
from fries_tpu_torch import parallel, synth  # noqa: E402

pytestmark = pytest.mark.cuda
N = 2


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_sharded_frisys_card_matches_cpu(cuda):
    ham = synth.make_system(8, 4, symm=[0, 1, 0, 1, 0, 1, 2, 3], seed=3)
    h = {"hcore": ham.hcore.numpy(), "eris": ham.eris.numpy(), "symm": ham.symm.numpy(),
         "n_orb": 8, "n_elec": 4}
    cfg = dict(eps=0.02, vec_nonz=60, matr_samp=150, capacity=256, spawn_cap=200,
               target_norm=200.0, shift_interval=2, n_shards=N)
    refused = parallel.launch(torch_world.probe_cuda, N, "gloo", "cuda", timeout=60,
                              join_timeout=120)[0]
    assert refused == [], f"gloo refuses CUDA tensors in {refused}"
    card = parallel.launch(torch_world.frisys_small_steps, N, "gloo", "cuda",
                           args=(h, cfg, 12, 4), timeout=100, join_timeout=120)
    cpu = parallel.launch(torch_world.frisys_small_steps, N, "gloo", "cpu", args=(h, cfg, 12, 4),
                          timeout=100, join_timeout=120)
    for r in range(N):
        for (ca, cm), (pa, pm) in zip(card[r], cpu[r]):
            np.testing.assert_array_equal(ca["keys"], pa["keys"])
            assert ca["n_used"] == pa["n_used"]
            np.testing.assert_allclose(ca["vals"], pa["vals"], rtol=1e-10, atol=1e-12)
            for k, v in pm.items():
                if v.dtype.kind == "f":
                    np.testing.assert_allclose(cm[k], v, rtol=1e-10, atol=1e-12, err_msg=k)
                else:
                    np.testing.assert_array_equal(cm[k], v, err_msg=k)
    assert all(card[r][-1][0]["n_used"] > 5 for r in range(N))
