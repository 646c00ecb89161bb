"""The flagship run on the card against the CPU (marked ``cuda``; skips
without a CUDA device).  The small system of the card-against-CPU checks
(8 orbitals, 4 electrons), its CPU CISD trial, a 6-determinant
deterministic space, deadbeat damping and tracking: ``flagship.run`` for
40 iterations on the card (kernels A and B, counted) and on the CPU (their
plain versions) from one seed.  Determinant counts and the arena's keys
exact, the estimators, the shift, the norm and the arena's values within
rtol 1e-10, and the card's statistics the CPU's (the gate's verdict equal,
its numbers within rtol 1e-9).  Run on a GPU machine with
``python -m pytest --noconftest tests/test_torch_flagship_cuda.py -q``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fries_tpu_torch import cisd, flagship, profiling, synth  # noqa: E402

pytestmark = pytest.mark.cuda
SYMM = np.array([0, 1, 0, 1, 0, 1, 2, 3])
N_ITERS = 40
META = {"exact_corr": -0.2, "budget": 1000, "capacity": 4096, "published": "none", "rows": {}}
FLAGS = ["--determ", "6", "--initiator", "1.0", "--eps", "0.05", "--iters", str(N_ITERS),
         "--burn", "10", "--scan", "10", "--block", "20", "--save_interval", "20",
         "--seed", "20"]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_flagship_card_matches_cpu(cuda, tmp_path):
    e, words, vals = cisd.cisd_ground_state(synth.make_system(8, 4, symm=SYMM, seed=3))
    trial = (words.numpy(), vals.numpy())
    out = {}
    for dev in ("cpu", "cuda"):
        ham = synth.make_system(8, 4, symm=SYMM, seed=3, device=dev)
        args = flagship.parser().parse_args(
            [*FLAGS, "--device", dev, "--result_dir", str(tmp_path / dev)])
        profiling.reset("launch.merge", "launch.emit")
        out[dev] = flagship.run(ham, trial, args, META, e_cisd=e, log=lambda s: None)
        out[dev]["launches"] = (profiling.total("launch.merge"), profiling.total("launch.emit"))
    assert out["cuda"]["launches"] == (N_ITERS, 3 * N_ITERS)
    assert out["cpu"]["launches"] == (0, 0)
    for name in flagship.STREAMS:
        cpu = np.loadtxt(tmp_path / "cpu" / f"{name}.txt")
        card = np.loadtxt(tmp_path / "cuda" / f"{name}.txt")
        assert cpu.shape == card.shape == (N_ITERS,)
        if name == "nkept":
            np.testing.assert_array_equal(card, cpu)
        else:
            np.testing.assert_allclose(card, cpu, rtol=1e-10, atol=0, err_msg=name)
    with np.load(tmp_path / "cpu" / "checkpoint.npz") as c, \
            np.load(tmp_path / "cuda" / "checkpoint.npz") as g:
        np.testing.assert_array_equal(g["keys"], c["keys"])
        np.testing.assert_allclose(g["vals"], c["vals"], rtol=1e-10, atol=1e-12)
    cpu, card = out["cpu"], out["cuda"]
    assert set(card) == set(cpu)
    for k in ("e_corr", "iat", "efficiency", "error_mEh", "two_sigma_mEh",
              "unconverged_estimate_mEh", "norm_max"):
        if k in cpu:
            np.testing.assert_allclose(card[k], cpu[k], rtol=1e-9, err_msg=k)
    for k in ("n_independent_samples", "within_0p1_mEh", "n_dets_final"):
        assert card.get(k) == cpu.get(k), k
    assert card["card"] and card["peak_mem_bytes"] > 0
