"""Kernels A and C on keys wider than four words (W = 5..16: 64-bit limb
keys, L = ceil(W / 2)) against their plain versions on the card, and a
five-word frisys step (65 orbitals) on the card against the CPU.

Marked ``cuda``: every test skips without a CUDA device (decided inside the
``cuda`` fixture, never at import).  Run on a GPU machine with
``python -m pytest --noconftest tests/test_torch_wider_cuda.py -q``.
Inputs are made from a seed with numpy (tests/test_torch_kernels_cuda.py's
made-up streams: half the keys copies of the others with one word
redrawn); keys, counts and flags exact, values at rtol 1e-12."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from fries_tpu_torch import profiling, synth  # noqa: E402
from fries_tpu_torch.drivers import frisys  # noqa: E402
from test_torch_kernels_cuda import (WIDE_CASES, card_steps_match_cpu, run_merge,  # noqa: E402
                                     run_merge_multi, wide_regime)

pytestmark = pytest.mark.cuda

WIDER = [5, 6, 7, 8, 16]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("case", sorted(WIDE_CASES))
@pytest.mark.parametrize("n_words", WIDER)
def test_merge_wider_matches_plain(cuda, n_words, case):
    rng = np.random.default_rng(900 + 10 * n_words + len(case))
    a, sk, sv, _, si = wide_regime(rng, n_words, case)
    run_merge(cuda, a, sk, sv, si, (1, 0, 0))
    keep = torch.as_tensor(rng.random(a.capacity) < 0.05)
    run_merge(cuda, a, sk, sv, si, (2, 0, 1), keep)


@pytest.mark.parametrize("case", sorted(WIDE_CASES))
@pytest.mark.parametrize("n_words", WIDER)
def test_merge_multi_wider_matches_plain(cuda, n_words, case):
    rng = np.random.default_rng(1000 + 10 * n_words + len(case))
    stats = run_merge_multi(cuda, *wide_regime(rng, n_words, case, n_rows=3))
    assert bool(stats["overflow"]) == (case == "overflow")


def test_five_word_frisys_step_cuda_matches_cpu(cuda):
    """Five-word frisys steps (65 orbitals, 130 bits) on the card and on
    the CPU from one state with the same uniforms."""
    cfg = frisys.FrisysConfig(eps=0.01, vec_nonz=400, matr_samp=2000, capacity=8192,
                              spawn_cap=2600, target_norm=2000.0, shift_interval=2)
    built = {dev: frisys.build(synth.make_system(65, 4, symm=np.arange(65) % 4, seed=5,
                                                 scale_two=0.1, device=dev), cfg, seed=4)
             for dev in ("cpu", cuda)}
    m0, e0 = profiling.total("launch.merge"), profiling.total("launch.emit")
    card_steps_match_cpu(cuda, built, 3, 3)
    assert profiling.total("launch.merge") - m0 == 3 and profiling.total("launch.emit") - e0 == 9
