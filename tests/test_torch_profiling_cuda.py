"""The program's host reads against the card's synchronizations, on a tiny
frisys step.

Marked ``cuda``: every test skips without a CUDA device (decided inside the
``cuda`` fixture, never at import).  Run on a GPU machine with
``python -m pytest --noconftest tests/test_torch_profiling_cuda.py -q``.
In ``torch.cuda`` sync debug mode one step warns once per synchronizing
call: each of the step's reads (``profiling.host_read``, the warnings
raised at its line) is one, and every other one is a copy of host data to
the card (``Memcpy HtoD`` in the trace of the same step: a tensor made on
the card from a host value waits for the card).  Under the profiler, each
read is one ``fries.read.<site>`` range and one copy to the host."""

import inspect
import json
import warnings
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from fries_tpu_torch import profiling, synth  # noqa: E402
from fries_tpu_torch.drivers import frisys  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tiny_step(cuda):
    ham = synth.make_system(8, 4, seed=3, device=cuda)
    cfg = frisys.FrisysConfig(eps=0.02, vec_nonz=60, matr_samp=400, capacity=1024,
                              spawn_cap=512, target_norm=400.0)
    step, _, state, aux = frisys.build(ham, cfg, seed=5)
    est = [aux[k] for k in ("num_keys", "num_vals", "den_keys", "den_vals", "ref_key")]
    for _ in range(4):
        state, _ = step(state, *est)
    torch.cuda.synchronize()
    return lambda state: step(state, *est), state


def test_syncs_are_the_reads_and_the_host_to_card_copies(tiny_step, tmp_path):
    step, state = tiny_step
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught, profiling.trace(tmp_path):
            warnings.simplefilter("always")
            state, _ = step(state)
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    reads = profiling.last_step_counts()
    here = Path(inspect.getsourcefile(profiling)).resolve()
    at_reads = [w for w in syncs if Path(w.filename).resolve() == here]
    events = json.loads((tmp_path / profiling.TRACE_NAME).read_text())["traceEvents"]
    to_card = [e for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    assert reads["fixpoint.comp_sub"] >= 6 and reads["fixpoint.preserve"] >= 2
    assert len(at_reads) == sum(reads.values())
    assert len(syncs) == sum(reads.values()) + len(to_card)


def test_each_read_is_one_range_and_one_copy_to_the_host(tiny_step, tmp_path):
    step, state = tiny_step
    with profiling.trace(tmp_path):
        state, _ = step(state)
        torch.cuda.synchronize()
    reads = sum(profiling.last_step_counts().values())
    events = json.loads((tmp_path / profiling.TRACE_NAME).read_text())["traceEvents"]
    ranges = [e for e in events if str(e.get("name", "")).startswith(profiling.READ)
              and "dur" in e]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")]
    assert reads > 0 and len(ranges) == reads and len(copies) == reads
