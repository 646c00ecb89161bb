"""fries_tpu_torch.profile_step's reading of a chrome trace, on a small
hand-made trace: the device's busy time and idle share, the per-phase time,
and the time inside each pair of nested phases, from device ranges and
from the program's host spans (the device operations they launched)."""

import json

import pytest

pytest.importorskip("torch")

from fries_tpu_torch import profile_step  # noqa: E402

LABELS = {"fries.comp_sub_factored", "fries.fixpoint", "fries.spawn"}


def write_trace(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def test_trace_device_activity_phases_and_pairs(tmp_path):
    events = [
        {"cat": "kernel", "name": "k1", "ts": 10, "dur": 5},
        {"cat": "kernel", "name": "k2", "ts": 20, "dur": 3},
        {"cat": "gpu_memcpy", "name": "copy", "ts": 21, "dur": 1},
        {"cat": "kernel", "name": "k3", "ts": 40, "dur": 2},
        {"cat": "gpu_user_annotation", "name": "fries.comp_sub_factored", "ts": 5,
         "dur": 30},
        {"cat": "gpu_user_annotation", "name": "fries.fixpoint", "ts": 18, "dur": 10},
        {"cat": "gpu_user_annotation", "name": "fries.spawn", "ts": 0, "dur": 50},
        {"cat": "gpu_user_annotation", "name": "unlabelled", "ts": 0, "dur": 50},
    ]
    busy, idle, n_ops, top, phases, pairs = profile_step.trace_device_activity(
        write_trace(tmp_path, events), 2, LABELS)
    # busy: [10, 15) + [20, 23) (the copy overlaps k2) + [40, 42), over 2 steps
    assert busy == pytest.approx(10 / 1e3 / 2)
    assert idle == pytest.approx(1 - 10 / 32)
    assert n_ops == 2.0
    assert top == pytest.approx({"k1": 2.5e-3, "k2": 1.5e-3, "k3": 1e-3, "copy": 0.5e-3})
    # operations are charged to every phase whose range they start in
    assert phases == pytest.approx({"fries.comp_sub_factored": 4.5e-3, "fries.fixpoint": 2e-3,
                                    "fries.spawn": 5.5e-3})
    # the spawn, which encloses most phases, is left out of the pairs
    assert pairs == pytest.approx({"fries.comp_sub_factored & fries.fixpoint": 2e-3})


def test_trace_device_activity_without_device_operations(tmp_path):
    events = [{"cat": "gpu_user_annotation", "name": "fries.comp_sub_factored", "ts": 0,
               "dur": 5}]
    assert profile_step.trace_device_activity(write_trace(tmp_path, events), 1, LABELS) \
        == (0.0, 1.0, 0.0, {}, {}, {})


def test_program_spans_own_what_they_launched(tmp_path):
    """A ``fries.*`` host span owns the device operations whose runtime
    call (same correlation id) it encloses, nested spans counting in each
    enclosing one; the step and the spawn stay out of the pairs."""
    launch = lambda ts, corr: {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                               "dur": 1, "tid": 7, "args": {"correlation": corr}}
    kernel = lambda ts, dur, corr: {"cat": "kernel", "name": f"k{corr}", "ts": ts, "dur": dur,
                                    "args": {"correlation": corr}}
    span = lambda name, ts, dur, tid=7: {"cat": "cpu_op", "name": name, "ts": ts, "dur": dur,
                                         "tid": tid}
    events = [
        span("fries.step", 0, 100), span("fries.spawn", 1, 60), span("fries.stage.cd", 2, 40),
        span("fries.fixpoint", 10, 20), span("fries.merge", 70, 20),
        span("fries.merge", 0, 100, tid=8),              # another thread's: owns nothing
        {"cat": "cpu_op", "name": "aten::add", "ts": 3, "dur": 2, "tid": 7},
        launch(3, 1), launch(12, 2), launch(35, 3), launch(75, 4), launch(95, 5),
        kernel(50, 4, 1), kernel(60, 2, 2), kernel(70, 6, 3), kernel(90, 8, 4),
        kernel(110, 1, 5), kernel(120, 3, 6),         # 6: no runtime call in the trace
    ]
    path = write_trace(tmp_path, events)
    assert profile_step.program_spans(path) == {"fries.step", "fries.spawn", "fries.stage.cd",
                                                "fries.fixpoint", "fries.merge"}
    *_, phases, pairs = profile_step.trace_device_activity(
        path, 1, profile_step.program_spans(path))
    assert phases == pytest.approx({"fries.step": 21e-3, "fries.spawn": 12e-3,
                                    "fries.stage.cd": 12e-3, "fries.fixpoint": 2e-3,
                                    "fries.merge": 8e-3})
    assert pairs == pytest.approx({"fries.fixpoint & fries.stage.cd": 2e-3})
