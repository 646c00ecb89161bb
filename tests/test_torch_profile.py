"""fries_tpu_torch.profile_step's reading of a chrome trace, on a small
hand-made trace: the device's busy time and idle share, the per-phase time,
and the time inside each pair of nested phases."""

import json

import pytest

pytest.importorskip("torch")

from fries_tpu_torch import profile_step  # noqa: E402

LABELS = {"C+D", "threshold fixpoint", "spawn (total)"}


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
        {"cat": "gpu_user_annotation", "name": "C+D", "ts": 5, "dur": 30},
        {"cat": "gpu_user_annotation", "name": "threshold fixpoint", "ts": 18, "dur": 10},
        {"cat": "gpu_user_annotation", "name": "spawn (total)", "ts": 0, "dur": 50},
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
    assert phases == pytest.approx({"C+D": 4.5e-3, "threshold fixpoint": 2e-3,
                                    "spawn (total)": 5.5e-3})
    # the spawn, which encloses most phases, is left out of the pairs
    assert pairs == pytest.approx({"C+D & threshold fixpoint": 2e-3})


def test_trace_device_activity_without_device_operations(tmp_path):
    events = [{"cat": "gpu_user_annotation", "name": "C+D", "ts": 0, "dur": 5}]
    assert profile_step.trace_device_activity(write_trace(tmp_path, events), 1, LABELS) \
        == (0.0, 1.0, 0.0, {}, {}, {})
