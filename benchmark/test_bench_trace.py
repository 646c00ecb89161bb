"""The byte counts and the trace reading on fixed inputs."""

import json

import pytest
import torch

from benchmark import roofline, spans
from fries_tpu_torch.runtime import arena as ar


def test_merge_bytes():
    a = ar.make(100, 2, 2)
    a = ar.Arena(keys=a.keys, vals=a.vals, n_used=torch.tensor([30]))
    keys = torch.zeros((50, 2), dtype=torch.int64)
    vals = torch.zeros(50, dtype=torch.float64)
    ini = torch.zeros(50, dtype=torch.bool)
    keep = torch.zeros(100, dtype=torch.bool)
    n_bytes, ops = roofline.merge_bytes(a, keys, vals, ini, 0, 1, keep_mask=keep)
    # rows of 2 words + 2 values (32 B): 30 in, 100 out; spawns 50 * 25 B; keep 30 B
    assert int(n_bytes) == 32 * 130 + 50 * 25 + 30 and int(ops) == 0


def test_emit_bytes_dense_and_factored():
    plan = {"offsets": torch.zeros(4, dtype=torch.int64), "out_size": 10,
            "uniform": torch.tensor([False, True, False, False]),
            "w_sub": torch.zeros((4, 6), dtype=torch.float32)}
    parent = torch.tensor([0, 0, 1, 2, -1])
    sub = torch.tensor([1, 4, 0, 2, -1])
    n_bytes, ops = roofline.emit_bytes(plan, parent, sub)
    # parents 0 (walks 5 columns) and 2 (3) weighted, 1 uniform, 3 idle
    assert int(n_bytes) == 8 * 4 + 25 * 2 + 49 + 4 * 8 + 24 * 10 and int(ops) == 2 * 8
    fplan = dict(plan, fa=torch.zeros((4, 2), dtype=torch.float32),
                 fb=torch.zeros((4, 3), dtype=torch.float32), kill_b0=None)
    del fplan["w_sub"]
    n_bytes, ops = roofline.emit_bytes(fplan, parent, sub)
    # columns 5 = (e 0..1, v ..3) and 3 = (e 0, v 3): fa 2 + 1, fb 3 + 3 entries
    assert int(n_bytes) == 8 * 4 + 25 * 2 + 49 + 4 * (3 + 6) + 24 * 10 and int(ops) == 3 * 8


def test_bound_takes_the_larger_time():
    assert roofline.bound_s(3.35e12) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)


def _trace(path):
    ev = [
        {"cat": "kernel", "name": "k1", "ts": 0, "dur": 10},
        {"cat": "kernel", "name": "k2", "ts": 5, "dur": 10},     # overlaps k1
        {"cat": "kernel", "name": "k1", "ts": 30, "dur": 20},
        {"cat": "gpu_memcpy", "name": "copy", "ts": 60, "dur": 10},
        {"cat": "gpu_user_annotation", "name": "m.f", "ts": 0, "dur": 20},
        {"cat": "gpu_user_annotation", "name": "m.g", "ts": 28, "dur": 30},
        {"cat": "user_annotation", "name": "m.f", "ts": 0, "dur": 26},
        {"cat": "cpu_op", "name": "aten::item", "ts": 16, "dur": 8},
    ]
    path.write_text(json.dumps({"traceEvents": ev}))
    return path


def test_trace_reading(tmp_path):
    r = spans.read_trace(_trace(tmp_path / "t.json"), steps=2, window_s=100e-6,
                         labels={"m.f", "m.g"})
    assert r.busy_s == pytest.approx(45e-6)          # [0, 15] + [30, 50] + [60, 70]
    assert r.device_s(["m.f"]) == pytest.approx(20e-6)
    assert r.device_s(["m.g"]) == pytest.approx(20e-6)
    assert r.device_s(["m.f", "m.g"]) == pytest.approx(40e-6)
    assert r.device_s(["m.h"]) is None
    assert r.device_ops[0] == ["k1", pytest.approx(30e-6)]
    assert r.idle_gaps[0] == ["f / aten::item", pytest.approx(15e-6)]
    assert ["outside the spans", pytest.approx(10e-6)] in r.idle_gaps
    ctx = {"trace": r, "steps": 2}
    assert spans.device_ms_per_step(ctx, ["m.f"]) == pytest.approx(1e-2)


def test_spans_wrap_and_count():
    from benchmark import catalog

    sp = spans.Spans()
    mod = catalog.metric("merge_roofline")
    for fn in mod.FUNCTIONS:
        sp.install(fn, mod.COUNTS.get(fn))
    from fries_tpu_torch.runtime import merge

    assert merge.accumulate.__wrapped__ is not None
    sp.counting = True
    a = ar.from_unsorted(ar.make(8, 1, 1), torch.tensor([[3]]), torch.tensor([[1.0]]))
    merge.accumulate(a, torch.tensor([[3], [5]]), torch.tensor([0.5, 0.25], dtype=torch.float64),
                     torch.tensor([True, True]))
    sp.remove()
    assert not hasattr(merge.accumulate, "__wrapped__")
    n_bytes, _, calls = sp.totals(mod.ENTRY)
    assert calls == 1 and n_bytes == 16 * (1 + 8) + 2 * 17
