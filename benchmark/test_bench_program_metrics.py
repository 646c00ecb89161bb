"""The readers of the program's spans and counters on fixed inputs:
``read_idle_ms`` from the host reads' device ranges (and, without them,
from the copies to the host), ``launch_idle_ms`` as the rest of the
window's idle, ``fixpoint_rounds`` from the last step's reads; and the
harness's wrapper on ``profiling.host_read`` seeing every read of a CPU
step."""

import json

import pytest
import torch

from benchmark import catalog, spans
from fries_tpu_torch import profiling

READ = "fries_tpu_torch.profiling.host_read"
D2H = "Memcpy DtoH (Device -> Pinned)"


def _trace(path, ranges=True):
    ev = [
        {"cat": "kernel", "name": "k1", "ts": 0, "dur": 10},
        {"cat": "gpu_memcpy", "name": D2H, "ts": 12, "dur": 2},     # read 1 ends at 14
        {"cat": "kernel", "name": "k2", "ts": 20, "dur": 10},       # 6 idle after it
        {"cat": "kernel", "name": "k3", "ts": 25, "dur": 20},       # busy to 45
        {"cat": "gpu_memcpy", "name": D2H, "ts": 30, "dur": 2},     # read 2: idle 45..50
        {"cat": "kernel", "name": "k4", "ts": 50, "dur": 10},
        {"cat": "gpu_memcpy", "name": D2H, "ts": 61, "dur": 1},     # read 3: nothing after
    ]
    if ranges:
        ev += [{"cat": "gpu_user_annotation", "name": READ, "ts": ts, "dur": dur}
               for ts, dur in ((12, 2), (30, 2), (61, 1))]
    path.write_text(json.dumps({"traceEvents": ev}))
    return path


@pytest.mark.parametrize("ranges", [True, False])
def test_read_and_launch_idle(tmp_path, ranges):
    reading = spans.read_trace(_trace(tmp_path / "t.json", ranges), steps=2, window_s=100e-6,
                               labels={READ})
    assert reading.busy_s == pytest.approx(48e-6)   # 10 + 2 + 25 + 10 + 1
    ctx = {"trace": reading, "steps": 2}
    read_idle = catalog.metric("read_idle_ms")
    assert read_idle.FUNCTIONS == (READ,)
    assert read_idle.read(ctx) == pytest.approx((6 + 5) * 1e-3 / 2)
    launch = catalog.metric("launch_idle_ms").read(ctx)
    assert launch == pytest.approx((100 - 48 - 11) * 1e-3 / 2)
    idle_pct = catalog.metric("idle_pct").read(ctx)
    assert read_idle.read(ctx) + launch == pytest.approx(idle_pct / 100 * 100e-3 / 2)


def test_no_reads_no_read_idle(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [{"cat": "kernel", "name": "k", "ts": 0,
                                                 "dur": 10}]}))
    ctx = {"trace": spans.read_trace(path, 1, 20e-6, {READ}), "steps": 1}
    with profiling.step(0):
        pass
    assert catalog.metric("read_idle_ms").read(ctx) == 0.0
    assert catalog.metric("launch_idle_ms").read(ctx) == pytest.approx(10e-3)


def _cpu_step():
    from fries_tpu_torch import synth
    from fries_tpu_torch.drivers import frisys

    ham = synth.make_system(5, 4, seed=1)
    cfg = frisys.FrisysConfig(eps=0.05, vec_nonz=20, matr_samp=40, capacity=64, spawn_cap=64)
    step, _, state, aux = frisys.build(ham, cfg, seed=0)
    est = [aux[k] for k in ("num_keys", "num_vals", "den_keys", "den_vals", "ref_key")]
    return lambda state: step(state, *est), state


def test_the_wrapper_sees_every_read_and_the_rounds_are_read():
    step, state = _cpu_step()
    sp = spans.Spans()
    sp.install(READ, lambda *a, result=None, **k: (torch.zeros(()), torch.zeros(())))
    sp.counting = True
    try:
        state, _ = step(state)
    finally:
        sp.remove()
    last = profiling.last_step_counts()
    *_, calls = sp.totals(READ)
    assert calls == sum(last.values()) > 0
    rounds = catalog.metric("fixpoint_rounds").read({})
    assert rounds == last["fixpoint.comp_sub"] + last["fixpoint.preserve"] >= 8
