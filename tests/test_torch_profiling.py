"""fries_tpu_torch.profiling on the CPU: the Timer's counts, totals and
report format (the reference's: one line per block, longest total first),
a ``span`` inside ``trace`` (the Chrome trace file exists and names the
region), and a CPU ``sync`` tensor that waits for nothing; the shared null
span with no profiler; the program's spans nested in a traced frisys step;
the host reads of each step by site, and the counters."""

import json
import re
import time

import pytest

torch = pytest.importorskip("torch")

from fries_tpu_torch import profiling  # noqa: E402

LINE = re.compile(r"^(\S.{29}) +([0-9.]+) ms total \((\d+) calls, +([0-9.]+) ms/call\)$")


def test_timer_counts_and_report():
    t = profiling.Timer()
    for _ in range(3):
        with t.block("short", sync=torch.zeros(2)):
            pass
    with t.block("long"):
        time.sleep(0.02)
    with pytest.raises(ValueError):
        with t.block("raises"):
            raise ValueError("counted all the same")
    assert dict(t.counts) == {"short": 3, "long": 1, "raises": 1}
    assert t.totals["long"] >= 0.02
    lines = t.report().splitlines()
    assert len(lines) == 3 and lines[0].startswith("long ")
    for line in lines:
        m = LINE.match(line)
        assert m, line
        name, total, calls, per_call = m.groups()
        name = name.strip()
        assert int(calls) == t.counts[name]
        assert float(total) == pytest.approx(1e3 * t.totals[name], abs=0.05)
        assert float(per_call) == pytest.approx(1e3 * t.totals[name] / t.counts[name],
                                                abs=0.005)


def test_annotate_inside_trace(tmp_path):
    """A ``span`` (``annotate``'s successor) inside ``trace`` is a range of
    the Chrome trace."""
    with profiling.trace(tmp_path / "trace") as prof:
        with profiling.span("fries_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    path = tmp_path / "trace" / profiling.TRACE_NAME
    assert path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "fries_region" and "dur" in e for e in events)


def test_span_without_a_profiler_is_the_shared_null():
    assert profiling.span("fries.a") is profiling.span("fries.b") is profiling.NULL
    with profiling.span("fries.a") as entered:
        assert entered is None
    calls = []
    f = profiling.spanned("fries.f")(lambda x, y=1: calls.append((x, y)) or x + y)
    assert f(2, y=3) == 5 and calls == [(2, 3)]


def _tiny_frisys():
    from fries_tpu_torch import synth
    from fries_tpu_torch.drivers import frisys

    ham = synth.make_system(5, 4, seed=1)
    cfg = frisys.FrisysConfig(eps=0.05, vec_nonz=20, matr_samp=40, capacity=64, spawn_cap=64)
    step, _, state, aux = frisys.build(ham, cfg, seed=0)
    est = [aux[k] for k in ("num_keys", "num_vals", "den_keys", "den_vals", "ref_key")]
    return lambda state: step(state, *est), state


def _intervals(events, name):
    return [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("name") == name and "dur" in e]


def test_program_spans_nest_in_the_step(tmp_path):
    step, state = _tiny_frisys()
    state, _ = step(state)
    with profiling.trace(tmp_path):
        state, _ = step(state)
    events = json.loads((tmp_path / profiling.TRACE_NAME).read_text())["traceEvents"]
    (s0, s1), = _intervals(events, "fries.step")
    inner = ("fries.spawn", "fries.stage.ab", "fries.stage.cd", "fries.stage.e", "fries.merge",
             "fries.keys", "fries.preserve", "fries.fixpoint", "fries.seed", "fries.layout",
             "fries.emit", "fries.finalize", "fries.norm_weight", "fries.diagonal",
             "fries.estimator", "fries.sys_comp", "fries.read.fixpoint.comp_sub",
             "fries.read.fixpoint.preserve")
    for name in inner:
        spans = _intervals(events, name)
        assert spans and all(s0 <= a <= b <= s1 for a, b in spans), name
    (a0, a1), = _intervals(events, "fries.stage.cd")
    assert any(a0 <= a <= b <= a1 for a, b in _intervals(events, "fries.fixpoint"))


def test_the_step_index_is_the_step_span_input():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        with profiling.step(17):
            torch.ones(3).sum()
    step_events = [e for e in prof.events() if e.name == profiling.STEP]
    assert len(step_events) == 1 and step_events[0].concrete_inputs == [17]


def test_last_step_counts_hold_that_steps_reads(monkeypatch):
    """The reads of each step by site, as a wrapper on the module attribute
    sees them, replaced at the next step; reads outside a step count in the
    running totals only."""
    step, state = _tiny_frisys()
    seen = []
    read = profiling.host_read

    def watched(x, site):
        seen.append(site)
        return read(x, site)

    monkeypatch.setattr(profiling, "host_read", watched)
    for _ in range(3):
        seen.clear()
        state, _ = step(state)
        by_site = {site: seen.count(site) for site in set(seen)}
        assert profiling.last_step_counts() == by_site
        assert by_site["fixpoint.comp_sub"] >= 6 and by_site["fixpoint.preserve"] >= 2
    last = profiling.last_step_counts()
    before = profiling.total("test.outside")
    assert profiling.host_read(torch.tensor(4), "test.outside") == 4
    assert profiling.host_read(torch.tensor([1.5, 2.5]), "test.outside") == [1.5, 2.5]
    assert profiling.total("test.outside") == before + 2
    assert profiling.last_step_counts() == last


def test_an_inner_step_leaves_the_counts_to_the_outer():
    with profiling.step(0):
        profiling.host_read(torch.tensor(1), "test.outer")
        with profiling.step(1):
            profiling.host_read(torch.tensor(2), "test.inner")
        assert "test.inner" not in profiling.last_step_counts()
    assert profiling.last_step_counts() == {"test.outer": 1, "test.inner": 1}


def test_counters_total_and_reset():
    profiling.reset("test.a", "test.b")
    profiling.count("test.a")
    profiling.count("test.a", 2)
    profiling.count("test.b")
    assert profiling.total("test.a") == 3 and profiling.total("test.b") == 1
    profiling.reset("test.a")
    assert profiling.total("test.a") == 0 and profiling.total("test.b") == 1
    assert profiling.total("test.never") == 0
