"""fries_tpu_torch.profiling on the CPU: the Timer's counts, totals and
report format (the reference's: one line per block, longest total first),
``annotate`` inside ``trace`` (the Chrome trace file exists and names the
region), and a CPU ``sync`` tensor that waits for nothing."""

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
    with profiling.trace(tmp_path / "trace") as prof:
        with profiling.annotate("fries_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    path = tmp_path / "trace" / profiling.TRACE_NAME
    assert path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "fries_region" for e in events)
