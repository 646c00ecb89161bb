"""Profiling hooks: a profiler trace of a block, named regions in it, and a
host block timer.

Counterpart of ``fries_tpu/profiling.py`` on ``torch.profiler``:

    with profiling.trace("trace_dir"):          # a Chrome trace of the block
        with profiling.annotate("steps"):
            state, m = run_steps(...)

    t = profiling.Timer()
    with t.block("spawn", sync=amps):           # waits for amps' device
        ...
    print(t.report())
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def trace(logdir):
    """Profile the block (CPU activity, and the card's where there is one)
    and write its Chrome trace to ``logdir/trace.json`` (viewable in
    Perfetto or chrome://tracing).  Yields the ``torch.profiler.profile``."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = Path(logdir)
    path.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(path / TRACE_NAME))


def annotate(name: str):
    """A named region in profiler traces (``torch.profiler.record_function``)."""
    return record_function(name)


class Timer:
    """Host-side block timer; a block given a CUDA tensor as ``sync`` waits
    for that tensor's device before it stops the clock."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def block(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None and sync.is_cuda:
                torch.cuda.synchronize(sync.device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            lines.append(
                f"{name:30s} {self.totals[name]*1000:10.1f} ms total "
                f"({self.counts[name]} calls, "
                f"{self.totals[name]/max(self.counts[name],1)*1000:8.2f} ms/call)"
            )
        return "\n".join(lines)
