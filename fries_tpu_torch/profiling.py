"""The program's tracing: spans at its layer boundaries, the one place a step
reads a device value on the host, and a registry of counters; besides, a
profiler trace of a block and a host block timer.

Spans.  ``span(name)`` is a range named ``name`` in a ``torch.profiler``
trace while a profiler records, on the profiler's clock beside the card's
operations, and the one shared null context :data:`NULL` while none does,
so a span costs a flag test and a return when tracing is off.
``spanned(name)`` wraps a function in such a span, so calls through an
imported name are covered too.  Each driver's step runs inside
``step(index)`` (``stepped`` wraps it), the ``fries.step`` range, whose
input is the step index (shown where the trace records inputs).  The names
sit under ``fries.``; PERF.md lists them with the metric each is for.  The
ranges are function-scope records (``cpu_op`` events in the Chrome trace),
not ``record_function``'s user-scope ones: the profiler ties a device
operation to the innermost user-scope range around its launch, so a
user-scope span here would take the device operations of a function away
from a range that a caller, such as a benchmark, wraps around it.

Host reads.  ``host_read(x, site)`` turns the device tensor ``x`` into a
Python value and counts one read of ``site`` (named by what it reads:
``fixpoint.comp_sub``, ``fixpoint.preserve``, ``exchange.counts``, ...);
while a profiler records, the read is the span ``fries.read.<site>``.  A
step reaches it through this module (``profiling.host_read``), never by an
imported name, so a wrapper installed on the module attribute sees every
read.  The counts are Python ints: no device work, no added sync.

Counters.  ``count(name)`` adds to a running total (``total``, ``reset``):
the kernels' launches (``launch.merge``, ``launch.emit``,
``launch.merge_multi``, ``launch.plan``, ``launch.attempt``,
``launch.probe_copy``, ``launch.probe_reshape``), the merges taken off the
kernels on the card (``merge.plain_on_card``) and the attempt passes that
ran their plain version on the card (``attempt.plain_on_card``).
Reads count there too, and per step: the exit of the outermost
``step(index)`` moves the reads made since its entry to
``last_step_counts()``.

Device counters.  ``device_count(name, flags)`` adds the True entries of
the device tensor that ``flags()`` makes to a counter held on that device,
only while a profiler records (while none does it returns before
``flags`` runs: no operation), so a step never reads it:
``device_total(name)`` reads it once, after the profiled steps.
``sampler.fallback`` counts the categorical draws past every f32 prefix
that take the last column of positive weight where the reference takes
column K - 1 (``compress.sample_categorical_rows``, and kernel G's draws,
``runtime/attempt.py``).

    with profiling.trace("trace_dir"):          # a Chrome trace of the block
        for i in range(3):
            with profiling.step(i):
                ...
    print(profiling.last_step_counts())         # {"fixpoint.comp_sub": 7, ...}

    t = profiling.Timer()
    with t.block("spawn", sync=amps):           # waits for amps' device
        ...
    print(t.report())
"""

from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile

TRACE_NAME = "trace.json"
STEP = "fries.step"
READ = "fries.read."

_range = torch._C._profiler._RecordFunctionFast


class _Null:
    """A span while no profiler records: enters nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL = _Null()

_totals: dict[str, int] = {}      # every counter, since the process started or a reset
_step_reads: dict[str, int] = {}  # reads of the step that is open
_last_step: dict[str, int] = {}   # reads of the last step that closed
_depth = 0                        # steps open (a step may run another's)
_device: dict[str, torch.Tensor] = {}   # device counters, added to while a profiler records


def span(name: str):
    """A range ``name`` while a profiler records; :data:`NULL` otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return NULL
    return _range(name)


def spanned(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned_call(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _range(name):
                return fn(*args, **kwargs)
        return spanned_call
    return wrap


@contextlib.contextmanager
def step(index: int):
    """One step of a driver: the ``fries.step`` range (its input the step
    index) while a profiler records; the outermost step's exit moves the
    reads made inside it to :func:`last_step_counts`."""
    global _depth, _last_step
    if _depth == 0:
        _step_reads.clear()
    _depth += 1
    try:
        if _autograd_profiler._is_profiler_enabled:
            with _range(STEP, (index,), {"step": index}):
                yield
        else:
            yield
    finally:
        _depth -= 1
        if _depth == 0:
            _last_step = dict(_step_reads)


def stepped(fn):
    """Decorator for a driver's ``step(state, ...)``: each call runs inside
    ``step(state.iterat)``."""
    @functools.wraps(fn)
    def step_call(state, *args, **kwargs):
        with step(state.iterat):
            return fn(state, *args, **kwargs)
    return step_call


def host_read(x: torch.Tensor, site: str):
    """``x`` as a Python value (``item()`` of a 0-dim tensor, ``tolist()``
    otherwise), counted as one read of ``site``."""
    _totals[site] = _totals.get(site, 0) + 1
    _step_reads[site] = _step_reads.get(site, 0) + 1
    if not _autograd_profiler._is_profiler_enabled:
        return x.item() if x.dim() == 0 else x.tolist()
    with _range(READ + site):
        return x.item() if x.dim() == 0 else x.tolist()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _totals[name] = _totals.get(name, 0) + n


def total(name: str) -> int:
    """The running total of the counter or read site ``name``."""
    return _totals.get(name, 0)


def recording() -> bool:
    """Whether a profiler records."""
    return _autograd_profiler._is_profiler_enabled


def device_count(name: str, flags) -> None:
    """While a profiler records, add the number of True entries of the
    device tensor ``flags()`` (or its sum, for a count) to the device
    counter ``name``, on the device (no host read); nothing otherwise,
    ``flags`` not called."""
    if not recording():
        return
    n = flags().sum()
    held = _device.get(name)
    _device[name] = n if held is None else held + n.to(held.device)


def device_total(name: str) -> int:
    """The device counter ``name`` read on the host (0 if nothing was
    counted): read it after the profiled steps, never inside a step."""
    held = _device.get(name)
    return 0 if held is None else int(held.item())


def reset(*names: str) -> None:
    """Zero the running totals and device counters of ``names``."""
    for name in names:
        _totals.pop(name, None)
        _device.pop(name, None)


def last_step_counts() -> dict[str, int]:
    """The reads of the last step that closed, by site."""
    return dict(_last_step)


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
