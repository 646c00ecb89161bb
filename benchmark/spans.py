"""Spans and counts of the traced run, from the benchmark's own files.

:class:`Spans` wraps functions of the program, named by their qualified
names (``fries_tpu_torch.compress.comp_sub``), in ``record_function`` ranges
labelled with those names.  The wrappers replace module attributes, and a
module that calls the function through its module (``compress.comp_sub``)
picks them up at call time; one that imported the function by name does
not.  A function may also carry a byte counter (:mod:`benchmark.roofline`),
which the wrapper evaluates on the call's arguments and result after the
range closes, while :attr:`Spans.counting` is on.

:func:`read_trace` reads a Chrome trace of the profiled steps: the device's
busy time (the union of kernel, memcpy and memset intervals), the device
time of the operations that start inside each label's ranges on the device
timeline (the ``gpu_user_annotation`` events), the device operations that
took most time, and the idle gaps named by what the host was doing.
"""

from __future__ import annotations

import bisect
import functools
import importlib
import json
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Labels installed on the program's functions; ``counters`` holds, per
    function, the (bytes, ops) device tensors of the calls made while
    ``counting`` is on."""

    def __init__(self):
        self.installed: dict[str, tuple] = {}
        self.counters: dict[str, list] = {}
        self.counting = False

    def install(self, qualname: str, count=None):
        """Wrap the function ``module.attr`` named by ``qualname`` once;
        ``count(*args, **kwargs, result=...)`` gives its (bytes, ops)."""
        if qualname in self.installed:
            if count is not None:
                self.installed[qualname][2].append(count)
            return
        import torch

        mod_name, attr = qualname.rsplit(".", 1)
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)
        counts = [] if count is None else [count]

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(qualname):
                out = fn(*args, **kwargs)
            if self.counting:
                for c in counts:
                    self.counters.setdefault(qualname, []).append(
                        c(*args, **kwargs, result=out))
            return out

        setattr(mod, attr, wrapper)
        self.installed[qualname] = (mod, fn, counts)

    def remove(self):
        for qualname, (mod, fn, _) in self.installed.items():
            setattr(mod, qualname.rsplit(".", 1)[1], fn)
        self.installed.clear()

    def totals(self, qualname: str) -> tuple[float, float, int] | None:
        """(bytes, ops, calls) summed over the counted calls, or None."""
        calls = self.counters.get(qualname)
        if not calls:
            return None
        return (float(sum(float(b) for b, _ in calls)), float(sum(float(o) for _, o in calls)),
                len(calls))


@dataclass
class TraceReading:
    """What the traced steps show.  Times in seconds over all ``steps``."""

    steps: int
    window_s: float
    busy_s: float
    label_s: dict = field(default_factory=dict)       # frozenset(labels) -> seconds
    device_ops: list = field(default_factory=list)   # [[name, seconds]] top 10
    idle_gaps: list = field(default_factory=list)    # [[host activity, seconds]] top 10
    _ops: list = field(default_factory=list, repr=False)
    _ranges: dict = field(default_factory=dict, repr=False)

    def device_s(self, labels) -> float | None:
        """Device seconds of the operations that start inside a range of any
        of ``labels`` (each operation once); None when no range of them ran
        on the device."""
        labels = frozenset(labels)
        if labels not in self.label_s:
            spans = sorted(iv for lab in labels for iv in self._ranges.get(lab, ()))
            if not spans:
                self.label_s[labels] = None
            else:
                starts = [s for s, _ in spans]
                total, reach = 0.0, []
                hi = float("-inf")
                for s, e in spans:          # running max of ends, for nesting
                    hi = max(hi, e)
                    reach.append(hi)
                for ts, dur, _ in self._ops:
                    i = bisect.bisect_right(starts, ts) - 1
                    if i >= 0 and ts <= reach[i]:
                        total += dur
                self.label_s[labels] = total * 1e-6
        return self.label_s[labels]


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _timeline(events):
    """Non-overlapping (start, end, name) segments of the innermost host
    event in force, from (start, end, name) events that nest."""
    segs, stack = [], []
    t = None

    def emit(until):
        if stack and t is not None and until > t:
            segs.append((t, until, stack[-1][2]))

    for s, e, name in sorted(events, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] <= s:
            emit(stack[-1][1])
            t = stack.pop()[1]
        emit(s)
        t = s
        stack.append((s, e, name))
    while stack:
        emit(stack[-1][1])
        t = stack.pop()[1]
    return segs


def _name_at(segs, starts, t):
    i = bisect.bisect_right(starts, t) - 1
    return segs[i][2] if i >= 0 and t < segs[i][1] else None


def read_trace(path, steps: int, window_s: float, labels) -> TraceReading:
    """The reading of a Chrome trace of ``steps`` profiled steps that took
    ``window_s`` on the host clock; ``labels`` are the installed ranges."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    ops = sorted((e["ts"], e["dur"], e.get("name", "")) for e in events
                 if e.get("cat") in DEVICE_CATS and "dur" in e)
    ranges: dict[str, list] = {}
    host_spans, host_ops = [], []
    for e in events:
        if "dur" not in e:
            continue
        cat, name = e.get("cat"), e.get("name")
        if cat == "gpu_user_annotation" and name in labels:
            ranges.setdefault(name, []).append((e["ts"], e["ts"] + e["dur"]))
        elif cat == "user_annotation" and name in labels:
            host_spans.append((e["ts"], e["ts"] + e["dur"], name.rsplit(".", 1)[-1]))
        elif cat in ("cpu_op", "cuda_runtime"):
            host_ops.append((e["ts"], e["ts"] + e["dur"], name))
    busy = _union((ts, ts + dur) for ts, dur, _ in ops)
    busy_us = sum(e - s for s, e in busy)
    by_name: dict[str, float] = {}
    for _, dur, name in ops:
        by_name[name[:120]] = by_name.get(name[:120], 0.0) + dur * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    span_segs, op_segs = _timeline(host_spans), _timeline(host_ops)
    span_starts, op_starts = [x[0] for x in span_segs], [x[0] for x in op_segs]
    gaps: dict[str, float] = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) / 2
        what = _name_at(span_segs, span_starts, mid) or "outside the spans"
        op = _name_at(op_segs, op_starts, mid)
        key = what if op is None else f"{what} / {op}"
        gaps[key] = gaps.get(key, 0.0) + (s1 - e0) * 1e-6
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return TraceReading(steps=steps, window_s=window_s, busy_s=busy_us * 1e-6,
                        device_ops=[[k, v] for k, v in top],
                        idle_gaps=[[k, v] for k, v in idle], _ops=ops, _ranges=ranges)


def device_ms_per_step(ctx, functions) -> float | None:
    """Device milliseconds per profiled step inside ``functions``' ranges,
    or None where none of them ran on the device."""
    s = ctx["trace"].device_s(functions)
    return None if not s else 1e3 * s / ctx["steps"]
