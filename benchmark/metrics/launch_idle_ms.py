"""Device idle that is not :mod:`read_idle_ms`'s, milliseconds per step:
the traced window's idle time, 1e3 (window - busy) / steps, less the idle
after the program's host reads; the host launching, between operations,
and what else it does there.  The two add up to ``idle_pct``'s idle time.
Layer: power step (``drivers/power``)."""

from pathlib import Path

from benchmark import catalog

_READS = catalog.metric("read_idle_ms", Path(__file__).resolve().parents[2])
FUNCTIONS = _READS.FUNCTIONS


def read(ctx):
    t = ctx["trace"]
    reads = _READS.read(ctx)
    if reads is None or t.window_s <= 0:
        return None
    return 1e3 * (t.window_s - t.busy_s) / ctx["steps"] - reads
