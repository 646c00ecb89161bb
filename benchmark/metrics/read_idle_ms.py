"""Device idle after the program's host reads, milliseconds per step: for
each device range of ``fries_tpu_torch.profiling.host_read`` (the read's
copy to the host), the idle time from the range's end to the start of the
next device operation, summed over the traced steps.  Where the trace gives
the reads no device ranges, the copies to the host (``Memcpy DtoH``) stand
for them.  A program without ``profiling.host_read`` gives nothing to read.
Layer: power step (``drivers/power``)."""

import bisect

QUALNAME = "fries_tpu_torch.profiling.host_read"


def _functions():
    try:
        from fries_tpu_torch import profiling
    except ImportError:
        return ()
    return (QUALNAME,) if hasattr(profiling, "host_read") else ()


FUNCTIONS = _functions()


def read_ends(trace) -> list:
    """The end of each read on the device timeline (microseconds), sorted:
    the ends of the wrapper's device ranges, or of the copies to the host."""
    ranges = trace._ranges.get(QUALNAME)
    if ranges:
        return sorted(e for _, e in ranges)
    return sorted(ts + dur for ts, dur, name in trace._ops if "DtoH" in name)


def idle_after(ops, ends) -> float:
    """Microseconds with no device operation between each of ``ends`` and
    the next start in ``ops`` ((start, duration, name), sorted by start),
    each gap counted once."""
    starts = [ts for ts, _, _ in ops]
    reach, hi = [], float("-inf")
    for ts, dur, _ in ops:            # the latest end of the operations up to each
        hi = max(hi, ts + dur)
        reach.append(hi)
    total, seen = 0.0, set()
    for t in ends:
        i = bisect.bisect_left(starts, t)
        if i == len(starts) or i in seen:
            continue
        seen.add(i)
        total += max(0.0, starts[i] - max(t, reach[i - 1] if i else t))
    return total


def read(ctx):
    if not FUNCTIONS:
        return None
    trace = ctx["trace"]
    ends = read_ends(trace)
    if not ends:
        from fries_tpu_torch import profiling

        return 0.0 if not sum(profiling.last_step_counts().values()) else None
    return 1e-3 * idle_after(trace._ops, ends) / ctx["steps"]
