"""Share of the traced window in which no operation ran on the device:
100 (1 - busy / window), the busy time being the union of the kernel,
memcpy and memset intervals of the profiled steps and the window their
host-clock length.  Layer: device."""

FUNCTIONS = ()


def read(ctx):
    t = ctx["trace"]
    if t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
