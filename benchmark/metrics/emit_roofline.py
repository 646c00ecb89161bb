"""Kernel B's share of its roofline: the least time its calls could take
(:func:`benchmark.roofline.emit_bytes` over 3.35 TB/s, or their f32
operations over 67 TFLOP/s where larger) over the device time of the
operations inside ``runtime.emit.emit`` and ``runtime.emit.emit_factored``,
summed over the traced steps."""

from benchmark import roofline

FUNCTIONS = ("fries_tpu_torch.runtime.emit.emit",
             "fries_tpu_torch.runtime.emit.emit_factored")
COUNTS = {fn: (lambda result=None, **plan: roofline.emit_bytes(plan, result[1], result[2]))
          for fn in FUNCTIONS}


def read(ctx):
    calls = [ctx["spans"].totals(fn) for fn in FUNCTIONS]
    calls = [c for c in calls if c is not None]
    device_s = ctx["trace"].device_s(FUNCTIONS)
    if not calls or not device_s:
        return None
    return 100.0 * sum(roofline.bound_s(b, o) for b, o, _ in calls) / device_s
