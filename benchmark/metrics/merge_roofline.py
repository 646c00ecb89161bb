"""Kernel A's share of its roofline: the least time its calls could take
(:func:`benchmark.roofline.merge_bytes` over 3.35 TB/s) over the device
time of the operations inside ``runtime.merge.accumulate`` and its spawn
sort (``runtime.merge.sort_spawns``), summed over the traced steps."""

from benchmark import roofline

ENTRY = "fries_tpu_torch.runtime.merge.accumulate"
FUNCTIONS = (ENTRY, "fries_tpu_torch.runtime.merge.sort_spawns")
COUNTS = {ENTRY: lambda *a, result=None, **k: roofline.merge_bytes(*a, **k)}


def read(ctx):
    totals = ctx["spans"].totals(ENTRY)
    device_s = ctx["trace"].device_s(FUNCTIONS)
    if totals is None or not device_s:
        return None
    return 100.0 * roofline.bound_s(totals[0], totals[1]) / device_s
