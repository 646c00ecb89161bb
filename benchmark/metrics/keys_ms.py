"""Device milliseconds per step of keys and lookups: ``dets.order_keys``
(one stable sort per 64-bit column past two words), ``dets.sort_dets``,
``dets.lookup_dets`` and ``runtime.arena.lookup``, wherever the step calls
them through their modules."""

from benchmark import spans

FUNCTIONS = ("fries_tpu_torch.dets.order_keys",
             "fries_tpu_torch.dets.sort_dets",
             "fries_tpu_torch.dets.lookup_dets",
             "fries_tpu_torch.runtime.arena.lookup")


def read(ctx):
    return spans.device_ms_per_step(ctx, FUNCTIONS)
