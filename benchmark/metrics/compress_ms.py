"""Device milliseconds per step of the compression layer: the operations
that start inside ``comp_sub`` (A+B, E), ``comp_sub_factored`` (C+D, with
its histogram seed and threshold fixpoint), ``find_preserve`` and
``sys_comp`` (the vector's compression).  Kernel B's emissions run inside
the rounds and count here."""

from benchmark import spans

FUNCTIONS = ("fries_tpu_torch.compress.comp_sub",
             "fries_tpu_torch.compress.comp_sub_factored",
             "fries_tpu_torch.compress.find_preserve",
             "fries_tpu_torch.compress.sys_comp")


def read(ctx):
    return spans.device_ms_per_step(ctx, FUNCTIONS)
