"""Device milliseconds per step of annihilation: the spawns merged into the
post-death arena under the initiator rule (``runtime.arena.accumulate_best``,
kernel A on the card) and the compaction that keeps HF
(``runtime.arena.compact``)."""

from benchmark import spans

FUNCTIONS = ("fries_tpu_torch.runtime.arena.accumulate_best",
             "fries_tpu_torch.runtime.arena.compact")


def read(ctx):
    return spans.device_ms_per_step(ctx, FUNCTIONS)
