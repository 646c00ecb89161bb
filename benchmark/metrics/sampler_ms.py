"""Device milliseconds per step of the samplers: the heat-bath doubles and
the uniform singles of the walker path (``ops/near_uniform``), their
categorical rows (``compress.sample_categorical_rows``) and the HB-PP
selection weight (``ops/heat_bath.norm_weight``, which the FRI spawner's
finalize runs too)."""

from benchmark import spans

FUNCTIONS = ("fries_tpu_torch.ops.near_uniform.sample_doubles_heat_bath",
             "fries_tpu_torch.ops.near_uniform.sample_singles",
             "fries_tpu_torch.compress.sample_categorical_rows",
             "fries_tpu_torch.ops.heat_bath.norm_weight")


def read(ctx):
    return spans.device_ms_per_step(ctx, FUNCTIONS)
