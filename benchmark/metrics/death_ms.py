"""Device milliseconds per step of death and cloning over the arena's rows:
the occupied orbitals of every row (``dets.occ_list``), their diagonal
elements (``ops.molecule.diag_matrel_chunked``) and the binomial rounding
of the post-death populations (``drivers.fciqmc._death``)."""

from benchmark import spans

FUNCTIONS = ("fries_tpu_torch.dets.occ_list",
             "fries_tpu_torch.ops.molecule.diag_matrel_chunked",
             "fries_tpu_torch.drivers.fciqmc._death")


def read(ctx):
    return spans.device_ms_per_step(ctx, FUNCTIONS)
