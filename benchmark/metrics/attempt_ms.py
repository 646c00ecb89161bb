"""Device milliseconds per step of the walker attempt pass: the slots'
parents (``drivers.fciqmc._attempt_parents``), one excitation drawn,
weighed and rounded per slot (``drivers.fciqmc._attempt_pass``) and the
live spawns' partition (``drivers.fciqmc._partition_spawns``, where
``spawn_cap`` is below the attempt slots).  A program whose attempt pass
is not a function of the module is read without it."""

import importlib

from benchmark import spans

WANTED = ("fries_tpu_torch.drivers.fciqmc._attempt_parents",
          "fries_tpu_torch.drivers.fciqmc._attempt_pass",
          "fries_tpu_torch.drivers.fciqmc._partition_spawns")


def _present(names):
    mod = importlib.import_module(names[0].rsplit(".", 1)[0])
    return tuple(n for n in names if hasattr(mod, n.rsplit(".", 1)[1]))


FUNCTIONS = _present(WANTED)


def read(ctx):
    return spans.device_ms_per_step(ctx, FUNCTIONS)
