"""Rounds of the compression's threshold fixpoints in the last profiled
step: the program's host reads at the ``fixpoint.*`` sites
(``fixpoint.comp_sub``: one per round of each comp_sub stage;
``fixpoint.preserve``: one per round of ``find_preserve``), from
``fries_tpu_torch.profiling.last_step_counts``.  A program without that
counter gives nothing to read.  Layer: compression."""

FUNCTIONS = ()


def read(ctx):
    try:
        from fries_tpu_torch import profiling
    except ImportError:
        return None
    last = getattr(profiling, "last_step_counts", None)
    if last is None:
        return None
    return sum(n for site, n in last().items() if site.startswith("fixpoint."))
