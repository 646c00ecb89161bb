"""Seconds of the program's build on the host clock: ``drivers/frisys.build``
or ``drivers/fciqmc.build`` (the heat-bath tables, p_doub, the estimator
vectors, the arena) up to a synchronize.  Layer: driver set-up."""

FUNCTIONS = ()


def read(ctx):
    return ctx["build_s"]
