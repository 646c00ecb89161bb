"""Host synchronizations of one step: the warnings ``torch.cuda`` sync debug
mode gives over one step after the window.  Layer: power step
(``drivers/power``, ``drivers/fciqmc``)."""

FUNCTIONS = ()


def read(ctx):
    return ctx["syncs_per_step"]
