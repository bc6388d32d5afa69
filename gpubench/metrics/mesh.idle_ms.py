"""mesh.idle_ms: the cards' idle time (the mean over the cards) while the
host's innermost port span is a ``mesh.*`` span, ms a traced job."""

from gpubench import portspans


def read(ctx):
    return portspans.idle_ms(ctx, "mesh.")
