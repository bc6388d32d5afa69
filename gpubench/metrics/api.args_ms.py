"""api.args_ms: the self time of the port's ``api.args`` spans (argument
checks, the footprint, the resolution and the payload), ms a traced
job."""

from gpubench import portspans


def read(ctx):
    return portspans.self_ms(ctx, "api.args")
