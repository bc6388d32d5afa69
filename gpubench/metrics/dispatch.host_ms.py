"""dispatch.host_ms: the self time of the port's ``dispatch.*`` spans (from
the route choice to the last launch's return: plans, outputs, the
launches; the mesh's spans inside left out), ms a traced job."""

from gpubench import portspans


def read(ctx):
    return portspans.self_ms(ctx, "dispatch.")
