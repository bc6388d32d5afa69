"""torchops.host_ms: the self time of the port's ``torchops.*`` spans (the
host issuing an op's passes of torch ops: XDraw's fields and epilogue,
the classes, the proximity mask and epilogue), ms a traced job."""

from gpubench import portspans


def read(ctx):
    return portspans.self_ms(ctx, "torchops.")
