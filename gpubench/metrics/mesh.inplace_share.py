"""mesh.inplace_share: the share of the blocks of the traced jobs' mesh
stencils that ran in place, on the tile with its ring rebuilt from bands
(the port's counters ``mesh.inplace_blocks`` and ``mesh.extended_blocks``,
one count a block a stencil call), 0 to 1."""

from gpubench import portspans


def read(ctx):
    mod = portspans.tracing()
    if mod is None or ctx.trace is None or not ctx.trace.jobs:
        return None
    c = mod.counters()
    inplace = c.get("mesh.inplace_blocks", 0)
    blocks = inplace + c.get("mesh.extended_blocks", 0)
    return inplace / blocks if blocks else None
