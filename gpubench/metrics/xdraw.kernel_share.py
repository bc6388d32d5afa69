"""xdraw.kernel_share: the share of the traced jobs' XDraw viewsheds
whose fields and epilogue ran as the card's kernels (the port's counters
``xdraw.cells_kernel`` and ``xdraw.cells_torchops``, one count a raster
or a mesh block), 0 to 1; nothing where the port counts neither."""

from gpubench import portspans


def read(ctx):
    mod = portspans.tracing()
    if mod is None or ctx.trace is None or not ctx.trace.jobs:
        return None
    c = mod.counters()
    kernel = c.get("xdraw.cells_kernel", 0)
    both = kernel + c.get("xdraw.cells_torchops", 0)
    return kernel / both if both else None
