"""peak_gib: ``max_memory_allocated`` over the window (reset at its
start), the largest over the cell's cards, in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30
