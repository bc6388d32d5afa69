"""device.idle_pct: the share of the traced window in which no kernel,
copy or fill ran, the mean over the cell's cards."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    busy = sum(t.busy_s(d) for d in range(t.cards)) / t.cards
    return 100.0 * (1.0 - busy / t.window_s)
