"""kernels.roofline_pct: the job's least time over its device busy time
on the busiest card of the traced window.  The least time is the larger
of the job's bytes at 3.35 TB/s and its operations at 67 TFLOP/s, each
times the cell's cards (the op's own work, ``work/<op>.py``)."""

from gpubench import peaks


def read(ctx):
    t = ctx.trace
    if t is None or not t.jobs:
        return None
    busy = t.busy_s(t.busiest()) / t.jobs
    if busy <= 0:
        return None
    nbytes, ops = ctx.work
    least = max(nbytes / (peaks.HBM_BYTES_S * ctx.cards),
                ops / (peaks.F32_FLOP_S * ctx.cards))
    return 100.0 * least / busy
