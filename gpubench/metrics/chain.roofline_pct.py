"""chain.roofline_pct: a global job's least time over its device busy
time a job on the busiest card of the traced window: the share
``kernels.roofline_pct`` reads, of every step's own work
(``work/<op>.py``), for the cells of a chain of steps."""

from pathlib import Path

from gpubench.spec import Bench


def read(ctx):
    bench = Bench(Path(__file__).resolve().parents[2])
    return bench.reader("kernels.roofline_pct").read(ctx)
