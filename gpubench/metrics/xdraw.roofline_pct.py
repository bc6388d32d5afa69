"""xdraw.roofline_pct: the least time of the XDraw scans (the slope plane
read once and the field written once, ``work/viewshed.py::x1``, at 3.35
TB/s or 67 TFLOP/s) over the device time a job of X1's kernel
``xdraw_banded_kernel`` on the busiest card of the traced window."""

from pathlib import Path

from gpubench import peaks
from gpubench.spec import Bench
from gpubench.trace import base_name

KERNEL = "xdraw_banded_kernel"


def read(ctx):
    t = ctx.trace
    if t is None or not t.jobs:
        return None
    s = t.total_s(t.busiest(),
                  lambda c, n: c == "kernel" and base_name(n) == KERNEL)
    if s <= 0:
        return None
    work = Bench(Path(__file__).resolve().parents[2]).work("viewshed")
    nbytes, ops = work.x1(ctx.pixels)
    least = max(nbytes / peaks.HBM_BYTES_S, ops / peaks.F32_FLOP_S)
    return 100.0 * least / (s / t.jobs)
