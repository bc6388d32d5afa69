"""torchops.device_ms: device time a job of the kernels that are not the
port's own (torch's elementwise, reduction, copy and index kernels: the
passes the port runs as torch ops) on the busiest card of the traced
window."""

from gpubench.trace import base_name


def read(ctx):
    t = ctx.trace
    if t is None or not t.jobs:
        return None
    own = ctx.port_kernels
    s = t.total_s(t.busiest(),
                  lambda c, n: c == "kernel" and base_name(n) not in own)
    return s / t.jobs * 1e3 if s else None
