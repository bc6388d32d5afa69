"""kernels.device_ms: device time per job of the port's own kernels (the
``__global__`` functions of its ``csrc/``, by name) on the busiest card
of the traced window."""

from gpubench.trace import base_name


def read(ctx):
    t = ctx.trace
    if t is None or not t.jobs:
        return None
    own = ctx.port_kernels
    s = t.total_s(t.busiest(),
                  lambda c, n: c == "kernel" and base_name(n) in own)
    return s / t.jobs * 1e3 if s else None
