"""mesh.copy_ms: device time per job of copies on the busiest card of the
traced window: device-to-device and peer-to-peer memcpys and copy
kernels (halo strips, extended blocks)."""


def is_copy(cat, name):
    return cat == "gpu_memcpy" or (cat == "kernel"
                                   and "copy" in name.lower())


def read(ctx):
    t = ctx.trace
    if t is None or not t.jobs:
        return None
    s = t.total_s(t.busiest(), is_copy)
    return s / t.jobs * 1e3 if s else None
