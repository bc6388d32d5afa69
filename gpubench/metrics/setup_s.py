"""setup_s: seconds from the process's start to the first timed job (the
CUDA contexts, the kernel library's load or build, the DEM made on the
card(s), the warm-up jobs)."""


def read(ctx):
    return ctx.setup_s
