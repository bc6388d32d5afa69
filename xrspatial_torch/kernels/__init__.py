"""Torch twins and their hand-written CUDA kernels.

On the CPU, PyTorch sends float ``sqrt``, ``atan``, ``asin``, ``sin``,
``cos`` and other functions through MKL's vector math, split across its
OpenMP threads in chunks of 2048 elements.  When the first such call of a
process is split across threads, one thread's chunk can come out of a
low-accuracy path: errors near 3e-4 relative (11 bits) in that chunk, on
that first call only, so a twin's first call disagreed with every later
one.  A first call of each function on one thread, on a tensor too small
to be split, prevents it: it is made here, when the package is imported.
"""

import torch


def _init_cpu_vector_math() -> None:
    for dtype in (torch.float32, torch.float64):
        x = torch.full((4,), 0.5, dtype=dtype)
        for fn in (torch.sqrt, torch.rsqrt, torch.atan, torch.asin,
                   torch.sin, torch.cos):   # the twins' functions
            fn(x)
        torch.atan2(x, x)


_init_cpu_vector_math()
