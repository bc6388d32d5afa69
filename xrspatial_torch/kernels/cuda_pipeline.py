"""Wrapper of the CUDA fused pipeline kernel (``csrc/pipeline.cu``).

Replaces ``xrspatial_tpu/kernels/pallas_pipeline.py::pipeline_tiled``.
The wrapper takes only a tensor on the card: it builds the kernel library
at the first call, allocates the surface planes and the focal stack,
launches once on PyTorch's current stream and raises if the launch fails.
Its plain version is ``kernels/pipeline.py::pipeline_multi``.
"""

from __future__ import annotations

import torch

from . import _cuda
from .cuda_surface import surface_args
from .cuda_window import focal_args

__all__ = ["pipeline_cuda", "LAUNCHES"]

# launches of the kernel in this process, for checks that a path ran on it
LAUNCHES = 0


def pipeline_cuda(data: torch.Tensor, offsets, stats, which,
                  cellsize_x=1.0, cellsize_y=1.0, azimuth=225.0,
                  angle_altitude=25.0) -> tuple:
    """The (H, W) float32 surface products in `which` order (1-cell NaN
    ring), then the (S, H, W) float32 focal stack in `stats` order."""
    global LAUNCHES
    x, offsets, offs, slots, stack = focal_args(data, offsets, stats,
                                                "pipeline_cuda")
    h, w = x.shape
    outs, ptrs, mask, scalars = surface_args(
        x, which, cellsize_x, cellsize_y, azimuth, angle_altitude)
    lib = _cuda.library()
    with torch.cuda.device(x.device):
        err = lib.pipeline_launch(x.data_ptr(), *ptrs, mask, *scalars,
                                  offs.data_ptr(), len(offsets), slots,
                                  stack.data_ptr(), h, w,
                                  _cuda.stream_of(x.device))
    _cuda.check(err, "pipeline_kernel")
    LAUNCHES += 1
    return (*(outs[p] for p in which), stack)
