"""Wrapper of the CUDA fused pipeline kernel, B4.

Replaces ``xrspatial_tpu/kernels/pallas_pipeline.py::pipeline_tiled``.
By default the staged kernel of ``csrc/focal_halo.cu`` with its surface
epilogue, on the route ``kernels/pipeline.py::pipeline_plan`` names
("tma", or "async" where TMA refuses the pitch or base): each tile's
window staged once, the focal statistics and the surface products of its
cells from it; route "simple" takes the first port,
``csrc/pipeline.cu::pipeline_kernel``, by name.  The routes give the same
bits, and the same bits as the split kernels B1 and B2.  The wrapper
takes only a tensor on the card: it builds the kernel library at the
first call, allocates the surface planes and the focal stack, launches
once on PyTorch's current stream and raises if the launch fails.  Its
plain version is ``kernels/pipeline.py::pipeline_multi``.
"""

from __future__ import annotations

import torch

from . import _cuda
from .cuda_surface import surface_args
from .cuda_window import _device_runs, focal_args
from .focal_halo import register_class, run_table
from .pipeline import SURFACE_RADIUS, pipeline_plan, pipeline_radii

__all__ = ["pipeline_cuda", "LAUNCHES", "TMA_LAUNCHES", "ASYNC_LAUNCHES",
           "SIMPLE_LAUNCHES"]

# launches of the kernel in this process, for checks that a path ran on it
LAUNCHES = 0          # every route
TMA_LAUNCHES = 0      # the staged kernel, its window by TMA
ASYNC_LAUNCHES = 0    # the staged kernel, its window by cp.async
SIMPLE_LAUNCHES = 0   # the first port, pipeline_kernel, by name


def pipeline_cuda(data: torch.Tensor, offsets, stats, which,
                  cellsize_x=1.0, cellsize_y=1.0, azimuth=225.0,
                  angle_altitude=25.0, route=None) -> tuple:
    """The (H, W) float32 surface products in `which` order (1-cell NaN
    ring), then the (S, H, W) float32 focal stack in `stats` order.

    `route` None takes the plan's route ("tma" or "async" must be the
    plan's); "simple" takes the first port by name."""
    global LAUNCHES, TMA_LAUNCHES, ASYNC_LAUNCHES, SIMPLE_LAUNCHES
    x, offsets, offs, slots, stack = focal_args(data, offsets, stats,
                                                "pipeline_cuda")
    h, w = x.shape
    outs, ptrs, mask, scalars = surface_args(
        x, which, cellsize_x, cellsize_y, azimuth, angle_altitude)
    if route == "simple":
        lib = _cuda.library()
        with torch.cuda.device(x.device):
            err = lib.pipeline_launch(x.data_ptr(), *ptrs, mask, *scalars,
                                      offs.data_ptr(), len(offsets), slots,
                                      stack.data_ptr(), h, w,
                                      _cuda.stream_of(x.device))
        _cuda.check(err, "pipeline_kernel")
        SIMPLE_LAUNCHES += 1
    else:
        plan = pipeline_plan(h, w, offsets, x.data_ptr())
        if plan.route == "ring":
            raise ValueError(f"pipeline_cuda: no staged window of this "
                             f"footprint fits a block (plan {plan})")
        if route not in (None, plan.route):
            raise ValueError(f"pipeline_cuda: route {route!r} is not the "
                             f"plan's ({plan.route!r}) or 'simple'")
        ry, rx = pipeline_radii(offsets)
        runs = _device_runs(run_table(offsets, plan, SURFACE_RADIUS),
                            x.device)
        lib = _cuda.library()
        with torch.cuda.device(x.device):
            err = lib.pipeline_staged_launch(
                x.data_ptr(), *ptrs, mask, *scalars, runs.data_ptr(),
                runs.shape[0], len(offsets), slots, stack.data_ptr(), h, w,
                ry, rx, ("tma", "async").index(plan.route), plan.tile[0],
                plan.pad, plan.pitch, plan.rows, plan.box[0], plan.box[1],
                plan.shared_bytes, plan.grid, register_class(plan),
                _cuda.stream_of(x.device))
        if err < 0:
            raise RuntimeError(f"pipeline_staged: cuTensorMapEncodeTiled "
                               f"failed with CUresult {-err} for a {h}x{w} "
                               f"float32 raster, box {plan.box}")
        _cuda.check(err, f"pipeline_staged ({plan.route})")
        if plan.route == "tma":
            TMA_LAUNCHES += 1
        else:
            ASYNC_LAUNCHES += 1
    LAUNCHES += 1
    return (*(outs[p] for p in which), stack)
