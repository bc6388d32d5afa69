"""Wrappers of the CUDA surface kernels (``csrc/surface.cu``).

``surface_cuda`` (B1) replaces
``xrspatial_tpu/kernels/pallas_surface2.py::surface_tiled``: by default
``surface_staged_kernel`` on the route ``kernels/surface.py::
surface_plan`` names ("tma", or "async" where TMA refuses the pitch or
base), or B1's first port ``surface_kernel`` by name (route "simple");
the routes give the same bits.  Its plain version is
``kernels/surface.py::surface_multi``.
``surface_stacked_cuda`` (B0) replaces
``xrspatial_tpu/kernels/pallas_surface.py::surface_pallas``: by default on
the route ``kernels/surface.py::stacked_plan`` names ("tma":
``surface_staged_kernel`` on the planes of one buffer; "phased":
``surface_phased_kernel``, where TMA refuses the pitch or a base), or B0's
first port ``surface_stacked_kernel`` by name (route "simple"); the routes
give the same bits.  Its plain version is ``kernels/surface.py::
surface_multi_stacked``.  Each wrapper
takes only a tensor on the card: it builds the kernel library at the
first call, allocates the outputs, launches on PyTorch's current stream
and raises if the launch fails.
"""

from __future__ import annotations

import functools

import torch

from . import _cuda
from .surface import (PRODUCTS, SURFACE_TILE, check_products, stacked_plan,
                      sun_scalars, surface_plan)

__all__ = ["surface_cuda", "surface_stacked_cuda", "LAUNCHES",
           "STAGED_TMA_LAUNCHES", "STAGED_ASYNC_LAUNCHES", "SIMPLE_LAUNCHES",
           "STACKED_LAUNCHES", "STACKED_TMA_LAUNCHES",
           "STACKED_PHASED_LAUNCHES", "STACKED_SIMPLE_LAUNCHES"]

# launches of each kernel in this process, for checks that a path ran on it
LAUNCHES = 0               # B1 (surface_cuda), every route
STAGED_TMA_LAUNCHES = 0    # ... surface_staged_kernel, windows by TMA
STAGED_ASYNC_LAUNCHES = 0  # ... surface_staged_kernel, windows by cp.async
SIMPLE_LAUNCHES = 0        # ... the first port, surface_kernel, by name
STACKED_LAUNCHES = 0       # B0 (surface_stacked_cuda), every route
STACKED_TMA_LAUNCHES = 0   # ... surface_staged_kernel on the planes, TMA
STACKED_PHASED_LAUNCHES = 0  # ... surface_phased_kernel
STACKED_SIMPLE_LAUNCHES = 0  # ... the first port, surface_stacked_kernel


def _scalars(cellsize_x, cellsize_y, azimuth, angle_altitude) -> tuple:
    """csx, csy and the sun's four scalars in float32, on the host (no
    device sync), computed once for each set of arguments: a mesh's
    stencil launches B1 on every tile and band."""
    return _scalars_of(float(cellsize_x), float(cellsize_y), float(azimuth),
                       float(angle_altitude))


@functools.lru_cache(maxsize=64)
def _scalars_of(cellsize_x: float, cellsize_y: float, azimuth: float,
                angle_altitude: float) -> tuple:
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    sun = [float(s) for s in sun_scalars(f32(azimuth), f32(angle_altitude))]
    return (float(f32(cellsize_x)), float(f32(cellsize_y)), *sun)


def _card_raster(data: torch.Tensor, who: str) -> torch.Tensor:
    """`data` as a contiguous float32 tensor; raises unless it is a 2D
    tensor on the card."""
    if data.device.type != "cuda":
        raise ValueError(f"{who} takes a CUDA tensor, got one on "
                         f"{data.device}")
    if data.ndim != 2:
        raise ValueError(f"{who} takes a 2D tensor, got {data.ndim}D")
    return data.to(torch.float32).contiguous()


def surface_args(x: torch.Tensor, which, cellsize_x, cellsize_y, azimuth,
                 angle_altitude) -> tuple:
    """The surface half of a launch: ``(outs, ptrs, mask, scalars)``, the
    (H, W) float32 planes of `which` (allocated), the four product
    pointers in the kernel's order (None where not requested), the product
    mask, and csx, csy and the sun's four scalars in float32."""
    check_products(which)
    outs = {p: torch.empty(x.shape, dtype=torch.float32, device=x.device)
            for p in which}
    mask = sum(1 << PRODUCTS.index(p) for p in which)
    ptrs = [outs[p].data_ptr() if p in outs else None for p in PRODUCTS]
    return outs, ptrs, mask, _scalars(cellsize_x, cellsize_y, azimuth,
                                      angle_altitude)


def surface_cuda(data: torch.Tensor, which, cellsize_x=1.0, cellsize_y=1.0,
                 azimuth=225.0, angle_altitude=25.0, route=None,
                 tile=SURFACE_TILE) -> tuple:
    """Tuple of (H, W) float32 products, in `which` order, 1-cell NaN ring.

    `route` None takes the plan's route (``surface_plan`` at `tile`, one
    of ``SURFACE_TILES``); "tma" or "async" must be the plan's; "simple"
    takes the first port, ``surface_kernel``, by name."""
    global LAUNCHES, STAGED_TMA_LAUNCHES, STAGED_ASYNC_LAUNCHES
    global SIMPLE_LAUNCHES
    x = _card_raster(data, "surface_cuda")
    check_products(which, allow_empty=False)
    h, w = x.shape
    outs, ptrs, mask, scalars = surface_args(
        x, which, cellsize_x, cellsize_y, azimuth, angle_altitude)
    lib = _cuda.library()
    if route == "simple":
        with torch.cuda.device(x.device):
            err = lib.surface_launch(x.data_ptr(), *ptrs, h, w, mask,
                                     *scalars, _cuda.stream_of(x.device))
        _cuda.check(err, "surface_kernel")
        SIMPLE_LAUNCHES += 1
    else:
        sms = torch.cuda.get_device_properties(
            x.device).multi_processor_count
        plan = surface_plan(h, w, x.data_ptr(), tile, sms)
        if route not in (None, plan.route):
            raise ValueError(f"surface_cuda: route {route!r} is not the "
                             f"plan's ({plan.route!r}) or 'simple'")
        with torch.cuda.device(x.device):
            err = lib.surface_staged_launch(
                x.data_ptr(), *ptrs, h, w, mask, *scalars, tile[0], tile[1],
                ("tma", "async").index(plan.route), plan.stages, plan.grid,
                plan.shared_bytes, _cuda.stream_of(x.device))
        if err < 0:
            raise RuntimeError(f"surface_staged: cuTensorMapEncodeTiled "
                               f"failed with CUresult {-err} for a {h}x{w} "
                               f"float32 raster, box {plan.box}")
        _cuda.check(err, f"surface_staged ({plan.route})")
        if plan.route == "tma":
            STAGED_TMA_LAUNCHES += 1
        else:
            STAGED_ASYNC_LAUNCHES += 1
    LAUNCHES += 1
    return tuple(outs[p] for p in which)


def surface_stacked_cuda(data: torch.Tensor, which, cellsize_x=1.0,
                         cellsize_y=1.0, azimuth=225.0, angle_altitude=25.0,
                         squeeze=False, route=None, tile=None,
                         stages=None) -> torch.Tensor:
    """(K, H, W) float32 stack, plane k = product ``which[k]``, 1-cell NaN
    ring; (H, W) when `squeeze` and K == 1.

    `route` None takes the plan's route (``stacked_plan``: "tma" or
    "phased"); "tma" must be the plan's, "phased" runs at any shape;
    `tile` and `stages` as ``stacked_plan`` takes them; "simple" takes the
    first port, ``surface_stacked_kernel``, by name."""
    global STACKED_LAUNCHES, STACKED_TMA_LAUNCHES, STACKED_PHASED_LAUNCHES
    global STACKED_SIMPLE_LAUNCHES
    x = _card_raster(data, "surface_stacked_cuda")
    check_products(which, allow_empty=False)
    h, w = x.shape
    out = torch.empty((len(which), h, w), dtype=torch.float32,
                      device=x.device)
    planes = [which.index(p) if p in which else -1 for p in PRODUCTS]
    scalars = _scalars(cellsize_x, cellsize_y, azimuth, angle_altitude)
    lib = _cuda.library()
    if route == "simple":
        with torch.cuda.device(x.device):
            err = lib.surface_stacked_launch(
                x.data_ptr(), out.data_ptr(), h, w, *planes, *scalars,
                _cuda.stream_of(x.device))
        _cuda.check(err, "surface_stacked_kernel")
        STACKED_SIMPLE_LAUNCHES += 1
    else:
        sms = torch.cuda.get_device_properties(
            x.device).multi_processor_count
        plan = stacked_plan(h, w, x.data_ptr(), out.data_ptr(), route, tile,
                            stages, sms)
        with torch.cuda.device(x.device):
            err = lib.surface_stacked_staged_launch(
                x.data_ptr(), out.data_ptr(), h, w, *planes, *scalars,
                plan.tile[0], plan.tile[1],
                {"tma": 0, "phased": 2}[plan.route], plan.stages, plan.grid,
                plan.shared_bytes, _cuda.stream_of(x.device))
        if err < 0:
            raise RuntimeError(f"surface_stacked: cuTensorMapEncodeTiled "
                               f"failed with CUresult {-err} for a {h}x{w} "
                               f"float32 raster, tile {plan.tile}")
        _cuda.check(err, f"surface_stacked ({plan.route})")
        if plan.route == "tma":
            STACKED_TMA_LAUNCHES += 1
        else:
            STACKED_PHASED_LAUNCHES += 1
    STACKED_LAUNCHES += 1
    return out[0] if squeeze and len(which) == 1 else out
