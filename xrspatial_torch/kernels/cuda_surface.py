"""Wrapper of the CUDA surface kernel (``csrc/surface.cu``).

Replaces ``xrspatial_tpu/kernels/pallas_surface2.py::surface_tiled``.  The
wrapper takes only a tensor on the card: it builds the kernel library at
the first call, allocates the outputs, launches on PyTorch's current
stream and raises if the launch fails.  Its plain version is
``kernels/surface.py::surface_multi``.
"""

from __future__ import annotations

import torch

from . import _cuda
from .surface import PRODUCTS, sun_scalars

__all__ = ["surface_cuda", "LAUNCHES"]

# launches of the kernel in this process, for checks that a path ran on it
LAUNCHES = 0


def surface_args(x: torch.Tensor, which, cellsize_x, cellsize_y, azimuth,
                 angle_altitude) -> tuple:
    """The surface half of a launch: ``(outs, ptrs, mask, scalars)``, the
    (H, W) float32 planes of `which` (allocated), the four product
    pointers in the kernel's order (None where not requested), the product
    mask, and csx, csy and the sun's four scalars in float32."""
    unknown = [p for p in which if p not in PRODUCTS]
    if unknown or len(set(which)) != len(which):
        raise ValueError(f"products must be distinct names from {PRODUCTS}, "
                         f"got {which!r}")
    outs = {p: torch.empty(x.shape, dtype=torch.float32, device=x.device)
            for p in which}
    mask = sum(1 << PRODUCTS.index(p) for p in which)
    ptrs = [outs[p].data_ptr() if p in outs else None for p in PRODUCTS]
    # the scalars in float32, on the host (no device sync)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    sun = [float(s) for s in sun_scalars(f32(azimuth), f32(angle_altitude))]
    return outs, ptrs, mask, (float(f32(cellsize_x)), float(f32(cellsize_y)),
                              *sun)


def surface_cuda(data: torch.Tensor, which, cellsize_x=1.0, cellsize_y=1.0,
                 azimuth=225.0, angle_altitude=25.0) -> tuple:
    """Tuple of (H, W) float32 products, in `which` order, 1-cell NaN ring."""
    global LAUNCHES
    if data.device.type != "cuda":
        raise ValueError(
            f"surface_cuda takes a CUDA tensor, got one on {data.device}")
    if data.ndim != 2:
        raise ValueError(f"surface_cuda takes a 2D tensor, got {data.ndim}D")
    if not which:
        raise ValueError(f"products must be distinct names from {PRODUCTS}, "
                         f"got {which!r}")
    x = data.to(torch.float32).contiguous()
    h, w = x.shape
    outs, ptrs, mask, scalars = surface_args(
        x, which, cellsize_x, cellsize_y, azimuth, angle_altitude)
    lib = _cuda.library()
    with torch.cuda.device(x.device):
        err = lib.surface_launch(x.data_ptr(), *ptrs, h, w, mask, *scalars,
                                 _cuda.stream_of(x.device))
    _cuda.check(err, "surface_kernel")
    LAUNCHES += 1
    return tuple(outs[p] for p in which)
