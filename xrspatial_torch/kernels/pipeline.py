"""terrain_pipeline's fused branch: surface products + focal statistics.

Counterpart of ``xrspatial_tpu/kernels/pallas_pipeline.py``.
``pipeline_multi`` is the torch twin: ``surface_multi`` plus
``window_stats``, exactly the split path's twins.  It is the plain version
of the CUDA kernel in ``cuda_pipeline.py``, which computes every output
from one launch over the DEM.  ``pipeline_kernels`` dispatches: a tensor
on the CPU to the twin, a tensor on the card to the kernel, at every size.

``pipeline_plan`` plans the kernel (B4 on B2's staged window,
``csrc/focal_halo.cu``): ``halo_plan``'s window over the footprint's
radii, each at least ``SURFACE_RADIUS``, since the surface products read
every cell's 3x3 neighbourhood from the same window and the gate admits
footprints of radius 0 along an axis (a 1x3 row, a 3x1 column).
"""

from __future__ import annotations

import torch

from ..tracing import span
from .focal_halo import HaloPlan, halo_plan
from .surface import surface_multi
from .window import window_stats

__all__ = ["pipeline_supported", "pipeline_plan", "pipeline_radii",
           "pipeline_multi", "pipeline_kernels", "SURFACE_RADIUS"]

SURFACE_RADIUS = 1   # the surface products' 3x3 neighbourhood


def pipeline_radii(offsets) -> tuple:
    """(ry, rx) of the fused kernel's window: the footprint's radii, each
    at least ``SURFACE_RADIUS``."""
    return (max(max(abs(dy) for dy, _ in offsets), SURFACE_RADIUS),
            max(max(abs(dx) for _, dx in offsets), SURFACE_RADIUS))


def pipeline_plan(h: int, w: int, offsets, ptr: int = 0) -> HaloPlan:
    """How the fused kernel runs an (h, w) float32 raster at input address
    `ptr` over `offsets`: ``halo_plan`` with its radii at least
    ``SURFACE_RADIUS``; route "tma" or "async" (or "ring" where no
    window fits a block, which no footprint the gate accepts reaches)."""
    return halo_plan(h, w, offsets, ptr, min_radius=SURFACE_RADIUS)


def pipeline_supported(offsets) -> bool:
    """The JAX package's gate for its fused kernel: ry <= 32 and
    2*rx <= 128, with radii of at least 1."""
    ry, rx = pipeline_radii(offsets)
    return ry <= 32 and 2 * rx <= 128


def pipeline_multi(data: torch.Tensor, offsets, stats, which,
                   cellsize_x=1.0, cellsize_y=1.0, azimuth=225.0,
                   angle_altitude=25.0) -> tuple:
    """The (H, W) surface products in `which` order, then the (S, H, W)
    focal stack in `stats` order (``pipeline_tiled``'s outputs)."""
    surf = surface_multi(data, cellsize_x, cellsize_y, azimuth,
                         angle_altitude, tuple(which))
    focal = window_stats(data, offsets, tuple(stats))
    return (*(surf[p] for p in which),
            torch.stack([focal[s] for s in stats]))


def pipeline_kernels(data: torch.Tensor, offsets, stats, which,
                     cellsize_x=1.0, cellsize_y=1.0, azimuth=225.0,
                     angle_altitude=25.0) -> tuple:
    """``pipeline_multi``'s outputs: the twin for a CPU tensor, one launch
    of the CUDA kernel otherwise."""
    args = (data, offsets, stats, which, cellsize_x, cellsize_y, azimuth,
            angle_altitude)
    with span("dispatch.pipeline"):
        if data.device.type == "cpu":
            return pipeline_multi(*args)
        from .cuda_pipeline import pipeline_cuda
        return pipeline_cuda(*args)
