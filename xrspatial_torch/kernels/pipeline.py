"""terrain_pipeline's fused branch: surface products + focal statistics.

Counterpart of ``xrspatial_tpu/kernels/pallas_pipeline.py``.
``pipeline_multi`` is the torch twin: ``surface_multi`` plus
``window_stats``, exactly the split path's twins.  It is the plain version
of the CUDA kernel in ``cuda_pipeline.py``, which computes every output
from one launch over the DEM.  ``pipeline_kernels`` dispatches: a tensor
on the CPU to the twin, a tensor on the card to the kernel, at every size.
"""

from __future__ import annotations

import torch

from .surface import surface_multi
from .window import window_stats

__all__ = ["pipeline_supported", "pipeline_multi", "pipeline_kernels"]


def pipeline_supported(offsets) -> bool:
    """The JAX package's gate for its fused kernel: ry <= 32 and
    2*rx <= 128, with radii of at least 1."""
    ry = max(max(abs(dy) for dy, _ in offsets), 1)
    rx = max(max(abs(dx) for _, dx in offsets), 1)
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
    if data.device.type == "cpu":
        return pipeline_multi(*args)
    from .cuda_pipeline import pipeline_cuda
    return pipeline_cuda(*args)
