"""Composite terrain analytics.

Counterpart of ``xrspatial_tpu/analytics.py``.  ``summarize_terrain``
computes slope, aspect and curvature from one read of the DEM;
``terrain_pipeline`` is the split path: one surface pass for all requested
products, then one focal pass.  On the card that is exactly one launch of
the surface kernel and one of the focal kernel.  The fused single-pass
branch (TPU kernel ``pallas_pipeline.py::pipeline_tiled``) waits for
ROADMAP B4; the mesh-sharded branch for ROADMAP A13.
"""

from __future__ import annotations

import numpy as np

from .convolution import circle_kernel, custom_kernel
from .focal import _STAT_NAMES, focal_stats
from .kernels.surface import PRODUCTS, surface_kernels
from .utils import get_dataarray_resolution, to_torch, wrap_like
from .xrlib import DataArray, Dataset

__all__ = ["summarize_terrain", "terrain_pipeline"]


def summarize_terrain(terrain: DataArray) -> Dataset:
    """Calculate slope, aspect, and curvature of a terrain in one pass.

    Returns a Dataset with variables named ``{terrain.name}-slope``,
    ``{terrain.name}-curvature``, ``{terrain.name}-aspect`` plus the
    original terrain.
    """
    if terrain.name is None:
        raise NameError('Requires DataArray.name property to be set')

    cellsize_x, cellsize_y = get_dataarray_resolution(terrain)
    outs = surface_kernels(to_torch(terrain), ("slope", "aspect", "curvature"),
                           cellsize_x, cellsize_y)

    ds = terrain.to_dataset()
    for p in ("slope", "curvature", "aspect"):
        ds[f'{terrain.name}-{p}'] = wrap_like(terrain, outs[p],
                                              f'{terrain.name}-{p}')
    return ds


def terrain_pipeline(agg: DataArray,
                     surface=("slope", "hillshade"),
                     kernel=None,
                     stats_funcs=("mean", "max", "min", "std"),
                     azimuth: float = 225.0,
                     angle_altitude: float = 25.0) -> Dataset:
    """Surface products + focal statistics of one DEM.

    Results are identical to calling ``slope``/``aspect``/``curvature``/
    ``hillshade`` and ``focal_stats`` separately, except that curvature
    uses the mean of the two cell sizes.  Returns a Dataset with one
    variable per surface product plus ``focal_stats`` as a (stats, y, x)
    stack (same layout as ``focal.focal_stats``).
    """
    if agg.ndim != 2:
        raise ValueError("`agg` must be 2D")
    for s in stats_funcs:
        if s not in _STAT_NAMES:
            raise ValueError(f"unknown stat {s!r}; supported: {_STAT_NAMES}")
    for p in surface:
        if p not in PRODUCTS:
            raise ValueError(f"unknown surface product {p!r}; "
                             f"supported: {PRODUCTS}")
    if kernel is None:
        kernel = circle_kernel(1, 1, 1.5)
    kernel = custom_kernel(np.asarray(kernel))
    cellsize_x, cellsize_y = get_dataarray_resolution(agg)
    surf_outs = surface_kernels(to_torch(agg), tuple(surface), cellsize_x,
                                cellsize_y, azimuth, angle_altitude)

    name = agg.name or "terrain"
    ds = agg.to_dataset(name=name)
    for p in surface:
        ds[f'{name}-{p}'] = wrap_like(agg, surf_outs[p], f'{name}-{p}')
    ds["focal_stats"] = focal_stats(
        agg, kernel, stats_funcs=list(stats_funcs)).rename("focal_stats")
    return ds
