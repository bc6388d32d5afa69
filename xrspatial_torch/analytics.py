"""Composite terrain analytics.

Counterpart of ``xrspatial_tpu/analytics.py``.  ``summarize_terrain``
computes slope, aspect and curvature from one read of the DEM;
``terrain_pipeline`` runs by default the split path: one surface pass for
all requested products, then one focal pass; on the card, for footprints
the tiled focal kernel takes, exactly one launch of the surface kernel and
one of the focal kernel.  With ``XRSPATIAL_FUSED_PIPELINE=1``, the JAX
package's opt-in, and a footprint its gate accepts (``pipeline_supported``)
it runs the fused branch instead: one launch of the pipeline kernel on the
card, the same twins on the CPU.  On a raster split over a mesh the
fused branch is not taken, as in the JAX package: the surface products
come from one pass over the tiles (``run_stencil``: on the card, one
surface kernel launch on each tile in place and one on each of its two
bands, or one on each extended block), then ``focal_stats`` takes its own
mesh branch, and
every result is split over the same mesh.  (The JAX package's mesh branch
runs one pass a product, through ``run_surface_op``, whose curvature takes
``cellsize_x`` alone; one pass for all keeps this branch equal to the
unsharded call.)  ``summarize_terrain`` takes the same surface pass.
"""

from __future__ import annotations

import os

import numpy as np

from .convolution import circle_kernel, custom_kernel
from .focal import _STAT_NAMES, focal_stats, stats_dataarray
from .kernels.pipeline import pipeline_kernels, pipeline_supported
from .kernels.surface import PRODUCTS, surface_kernels
from .kernels.window import kernel_offsets
from .parallel.halo import get_raster_mesh
from .tracing import span
from .utils import get_dataarray_resolution, raster_payload, wrap_like
from .xrlib import DataArray, Dataset

__all__ = ["summarize_terrain", "terrain_pipeline"]


def _use_fused_pipeline(offsets) -> bool:
    """The JAX package's opt-in, read at call time: the fused branch runs
    when XRSPATIAL_FUSED_PIPELINE is "1" and the footprint passes
    ``pipeline_supported``."""
    if os.environ.get("XRSPATIAL_FUSED_PIPELINE") != "1":
        return False
    return pipeline_supported(offsets)


def summarize_terrain(terrain: DataArray) -> Dataset:
    """Calculate slope, aspect, and curvature of a terrain in one pass.

    Returns a Dataset with variables named ``{terrain.name}-slope``,
    ``{terrain.name}-curvature``, ``{terrain.name}-aspect`` plus the
    original terrain.
    """
    if terrain.name is None:
        raise NameError('Requires DataArray.name property to be set')

    cellsize_x, cellsize_y = get_dataarray_resolution(terrain)
    outs = surface_kernels(raster_payload(terrain),
                           ("slope", "aspect", "curvature"), cellsize_x,
                           cellsize_y)

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
    stack (same layout as ``focal.focal_stats``).  Both branches, split
    and fused (see the module's docstring), give this layout.
    """
    with span("api.terrain_pipeline"):
        with span("api.args"):
            if agg.ndim != 2:
                raise ValueError("`agg` must be 2D")
            for s in stats_funcs:
                if s not in _STAT_NAMES:
                    raise ValueError(f"unknown stat {s!r}; supported: "
                                     f"{_STAT_NAMES}")
            for p in surface:
                if p not in PRODUCTS:
                    raise ValueError(f"unknown surface product {p!r}; "
                                     f"supported: {PRODUCTS}")
            if kernel is None:
                kernel = circle_kernel(1, 1, 1.5)
            kernel = custom_kernel(np.asarray(kernel))
            cellsize_x, cellsize_y = get_dataarray_resolution(agg)
            data = raster_payload(agg)
            name = agg.name or "terrain"
            offsets = kernel_offsets(kernel)
        with span("api.dataset"):
            ds = agg.to_dataset(name=name)

        if get_raster_mesh(data) is None and _use_fused_pipeline(offsets):
            outs = pipeline_kernels(data, offsets, tuple(stats_funcs),
                                    tuple(surface), cellsize_x, cellsize_y,
                                    azimuth, angle_altitude)
            with span("api.dataset"):
                for p, out in zip(surface, outs):
                    ds[f'{name}-{p}'] = wrap_like(agg, out, f'{name}-{p}')
                ds["focal_stats"] = stats_dataarray(agg, outs[-1],
                                                    stats_funcs,
                                                    "focal_stats")
            return ds

        surf_outs = surface_kernels(data, tuple(surface), cellsize_x,
                                    cellsize_y, azimuth, angle_altitude)
        with span("api.dataset"):
            for p in surface:
                ds[f'{name}-{p}'] = wrap_like(agg, surf_outs[p],
                                              f'{name}-{p}')
        stats = focal_stats(agg, kernel, stats_funcs=list(stats_funcs))
        with span("api.dataset"):
            ds["focal_stats"] = stats.rename("focal_stats")
        return ds
