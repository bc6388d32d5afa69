"""Curvature: second derivative of the surface (convexity/concavity).

Counterpart of ``xrspatial_tpu/curvature.py``: the plus-shaped stencil
``-2*(d+e)*100/cellsize^2`` with the mean of the x and y resolution as
cell size.
"""

from __future__ import annotations

from typing import Optional

from .dataset_support import supports_dataset
from .kernels.surface import run_surface_op
from .utils import get_dataarray_resolution, raster_payload, wrap_like
from .xrlib import DataArray

__all__ = ["curvature"]


@supports_dataset
def curvature(agg: DataArray,
              name: Optional[str] = 'curvature') -> DataArray:
    """Returns curvature of the input elevation raster.

    Positive values indicate convex-upward cells, negative concave.
    Output preserves dims/coords/attrs with a 1-cell NaN border.
    """
    cellsize_x, cellsize_y = get_dataarray_resolution(agg)
    cellsize = (cellsize_x + cellsize_y) / 2
    out = run_surface_op("curvature", raster_payload(agg), cellsize,
                         cellsize)
    return wrap_like(agg, out, name)
