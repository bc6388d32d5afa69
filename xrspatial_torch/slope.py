"""Slope: terrain gradient magnitude in degrees (planar Horn).

Counterpart of ``xrspatial_tpu/slope.py``.  The planar method runs
through ``kernels/surface.py::run_surface_op``; ``method='geodesic'`` is
the float64 ECEF plane fit of ``kernels/geodesic.py`` (torch ops, on the
raster's device).
"""

from __future__ import annotations

import torch

from .dataset_support import supports_dataset
from .kernels.geodesic import WGS84_A2, WGS84_B2, geodesic_mesh, geodesic_slope
from .kernels.surface import run_surface_op
from .parallel.halo import ShardedRaster
from .utils import (Z_UNITS, _extract_latlon_coords,
                    get_dataarray_resolution, latlon_coords, raster_payload,
                    wrap_like)
from .xrlib import DataArray

__all__ = ["slope"]


@supports_dataset
def slope(agg: DataArray,
          name: str = 'slope',
          method: str = 'planar',
          z_unit: str = 'meter') -> DataArray:
    """Returns slope of input aggregate in degrees.

    Parameters
    ----------
    agg : DataArray or Dataset
        2D array of elevation data.  For a Dataset the op is applied to
        each data variable independently.
    name : str, default='slope'
        Name of output DataArray.
    method : str, default='planar'
        ``'planar'``: classic Horn algorithm with uniform cell size.
        ``'geodesic'``: cells converted to ECEF and fit with a 3D plane —
        accurate for geographic (lat/lon) grids.
    z_unit : str, default='meter'
        Unit of elevation values (geodesic method only).

    Returns
    -------
    slope_agg : DataArray of the same shape, dims/coords/attrs preserved,
        1-cell NaN border.
    """
    if method not in ('planar', 'geodesic'):
        raise ValueError(
            f"method must be 'planar' or 'geodesic', got {method!r}")
    if method == 'planar':
        cellsize_x, cellsize_y = get_dataarray_resolution(agg)
        out = run_surface_op("slope", raster_payload(agg), cellsize_x,
                             cellsize_y)
    else:
        if z_unit not in Z_UNITS:
            raise ValueError(
                f"z_unit must be one of "
                f"{sorted(Z_UNITS)}, got {z_unit!r}")
        elev = raster_payload(agg, torch.float64)
        if isinstance(elev, ShardedRaster):
            out = geodesic_mesh(geodesic_slope, elev, *latlon_coords(agg),
                                WGS84_A2, WGS84_B2, Z_UNITS[z_unit])
            return wrap_like(agg, out, name)
        lat_2d, lon_2d = _extract_latlon_coords(agg)
        out = geodesic_slope(elev, torch.from_numpy(lat_2d),
                             torch.from_numpy(lon_2d), WGS84_A2, WGS84_B2,
                             Z_UNITS[z_unit])
    return wrap_like(agg, out, name)
