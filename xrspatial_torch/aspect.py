"""Aspect: downslope compass direction (planar 3x3).

Counterpart of ``xrspatial_tpu/aspect.py``; flat cells are -1.
``method='geodesic'`` is the float64 ECEF plane fit of
``kernels/geodesic.py`` (torch ops, on the raster's device).
"""

from __future__ import annotations

import torch

from .dataset_support import supports_dataset
from .kernels.geodesic import WGS84_A2, WGS84_B2, geodesic_mesh, geodesic_aspect
from .kernels.surface import run_surface_op
from .parallel.halo import ShardedRaster
from .utils import (Z_UNITS, _extract_latlon_coords, latlon_coords,
                    raster_payload, wrap_like)
from .xrlib import DataArray

__all__ = ["aspect"]


@supports_dataset
def aspect(agg: DataArray,
           name: str = 'aspect',
           method: str = 'planar',
           z_unit: str = 'meter') -> DataArray:
    """Returns downslope aspect in compass degrees (0 = N, 90 = E, ...).

    Flat cells return -1.  Output preserves dims/coords/attrs with a
    1-cell NaN border.

    Parameters
    ----------
    agg : DataArray or Dataset
        2D elevation array.
    name : str, default='aspect'
    method : 'planar' | 'geodesic'
    z_unit : str, default='meter' (geodesic only)
    """
    if method not in ('planar', 'geodesic'):
        raise ValueError(
            f"method must be 'planar' or 'geodesic', got {method!r}")
    if method == 'planar':
        out = run_surface_op("aspect", raster_payload(agg))
    else:
        if z_unit not in Z_UNITS:
            raise ValueError(
                f"z_unit must be one of "
                f"{sorted(Z_UNITS)}, got {z_unit!r}")
        elev = raster_payload(agg, torch.float64)
        if isinstance(elev, ShardedRaster):
            out = geodesic_mesh(geodesic_aspect, elev, *latlon_coords(agg),
                                WGS84_A2, WGS84_B2, Z_UNITS[z_unit])
            return wrap_like(agg, out, name)
        lat_2d, lon_2d = _extract_latlon_coords(agg)
        out = geodesic_aspect(elev, torch.from_numpy(lat_2d),
                              torch.from_numpy(lon_2d), WGS84_A2, WGS84_B2,
                              Z_UNITS[z_unit])
    return wrap_like(agg, out, name)
