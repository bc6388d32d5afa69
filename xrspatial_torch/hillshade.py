"""Hillshade: illumination of a surface from a given sun azimuth/altitude.

Counterpart of ``xrspatial_tpu/hillshade.py``: the np.gradient-based
formulation in its one-rsqrt form.  ``shadows=True`` is the ray march
toward the sun of ``kernels/shadows.py`` (torch ops, on the raster's
device; on a mesh through ``run_stencil`` with the march's halo).
"""

from __future__ import annotations

from typing import Optional

from .dataset_support import supports_dataset
from .kernels.shadows import hillshade_shadows, hillshade_shadows_mesh
from .kernels.surface import run_surface_op
from .parallel.halo import ShardedRaster
from .utils import get_dataarray_resolution, raster_payload, wrap_like
from .xrlib import DataArray

__all__ = ["hillshade"]


@supports_dataset
def hillshade(agg: DataArray,
              azimuth: int = 225,
              angle_altitude: int = 25,
              name: Optional[str] = 'hillshade',
              shadows: bool = False) -> DataArray:
    """Returns illumination values in [0, 1] for each cell.

    Parameters
    ----------
    agg : DataArray or Dataset
        2D elevation array.
    angle_altitude : int, default=25
        Sun altitude angle in degrees.
    azimuth : int, default=225
        Sun azimuth (angle from north) in degrees.
    name : str, default='hillshade'
    shadows : bool, default=False
        Also compute cast shadows by ray-marching each cell toward the sun:
        Lambert shading, halved in shadow.
    """
    if shadows:
        cellsize_x, cellsize_y = get_dataarray_resolution(agg)
        data = raster_payload(agg)
        shade = (hillshade_shadows_mesh if isinstance(data, ShardedRaster)
                 else hillshade_shadows)
        out = shade(data, azimuth, angle_altitude, cellsize_x,
                    abs(cellsize_y))
    else:
        out = run_surface_op("hillshade", raster_payload(agg),
                             azimuth=azimuth, angle_altitude=angle_altitude)
    return wrap_like(agg, out, name)
