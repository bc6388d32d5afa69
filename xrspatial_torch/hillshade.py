"""Hillshade: illumination of a surface from a given sun azimuth/altitude.

Counterpart of ``xrspatial_tpu/hillshade.py``: the np.gradient-based
formulation in its one-rsqrt form.  ``shadows=True`` (the ray-marched cast
shadows) waits for ROADMAP A10.
"""

from __future__ import annotations

from typing import Optional

from .dataset_support import supports_dataset
from .kernels.surface import run_surface_op
from .utils import to_torch, wrap_like
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
        Cast shadows are not ported yet.
    """
    if shadows:
        raise NotImplementedError(
            "hillshade(shadows=True) is not ported to xrspatial_torch yet "
            "(ROADMAP A10)")
    out = run_surface_op("hillshade", to_torch(agg), azimuth=azimuth,
                         angle_altitude=angle_altitude)
    return wrap_like(agg, out, name)
