"""Slope: terrain gradient magnitude in degrees (planar Horn).

Counterpart of ``xrspatial_tpu/slope.py``.  The planar method runs
through ``kernels/surface.py::run_surface_op``.  ``method='geodesic'``
waits for ROADMAP A10.
"""

from __future__ import annotations

from .dataset_support import supports_dataset
from .kernels.surface import run_surface_op
from .utils import get_dataarray_resolution, to_torch, wrap_like
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
        ``'geodesic'`` is not ported yet.
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
    if method == 'geodesic':
        raise NotImplementedError(
            "slope(method='geodesic') is not ported to xrspatial_torch yet "
            "(ROADMAP A10)")
    cellsize_x, cellsize_y = get_dataarray_resolution(agg)
    out = run_surface_op("slope", to_torch(agg), cellsize_x, cellsize_y)
    return wrap_like(agg, out, name)
