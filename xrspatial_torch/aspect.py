"""Aspect: downslope compass direction (planar 3x3).

Counterpart of ``xrspatial_tpu/aspect.py``; flat cells are -1.
``method='geodesic'`` waits for ROADMAP A10.
"""

from __future__ import annotations

from .dataset_support import supports_dataset
from .kernels.surface import run_surface_op
from .utils import to_torch, wrap_like
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
    method : 'planar' ('geodesic' is not ported yet)
    z_unit : str, default='meter' (geodesic only)
    """
    if method not in ('planar', 'geodesic'):
        raise ValueError(
            f"method must be 'planar' or 'geodesic', got {method!r}")
    if method == 'geodesic':
        raise NotImplementedError(
            "aspect(method='geodesic') is not ported to xrspatial_torch yet "
            "(ROADMAP A10)")
    out = run_surface_op("aspect", to_torch(agg))
    return wrap_like(agg, out, name)
