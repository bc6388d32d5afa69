"""Shared helpers: resolution inference and torch adapters.

Counterpart of ``xrspatial_tpu/utils.py``.  Ported so far: the resolution
helpers (host code, same behaviour), ``to_torch`` in place of ``to_jax``,
``wrap_like``, and ``dataarray_from``, which carries a raster and its
metadata over from any DataArray-like object.  Float64 scopes, the
geodesic helpers, ``canvas_like`` and ``nan_border`` wait for their
callers (ROADMAP A5-A10).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .xrlib import DataArray

__all__ = [
    "get_xy_range",
    "calc_res",
    "get_dataarray_resolution",
    "to_torch",
    "wrap_like",
    "dataarray_from",
]


def get_xy_range(raster, xdim=None, ydim=None):
    """(xmin, xmax), (ymin, ymax) from the raster's dim coordinates."""
    if ydim is None:
        ydim = raster.dims[-2]
    if xdim is None:
        xdim = raster.dims[-1]
    xvals = np.asarray(raster[xdim].data)
    yvals = np.asarray(raster[ydim].data)
    return (float(xvals.min()), float(xvals.max())), \
           (float(yvals.min()), float(yvals.max()))


def calc_res(raster, xdim=None, ydim=None):
    """(xres, yres) derived from coordinate extents (endpoint spacing)."""
    h, w = raster.shape[-2:]
    (xmin, xmax), (ymin, ymax) = get_xy_range(raster, xdim, ydim)
    return (xmax - xmin) / (w - 1), (ymax - ymin) / (h - 1)


def get_dataarray_resolution(agg, xdim: Optional[str] = None,
                             ydim: Optional[str] = None):
    """Cell size (x, y): prefer the ``res`` attr, else derive from coords.

    ``res`` may be a scalar or a 2-sequence; anything malformed falls back
    to coordinate spacing.
    """
    try:
        cellsize = agg.attrs.get("res")
        if (isinstance(cellsize, (tuple, list, np.ndarray))
                and len(cellsize) == 2
                and isinstance(cellsize[0], (int, float, np.number))
                and isinstance(cellsize[1], (int, float, np.number))):
            return cellsize[0], cellsize[1]
        if isinstance(cellsize, (int, float, np.number)):
            return cellsize, cellsize
        return calc_res(agg, xdim, ydim)
    except Exception:
        return calc_res(agg, xdim, ydim)


def to_torch(agg, dtype: Optional[torch.dtype] = torch.float32,
             device=None) -> torch.Tensor:
    """Coerce a DataArray's payload to a tensor of `dtype` on `device`.

    A tensor stays on its own device unless `device` is given; a numpy
    payload goes to `device`, or to the CPU.  No copy is made when the
    payload already has the requested dtype and device.
    """
    data = agg.data if isinstance(agg, DataArray) else agg
    if not isinstance(data, torch.Tensor):
        # torch.from_numpy needs a writeable array (read-only views of
        # device buffers are common payloads)
        data = torch.from_numpy(np.require(np.asarray(data),
                                           requirements="W"))
    return data.to(device=device, dtype=dtype)


def wrap_like(agg, out, name: Optional[str] = None) -> DataArray:
    """Wrap an output array with the input's coords/dims/attrs."""
    return DataArray(out, name=name, coords=agg.coords, dims=agg.dims,
                     attrs=agg.attrs)


def dataarray_from(other, device=None) -> DataArray:
    """A DataArray of this package holding `other`'s raster as a tensor.

    `other` is any DataArray-like object (another package's shim or real
    xarray).  Its payload is read to the host with ``np.asarray`` and
    placed on `device` (the CPU by default); coords are copied as numpy
    arrays; dims, attrs and name are taken as they are.
    """
    data = torch.from_numpy(np.array(np.asarray(other.data))).to(device)
    coords = {k: (tuple(v.dims), np.array(np.asarray(v.data)),
                  dict(v.attrs))
              for k, v in other.coords.items()}
    return DataArray(data, coords=coords, dims=tuple(other.dims),
                     name=other.name, attrs=dict(other.attrs))
