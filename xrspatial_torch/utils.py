"""Shared helpers: resolution inference and torch adapters.

Counterpart of ``xrspatial_tpu/utils.py``.  Ported so far: the resolution
helpers (host code, same behaviour), ``validate_arrays``, ``to_torch`` in
place of ``to_jax``, ``wrap_like``, ``dataarray_from``, which carries a
raster and its metadata over from any DataArray-like object, the package's
default device, the geodesic helpers (``Z_UNITS``, the lat/lon extraction)
and ``nan_border``.
``canvas_like`` waits for its callers (ROADMAP A9); float64 is native in
torch, so ``x64`` has no counterpart.

A numpy payload goes to the default device, which is the card (``cuda``)
unless ``set_default_device`` says otherwise; a tensor payload stays on
its own device.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .xrlib import DataArray

__all__ = [
    "get_xy_range",
    "calc_res",
    "get_dataarray_resolution",
    "validate_arrays",
    "to_torch",
    "wrap_like",
    "dataarray_from",
    "set_default_device",
    "default_device",
    "Z_UNITS",
    "nan_border",
]

_default_device = torch.device("cuda")


def set_default_device(device) -> None:
    """Set the device numpy payloads go to (``"cuda"`` unless set).

    ``set_default_device("cpu")`` runs the package's entry points on the
    CPU, through the torch twins, for rasters given as numpy arrays.
    """
    global _default_device
    _default_device = torch.device(device)


def default_device() -> torch.device:
    """The device numpy payloads go to."""
    return _default_device


def _payload_device(device) -> torch.device:
    """`device`, or the default; raises if that is the card and there is
    none (never a silent run on the CPU)."""
    dev = torch.device(device) if device is not None else _default_device
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"xrspatial_torch puts numpy rasters on {dev}, but "
            f"torch.cuda.is_available() is false; call "
            f"xrspatial_torch.set_default_device('cpu') to run on the CPU")
    return dev


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


def validate_arrays(*arrays):
    """Check that all input DataArrays share one shape."""
    if len(arrays) < 2:
        raise ValueError(
            "validate_arrays() input must contain 2 or more arrays")
    first = arrays[0]
    for other in arrays[1:]:
        if tuple(first.data.shape) != tuple(other.data.shape):
            raise ValueError("input arrays must have equal shapes")


def to_torch(agg, dtype: Optional[torch.dtype] = torch.float32,
             device=None) -> torch.Tensor:
    """Coerce a DataArray's payload to a tensor of `dtype` on `device`.

    A tensor stays on its own device unless `device` is given; a numpy
    payload goes to `device`, or to the default device
    (``default_device()``).  No copy is made when the payload already has
    the requested dtype and device.
    """
    data = agg.data if isinstance(agg, DataArray) else agg
    if not isinstance(data, torch.Tensor):
        device = _payload_device(device)
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
    placed on `device` (the default device unless given); coords are
    copied as numpy arrays; dims, attrs and name are taken as they are.
    """
    data = torch.from_numpy(np.array(np.asarray(other.data))).to(
        _payload_device(device))
    coords = {k: (tuple(v.dims), np.array(np.asarray(v.data)),
                  dict(v.attrs))
              for k, v in other.coords.items()}
    return DataArray(data, coords=coords, dims=tuple(other.dims),
                     name=other.name, attrs=dict(other.attrs))


def nan_border(arr: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """Set a `radius`-wide border of the last two axes to NaN (stencil edge
    contract); returns a new tensor."""
    if radius <= 0:
        return arr
    h, w = arr.shape[-2], arr.shape[-1]
    rows = torch.arange(h, device=arr.device)[:, None]
    cols = torch.arange(w, device=arr.device)[None, :]
    interior = ((rows >= radius) & (rows < h - radius)
                & (cols >= radius) & (cols < w - radius))
    return torch.where(interior, arr, math.nan)


# -- lat/lon extraction for the geodesic methods -----------------------------

Z_UNITS = {
    'meter': 1.0, 'meters': 1.0, 'm': 1.0,
    'foot': 0.3048, 'feet': 0.3048, 'ft': 0.3048,
    'kilometer': 1000.0, 'kilometers': 1000.0, 'km': 1000.0,
    'mile': 1609.344, 'miles': 1609.344, 'mi': 1609.344,
}

_LAT_NAMES = {"lat", "latitude", "y"}
_LON_NAMES = {"lon", "longitude", "x"}


def _find_coord(agg, dim_name, known_names, label):
    if dim_name in agg.coords:
        coord = agg.coords[dim_name]
        if np.issubdtype(np.asarray(coord.data).dtype, np.number):
            return coord
    for name in agg.coords:
        if str(name).lower() in known_names:
            coord = agg.coords[name]
            if np.issubdtype(np.asarray(coord.data).dtype, np.number):
                return coord
    raise ValueError(
        f"geodesic method requires a numeric {label} coordinate; "
        f"none found among {list(agg.coords)}")


def _validate_geographic_range(lat_2d, lon_2d):
    if np.nanmin(lat_2d) < -90.0 or np.nanmax(lat_2d) > 90.0:
        raise ValueError("latitude values must be within [-90, 90] degrees")
    if np.nanmin(lon_2d) < -180.0 or np.nanmax(lon_2d) > 360.0:
        raise ValueError("longitude values must be within [-180, 360] degrees")


def _extract_latlon_coords(agg):
    """2-D float64 (lat, lon) numpy grids from 1-D or 2-D coordinates."""
    if agg.ndim < 2:
        raise ValueError(
            f"geodesic method requires a 2-D DataArray, got {agg.ndim}-D")
    dim_y, dim_x = agg.dims[-2], agg.dims[-1]
    lat_vals = np.asarray(_find_coord(agg, dim_y, _LAT_NAMES, "latitude").data,
                          dtype=np.float64)
    lon_vals = np.asarray(_find_coord(agg, dim_x, _LON_NAMES, "longitude").data,
                          dtype=np.float64)
    h, w = agg.shape[-2], agg.shape[-1]
    if lat_vals.ndim == 1 and lon_vals.ndim == 1:
        lat_2d = np.broadcast_to(lat_vals[:, None], (h, w)).copy()
        lon_2d = np.broadcast_to(lon_vals[None, :], (h, w)).copy()
    elif lat_vals.ndim == 2 and lon_vals.ndim == 2:
        lat_2d, lon_2d = lat_vals, lon_vals
    else:
        raise ValueError(
            f"lat/lon coordinates must be both 1-D or both 2-D, "
            f"got lat={lat_vals.ndim}-D and lon={lon_vals.ndim}-D")
    _validate_geographic_range(lat_2d, lon_2d)
    return lat_2d, lon_2d
