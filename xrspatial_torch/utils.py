"""Shared helpers: resolution inference and torch adapters.

Counterpart of ``xrspatial_tpu/utils.py``, every helper of it: the
resolution helpers (host code, same behaviour), ``validate_arrays``,
``to_torch`` in place of ``to_jax``, ``wrap_like``, ``dataarray_from``,
which carries a raster and its metadata over from any DataArray-like
object, the package's default device, the unit heuristics behind
``warn_if_unit_mismatch`` and ``diagnose`` (which move five sampled
windows of a raster to the host, never the whole tensor), the geodesic
helpers (``Z_UNITS``, the lat/lon extraction), ``nan_border``,
``canvas_like`` (two ``index_select`` calls on the raster's device), the
Web-Mercator and aspect-ratio helpers, the image helpers (host numpy, as
in the JAX package) and the reference's backend predicates, which answer
for a torch payload: no cupy and no dask.  float64 is native in torch, so
``x64`` has no counterpart.

A numpy payload goes to the default device, which is the card (``cuda``)
unless ``set_default_device`` says otherwise; a tensor payload stays on
its own device.  A raster split over a device mesh (a
``parallel.ShardedRaster``) is taken as it is by the ops with a mesh
branch (``raster_payload``, ``per_block``, ``mesh_shards``); the host
functions gather it with a warning (``host_copy``); ``to_torch`` refuses
it, so no op gathers a split raster behind the caller's back.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from .parallel.halo import (ShardedRaster, distribute, get_raster_mesh,
                            tiles, zip_blocks)
from .xr_compat import _to_numpy
from .xrlib import DataArray

__all__ = [
    "canvas_like",
    "lnglat_to_meters",
    "height_implied_by_aspect_ratio",
    "warn_if_unit_mismatch",
    "bands_to_img",
    "color_values",
    "has_cuda_and_cupy",
    "is_cupy_array",
    "has_dask_array",
    "has_dask_dataframe",
    "is_cupy_backed",
    "is_dask_cupy",
    "cuda_args",
    "calc_cuda_dims",
    "not_implemented_func",
    "raster_device",
    "get_xy_range",
    "calc_res",
    "get_dataarray_resolution",
    "validate_arrays",
    "to_torch",
    "raster_payload",
    "blockwise",
    "payload_mesh", "host_copy", "mesh_shards", "per_block",
    "latlon_coords",
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


def raster_device(agg) -> torch.device:
    """The device a raster's results go to: its tensor's (a mesh raster's
    first block's), or for a numpy payload the default device."""
    data = agg.data if isinstance(agg, DataArray) else agg
    if isinstance(data, torch.Tensor):
        return data.device
    if isinstance(data, ShardedRaster):
        return data.blocks[0][0].device
    return _payload_device(None)


def to_torch(agg, dtype: Optional[torch.dtype] = torch.float32,
             device=None) -> torch.Tensor:
    """Coerce a DataArray's payload to a tensor of `dtype` on `device`.

    A tensor stays on its own device unless `device` is given; a numpy
    payload goes to `device`, or to the default device
    (``default_device()``).  No copy is made when the payload already has
    the requested dtype and device.  A ``ShardedRaster`` that no block
    splits (a one-device mesh, or a raster every block holds whole) gives
    its first block; one split over a mesh is refused with a
    ``ValueError``: every op takes such a raster through its mesh branch
    (``raster_payload``, ``per_block``, ``host_copy``), and none gathers
    it behind the caller's back.
    """
    data = agg.data if isinstance(agg, DataArray) else agg
    if isinstance(data, ShardedRaster):
        if get_raster_mesh(data) is not None:
            raise ValueError(
                "to_torch: the raster is split over a device mesh; its "
                "blocks are reached through the op's mesh branch, or "
                "gathered with .data.gather()")
        data = data.blocks[0][0]
    if not isinstance(data, torch.Tensor):
        device = _payload_device(device)
        # torch.from_numpy needs a writeable array (read-only views of
        # device buffers are common payloads)
        data = torch.from_numpy(np.require(np.asarray(data),
                                           requirements="W"))
    return data.to(device=device, dtype=dtype)


def blockwise(fn, data):
    """``fn(data)``, or for a raster split over a mesh the raster of the
    same layout holding ``fn`` of each block."""
    if get_raster_mesh(data) is not None:
        return data.map_blocks(fn)
    return fn(data)


def payload_mesh(*aggs):
    """The mesh the first payload split over one lies on, or None."""
    for agg in aggs:
        data = agg.data if isinstance(agg, DataArray) else agg
        mesh = get_raster_mesh(data)
        if mesh is not None:
            return mesh
    return None


def host_copy(agg, what: str) -> np.ndarray:
    """A DataArray's payload as a numpy array on the host, for the
    functions that compute in numpy.  A raster split over a mesh is
    gathered with a ``UserWarning`` naming `what`, as ``np.asarray``
    gathers a sharded array in the JAX package."""
    data = agg.data if isinstance(agg, DataArray) else agg
    if get_raster_mesh(data) is not None:
        warnings.warn(
            f"{what}: input is mesh-sharded but the function runs on the "
            "HOST over a gathered copy (correct, not distributed).",
            UserWarning, stacklevel=3)
    return _to_numpy(data)


def mesh_shards(mesh, *aggs, dtype: Optional[torch.dtype] = torch.float32):
    """The payloads of `aggs` as rasters of tiles on `mesh`, each block of
    `dtype` (None: as it is): a raster split over `mesh` as it is, a
    tensor or numpy payload placed on it by ``distribute`` (a copy, no
    gather).  A raster split over another mesh is refused."""
    out = []
    for agg in aggs:
        data = agg.data if isinstance(agg, DataArray) else agg
        m = get_raster_mesh(data)
        if m is None:
            if isinstance(data, ShardedRaster):
                data = data.blocks[0][0]
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                data = distribute(data, mesh)
        elif m is not mesh:
            raise ValueError("the rasters lie on different device meshes")
        data = tiles(data)
        if dtype is not None and data.dtype != dtype:
            data = data.map_blocks(lambda b: b.to(dtype))
        out.append(data)
    return out


def per_block(fn, *aggs, dtype: Optional[torch.dtype] = torch.float32):
    """``fn(*tensors)`` of a cell-by-cell op: on one device of the payloads
    as ``to_torch`` gives them; where any payload is split over a mesh, of
    each block of them all (see ``mesh_shards``), a raster of the tiles
    on that mesh."""
    mesh = payload_mesh(*aggs)
    if mesh is None:
        return fn(*(to_torch(a, dtype) for a in aggs))
    return zip_blocks(lambda i, j, *bs: fn(*bs),
                      *mesh_shards(mesh, *aggs, dtype=dtype))


def raster_payload(agg, dtype: Optional[torch.dtype] = torch.float32):
    """The payload of an op that has a mesh branch: a raster split over a
    mesh as a ``ShardedRaster`` of `dtype` (None: as it is), anything else
    as ``to_torch`` gives it."""
    data = agg.data if isinstance(agg, DataArray) else agg
    if get_raster_mesh(data) is None:
        return to_torch(agg, dtype)
    if dtype is None or data.dtype == dtype:
        return data
    return data.map_blocks(lambda b: b.to(dtype))


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
    lat_vals, lon_vals = latlon_coords(agg)
    h, w = agg.shape[-2], agg.shape[-1]
    if lat_vals.ndim == 1:
        return (np.broadcast_to(lat_vals[:, None], (h, w)).copy(),
                np.broadcast_to(lon_vals[None, :], (h, w)).copy())
    return lat_vals, lon_vals


def latlon_coords(agg):
    """The float64 (lat, lon) coordinates as numpy arrays, both 1-D (the
    rows' latitudes and the columns' longitudes) or both 2-D grids,
    checked to lie within the geographic range."""
    if agg.ndim < 2:
        raise ValueError(
            f"geodesic method requires a 2-D DataArray, got {agg.ndim}-D")
    dim_y, dim_x = agg.dims[-2], agg.dims[-1]
    lat_vals = np.asarray(_find_coord(agg, dim_y, _LAT_NAMES, "latitude").data,
                          dtype=np.float64)
    lon_vals = np.asarray(_find_coord(agg, dim_x, _LON_NAMES, "longitude").data,
                          dtype=np.float64)
    if not (lat_vals.ndim == lon_vals.ndim and lat_vals.ndim in (1, 2)):
        raise ValueError(
            f"lat/lon coordinates must be both 1-D or both 2-D, "
            f"got lat={lat_vals.ndim}-D and lon={lon_vals.ndim}-D")
    _validate_geographic_range(lat_vals, lon_vals)
    return lat_vals, lon_vals


# -- unit heuristics ----------------------------------------------------------

_LINEAR_UNITS = (
    "m", "meter", "metre", "meters", "metres",
    "km", "kilometer", "kilometre", "kilometers", "kilometres",
    "ft", "foot", "feet",
)


def _infer_coord_unit_type(coord, cellsize: float) -> str:
    """Classify a coordinate axis as 'degrees' | 'linear' | 'unknown'."""
    units = str(coord.attrs.get("units", "")).lower()
    if "degree" in units or units in ("deg", "degrees"):
        return "degrees"
    if units in _LINEAR_UNITS:
        return "linear"

    vals = _to_numpy(coord.data)
    if vals.size < 2 or not np.issubdtype(vals.dtype, np.number):
        return "unknown"
    vmin, vmax = float(np.nanmin(vals)), float(np.nanmax(vals))
    span, dx = abs(vmax - vmin), abs(float(cellsize))
    if -360.0 <= vmin <= 360.0 and -360.0 <= vmax <= 360.0 \
            and 1e-5 <= dx <= 0.5:
        return "degrees"
    if span > 1000.0 and dx >= 0.1:
        return "linear"
    return "unknown"


def _sample_windows_min_max(data, max_window_elems: int = 65536,
                            windows: int = 5) -> Tuple[float, float]:
    """Min and max of the finite values of a few evenly spaced windows of
    the flattened payload, never a full pass: only the windows move to the
    host."""
    flat = data.reshape(-1)
    n = int(flat.shape[0])
    if n == 0:
        return np.nan, np.nan
    win = min(max_window_elems, n)
    starts = np.linspace(0, max(n - win, 0),
                         num=max(windows, 1)).astype(np.int64)
    vmin, vmax = np.inf, -np.inf
    for s in starts:
        chunk = _to_numpy(flat[int(s):int(s) + win])
        finite = chunk[np.isfinite(chunk)] if chunk.dtype.kind == "f" \
            else chunk
        if finite.size:
            vmin = min(vmin, float(finite.min()))
            vmax = max(vmax, float(finite.max()))
    if vmin is np.inf:
        return np.nan, np.nan
    return vmin, vmax


def _infer_vertical_unit_type(agg) -> str:
    units = str(agg.attrs.get("units", "")).lower()
    if any(k in units for k in ("degree", "deg")) or "rad" in units:
        return "angle"
    if units in _LINEAR_UNITS:
        return "elevation"
    try:
        vmin, vmax = _sample_windows_min_max(agg.data)
    except Exception:
        return "unknown"
    if not (np.isfinite(vmin) and np.isfinite(vmax)):
        return "unknown"
    span = vmax - vmin
    if 10.0 <= span <= 20000.0 and vmin > -500.0:
        return "elevation"
    if -360.0 <= vmin <= 360.0 and -360.0 <= vmax <= 360.0 and span <= 720.0:
        return "angle"
    return "unknown"


def warn_if_unit_mismatch(agg) -> None:
    """Warn when coordinates look like degrees but elevations look linear."""
    try:
        cellsize_x, cellsize_y = get_dataarray_resolution(agg)
    except Exception:
        return
    if len(agg.dims) < 2:
        return
    dim_y, dim_x = agg.dims[-2], agg.dims[-1]
    coord_x = agg.coords.get(dim_x) if hasattr(agg.coords, "get") else None
    coord_y = agg.coords.get(dim_y) if hasattr(agg.coords, "get") else None
    if coord_x is None and dim_x in agg.coords:
        coord_x = agg.coords[dim_x]
    if coord_y is None and dim_y in agg.coords:
        coord_y = agg.coords[dim_y]
    if coord_x is None or coord_y is None:
        return
    horiz = {_infer_coord_unit_type(coord_x, cellsize_x),
             _infer_coord_unit_type(coord_y, cellsize_y)} - {"unknown"}
    vert = _infer_vertical_unit_type(agg)
    if not horiz or vert == "unknown":
        return
    if "degrees" in horiz and vert == "elevation":
        warnings.warn(
            "input DataArray appears to have coordinates in degrees but "
            "elevation values in a linear unit (e.g. meters/feet). "
            "Slope/aspect operations expect horizontal distances in the same "
            "units as vertical. Consider reprojecting to a projected CRS "
            "with meter-based coordinates.",
            UserWarning,
        )


# -- projection, canvas ---------------------------------------------------------

def lnglat_to_meters(longitude, latitude):
    """Project (longitude, latitude) to Web Mercator meters (numpy)."""
    if isinstance(longitude, (list, tuple)):
        longitude = np.array(longitude)
    if isinstance(latitude, (list, tuple)):
        latitude = np.array(latitude)
    shift = np.pi * 6378137
    easting = longitude * shift / 180.0
    northing = np.log(np.tan((90 + latitude) * np.pi / 360.0)) * shift / np.pi
    return easting, northing


def height_implied_by_aspect_ratio(W: int, X, Y) -> int:
    """Height (pixels) implied by width + x/y ranges at equal aspect."""
    return int(W * (Y[1] - Y[0]) / (X[1] - X[0]))


def canvas_like(raster, width: int = 512, height: Optional[int] = None,
                x_range: Optional[tuple] = None,
                y_range: Optional[tuple] = None, layer=None):
    """Resample a raster onto a canvas grid (nearest neighbor).

    Output pixel centres follow the datashader Canvas convention and each
    samples the nearest input cell; the source indices are found on the
    host (coordinates are 1-D), the gather is two whole-axis
    ``index_select`` calls on the raster's device (a numpy payload: the
    default device).
    """
    if raster.ndim == 3 and layer is not None:
        raster = raster.sel({raster.dims[0]: layer})
    ydim, xdim = raster.dims[-2], raster.dims[-1]
    x_coords = np.asarray(raster[xdim].data, dtype=np.float64)
    y_coords = np.asarray(raster[ydim].data, dtype=np.float64)
    if x_range is None:
        x_range = (float(x_coords.min()), float(x_coords.max()))
    if y_range is None:
        y_range = (float(y_coords.min()), float(y_coords.max()))
    if height is None:
        height = height_implied_by_aspect_ratio(width, x_range, y_range)

    dx = (x_range[1] - x_range[0]) / width
    dy = (y_range[1] - y_range[0]) / height
    out_x = x_range[0] + dx * (np.arange(width) + 0.5)
    out_y = y_range[0] + dy * (np.arange(height) + 0.5)

    xi = np.abs(out_x[None, :] - x_coords[:, None]).argmin(axis=0)
    yi = np.abs(out_y[None, :] - y_coords[:, None]).argmin(axis=0)
    data = to_torch(raster, dtype=None)
    resampled = data.index_select(
        -2, torch.from_numpy(yi).to(data.device)).index_select(
        -1, torch.from_numpy(xi).to(data.device))

    out = DataArray(resampled, name=raster.name,
                    dims=raster.dims, attrs=dict(raster.attrs))
    for cname, cval in raster.coords.items():
        if cname not in (ydim, xdim):
            out.coords[cname] = cval
    out.coords[ydim] = out_y
    out.coords[xdim] = out_x
    out.attrs["res"] = (dx, dy)
    return out


# -- backend predicates ---------------------------------------------------------
# The reference dispatches over numpy, cupy, dask and dask+cupy.  This
# package holds torch tensors (on the card or the CPU) and uses neither
# cupy nor dask, so the predicates say so; code ported from the reference
# may import them.

def has_cuda_and_cupy() -> bool:
    """Always False: the port's card arrays are torch tensors, not cupy."""
    return False


def is_cupy_array(arr) -> bool:
    """Always False (a tensor on the card is a torch.Tensor)."""
    return False


def has_dask_array() -> bool:
    """Always False: no dask."""
    return False


def has_dask_dataframe() -> bool:
    """Always False: no dask."""
    return False


def is_cupy_backed(agg) -> bool:
    """Always False."""
    return False


def is_dask_cupy(agg) -> bool:
    """Always False."""
    return False


def cuda_args(shape):
    """Unavailable: the port's kernels are launched by their wrappers
    (``kernels/cuda_*.py``), each with its own launch geometry."""
    raise NotImplementedError(
        "cuda_args is not applicable to xrspatial_torch: each CUDA kernel's "
        "wrapper chooses its own launch geometry.")


def calc_cuda_dims(shape):
    """Unavailable: see cuda_args."""
    raise NotImplementedError(
        "calc_cuda_dims is not applicable to xrspatial_torch.")


def not_implemented_func(agg, *args, messages='Not yet implemented.'):
    """Raise NotImplementedError."""
    raise NotImplementedError(messages)


# -- image helpers (host numpy) -------------------------------------------------

def bands_to_img(r, g, b, nodata=1):
    """Combine three band rasters into an RGBA uint32 image.

    The reference returns a datashader ``tf.Image``; datashader is not a
    dependency, so the packed RGBA image is a uint32 DataArray holding a
    numpy array (the array such an Image wraps), as in the JAX package.
    Alpha is 0 where the red band is NaN or <= nodata, else 255.
    """
    r, g, b = (_to_numpy(v.data if isinstance(v, DataArray) else v)
               .astype(np.float64) for v in (r, g, b))
    with np.errstate(invalid="ignore"):
        a = np.where(np.logical_or(np.isnan(r), r <= nodata), 0, 255)
        data = (r.astype(np.uint32) & 0xFF) \
            | (g.astype(np.uint32) & 0xFF) << 8 \
            | (b.astype(np.uint32) & 0xFF) << 16 \
            | a.astype(np.uint32) << 24
    return DataArray(data, dims=("y", "x"), name="image")


# a small CSS colour table for color_values (the reference delegates to
# datashader.colors.rgb; these cover its documented examples)
_CSS_COLORS = {
    "black": (0, 0, 0), "white": (255, 255, 255), "red": (255, 0, 0),
    "green": (0, 128, 0), "lime": (0, 255, 0), "blue": (0, 0, 255),
    "yellow": (255, 255, 0), "cyan": (0, 255, 255), "aqua": (0, 255, 255),
    "magenta": (255, 0, 255), "fuchsia": (255, 0, 255),
    "gray": (128, 128, 128), "grey": (128, 128, 128),
    "silver": (192, 192, 192), "maroon": (128, 0, 0),
    "olive": (128, 128, 0), "navy": (0, 0, 128), "teal": (0, 128, 128),
    "purple": (128, 0, 128), "orange": (255, 165, 0),
    "brown": (165, 42, 42), "pink": (255, 192, 203),
}


def _rgb(c):
    """(r, g, b) from a colour name, '#rrggbb' hex string, or 3-tuple."""
    if isinstance(c, (tuple, list)) and len(c) == 3:
        return tuple(int(v) for v in c)
    if isinstance(c, str):
        s = c.strip().lower()
        if s.startswith("#") and len(s) == 7:
            return tuple(int(s[i:i + 2], 16) for i in (1, 3, 5))
        if s in _CSS_COLORS:
            return _CSS_COLORS[s]
    raise ValueError(f"don't know how to convert color {c!r}")


def color_values(agg, color_key, alpha=255):
    """Colour a categorical aggregate by a value->colour mapping: the
    packed RGBA uint32 raster as a DataArray of a numpy array (values
    missing from ``color_key`` map to 0, transparent)."""
    data = _to_numpy(agg.data if isinstance(agg, DataArray) else agg)
    out = np.zeros(data.shape, dtype=np.uint32)
    for val, color in color_key.items():
        r, g, b = _rgb(color)
        packed = np.uint32(r | (g << 8) | (b << 16) | (alpha << 24))
        out = np.where(data == val, packed, out)
    return DataArray(out, dims=("y", "x")[:out.ndim], name="image")
