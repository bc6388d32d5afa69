"""Minimal xarray-compatible data model backed by torch tensors.

Counterpart of ``xrspatial_tpu/xr_compat.py``, method for method.  The
payload ``.data`` may be a ``torch.Tensor`` on any device (or a numpy
array) and is never copied to the host implicitly: only ``.values`` /
``.to_numpy()`` / ``__array__`` / ``item`` copy, and they are explicit
host reads.  Coordinates are small and live on the host as numpy arrays.

On a tensor payload every method runs torch ops on the payload's device:
the reductions return a 0-d or reduced tensor there (the JAX shim reduces
a host copy with numpy's ``nanmin`` ... ``nanvar``); ``nanstd`` and
``nanvar`` use ddof 0, and an all-NaN reduction gives NaN.  A numpy
payload keeps the JAX shim's numpy code.  Positional assignment clones
the tensor before it writes, so no other DataArray sharing it (a shallow
copy, a view) sees the write, as no jax array can be written in place.
One deliberate difference: a DataArray hashes by identity, although
``==`` compares elementwise (the JAX shim makes it unhashable).

The payload may also be a ``parallel.ShardedRaster``, a raster in blocks
over a device mesh, as a JAX shim's may be a sharded ``jax.Array``: the
ops with a mesh branch take it as it is, ``.values`` gathers it to the
host, as ``np.asarray`` gathers a sharded array.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Any, Hashable, Iterator, Optional, Sequence, Union

import numpy as np
import torch

from .parallel.halo import ShardedRaster

__all__ = ["DataArray", "Dataset", "concat"]


def _is_array(obj) -> bool:
    return isinstance(obj, (np.ndarray, torch.Tensor, ShardedRaster))


def _asarray(obj):
    """Coerce to an array without moving a tensor off its device."""
    if _is_array(obj):
        return obj
    if isinstance(obj, DataArray):
        return obj._data
    return np.asarray(obj)


def _to_numpy(obj) -> np.ndarray:
    """Explicit host copy of a payload (a ``ShardedRaster`` is gathered,
    as ``np.asarray`` gathers a sharded ``jax.Array``)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return np.asarray(obj)


def _default_dims(ndim: int) -> tuple:
    return tuple(f"dim_{i}" for i in range(ndim))


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (or type, or name); a torch dtype
    is returned as it is."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def _like(value, ref: torch.Tensor):
    """`value` as an operand of tensor `ref`: a numpy array goes to `ref`'s
    device (an explicit upload); scalars and tensors stay as they are."""
    if isinstance(value, np.ndarray):
        return torch.as_tensor(value, device=ref.device)
    return value


def _pair(a, b):
    """Operands of a binary op: where one is a tensor and the other a numpy
    array, the array goes to the tensor's device."""
    if isinstance(a, torch.Tensor):
        return a, _like(b, a)
    if isinstance(b, torch.Tensor):
        return _like(a, b), b
    return a, b


def _same_values(a, b) -> bool:
    """Equal dtype and values, NaN equal to NaN (``DataArray.equals``)."""
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        if a.dtype != b.dtype:
            return False
        if a.dtype.kind == "f":
            return bool(np.array_equal(a, b, equal_nan=True))
        return bool(np.array_equal(a, b))
    try:
        dtypes = [torch_dtype(getattr(x, "dtype")) for x in (a, b)]
    except TypeError:           # a numpy dtype torch has not (strings)
        return False
    if dtypes[0] != dtypes[1]:
        return False
    ref = a if isinstance(a, torch.Tensor) else b
    a, b = (torch.as_tensor(x, device=ref.device) for x in (a, b))
    if a.is_floating_point():
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


# -- reductions on a tensor payload ------------------------------------------
# torch has no nanmin, nanmax, nanstd or nanvar; these are numpy's, on the
# tensor's device (``dim`` None for all axes, or a tuple of axes)

def _flat(x: torch.Tensor, dim):
    return (x.reshape(-1), (0,)) if dim is None else (x, dim)


def _exact(x: torch.Tensor) -> torch.Tensor:
    """Integers average in float64, as numpy's mean/std/var do."""
    return x if x.is_floating_point() else x.double()


def _nan_extreme(x, dim, reduce, fill):
    x, dim = _flat(x, dim)
    if not x.is_floating_point():
        return reduce(x, dim=dim)
    nan = torch.isnan(x)
    out = reduce(torch.where(nan, fill, x), dim=dim)
    return torch.where(nan.all(dim=dim), math.nan, out)


def nanmin(x: torch.Tensor, dim=None) -> torch.Tensor:
    """The least non-NaN value; all-NaN gives NaN."""
    return _nan_extreme(x, dim, torch.amin, math.inf)


def nanmax(x: torch.Tensor, dim=None) -> torch.Tensor:
    """The greatest non-NaN value; all-NaN gives NaN."""
    return _nan_extreme(x, dim, torch.amax, -math.inf)


def nanvar(x: torch.Tensor, dim=None) -> torch.Tensor:
    """Population variance (ddof 0) of the non-NaN values; all-NaN gives
    NaN."""
    x, dim = _flat(_exact(x), dim)
    valid = ~torch.isnan(x)
    n = valid.sum(dim=dim, keepdim=True)
    mean = torch.nansum(x, dim=dim, keepdim=True) / n
    d = torch.where(valid, x - mean, 0.0)
    return ((d * d).sum(dim=dim, keepdim=True) / n).squeeze(dim)


def _nansum(x, dim):
    return torch.nansum(x, dim=dim) if x.is_floating_point() \
        else x.sum(dim=dim)


# (name, skipna) -> (numpy function, torch function of (tensor, dim))
_REDUCTIONS = {
    ("min", True): (np.nanmin, nanmin),
    ("min", False): (np.min, lambda x, d: torch.amin(x, dim=d)),
    ("max", True): (np.nanmax, nanmax),
    ("max", False): (np.max, lambda x, d: torch.amax(x, dim=d)),
    ("mean", True): (np.nanmean,
                     lambda x, d: torch.nanmean(_exact(x), dim=d)),
    ("mean", False): (np.mean, lambda x, d: _exact(x).mean(dim=d)),
    ("sum", True): (np.nansum, _nansum),
    ("sum", False): (np.sum, lambda x, d: x.sum(dim=d)),
    ("std", True): (np.nanstd, lambda x, d: torch.sqrt(nanvar(x, d))),
    ("std", False): (np.std,
                     lambda x, d: torch.std(_exact(x), dim=d, correction=0)),
    ("var", True): (np.nanvar, nanvar),
    ("var", False): (np.var,
                     lambda x, d: torch.var(_exact(x), dim=d, correction=0)),
}


class Coordinates(Mapping):
    """Ordered mapping of name -> 1-D (or scalar) coordinate DataArray.

    Iteration yields coordinate *names*, matching xarray.
    """

    def __init__(self, coords: Optional[Mapping] = None,
                 dim_order: Sequence[Hashable] = ()):
        self._coords: dict = {}
        self._dim_order = tuple(dim_order)
        if coords is not None:
            items = coords.items() if isinstance(coords, Mapping) else coords
            for k, v in items:
                self[k] = v

    def __getitem__(self, key) -> "DataArray":
        return self._coords[key]

    def __setitem__(self, key, value) -> None:
        if isinstance(value, DataArray):
            arr = value
            if arr.name != key:
                arr = DataArray(arr._data, dims=arr.dims, name=key,
                                attrs=dict(arr.attrs))
                # share the attrs dict so later mutation propagates
                arr._attrs = value._attrs
        elif (isinstance(value, tuple) and len(value) in (2, 3)
              and not _is_array(value)):
            # xarray-style (dims, data[, attrs]) tuple
            dims = (value[0],) if isinstance(value[0], str) else tuple(value[0])
            attrs = dict(value[2]) if len(value) == 3 else {}
            arr = DataArray(_asarray(value[1]), dims=dims, name=key,
                            attrs=attrs)
        else:
            data = _asarray(value)
            dims = (key,) if data.ndim == 1 else _default_dims(data.ndim)
            arr = DataArray(data, dims=dims, name=key)
        self._coords[key] = arr

    def __delitem__(self, key) -> None:
        del self._coords[key]

    def __iter__(self) -> Iterator:
        return iter(self._coords)

    def __len__(self) -> int:
        return len(self._coords)

    def __contains__(self, key) -> bool:
        return key in self._coords

    def keys(self):
        return self._coords.keys()

    def values(self):
        return self._coords.values()

    def items(self):
        return self._coords.items()

    def copy(self) -> "Coordinates":
        new = Coordinates(dim_order=self._dim_order)
        for k, v in self._coords.items():
            new._coords[k] = v.copy(deep=False)
        return new

    def equals(self, other: "Coordinates") -> bool:
        if set(self.keys()) != set(other.keys()):
            return False
        return all(self[k].equals(other[k]) for k in self.keys())

    def __repr__(self) -> str:
        lines = ["Coordinates:"]
        for k, v in self._coords.items():
            lines.append(f"  * {k:<10} ({', '.join(map(str, v.dims))}) "
                         f"{v.dtype}")
        return "\n".join(lines)


class DataArray:
    """N-d labelled array: data + dims + coords + attrs + name.

    The payload is a ``torch.Tensor`` (any device) or a ``numpy.ndarray``;
    all metadata stays on the host.
    """

    __slots__ = ("_data", "_dims", "_coords", "_attrs", "name")

    def __init__(self, data, coords=None, dims=None, name=None, attrs=None):
        if isinstance(data, DataArray):
            coords = data.coords if coords is None else coords
            dims = data.dims if dims is None else dims
            attrs = data.attrs if attrs is None else attrs
            name = data.name if name is None else name
            data = data._data
        if not _is_array(data):
            data = np.asarray(data)
        self._data = data

        if dims is None:
            if (isinstance(coords, Coordinates)
                    and len(coords._dim_order) == data.ndim):
                dims = coords._dim_order
            else:
                dims = _default_dims(data.ndim)
        elif isinstance(dims, str):
            dims = (dims,)
        else:
            dims = tuple(dims)
        if len(dims) != data.ndim:
            raise ValueError(
                f"dims {dims!r} do not match data ndim {data.ndim}")
        self._dims = dims

        self._attrs = dict(attrs or {})
        self.name = name

        self._coords = Coordinates(dim_order=dims)
        if coords is not None:
            if isinstance(coords, Mapping):
                for k, v in coords.items():
                    self._coords[k] = v
            elif isinstance(coords, (list, tuple)):
                # positional list of coordinate arrays, one per dim
                for d, v in zip(dims, coords):
                    self._coords[d] = v
            else:
                raise TypeError(f"unsupported coords type {type(coords)}")

    # -- core properties ---------------------------------------------------
    @property
    def data(self):
        return self._data

    @data.setter
    def data(self, value):
        value = _asarray(value)
        if tuple(value.shape) != self.shape:
            raise ValueError("replacement data must match shape")
        self._data = value

    @property
    def values(self) -> np.ndarray:
        """Host copy of the payload (a device tensor is read back)."""
        return _to_numpy(self._data)

    def to_numpy(self) -> np.ndarray:
        return self.values

    def __array__(self, dtype=None, copy=None):
        arr = _to_numpy(self._data)
        return arr.astype(dtype) if dtype is not None else arr

    @property
    def dims(self) -> tuple:
        return self._dims

    @property
    def coords(self) -> Coordinates:
        return self._coords

    @property
    def attrs(self) -> dict:
        return self._attrs

    @attrs.setter
    def attrs(self, value):
        self._attrs = dict(value or {})

    @property
    def shape(self) -> tuple:
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def ndim(self) -> int:
        return self._data.ndim

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def sizes(self) -> dict:
        return dict(zip(self._dims, self.shape))

    @property
    def chunks(self):
        # no dask beside torch; kept for API compatibility
        return None

    # -- indexing ----------------------------------------------------------
    def __getitem__(self, key):
        if isinstance(key, str):
            if key in self._coords:
                return self._coords[key]
            raise KeyError(key)
        data = self._data[key]
        # best-effort dims/coords propagation for basic slicing
        if not isinstance(key, tuple):
            key = (key,)
        if any(k is Ellipsis for k in key):
            # expand ... into full slices so that positional dim matching
            # stays aligned (d3[..., 0] drops the LAST dim)
            i = key.index(Ellipsis)
            fill = (slice(None),) * (len(self._dims) - (len(key) - 1))
            key = key[:i] + fill + key[i + 1:]
        new_dims = []
        new_coords = {}
        for ki, d in enumerate(self._dims):
            k = key[ki] if ki < len(key) else slice(None)
            if isinstance(k, (int, np.integer)):
                continue
            new_dims.append(d)
            if d in self._coords:
                new_coords[d] = DataArray(
                    self._coords[d]._data[k], dims=(d,), name=d,
                    attrs=dict(self._coords[d].attrs))
        # non-dim coords pass through if all their dims survive
        for cname, cval in self._coords.items():
            if cname in new_coords or cname in self._dims:
                continue
            if all(cd in new_dims for cd in cval.dims):
                new_coords[cname] = cval
        if len(new_dims) != data.ndim:
            return DataArray(data, name=self.name, attrs=dict(self._attrs))
        return DataArray(data, coords=new_coords, dims=new_dims,
                         name=self.name, attrs=dict(self._attrs))

    def __setitem__(self, key, value):
        if isinstance(key, str):
            self._coords[key] = value
            return
        value = _asarray(value)
        if isinstance(self._data, torch.Tensor):
            # clone first: another DataArray may share this tensor
            data = self._data.clone()
            data[key] = _like(value, data)
        else:
            data = np.array(self._data)
            data[key] = _to_numpy(value)
        self._data = data

    def isel(self, indexers: Optional[Mapping] = None, **kw):
        indexers = dict(indexers or {}, **kw)
        return self[tuple(indexers.get(d, slice(None)) for d in self._dims)]

    def sel(self, indexers: Optional[Mapping] = None,
            method: Optional[str] = None, **kw):
        indexers = dict(indexers or {}, **kw)
        out = {}
        for d, target in indexers.items():
            cvals = _to_numpy(self._coords[d]._data)
            if isinstance(target, slice):
                lo, hi = target.start, target.stop
                mask = np.ones(len(cvals), dtype=bool)
                ascending = len(cvals) < 2 or cvals[0] <= cvals[-1]
                if lo is not None:
                    mask &= (cvals >= lo) if ascending else (cvals <= lo)
                if hi is not None:
                    mask &= (cvals <= hi) if ascending else (cvals >= hi)
                idx = np.nonzero(mask)[0]
                out[d] = slice(idx[0], idx[-1] + 1) if len(idx) \
                    else slice(0, 0)
            elif method == "nearest":
                out[d] = int(np.argmin(np.abs(cvals - target)))
            else:
                matches = np.nonzero(cvals == target)[0]
                if len(matches) == 0:
                    raise KeyError(target)
                out[d] = int(matches[0])
        return self.isel(out)

    # -- copies / conversions ----------------------------------------------
    def astype(self, dtype) -> "DataArray":
        """A numpy dtype (or a torch dtype) for a tensor payload."""
        if isinstance(self._data, torch.Tensor):
            return self._replace(self._data.to(torch_dtype(dtype)))
        return self._replace(self._data.astype(dtype))

    def copy(self, deep: bool = True) -> "DataArray":
        data = self._data
        if deep:
            data = data.clone() if isinstance(data, torch.Tensor) else data.copy()
        new = DataArray(data, dims=self._dims, name=self.name,
                        attrs=dict(self._attrs))
        for k, v in self._coords.items():
            new._coords._coords[k] = v.copy(deep=deep) if deep else v
        return new

    def _replace(self, data, name=None) -> "DataArray":
        same_ndim = data.ndim == self.ndim
        new = DataArray(data, dims=self._dims if same_ndim else None,
                        name=self.name if name is None else name,
                        attrs=dict(self._attrs))
        if same_ndim and tuple(data.shape) == self.shape:
            new._coords = self._coords.copy()
        return new

    def item(self):
        """The single value, read to the host."""
        return self._data.item()

    # -- reductions --------------------------------------------------------
    def _reduce(self, name, skipna, dim=None, axis=None, **kw):
        if kw:
            raise TypeError(
                f"unsupported reduction arguments {sorted(kw)}; this "
                "xarray-compat subset accepts dim=, axis=, skipna=")
        if dim is not None and axis is not None:
            raise ValueError("cannot supply both 'dim' and 'axis'")
        if dim is not None:
            dims = [dim] if isinstance(dim, str) else list(dim)
            for d in dims:
                if d not in self._dims:
                    raise ValueError(f"dimension {d!r} not in {self._dims}")
            axis = tuple(self._dims.index(d) for d in dims)
        np_fn, torch_fn = _REDUCTIONS[name, bool(skipna)]
        if isinstance(self._data, torch.Tensor):
            x = self._data
            if axis is None:
                out = torch_fn(x.reshape(-1), (0,))
            else:
                out = torch_fn(x, (axis,) if isinstance(axis, int)
                               else tuple(axis))
        else:
            out = np.asarray(np_fn(self._data) if axis is None
                             else np_fn(self._data, axis=axis))
        if axis is None:
            return DataArray(out, name=self.name, attrs=dict(self._attrs))
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        axes = tuple(a % len(self._dims) for a in axes)
        kept = [d for i, d in enumerate(self._dims) if i not in axes]
        res = DataArray(out, name=self.name, dims=tuple(kept),
                        attrs=dict(self._attrs))
        for d in kept:
            if d in self._coords:
                res._coords[d] = self._coords[d]
        return res

    def min(self, dim=None, axis=None, **kw):
        return self._reduce("min", kw.pop("skipna", True), dim, axis, **kw)

    def max(self, dim=None, axis=None, **kw):
        return self._reduce("max", kw.pop("skipna", True), dim, axis, **kw)

    def mean(self, dim=None, axis=None, **kw):
        return self._reduce("mean", kw.pop("skipna", True), dim, axis, **kw)

    def sum(self, dim=None, axis=None, **kw):
        return self._reduce("sum", kw.pop("skipna", True), dim, axis, **kw)

    def std(self, dim=None, axis=None, **kw):
        return self._reduce("std", kw.pop("skipna", True), dim, axis, **kw)

    def var(self, dim=None, axis=None, **kw):
        return self._reduce("var", kw.pop("skipna", True), dim, axis, **kw)

    # -- arithmetic --------------------------------------------------------
    def _binop(self, other, op, reflexive=False):
        other_data = other._data if isinstance(other, DataArray) else other
        a, b = _pair(self._data, other_data)
        return self._replace_binop(op(b, a) if reflexive else op(a, b))

    def _replace_binop(self, data):
        new = DataArray(data, name=self.name)
        if data.ndim == self.ndim and tuple(data.shape) == self.shape:
            new._dims = self._dims
            new._coords = self._coords.copy()
        return new

    def __add__(self, o):
        return self._binop(o, lambda a, b: a + b)

    def __radd__(self, o):
        return self._binop(o, lambda a, b: a + b, True)

    def __sub__(self, o):
        return self._binop(o, lambda a, b: a - b)

    def __rsub__(self, o):
        return self._binop(o, lambda a, b: a - b, True)

    def __mul__(self, o):
        return self._binop(o, lambda a, b: a * b)

    def __rmul__(self, o):
        return self._binop(o, lambda a, b: a * b, True)

    def __truediv__(self, o):
        return self._binop(o, lambda a, b: a / b)

    def __rtruediv__(self, o):
        return self._binop(o, lambda a, b: a / b, True)

    # no __rpow__, as in the JAX shim: ``2 ** a`` raises TypeError
    def __pow__(self, o):
        return self._binop(o, lambda a, b: a ** b)

    def __neg__(self):
        return self._replace_binop(-self._data)

    def __abs__(self):
        return self._replace_binop(abs(self._data))

    def __lt__(self, o):
        return self._binop(o, lambda a, b: a < b)

    def __le__(self, o):
        return self._binop(o, lambda a, b: a <= b)

    def __gt__(self, o):
        return self._binop(o, lambda a, b: a > b)

    def __ge__(self, o):
        return self._binop(o, lambda a, b: a >= b)

    def __eq__(self, o):  # elementwise, like xarray
        if isinstance(o, (DataArray, int, float, np.generic)) or _is_array(o):
            return self._binop(o, lambda a, b: a == b)
        return NotImplemented

    def __ne__(self, o):
        if isinstance(o, (DataArray, int, float, np.generic)) or _is_array(o):
            return self._binop(o, lambda a, b: a != b)
        return NotImplemented

    # defining __eq__ would leave the class unhashable: hash by identity,
    # so that a DataArray can key a dict or sit in a set
    __hash__ = object.__hash__

    # -- comparison / metadata ---------------------------------------------
    def equals(self, other: "DataArray") -> bool:
        if not isinstance(other, DataArray):
            return False
        if self.dims != other.dims or self.shape != other.shape:
            return False
        if not _same_values(self._data, other._data):
            return False
        return self._coords.equals(other._coords)

    def identical(self, other: "DataArray") -> bool:
        return (self.equals(other) and self.name == other.name
                and dict(self.attrs) == dict(other.attrs))

    def rename(self, name) -> "DataArray":
        new = self.copy(deep=False)
        new.name = name
        return new

    def assign_attrs(self, *args, **kwargs) -> "DataArray":
        new = self.copy(deep=False)
        for mapping in args:
            new._attrs.update(mapping)
        new._attrs.update(kwargs)
        return new

    def assign_coords(self, coords=None, **kwargs) -> "DataArray":
        new = self.copy(deep=False)
        for k, v in dict(coords or {}, **kwargs).items():
            new._coords[k] = v
        return new

    def where(self, cond, other=math.nan) -> "DataArray":
        cond = cond._data if isinstance(cond, DataArray) else cond
        other = other._data if isinstance(other, DataArray) else other
        if isinstance(self._data, torch.Tensor):
            return self._replace(torch.where(_like(cond, self._data),
                                             self._data,
                                             _like(other, self._data)))
        return self._replace(np.where(cond, self._data, other))

    def fillna(self, value) -> "DataArray":
        x = self._data
        if isinstance(x, torch.Tensor):
            return self._replace(torch.where(torch.isnan(x), value, x))
        return self._replace(np.where(np.isnan(x), value, x))

    def expand_dims(self, dim, axis=0) -> "DataArray":
        if isinstance(self._data, torch.Tensor):
            data = self._data.unsqueeze(axis)
        else:
            data = np.expand_dims(self._data, axis)
        dims = list(self._dims)
        dims.insert(axis, dim)
        new = DataArray(data, dims=dims, name=self.name,
                        attrs=dict(self._attrs))
        for k, v in self._coords.items():
            new._coords[k] = v
        return new

    def to_dataset(self, name=None) -> "Dataset":
        vname = name if name is not None else self.name
        if vname is None:
            raise ValueError("unable to convert unnamed DataArray to Dataset")
        ds = Dataset()
        ds[vname] = self
        return ds

    def drop_vars(self, names) -> "DataArray":
        if isinstance(names, str):
            names = [names]
        new = self.copy(deep=False)
        for n in names:
            if n in new._coords:
                del new._coords[n]
        return new

    def __repr__(self) -> str:
        shape = ", ".join(f"{d}: {s}" for d, s in zip(self._dims, self.shape))
        if isinstance(self._data, ShardedRaster):
            mesh = self._data.mesh.shape
            device = f"a {mesh['y']}x{mesh['x']} mesh"
        else:
            device = getattr(self._data, "device", "host")
        return (f"<torch.DataArray {self.name!r} ({shape}) {self.dtype} "
                f"on {device}>")


class Dataset:
    """Mapping of variable name -> DataArray with shared attrs."""

    def __init__(self, data_vars: Optional[Mapping] = None, coords=None,
                 attrs: Optional[Mapping] = None):
        self._variables: dict = {}
        self._attrs = dict(attrs or {})
        self._coords = Coordinates()
        if coords is not None:
            items = coords.items() if isinstance(coords, Mapping) else coords
            for k, v in items:
                self._coords[k] = v
        for k, v in (data_vars or {}).items():
            self[k] = v

    @property
    def data_vars(self) -> dict:
        return self._variables

    @property
    def attrs(self) -> dict:
        return self._attrs

    @attrs.setter
    def attrs(self, value):
        self._attrs = dict(value or {})

    @property
    def coords(self) -> Coordinates:
        return self._coords

    @property
    def dims(self) -> dict:
        out: dict = {}
        for v in self._variables.values():
            out.update(zip(v.dims, v.shape))
        return out

    def __getitem__(self, key) -> DataArray:
        if key in self._variables:
            return self._variables[key]
        if key in self._coords:
            return self._coords[key]
        raise KeyError(key)

    def __setitem__(self, key, value) -> None:
        if isinstance(value, tuple) and not _is_array(value[0]):
            # (dims, data) tuple form
            dims = (value[0],) if isinstance(value[0], str) else tuple(value[0])
            value = DataArray(_asarray(value[1]), dims=dims, name=key)
        if not isinstance(value, DataArray):
            value = DataArray(_asarray(value), name=key)
        arr = DataArray(value._data, dims=value.dims, name=key,
                        attrs=dict(value.attrs))
        for k, v in value.coords.items():
            arr._coords._coords[k] = v
            if k not in self._coords:
                self._coords._coords[k] = v
        self._variables[key] = arr

    def __delitem__(self, key) -> None:
        del self._variables[key]

    def __contains__(self, key) -> bool:
        return key in self._variables

    def __iter__(self):
        return iter(self._variables)

    def __len__(self):
        return len(self._variables)

    def keys(self):
        return self._variables.keys()

    def values(self):
        return self._variables.values()

    def items(self):
        return self._variables.items()

    def copy(self, deep: bool = True) -> "Dataset":
        new = Dataset(attrs=dict(self._attrs))
        for k, v in self._variables.items():
            new._variables[k] = v.copy(deep=deep)
        new._coords = self._coords.copy()
        return new

    def rename(self, mapping: Mapping) -> "Dataset":
        new = Dataset(attrs=dict(self._attrs))
        for k, v in self._variables.items():
            nk = mapping.get(k, k)
            new._variables[nk] = v.rename(nk)
        new._coords = self._coords.copy()
        return new

    def merge(self, other: "Dataset") -> "Dataset":
        new = self.copy(deep=False)
        for k, v in other.items():
            new[k] = v
        return new

    def equals(self, other: "Dataset") -> bool:
        if set(self.keys()) != set(other.keys()):
            return False
        return all(self[k].equals(other[k]) for k in self.keys())

    def __repr__(self) -> str:
        lines = ["<torch.Dataset>", f"Dimensions: {self.dims}"]
        for k, v in self._variables.items():
            lines.append(f"  {k:<12} ({', '.join(map(str, v.dims))}) "
                         f"{v.dtype}")
        if self._attrs:
            lines.append(f"Attributes: {dict(self._attrs)}")
        return "\n".join(lines)


def concat(arrays: Sequence[DataArray], dim: Union[str, Any]) -> DataArray:
    """Concatenate DataArrays along a (possibly new) dimension.

    ``concat(stats_aggs, dim='stats')`` stacks 2-D inputs under a new
    leading dim.  Tensor payloads join on the first tensor's device (a
    numpy payload among them is uploaded there); numpy payloads alone stay
    numpy.
    """
    if not arrays:
        raise ValueError("need at least one array")
    first = arrays[0]
    dim_name = dim if isinstance(dim, str) else dim.name
    datas = [a._data for a in arrays]
    ref = next((d for d in datas if isinstance(d, torch.Tensor)), None)
    if ref is not None:
        datas = [_like(d, ref) for d in datas]
        join, stack = torch.cat, torch.stack
    else:
        join, stack = np.concatenate, np.stack

    if dim_name in first.dims:
        axis = first.dims.index(dim_name)
        out = DataArray(join(datas, axis), dims=first.dims, name=first.name,
                        attrs=dict(first.attrs))
        for k, v in first.coords.items():
            if dim_name not in v.dims:
                out._coords[k] = v
        # the concat-dim coordinate concatenates too (xarray semantics)
        if all(dim_name in a.coords for a in arrays):
            cvals = np.concatenate(
                [_to_numpy(a.coords[dim_name]._data) for a in arrays])
            out._coords[dim_name] = DataArray(
                cvals, dims=(dim_name,), name=dim_name,
                attrs=dict(first.coords[dim_name].attrs))
        return out

    out = DataArray(stack(datas, 0), dims=(dim_name,) + first.dims,
                    name=first.name, attrs=dict(first.attrs))
    for k, v in first.coords.items():
        out._coords[k] = v
    names = [a.name for a in arrays]
    if all(n is not None for n in names):
        out._coords[dim_name] = DataArray(np.asarray(names), dims=(dim_name,),
                                          name=dim_name)
    if not isinstance(dim, str) and isinstance(dim, DataArray):
        out._coords[dim_name] = dim
    return out
