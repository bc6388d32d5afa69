"""Minimal xarray-compatible data model backed by torch tensors.

Counterpart of ``xrspatial_tpu/xr_compat.py``.  The payload ``.data`` may
be a ``torch.Tensor`` on any device (or a numpy array) and is never copied
to the host implicitly: only ``.values`` / ``.to_numpy()`` / ``__array__``
copy, and they are explicit host reads.  Coordinates are small and live on
the host as numpy arrays.

Ported so far: construction, ``data``, ``values``/``to_numpy``, dims,
coords, attrs, name, shape/ndim/dtype/size/sizes, coordinate get/set,
``rename``, ``to_dataset``, ``copy``, and the Dataset mapping.  Slicing,
``sel``/``isel``, reductions, arithmetic, comparisons, ``**``, ``abs``,
``where``, ``item``, ``equals``/``identical``, ``assign_attrs``/
``assign_coords``, ``expand_dims``, ``drop_vars``, ``chunks`` and
``concat`` raise ``NotImplementedError`` until ROADMAP item A5.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Hashable, Iterator, Optional, Sequence

import numpy as np
import torch

__all__ = ["DataArray", "Dataset", "concat"]

_LATER = "ROADMAP A5"


def _is_array(obj) -> bool:
    return isinstance(obj, (np.ndarray, torch.Tensor))


def _asarray(obj):
    """Coerce to an array without moving a tensor off its device."""
    if _is_array(obj):
        return obj
    if isinstance(obj, DataArray):
        return obj._data
    return np.asarray(obj)


def _to_numpy(obj) -> np.ndarray:
    """Explicit host copy of a payload."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return np.asarray(obj)


def _default_dims(ndim: int) -> tuple:
    return tuple(f"dim_{i}" for i in range(ndim))


def _not_ported(what: str):
    def method(self, *args, **kwargs):
        raise NotImplementedError(
            f"DataArray.{what} is not ported to xrspatial_torch yet "
            f"({_LATER})")
    method.__name__ = what
    return method


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

    def copy(self) -> "Coordinates":
        new = Coordinates(dim_order=self._dim_order)
        for k, v in self._coords.items():
            new._coords[k] = v.copy(deep=False)
        return new

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

    # -- coordinates by name -----------------------------------------------
    def __getitem__(self, key):
        if not isinstance(key, str):
            raise NotImplementedError(
                f"positional indexing is not ported to xrspatial_torch yet "
                f"({_LATER})")
        if key in self._coords:
            return self._coords[key]
        raise KeyError(key)

    def __setitem__(self, key, value):
        if not isinstance(key, str):
            raise NotImplementedError(
                f"positional assignment is not ported to xrspatial_torch "
                f"yet ({_LATER})")
        self._coords[key] = value

    # -- copies / conversions ----------------------------------------------
    def copy(self, deep: bool = True) -> "DataArray":
        data = self._data
        if deep:
            data = data.clone() if isinstance(data, torch.Tensor) else data.copy()
        new = DataArray(data, dims=self._dims, name=self.name,
                        attrs=dict(self._attrs))
        for k, v in self._coords.items():
            new._coords._coords[k] = v.copy(deep=deep) if deep else v
        return new

    def rename(self, name) -> "DataArray":
        new = self.copy(deep=False)
        new.name = name
        return new

    def to_dataset(self, name=None) -> "Dataset":
        vname = name if name is not None else self.name
        if vname is None:
            raise ValueError("unable to convert unnamed DataArray to Dataset")
        ds = Dataset()
        ds[vname] = self
        return ds

    isel = _not_ported("isel")
    sel = _not_ported("sel")
    astype = _not_ported("astype")
    where = _not_ported("where")
    fillna = _not_ported("fillna")
    min = _not_ported("min")
    max = _not_ported("max")
    mean = _not_ported("mean")
    sum = _not_ported("sum")
    std = _not_ported("std")
    var = _not_ported("var")
    __add__ = __radd__ = _not_ported("__add__")
    __sub__ = __rsub__ = _not_ported("__sub__")
    __mul__ = __rmul__ = _not_ported("__mul__")
    __truediv__ = __rtruediv__ = _not_ported("__truediv__")
    __neg__ = _not_ported("__neg__")
    __pow__ = __rpow__ = _not_ported("__pow__")
    __abs__ = _not_ported("__abs__")
    # xarray compares elementwise; Python's default would compare identity
    # and answer a bool, so the comparisons raise until A5 ports them
    __eq__ = _not_ported("__eq__")
    __ne__ = _not_ported("__ne__")
    __lt__ = _not_ported("__lt__")
    __le__ = _not_ported("__le__")
    __gt__ = _not_ported("__gt__")
    __ge__ = _not_ported("__ge__")
    item = _not_ported("item")
    equals = _not_ported("equals")
    identical = _not_ported("identical")
    assign_attrs = _not_ported("assign_attrs")
    assign_coords = _not_ported("assign_coords")
    expand_dims = _not_ported("expand_dims")
    drop_vars = _not_ported("drop_vars")

    @property
    def chunks(self):
        _not_ported("chunks")(self)

    # defining __eq__ would leave the class unhashable: keep hashing by
    # identity until A5 brings the elementwise comparisons
    __hash__ = object.__hash__

    def __repr__(self) -> str:
        shape = ", ".join(f"{d}: {s}" for d, s in zip(self._dims, self.shape))
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

    def __repr__(self) -> str:
        lines = ["<torch.Dataset>", f"Dimensions: {self.dims}"]
        for k, v in self._variables.items():
            lines.append(f"  {k:<12} ({', '.join(map(str, v.dims))}) "
                         f"{v.dtype}")
        if self._attrs:
            lines.append(f"Attributes: {dict(self._attrs)}")
        return "\n".join(lines)


def concat(arrays, dim):
    raise NotImplementedError(
        f"concat is not ported to xrspatial_torch yet ({_LATER})")
