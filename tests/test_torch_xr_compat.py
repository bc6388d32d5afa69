"""The port's DataArray shim refuses what it has not ported, and the port
exports every public name of the JAX package that it has ported.

Python would answer ``DataArray == 0`` by identity, a silent wrong answer
where xarray compares elementwise; until ROADMAP A5 ports them, every
comparison, ``**``, ``abs`` and the listed methods raise
``NotImplementedError`` naming A5, and a DataArray hashes by identity.
"""

import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import xrspatial_torch as xt
import xrspatial_tpu


def dataarray():
    return xt.DataArray(torch.zeros(2, 3), dims=("y", "x"),
                        coords={"x": np.arange(3.0)}, name="z")


UNPORTED = {
    "eq": lambda a: a == 0, "ne": lambda a: a != 0, "lt": lambda a: a < 0,
    "le": lambda a: a <= 0, "gt": lambda a: a > 0, "ge": lambda a: a >= 0,
    "eq_reflected": lambda a: 0 == a, "lt_reflected": lambda a: 0 < a,
    "eq_dataarray": lambda a: a == dataarray(),
    "pow": lambda a: a ** 2, "rpow": lambda a: 2 ** a, "abs": abs,
    "item": lambda a: a.item(), "equals": lambda a: a.equals(a),
    "identical": lambda a: a.identical(a),
    "assign_attrs": lambda a: a.assign_attrs(units="m"),
    "assign_coords": lambda a: a.assign_coords(x=np.arange(3.0)),
    "expand_dims": lambda a: a.expand_dims("band"),
    "drop_vars": lambda a: a.drop_vars("x"),
    "chunks": lambda a: a.chunks,
}


@pytest.mark.parametrize("call", list(UNPORTED.values()), ids=list(UNPORTED))
def test_unported_method_raises_naming_a5(call):
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        call(dataarray())


def test_dataarray_hashes_by_identity():
    a, b = dataarray(), dataarray()
    assert hash(a) == hash(a) and hash(a) != hash(b)
    assert {a: 1, b: 2}[a] == 1
    # identity comparisons never reach __eq__
    assert a is not b and [a, b].index(a) == 0 and a in [a]


def test_dataset_lookups_do_not_compare_dataarrays():
    ds = dataarray().to_dataset()
    assert "z" in ds and "x" in ds.coords and list(ds) == ["z"]
    assert ds["z"].dims == ("y", "x") and ds.dims == {"y": 2, "x": 3}


def test_hasattr_chunks_raises_instead_of_answering():
    """hasattr only swallows AttributeError: a caller probing for dask
    chunks learns that the shim has not ported them."""
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        hasattr(dataarray(), "chunks")


DISTANCES = ["euclidean_distance", "manhattan_distance",
             "great_circle_distance"]


@pytest.mark.parametrize("name", DISTANCES)
def test_distance_functions_are_exported(name):
    args = (10.0, 12.5, 40.0, 41.0)
    assert name in xt.__all__
    assert getattr(xt, name)(*args) == getattr(xrspatial_tpu, name)(*args)


def _port_definitions() -> set:
    """Names of the functions and classes the modules of xrspatial_torch
    define (not the ones they import)."""
    names = set()
    for info in pkgutil.walk_packages(xt.__path__, "xrspatial_torch."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if (inspect.isfunction(obj) or inspect.isclass(obj)) \
                    and obj.__module__ == mod.__name__:
                names.add(name)
    return names


def test_every_ported_public_name_of_the_jax_package_is_exported():
    public = {name for name, obj in vars(xrspatial_tpu).items()
              if not name.startswith("_")
              and (inspect.isfunction(obj) or inspect.isclass(obj))}
    ported = public & _port_definitions()
    assert {"slope", "proximity", "viewshed", "DataArray", "concat",
            *DISTANCES} <= ported
    missing = sorted(n for n in ported if not hasattr(xt, n))
    assert not missing, f"ported but not exported: {missing}"
    for name in ported:
        assert name in xt.__all__, name
