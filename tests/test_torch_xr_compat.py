"""The port's DataArray shim against the JAX package's, method for
method, and the port exports every public name of the JAX package that it
has ported.

Each method runs on both shims on the same values (the port's payload a
tensor, the JAX shim's a jax array): equal dims, coords, name, attrs and
values, NaN equal to NaN; reductions within rtol 1e-6 of the JAX shim's
numpy ``nan*`` reductions, and arithmetic within rtol 1e-6 (XLA's CPU
code fuses a product and a sum into one multiply-add).  The JAX shim's
``astype(np.float64)`` gives float32 where jax runs without x64; the
port's gives float64.  The port's reductions, arithmetic,
comparisons and the other methods stay on the payload's device and never
read it to the host.  Two deliberate differences are pinned: positional
assignment clones the tensor before it writes, and a DataArray hashes by
identity although ``==`` compares elementwise (the JAX shim makes it
unhashable).
"""

import importlib
import inspect
import math
import pkgutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xrspatial_torch as xt
import xrspatial_tpu
from xrspatial_tpu import xr_compat as jxr

VALUES = np.array([[-2.0, -1.0, 0.0], [1.0, 2.0, np.nan]], np.float32)
RTOL = 1e-6


def dataarray():
    return xt.DataArray(torch.from_numpy(VALUES.copy()), dims=("y", "x"),
                        coords={"x": np.arange(3.0)}, name="z")


def jax_dataarray():
    return jxr.DataArray(jnp.asarray(VALUES), dims=("y", "x"),
                         coords={"x": np.arange(3.0)}, name="z")


def host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(j, t, rtol=0.0):
    """The JAX shim's result `j` and the port's `t` agree: DataArrays in
    dims, name, attrs, coords and values (dtype kind and NaN mask
    included), anything else by ==."""
    if isinstance(j, jxr.DataArray):
        assert isinstance(t, xt.DataArray), type(t)
        assert t.dims == j.dims and t.name == j.name
        assert dict(t.attrs) == dict(j.attrs)
        assert list(t.coords) == list(j.coords)
        for k in j.coords:
            assert t.coords[k].dims == j.coords[k].dims
            np.testing.assert_array_equal(host(t.coords[k].data),
                                          np.asarray(j.coords[k].data))
        jv, tv = np.asarray(j.data), host(t.data)
        assert tv.dtype.kind == jv.dtype.kind, (tv.dtype, jv.dtype)
        assert tv.shape == jv.shape
        np.testing.assert_allclose(tv, jv, rtol=rtol, atol=0,
                                   equal_nan=True)
    else:
        assert t == j, (t, j)


CALLS = {
    "eq": lambda a: a == 0, "ne": lambda a: a != 0, "lt": lambda a: a < 0,
    "le": lambda a: a <= 0, "gt": lambda a: a > 0, "ge": lambda a: a >= 0,
    "eq_reflected": lambda a: 0 == a, "lt_reflected": lambda a: 0 < a,
    "eq_dataarray": lambda a: a == a.copy(),
    "pow": lambda a: a ** 2, "rpow": lambda a: 2 ** a, "abs": abs,
    "item": lambda a: a[1, 1].item(), "equals": lambda a: a.equals(a),
    "identical": lambda a: a.identical(a),
    "assign_attrs": lambda a: a.assign_attrs(units="m"),
    "assign_coords": lambda a: a.assign_coords(x=np.arange(3.0) + 1),
    "expand_dims": lambda a: a.expand_dims("band"),
    "drop_vars": lambda a: a.drop_vars("x"),
    "chunks": lambda a: a.chunks,
}


@pytest.mark.parametrize("call", list(CALLS.values()), ids=list(CALLS))
def test_unported_method_raises_naming_a5(call):
    """Named for what it held before ROADMAP A5 ported these methods; it
    now holds each to the JAX shim's result.  ``2 ** a`` raises TypeError
    in both: neither shim has ``__rpow__``."""
    try:
        expected = call(jax_dataarray())
    except TypeError:
        with pytest.raises(TypeError):
            call(dataarray())
        return
    assert_same(expected, call(dataarray()))


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
    """Named for what it held before ROADMAP A5: the shims have no dask,
    so ``chunks`` is None in both and ``hasattr`` answers True."""
    assert hasattr(dataarray(), "chunks") and hasattr(jax_dataarray(),
                                                      "chunks")
    assert dataarray().chunks is None and jax_dataarray().chunks is None


# -- reductions ---------------------------------------------------------------

CUBE = np.random.default_rng(3).random((3, 5, 6)).astype(np.float32) * 100
CUBE[0, 1:3, 2:4] = np.nan
CUBE[:, 4, 5] = np.nan                       # an all-NaN column along dim t
REDUCTIONS = ("min", "max", "mean", "sum", "std", "var")


def cubes():
    dims = ("t", "y", "x")
    coords = {"x": np.arange(6.0), "y": np.arange(5.0) * 2}
    return (jxr.DataArray(jnp.asarray(CUBE), dims=dims, coords=coords,
                          name="c", attrs={"units": "m"}),
            xt.DataArray(torch.from_numpy(CUBE.copy()), dims=dims,
                         coords=coords, name="c", attrs={"units": "m"}))


@pytest.mark.parametrize("skipna", [True, False])
@pytest.mark.parametrize("kw", [{}, {"dim": "t"}, {"dim": ("y", "x")},
                                {"axis": 1}, {"axis": (0, 2)}],
                         ids=["all", "t", "yx", "axis1", "axes02"])
@pytest.mark.parametrize("name", REDUCTIONS)
def test_reductions_match_the_jax_shim(name, kw, skipna):
    j, t = cubes()
    expected = getattr(j, name)(skipna=skipna, **kw)
    got = getattr(t, name)(skipna=skipna, **kw)
    assert isinstance(got.data, torch.Tensor)
    assert got.data.dtype == torch.float32
    assert_same(expected, got, rtol=RTOL)


@pytest.mark.parametrize("name", REDUCTIONS)
def test_all_nan_reductions(name):
    """numpy's nan-reductions of an all-NaN array: NaN, except nansum 0;
    the port's result is a 0-d tensor on the payload's device."""
    a = xt.DataArray(torch.full((2, 3), math.nan))
    got = getattr(a, name)().data
    assert isinstance(got, torch.Tensor) and got.shape == ()
    expected = getattr(jxr.DataArray(np.full((2, 3), np.nan, np.float32)),
                       name)().data
    np.testing.assert_array_equal(got.numpy(), expected)
    assert (got.item() == 0.0) if name == "sum" else math.isnan(got.item())


def test_integer_reductions_follow_numpy():
    data = np.arange(12, dtype=np.int32).reshape(3, 4)
    j, t = jxr.DataArray(data), xt.DataArray(torch.from_numpy(data))
    for name in REDUCTIONS:
        expected, got = getattr(j, name)(), getattr(t, name)()
        assert_same(expected, got, rtol=RTOL)
        assert got.dtype == xt.xr_compat.torch_dtype(np.asarray(
            expected.data).dtype), name


def test_reduction_argument_errors():
    _, t = cubes()
    with pytest.raises(ValueError, match="both"):
        t.mean(dim="t", axis=0)
    with pytest.raises(ValueError, match="not in"):
        t.mean(dim="band")
    with pytest.raises(TypeError, match="unsupported"):
        t.mean(keepdims=True)


# -- indexing, assignment, conversions -------------------------------------------

def grids():
    data = np.arange(20, dtype=np.float32).reshape(4, 5)
    coords = {"y": np.array([40.0, 30.0, 20.0, 10.0]),
              "x": np.array([1.0, 2.0, 3.0, 4.0, 5.0])}
    kw = dict(dims=("y", "x"), coords=coords, name="g", attrs={"res": 10})
    return (jxr.DataArray(jnp.asarray(data), **kw),
            xt.DataArray(torch.from_numpy(data.copy()), **kw))


SELECTIONS = {
    "index_row": lambda a: a[1], "index_slice": lambda a: a[1:3, ::2],
    "index_ellipsis": lambda a: a[..., 0], "index_pair": lambda a: a[2, 3],
    "isel": lambda a: a.isel(x=slice(1, 4), y=0),
    "sel_value": lambda a: a.sel(y=30.0),
    "sel_nearest": lambda a: a.sel(x=2.6, y=12.0, method="nearest"),
    "sel_descending_slice": lambda a: a.sel(y=slice(35.0, 15.0)),
    "sel_ascending_slice": lambda a: a.sel(x=slice(2.0, 4.5)),
    "sel_empty": lambda a: a.sel(x=slice(9.0, 10.0)),
    "astype_float64": lambda a: a.astype(np.float64),
    "astype_int32": lambda a: a.astype("int32"),
    "astype_bool": lambda a: a.astype(bool),
    "where_scalar": lambda a: a.where(a > 6),
    "where_other": lambda a: a.where(a > 6, -1.0),
    "where_dataarray": lambda a: a.where(a < 10, a * 2),
    "fillna": lambda a: (a / (a - 7)).fillna(99.0),
    "neg_sub_div": lambda a: (1 - a) / 4 - -a,
    "radd_rmul_rtruediv": lambda a: 3 + 2 * a + 12 / (a + 1),
    "add_dataarray": lambda a: a + a[0:4],
    "expand_dims_axis1": lambda a: a.expand_dims("band", axis=1),
    "rename": lambda a: a.rename("h"),
    "drop_missing": lambda a: a.drop_vars(["x", "none"]),
    "equals_other_values": lambda a: a.equals(a + 1),
    "equals_other_coords": lambda a: a.equals(
        a.assign_coords(x=np.arange(5.0))),
    "equals_other_dtype": lambda a: a.equals(a.astype(np.int32)),
    "identical_other_name": lambda a: a.identical(a.rename("h")),
    "item_sum": lambda a: a.sum().item(),
}


@pytest.mark.parametrize("call", list(SELECTIONS.values()),
                         ids=list(SELECTIONS))
def test_methods_match_the_jax_shim(call):
    """rtol 1e-6: XLA's CPU code contracts a product and a sum into one
    fused multiply-add, where torch rounds each op."""
    j, t = grids()
    assert_same(call(j), call(t), rtol=RTOL)


def test_sel_missing_value_raises_key_error():
    for a in grids():
        with pytest.raises(KeyError):
            a.sel(y=25.0)


def test_positional_assignment_clones_first():
    """A write goes to a fresh tensor: a DataArray sharing the old one
    (a shallow copy, a view taken before) is unchanged."""
    j, t = grids()
    old = t.data
    shallow = t.copy(deep=False)
    row = t[1]
    t[1, 2] = -5.0
    j[1, 2] = -5.0
    assert t.data is not old and t.data.device == old.device
    assert shallow.data is old and float(old[1, 2]) == 7.0
    assert float(row.data[2]) == 7.0
    assert_same(j, t)
    t[0] = xt.DataArray(torch.arange(5.0))
    j[0] = np.arange(5.0)
    assert_same(j, t)


def test_astype_maps_numpy_dtypes_to_torch():
    _, t = grids()
    for np_dtype, torch_dtype in ((np.float64, torch.float64),
                                  ("float16", torch.float16),
                                  (np.int64, torch.int64),
                                  (np.uint8, torch.uint8), (bool, torch.bool),
                                  (torch.int16, torch.int16)):
        out = t.astype(np_dtype)
        assert out.dtype == torch_dtype and out.dims == t.dims
        assert list(out.coords) == ["y", "x"]


def test_numpy_payload_keeps_the_jax_shims_numpy_code():
    data = np.arange(6.0).reshape(2, 3)
    t = xt.DataArray(data, dims=("y", "x"))
    for out in ((t + 1).data, t.mean().data, t.where(t > 2).data,
                t[0].data, t.expand_dims("b").data):
        assert isinstance(out, np.ndarray)
    t[0, 0] = 7.0
    assert isinstance(t.data, np.ndarray) and data[0, 0] == 0.0


def test_tensor_methods_never_read_the_payload_to_the_host(monkeypatch):
    """Every method but ``item``, ``equals``/``identical`` (which answer a
    Python value) and the explicit host reads keeps a tensor payload a
    tensor and never copies it to the host."""
    j, t = grids()

    def refuse(*args, **kwargs):
        raise AssertionError("implicit host copy")

    for name in ("numpy", "cpu", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    outs = [t + 1, t == 3, abs(-t), t ** 2, t.min(), t.std(dim="x"),
            t.var(skipna=False), t.sel(x=slice(2.0, 4.0)), t[1:3],
            t.where(t > 3), t.fillna(0.0), t.astype(np.float64),
            t.expand_dims("b"), xt.concat([t, t], dim="t")]
    assert all(isinstance(o.data, torch.Tensor) for o in outs)
    assert t.equals(t.copy()) and not t.equals(t + 1)


# -- Coordinates, Dataset, concat -----------------------------------------------

def test_coordinates_mapping_and_equals():
    j, t = grids()
    assert list(t.coords.keys()) == list(j.coords.keys())
    assert [v.name for v in t.coords.values()] == ["y", "x"]
    assert [k for k, _ in t.coords.items()] == ["y", "x"]
    assert t.coords.equals(t.copy().coords)
    assert not t.coords.equals(t.assign_coords(x=np.arange(5.0)).coords)
    assert not t.coords.equals(t.drop_vars("x").coords)


def datasets(pkg_dataarray, to_payload):
    rng = np.random.default_rng(4)
    a, b = (rng.random((3, 4)).astype(np.float32) for _ in range(2))
    a[0, 0] = np.nan
    kw = dict(dims=("y", "x"), coords={"x": np.arange(4.0)})
    return {"a": pkg_dataarray(to_payload(a), **kw),
            "b": pkg_dataarray(to_payload(b), **kw)}


def test_dataset_rename_merge_equals_match_the_jax_shim():
    jv = datasets(jxr.DataArray, jnp.asarray)
    tv = datasets(xt.DataArray, torch.from_numpy)
    jd, td = jxr.Dataset({"a": jv["a"]}), xt.Dataset({"a": tv["a"]})
    jm = jd.merge(jxr.Dataset({"b": jv["b"]})).rename({"a": "c"})
    tm = td.merge(xt.Dataset({"b": tv["b"]})).rename({"a": "c"})
    assert list(tm) == list(jm) == ["c", "b"]
    for k in jm:
        assert_same(jm[k], tm[k])
    assert tm.equals(tm.copy()) and not tm.equals(td)
    other = tm.copy()
    other["b"] = tv["a"]
    assert not tm.equals(other) and jm.equals(jm.copy())


@pytest.mark.parametrize("dim", ["y", "x", "band"])
def test_concat_matches_the_jax_shim(dim):
    jv = datasets(jxr.DataArray, jnp.asarray)
    tv = datasets(xt.DataArray, torch.from_numpy)
    names = {"band": None}
    for d in (jv, tv):
        for k, v in d.items():
            v.name = names.get(dim, k)
    assert_same(jxr.concat([jv["a"], jv["b"]], dim),
                xt.concat([tv["a"], tv["b"]], dim))


def test_concat_of_named_arrays_labels_the_new_dim():
    jv = datasets(jxr.DataArray, jnp.asarray)
    tv = datasets(xt.DataArray, torch.from_numpy)
    for d in (jv, tv):
        for k, v in d.items():
            v.name = k
    j = jxr.concat([jv["a"], jv["b"]], "stats")
    t = xt.concat([tv["a"], tv["b"]], "stats")
    assert_same(j, t)
    assert list(t.coords["stats"].data) == ["a", "b"]
    mixed = xt.concat([tv["a"], xt.DataArray(np.zeros((3, 4), np.float32),
                                              dims=("y", "x"))], "t")
    assert isinstance(mixed.data, torch.Tensor)
    with pytest.raises(ValueError, match="at least one"):
        xt.concat([], "t")


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
    # the JAX package exports zonal's functions under other names
    # (zonal_stats for zonal.stats, ...): a name whose function the port
    # defines under the function's own name counts as ported too
    port_modules = {mod.__name__.removeprefix("xrspatial_torch.")
                    for mod in map(importlib.import_module, (
                        info.name for info in pkgutil.walk_packages(
                            xt.__path__, "xrspatial_torch.")))}
    aliases = {name for name in public - ported
               if getattr(vars(xrspatial_tpu)[name], "__module__", "")
               .removeprefix("xrspatial_tpu.") in port_modules
               and vars(xrspatial_tpu)[name].__name__ in _port_definitions()}
    assert {"zonal_stats", "zonal_crosstab", "zonal_apply"} <= aliases
    ported |= aliases
    # functions the package root itself defines (test)
    ported |= {name for name in public
               if getattr(getattr(xt, name, None), "__module__", "")
               == xt.__name__}
    assert {"crop", "regions", "suggest_zonal_canvas", "trim", "bump",
            "perlin", "generate_terrain", "a_star_search", "diagnose",
            "test"} <= ported
    # no public name of the JAX package is left unported
    assert not sorted(public - ported), sorted(public - ported)
    missing = sorted(n for n in ported if not hasattr(xt, n))
    assert not missing, f"ported but not exported: {missing}"
    for name in ported:
        # test() runs the suite: kept out of __all__, where a star import
        # into a test module would have pytest collect it
        assert (name in xt.__all__) == (name != "test"), name
        # the JAX package's signature, argument for argument
        if inspect.isfunction(getattr(xt, name)):
            assert inspect.signature(getattr(xt, name)).parameters.keys() \
                == inspect.signature(getattr(xrspatial_tpu, name)) \
                .parameters.keys(), name
