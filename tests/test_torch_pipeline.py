"""The torch port's slice as a whole against the JAX package (CPU).

``terrain_pipeline`` and ``summarize_terrain`` on one numpy DEM through
both packages: the same variables, dims, coords, attrs and values (surface
products at rtol 1e-4 / atol 5e-5, focal stats at rtol 1e-5 / atol 1e-5,
NaN masks equal).  The fused branch (``XRSPATIAL_FUSED_PIPELINE=1``) is
held to the JAX package's fused kernel ``pipeline_tiled``, run in
interpret mode, at the same tolerances.  Also the data model the slice
rests on, and the rule that the port never imports jax or the JAX package.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import xrspatial_torch as xt
import xrspatial_tpu.analytics as janalytics
from xrspatial_torch.convolution import circle_kernel
from xrspatial_torch.kernels import pipeline as tpipeline
from xrspatial_torch.kernels.window import kernel_offsets
from xrspatial_torch.utils import dataarray_from, to_torch
from xrspatial_tpu import xr_compat as jxr_compat
from xrspatial_tpu.xrlib import DataArray as JaxDataArray


@pytest.fixture(autouse=True)
def numpy_rasters_on_the_cpu():
    """These tests give numpy rasters and compare on the CPU."""
    saved = xt.default_device()
    xt.set_default_device("cpu")
    yield
    xt.set_default_device(saved)


SURFACE_TOL = dict(rtol=1e-4, atol=5e-5)
FOCAL_TOL = dict(rtol=1e-5, atol=1e-5)
PORT_DIR = pathlib.Path(xt.__file__).resolve().parent


def gaussian_bump(ny, nx):
    """bench.gaussian_bump's DEM, in numpy float32."""
    y = np.linspace(-1.0, 1.0, ny, dtype=np.float32)[:, None]
    x = np.linspace(-1.0, 1.0, nx, dtype=np.float32)[None, :]
    z = np.float32(1000.0) * np.exp(-(x * x + y * y) * np.float32(4.0))
    return (z + np.float32(20.0) * np.sin(x * np.float32(40.0))
            * np.cos(y * np.float32(40.0))).astype(np.float32)


@pytest.fixture
def dem():
    data = gaussian_bump(257, 389)
    data[100:104, 200:230] = np.nan  # a hole in the DEM
    coords = {"y": np.linspace(500.0, 244.0, 257),
              "x": np.linspace(10.0, 398.0, 389)}
    attrs = {"res": (1.0, 1.0), "crs": "EPSG:32633"}
    return (JaxDataArray(data, dims=("y", "x"), coords=coords, name="dem",
                         attrs=attrs),
            xt.DataArray(data, dims=("y", "x"), coords=coords, name="dem",
                         attrs=attrs))


def assert_matches(got, ref, tol, msg=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, msg
    assert np.array_equal(np.isnan(got), np.isnan(ref)), msg
    np.testing.assert_allclose(got, ref, equal_nan=True, err_msg=msg, **tol)


def assert_same_dataset(got, ref):
    assert list(got.data_vars) == list(ref.data_vars)
    assert list(got.coords) == list(ref.coords)
    for c in ref.coords:
        np.testing.assert_array_equal(got.coords[c].values,
                                      ref.coords[c].values)
    for k, rv in ref.data_vars.items():
        gv = got[k]
        assert gv.name == rv.name == k
        assert gv.dims == rv.dims, k
        assert gv.attrs == rv.attrs, k
        assert list(gv.coords) == list(rv.coords), k
        for c in rv.coords:
            np.testing.assert_array_equal(gv.coords[c].values,
                                          rv.coords[c].values)
        tol = FOCAL_TOL if k == "focal_stats" else SURFACE_TOL
        assert_matches(gv.values, rv.values, tol, k)


@pytest.mark.parametrize("kwargs", [
    {},
    {"surface": ("slope", "aspect", "curvature", "hillshade"),
     "stats_funcs": ("mean", "max", "min", "range", "std", "var", "sum"),
     "azimuth": 300.0, "angle_altitude": 40.0},
    {"surface": ("hillshade",), "stats_funcs": ("sum",),
     "kernel": np.ones((3, 5))},
], ids=["main_path", "all_products_all_stats", "custom_kernel"])
def test_terrain_pipeline_matches_jax(dem, kwargs):
    ja, ta = dem
    ref = janalytics.terrain_pipeline(ja, **kwargs)
    got = xt.terrain_pipeline(ta, **kwargs)
    assert_same_dataset(got, ref)
    fs = got["focal_stats"]
    assert isinstance(fs.data, torch.Tensor)
    assert fs.dims == ("stats", "y", "x")


def test_terrain_pipeline_unnamed_input_is_called_terrain(dem):
    _, ta = dem
    got = xt.terrain_pipeline(ta.rename(None))
    assert list(got.data_vars) == ["terrain", "terrain-slope",
                                   "terrain-hillshade", "focal_stats"]


def test_summarize_terrain_matches_jax(dem):
    ja, ta = dem
    assert_same_dataset(xt.summarize_terrain(ta),
                        janalytics.summarize_terrain(ja))


@pytest.mark.parametrize("call", [
    lambda m, a: m.terrain_pipeline(type(a)(np.ones((2, 4, 4), np.float32))),
    lambda m, a: m.terrain_pipeline(a, stats_funcs=("median",)),
    lambda m, a: m.terrain_pipeline(a, surface=("slope", "relief")),
    lambda m, a: m.terrain_pipeline(a, kernel=np.ones((2, 2))),
    lambda m, a: m.summarize_terrain(a.rename(None)),
], ids=["3d_input", "unknown_stat", "unknown_product", "even_kernel",
        "summarize_unnamed"])
def test_argument_errors_match_jax(dem, call):
    ja, ta = dem
    with pytest.raises(Exception) as ref:
        call(janalytics, ja)
    with pytest.raises(type(ref.value)) as got:
        call(xt, ta)
    assert str(got.value) == str(ref.value)


# -- the fused branch (XRSPATIAL_FUSED_PIPELINE=1) -----------------------------

_twin = tpipeline.pipeline_multi


def _refuse(*args):
    raise AssertionError("the fused twin ran")


def fused_raster():
    """The 70x300 NaN-patch raster of the JAX package's fused-kernel test."""
    rng = np.random.default_rng(11)
    data = rng.random((70, 300)).astype(np.float32) * 100
    data[20:23, 120:140] = np.nan
    data[31:33, 40] = np.nan  # on the th=32 seam
    return data


@pytest.mark.parametrize("which,stats,radius", [
    (("slope", "hillshade"), ("mean", "max", "min", "std"), 1.5),
    (("slope", "aspect", "curvature", "hillshade"),
     ("mean", "max", "min", "range", "std", "var", "sum"), 2.5),
], ids=["main_path", "all_products_r2"])
def test_fused_branch_matches_jax_pipeline_tiled(monkeypatch, which, stats,
                                                 radius):
    import jax.numpy as jnp
    from xrspatial_tpu.kernels.pallas_pipeline import pipeline_tiled
    monkeypatch.setenv("XRSPATIAL_FUSED_PIPELINE", "1")
    data = fused_raster()
    kernel = circle_kernel(1, 1, radius)
    f32 = jnp.float32
    ref = pipeline_tiled(jnp.asarray(data), f32(2.0), f32(3.0), f32(300.0),
                         f32(40.0), kernel_offsets(kernel), stats,
                         which=which, th=32, tw=128, interpret=True)
    calls = []

    def counting(*args):
        calls.append(1)
        return _twin(*args)

    monkeypatch.setattr(tpipeline, "pipeline_multi", counting)
    ds = xt.terrain_pipeline(
        xt.DataArray(data, dims=("y", "x"), name="dem",
                     attrs={"res": (2.0, 3.0)}),
        surface=which, kernel=kernel, stats_funcs=stats, azimuth=300.0,
        angle_altitude=40.0)
    assert calls == [1]
    assert list(ds.data_vars) == ["dem", *(f"dem-{p}" for p in which),
                                  "focal_stats"]
    for p, r in zip(which, ref):
        assert_matches(ds[f"dem-{p}"].values, np.asarray(r), SURFACE_TOL, p)
    fs = ds["focal_stats"]
    assert fs.dims == ("stats", "y", "x") and fs.name == "focal_stats"
    assert list(fs.coords["stats"].values) == list(stats)
    assert_matches(fs.values, np.asarray(ref[-1]), FOCAL_TOL, "focal")


def test_fused_branch_equals_the_split_path(dem, monkeypatch):
    _, ta = dem
    kwargs = dict(surface=("slope", "aspect", "curvature", "hillshade"),
                  stats_funcs=("mean", "max", "min", "range", "std", "var",
                               "sum"))
    split = xt.terrain_pipeline(ta, **kwargs)
    monkeypatch.setenv("XRSPATIAL_FUSED_PIPELINE", "1")
    fused = xt.terrain_pipeline(ta, **kwargs)
    assert list(fused.data_vars) == list(split.data_vars)
    for k in split.data_vars:
        assert fused[k].dims == split[k].dims and fused[k].name == k
        assert fused[k].attrs == split[k].attrs
        assert list(fused[k].coords) == list(split[k].coords)
        np.testing.assert_array_equal(fused[k].values, split[k].values)


@pytest.mark.parametrize("env,kernel", [
    ("1", np.ones((1, 131))),     # rx = 65: 2*rx > 128
    ("1", np.ones((67, 1))),      # ry = 33
    ("0", None),
    ("", None),
], ids=["rx65_refused", "ry33_refused", "env_0", "env_empty"])
def test_split_path_runs_unless_fused_is_on_and_accepted(dem, monkeypatch,
                                                         env, kernel):
    """As in the JAX package, the variable must be "1" and the footprint
    must pass pipeline_supported; otherwise the split path runs."""
    _, ta = dem
    monkeypatch.setenv("XRSPATIAL_FUSED_PIPELINE", env)
    monkeypatch.setattr(tpipeline, "pipeline_multi", _refuse)
    offsets = kernel_offsets(kernel if kernel is not None
                             else circle_kernel(1, 1, 1.5))
    assert tpipeline.pipeline_supported(offsets) == (kernel is None)
    got = xt.terrain_pipeline(ta, kernel=kernel)
    assert list(got.data_vars) == ["dem", "dem-slope", "dem-hillshade",
                                   "focal_stats"]


@pytest.mark.parametrize("kernel", [
    np.ones((3, 3)), np.ones((1, 129)), np.ones((1, 131)), np.ones((65, 1)),
    np.ones((67, 1)), circle_kernel(1, 1, 20), np.ones((1, 1))])
def test_pipeline_supported_matches_jax(kernel):
    from xrspatial_tpu.kernels.pallas_pipeline import pipeline_supported
    offsets = kernel_offsets(kernel)
    assert tpipeline.pipeline_supported(offsets) == pipeline_supported(
        offsets)


def test_dataarray_from_round_trips_a_jax_dataarray(dem):
    ja, _ = dem
    import jax.numpy as jnp
    ja = JaxDataArray(jnp.asarray(ja.values), dims=ja.dims, coords=ja.coords,
                      name=ja.name, attrs=ja.attrs)
    ta = dataarray_from(ja)
    assert isinstance(ta.data, torch.Tensor) and ta.data.device.type == "cpu"
    assert ta.dims == ja.dims and ta.name == ja.name and ta.attrs == ja.attrs
    np.testing.assert_array_equal(ta.values, ja.values)
    back = JaxDataArray(ta.values, dims=ta.dims, name=ta.name,
                        attrs=ta.attrs,
                        coords={k: v.values for k, v in ta.coords.items()})
    assert back.identical(ja)


def test_port_imports_neither_jax_nor_the_jax_package():
    banned = ("jax", "jaxlib", "xrspatial_tpu")
    files = sorted(PORT_DIR.rglob("*.py"))
    assert len(files) >= 16
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)


# -- the data model -----------------------------------------------------------

def test_dataarray_keeps_the_tensor_as_its_payload():
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    a = xt.DataArray(t, dims=("y", "x"), name="t", attrs={"k": 1})
    assert a.data is t
    assert a.shape == (3, 4) and a.ndim == 2 and a.dtype == torch.float32
    assert a.sizes == {"y": 3, "x": 4} and a.size == 12
    host = a.values
    assert isinstance(host, np.ndarray)
    np.testing.assert_array_equal(host, t.numpy())
    np.testing.assert_array_equal(a.to_numpy(), np.asarray(a))
    assert to_torch(a) is t


def test_dataarray_coords_rename_copy_and_dataset():
    a = xt.DataArray(np.zeros((2, 3), np.float32), dims=("y", "x"),
                     name="z", attrs={"res": 1.0})
    a["x"] = np.array([0.0, 1.0, 2.0])
    a.coords["y"] = ("y", np.array([5.0, 6.0]), {"units": "m"})
    assert list(a.coords) == ["x", "y"]
    assert a["y"].attrs == {"units": "m"} and a["y"].dims == ("y",)
    b = a.rename("w")
    assert b.name == "w" and a.name == "z"
    c = a.copy()
    c.attrs["res"] = 2.0
    assert a.attrs["res"] == 1.0
    ds = a.to_dataset()
    assert list(ds.data_vars) == ["z"] and list(ds.coords) == ["x", "y"]
    ds["v"] = ("x", np.ones(3))
    assert [k for k, _ in ds.items()] == ["z", "v"]
    assert ds.dims == {"y": 2, "x": 3}
    with pytest.raises(ValueError, match="unnamed"):
        a.rename(None).to_dataset()


def test_to_torch_converts_dtype_and_device_explicitly():
    a = xt.DataArray(np.arange(6, dtype=np.int32).reshape(2, 3))
    t = to_torch(a)
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    assert to_torch(a, dtype=None).dtype == torch.int32
    read_only = np.ones((2, 2), np.float32)
    read_only.flags.writeable = False
    assert to_torch(read_only).sum() == 4.0


@pytest.mark.parametrize("call", [
    lambda a: a.isel(x=0), lambda a: a.sel(x=1.0), lambda a: a.mean(),
    lambda a: a + 1, lambda a: a[0], lambda a: a.where(a.data > 0),
    lambda a: (xt.concat if isinstance(a, xt.DataArray)
               else jxr_compat.concat)([a, a], "t"),
], ids=["isel", "sel", "mean", "add", "index", "where", "concat"])
def test_unported_dataarray_methods_raise(call):
    """Named for what it held before ROADMAP A5 ported these methods; it
    now holds each to the JAX shim's result: the same dims, coords and
    values, and a tensor payload that stays a tensor."""
    data = np.arange(6, dtype=np.float32).reshape(2, 3) - 2
    kw = dict(dims=("y", "x"), coords={"x": np.arange(3.0)})
    j = call(JaxDataArray(data, **kw))
    t = call(xt.DataArray(torch.from_numpy(data.copy()), **kw))
    assert isinstance(t.data, torch.Tensor)
    assert t.dims == j.dims and list(t.coords) == list(j.coords)
    np.testing.assert_array_equal(t.values, np.asarray(j.data))
