"""Parity of the torch port's surface stencils with the JAX package (CPU).

The same numpy rasters go through ``xrspatial_tpu`` and ``xrspatial_torch``;
on the CPU the port runs its torch twins.  Tolerance: rtol 1e-4, atol 5e-5
(the JAX package's own bar for its surface kernels), NaN masks equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xrspatial_torch as xt
import xrspatial_tpu as xj
from xrspatial_torch.kernels.surface import PRODUCTS
from xrspatial_torch.kernels.surface import surface_multi as torch_multi
from xrspatial_torch.kernels.surface import surface_stacked
from xrspatial_tpu.kernels.surface import surface_multi as jax_multi
from xrspatial_tpu.xrlib import DataArray as JaxDataArray


@pytest.fixture(autouse=True)
def numpy_rasters_on_the_cpu():
    """These tests give numpy rasters and compare on the CPU."""
    saved = xt.default_device()
    xt.set_default_device("cpu")
    yield
    xt.set_default_device(saved)


RTOL, ATOL = 1e-4, 5e-5
CASES = ("patches_70x300", "row_1x257", "col_300x2", "elevation_raster")


@pytest.fixture(params=CASES)
def case(request):
    """(raster, (cellsize_x, cellsize_y)) built with numpy from a seed."""
    name = request.param
    if name == "elevation_raster":
        return request.getfixturevalue("elevation_raster"), (1.0, 1.0)
    rng = np.random.default_rng(5)
    if name == "patches_70x300":
        data = rng.random((70, 300)).astype(np.float32) * 100
        data[20:23, 120:140] = np.nan   # NaN patch
        data[31:33, 40] = np.nan        # NaN on a JAX tile seam row
        return data, (2.0, 3.0)
    shape = (1, 257) if name == "row_1x257" else (300, 2)
    return (rng.random(shape) * 100).astype(np.float32), (1.0, 1.0)


def assert_matches(got, ref, msg=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, msg
    assert np.array_equal(np.isnan(got), np.isnan(ref)), msg
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL,
                               equal_nan=True, err_msg=msg)


def both_arrays(data, res):
    dims = ("y", "x")
    return (JaxDataArray(data, dims=dims, name="dem", attrs={"res": res}),
            xt.DataArray(data, dims=dims, name="dem", attrs={"res": res}))


@pytest.mark.parametrize("op", ["slope", "aspect", "curvature", "hillshade"])
def test_public_op_matches_jax(case, op):
    data, res = case
    ja, ta = both_arrays(data, res)
    ref = getattr(xj, op)(ja)
    got = getattr(xt, op)(ta)
    assert isinstance(got.data, torch.Tensor)
    assert got.data.dtype == torch.float32
    assert got.name == ref.name == op
    assert got.dims == ref.dims
    assert got.attrs == ref.attrs
    assert_matches(got.values, ref.values, op)


@pytest.mark.parametrize("azimuth,altitude", [(315, 45), (90, 10)])
def test_hillshade_sun_position_matches_jax(case, azimuth, altitude):
    data, res = case
    ja, ta = both_arrays(data, res)
    ref = xj.hillshade(ja, azimuth=azimuth, angle_altitude=altitude)
    got = xt.hillshade(ta, azimuth=azimuth, angle_altitude=altitude)
    assert_matches(got.values, ref.values)


def test_surface_multi_matches_jax(case):
    data, (csx, csy) = case
    f32 = jnp.float32
    ref = jax_multi(jnp.asarray(data), f32(csx), f32(csy), f32(225.0),
                    f32(25.0), PRODUCTS)
    got = torch_multi(torch.from_numpy(data), csx, csy, 225.0, 25.0,
                      PRODUCTS)
    assert set(got) == set(ref) == set(PRODUCTS)
    for p in PRODUCTS:
        assert_matches(got[p].numpy(), ref[p], p)


def test_nan_ring_on_every_product(case):
    data, (csx, csy) = case
    outs = torch_multi(torch.from_numpy(data), csx, csy, 225.0, 25.0,
                       PRODUCTS)
    for p, out in outs.items():
        out = out.numpy()
        assert np.isnan(out[0]).all() and np.isnan(out[-1]).all(), p
        assert np.isnan(out[:, 0]).all() and np.isnan(out[:, -1]).all(), p


def test_dataset_input_maps_each_variable():
    rng = np.random.default_rng(3)
    a = (rng.random((12, 9)) * 50).astype(np.float32)
    b = (rng.random((12, 9)) * 50).astype(np.float32)
    res = {"res": (1.0, 1.0)}
    ref = xj.slope(xj.Dataset(
        {k: JaxDataArray(v, dims=("y", "x"), attrs=res)
         for k, v in (("a", a), ("b", b))}, attrs={"source": "test"}))
    got = xt.slope(xt.Dataset(
        {k: xt.DataArray(v, dims=("y", "x"), attrs=res)
         for k, v in (("a", a), ("b", b))}, attrs={"source": "test"}))
    assert got.attrs == ref.attrs
    assert list(got.data_vars) == list(ref.data_vars) == ["a", "b"]
    for k in ("a", "b"):
        assert got[k].name == ref[k].name
        assert_matches(got[k].values, ref[k].values, k)


@pytest.mark.parametrize("call", [
    lambda m, a: m.slope(a, method="geodesic"),
    lambda m, a: m.aspect(a, method="geodesic"),
    lambda m, a: m.hillshade(a, shadows=True),
], ids=["slope_geodesic", "aspect_geodesic", "hillshade_shadows"])
def test_unported_options_raise(call):
    """The options that raised NotImplementedError until ROADMAP A10 was
    ported now run, and match the JAX package (the geodesic fit within a
    float32 ulp, tests/test_torch_geodesic.py; the shadows' lit mask at
    every cell, tests/test_torch_shadows.py)."""
    rng = np.random.default_rng(11)
    data = (rng.random((9, 12)) * 40).astype(np.float32)
    data[4, 5] = np.nan
    coords = {"y": np.linspace(45.01, 45.0, 9), "x": np.linspace(7.0, 7.01,
                                                                   12)}
    ja, ta = both_arrays(data, (1.0, 1.0))
    for k, v in coords.items():
        ja[k] = v
        ta[k] = v
    ref = np.asarray(call(xj, ja).data)
    got = call(xt, ta).values
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6,
                               equal_nan=True)


STACK_ORDERS = {
    "all": PRODUCTS,
    "hillshade_slope": ("hillshade", "slope"),
    "curvature_aspect_slope": ("curvature", "aspect", "slope"),
    "aspect": ("aspect",),
}


@pytest.mark.parametrize("squeeze", [False, True])
@pytest.mark.parametrize("order", list(STACK_ORDERS))
def test_surface_stacked_matches_jax(case, order, squeeze):
    """The stacked entry (B0's plain version on the CPU) against the JAX
    package's ``surface_multi`` stacked in `which` order: the JAX
    ``surface_pallas`` itself has no interpret mode on the CPU."""
    data, (csx, csy) = case
    which = STACK_ORDERS[order]
    f32 = jnp.float32
    ref = jax_multi(jnp.asarray(data), f32(csx), f32(csy), f32(300.0),
                    f32(40.0), which)
    ref = np.stack([np.asarray(ref[p]) for p in which])
    got = surface_stacked(torch.from_numpy(data), csx, csy, 300.0, 40.0,
                          which=which, squeeze=squeeze)
    assert got.dtype == torch.float32
    if squeeze and len(which) == 1:
        assert tuple(got.shape) == data.shape
        got = got[None]
    assert tuple(got.shape) == (len(which),) + data.shape
    for k, p in enumerate(which):
        assert_matches(got[k].numpy(), ref[k], p)


def test_surface_stacked_planes_equal_surface_multi(case):
    data, (csx, csy) = case
    x = torch.from_numpy(data)
    which = ("hillshade", "curvature", "slope", "aspect")
    got = surface_stacked(x, csx, csy, 225.0, 25.0, which=which)
    ref = torch_multi(x, csx, csy, 225.0, 25.0, which)
    for k, p in enumerate(which):
        assert torch.equal(torch.isnan(got[k]), torch.isnan(ref[p]))
        assert torch.equal(torch.nan_to_num(got[k]),
                           torch.nan_to_num(ref[p])), p


@pytest.mark.parametrize("which", [(), ("slope", "slope"), ("relief",)],
                         ids=["empty", "repeated", "unknown"])
def test_surface_stacked_rejects_bad_products(which):
    with pytest.raises(ValueError, match="distinct names"):
        surface_stacked(torch.ones((4, 4)), which=which)


def test_unknown_method_raises_like_jax():
    data = np.ones((5, 5), np.float32)
    ja, ta = both_arrays(data, (1.0, 1.0))
    with pytest.raises(ValueError) as ref:
        xj.slope(ja, method="spherical")
    with pytest.raises(ValueError) as got:
        xt.slope(ta, method="spherical")
    assert str(got.value) == str(ref.value)
