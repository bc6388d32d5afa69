"""Parity of the port's geodesic slope / aspect with the JAX package (CPU).

The same seeded numpy rasters and coordinates go through
``xrspatial_tpu`` and ``xrspatial_torch`` with ``method='geodesic'``.
Both fit the tangent plane in float64 and return float32; float64
``sin``/``cos`` and the 9-term sums of torch and XLA may differ by float64
ulps, so the float32 outputs are held to 1 float32 ulp at every cell, NaN
masks equal.  On an exactly flat patch the slope is float64 cancellation
noise of ~1e-9 degrees in both packages; there the bar is an absolute
1e-8 degrees.  The errors (bad ``z_unit``, missing or out-of-range
coordinates) carry the JAX package's messages.
"""

import numpy as np
import pytest
import torch

import xrspatial_torch as xt
import xrspatial_tpu as xj
from xrspatial_torch.kernels import geodesic as tgeo
from xrspatial_torch.utils import Z_UNITS
from xrspatial_tpu.kernels import geodesic as jgeo
from xrspatial_tpu.utils import Z_UNITS as JAX_Z_UNITS
from xrspatial_tpu.xrlib import DataArray as JaxDataArray


@pytest.fixture(autouse=True)
def numpy_rasters_on_the_cpu():
    """These tests give numpy rasters and compare on the CPU."""
    saved = xt.default_device()
    xt.set_default_device("cpu")
    yield
    xt.set_default_device(saved)


MAX_ULPS = 1
FLAT_ATOL = 1e-8    # degrees: float64 noise of an exactly flat patch


def assert_within_ulps(got, ref, msg=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype == np.float32, msg
    assert got.shape == ref.shape, msg
    assert np.array_equal(np.isnan(got), np.isnan(ref)), msg
    fin = ~np.isnan(ref)
    g, r = got[fin], ref[fin]
    ulps = np.abs(g.view(np.int32).astype(np.int64)
                  - r.view(np.int32).astype(np.int64))
    bad = (ulps > MAX_ULPS) & (np.abs(g - r) > FLAT_ATOL)
    assert not bad.any(), (msg, int(bad.sum()), ulps.max())


def both(elev, coords):
    """(JAX DataArray, port DataArray) of `elev` with `coords`, a dict of
    name -> 1-D array (on its own dim) or (dims, 2-D array)."""
    ja = JaxDataArray(elev, dims=("y", "x"), name="elev")
    ta = xt.DataArray(elev, dims=("y", "x"), name="elev")
    for k, v in coords.items():
        ja.coords[k] = v
        ta.coords[k] = v
    return ja, ta


def geo_raster():
    """The raster of tests/test_geodesic.py: 8x10 float64, lat 45-45.07,
    lon 7-7.09."""
    rng = np.random.default_rng(8)
    elev = (rng.random((8, 10)) * 500).astype(np.float64)
    return elev, {"y": np.linspace(45.0, 45.07, 8),
                  "x": np.linspace(7.0, 7.09, 10)}


def tile_with_nan():
    """A float32 1/3600-degree tile crop with a NaN patch and a flat
    corner (the `mag < 1e-7` test)."""
    rng = np.random.default_rng(21)
    elev = (rng.random((61, 47)) * 800).astype(np.float32)
    elev[20:24, 10:15] = np.nan
    elev[40:, 30:] = 350.0
    return elev, {"y": 46.0 - np.arange(61) / 3600.0,
                  "x": 7.0 + np.arange(47) / 3600.0}


def two_d_coords():
    """2-D lat/lon coordinates named lat/lon on a rotated grid."""
    rng = np.random.default_rng(4)
    elev = (rng.random((24, 30)) * 300).astype(np.float32)
    iy, ix = np.mgrid[0:24, 0:30].astype(np.float64)
    lat = -33.0 + iy * 2e-4 + ix * 5e-5
    lon = 151.0 + ix * 2.5e-4 - iy * 4e-5
    return elev, {"lat": (("y", "x"), lat), "lon": (("y", "x"), lon)}


CASES = {"geo_raster": geo_raster, "tile_with_nan": tile_with_nan,
         "two_d_coords": two_d_coords}


@pytest.mark.parametrize("z_unit", ["meter", "ft", "km", "mile"])
@pytest.mark.parametrize("op", ["slope", "aspect"])
@pytest.mark.parametrize("case", list(CASES))
def test_geodesic_matches_jax(case, op, z_unit):
    elev, coords = CASES[case]()
    ja, ta = both(elev, coords)
    ref = getattr(xj, op)(ja, method="geodesic", z_unit=z_unit)
    got = getattr(xt, op)(ta, method="geodesic", z_unit=z_unit)
    assert isinstance(got.data, torch.Tensor)
    assert got.name == ref.name == op and got.dims == ref.dims
    assert_within_ulps(got.values, np.asarray(ref.data), f"{op} {z_unit}")
    out = got.values
    assert np.isnan(out[0]).all() and np.isnan(out[-1]).all()
    assert np.isnan(out[:, 0]).all() and np.isnan(out[:, -1]).all()


def test_flat_corner_is_minus_one_in_aspect():
    elev, coords = tile_with_nan()
    _, ta = both(elev, coords)
    out = xt.aspect(ta, method="geodesic").values
    assert (out[42:-1, 32:-1] == -1.0).all()


@pytest.mark.parametrize("fn", ["geodesic_slope", "geodesic_aspect"])
def test_kernel_functions_match_jax(fn):
    import jax.numpy as jnp
    from xrspatial_tpu.utils import x64
    elev, coords = tile_with_nan()
    lat = np.broadcast_to(coords["y"][:, None], elev.shape).copy()
    lon = np.broadcast_to(coords["x"][None, :], elev.shape).copy()
    with x64():
        ref = np.asarray(getattr(jgeo, fn)(
            jnp.asarray(elev, jnp.float64), jnp.asarray(lat),
            jnp.asarray(lon), jgeo.WGS84_A2, jgeo.WGS84_B2, 0.3048))
    got = getattr(tgeo, fn)(torch.from_numpy(elev), torch.from_numpy(lat),
                            torch.from_numpy(lon), tgeo.WGS84_A2,
                            tgeo.WGS84_B2, 0.3048)
    assert_within_ulps(got.numpy(), ref, fn)


def test_constants_and_units_match_jax():
    assert Z_UNITS == JAX_Z_UNITS
    for k in ("WGS84_A2", "WGS84_B2", "INV_2R"):
        assert getattr(tgeo, k) == getattr(jgeo, k), k


def errors_of(call_jax, call_torch):
    with pytest.raises(ValueError) as ref:
        call_jax()
    with pytest.raises(ValueError) as got:
        call_torch()
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("op", ["slope", "aspect"])
def test_bad_z_unit_raises_like_jax(op):
    ja, ta = both(*geo_raster())
    errors_of(lambda: getattr(xj, op)(ja, method="geodesic", z_unit="parsec"),
              lambda: getattr(xt, op)(ta, method="geodesic", z_unit="parsec"))


BAD_COORDS = {
    "latitude_out_of_range": {"y": np.linspace(89, 95, 4),
                              "x": np.linspace(0, 3, 4)},
    "longitude_out_of_range": {"y": np.linspace(10, 11, 4),
                               "x": np.linspace(350, 370, 4)},
    "no_coordinates": {},
    "text_coordinate": {"y": np.array(list("abcd")),
                        "x": np.linspace(0, 3, 4)},
    "one_1d_one_2d": {"y": np.linspace(10, 11, 4),
                      "lon": (("y", "x"), np.zeros((4, 4)))},
}


@pytest.mark.parametrize("op", ["slope", "aspect"])
@pytest.mark.parametrize("bad", list(BAD_COORDS))
def test_bad_coordinates_raise_like_jax(bad, op):
    ja, ta = both(np.zeros((4, 4)), BAD_COORDS[bad])
    errors_of(lambda: getattr(xj, op)(ja, method="geodesic"),
              lambda: getattr(xt, op)(ta, method="geodesic"))


def test_one_dimensional_raster_raises_like_jax():
    ja = JaxDataArray(np.zeros(5), dims=("x",))
    ta = xt.DataArray(np.zeros(5), dims=("x",))
    errors_of(lambda: xj.slope(ja, method="geodesic"),
              lambda: xt.slope(ta, method="geodesic"))
