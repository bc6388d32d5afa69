"""Parity of the port's multispectral indices with the JAX package (CPU).

The same seeded float32 bands (64x64, a NaN cell and a cell whose
denominators are exactly 0) go through ``xrspatial_tpu.multispectral`` and
``xrspatial_torch.multispectral``: NaN masks equal, values within the JAX
suite's rtol 1e-5, coords, dims and attrs from the same source band.

The port rounds every product and sum apart (no fused multiply-add), so
each index equals its formula in numpy float32, op for op, bit for bit;
the card gives the same bits.  XLA's CPU code fuses evi's products into
its sums (``fma(6, red, nir)``, then ``fma(-7.5, blue, .)``, pinned
below), which moves evi's denominator by up to one rounding of its
largest term: evi is held to that bound, ``|got - ref| <= |ref| * 4 eps *
(S / |den| + 1)`` with S the sum of the terms' magnitudes.  torch's
float32 sqrt on the CPU is 1 ulp off in about 0.6% of values, so ebbi is
held to its formula within 2 ulps.  ``true_color`` is uint8 within 1 of the JAX
package; its float-to-uint8 cast saturates as XLA's does (torch's wraps),
pinned on out-of-range values and on a constant band.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xrspatial_torch as xt
import xrspatial_tpu
from xrspatial_torch import multispectral as tm
from xrspatial_torch.multispectral import _saturate_uint8
from xrspatial_tpu import multispectral as jm
from xrspatial_tpu.xrlib import DataArray as JaxDataArray
from xrspatial_tpu.xrlib import Dataset as JaxDataset

RTOL = 1e-5
EPS = np.float32(2.0 ** -23)
BANDS = ("nir", "red", "blue", "green", "swir1", "swir2", "tir")


@pytest.fixture(autouse=True)
def numpy_rasters_on_the_cpu():
    """These tests give numpy rasters and compare on the CPU."""
    saved = xt.default_device()
    xt.set_default_device("cpu")
    yield
    xt.set_default_device(saved)


def band_values(shape=(64, 64), seed=20):
    rng = np.random.default_rng(seed)
    out = {k: (rng.random(shape) * 2).astype(np.float32) for k in BANDS}
    out["nir"][1, 2] = np.nan
    for k in BANDS:                  # ndvi's and most denominators 0 here
        out[k][2, 3] = 0.0
    return out


def coords(shape):
    return {"y": np.arange(shape[0]) * -30.0 + 4e6,
            "x": np.arange(shape[1]) * 30.0 + 5e5}


def both(values):
    """(JAX DataArrays, port DataArrays) of each band, with coords and
    attrs named after the band."""
    j, t = {}, {}
    for k, v in values.items():
        kw = dict(dims=("y", "x"), coords=coords(v.shape), name=k,
                  attrs={"band": k})
        j[k] = JaxDataArray(v, **kw)
        t[k] = xt.DataArray(v, **kw)
    return j, t


def _guard(den, num):
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(den == 0, np.float32(np.nan),
                        num / np.where(den == 0, np.float32(1), den))


f32 = np.float32
# index -> (bands in call order, source band, the formula in numpy float32
# with each op rounded apart)
INDICES = {
    "arvi": (("nir", "red", "blue"), "nir", lambda n, r, b: _guard(
        n + f32(2) * r + b, n - f32(2) * r + b)),
    "evi": (("nir", "red", "blue"), "nir", lambda n, r, b: f32(2.5) * _guard(
        n + f32(6) * r - f32(7.5) * b + f32(1), n - r)),
    "gci": (("nir", "green"), "nir", lambda n, g: np.where(
        g == 0, f32(np.nan), n / np.where(g == 0, f32(1), g) - f32(1))),
    "nbr": (("nir", "swir2"), "nir", lambda a, b: _guard(a + b, a - b)),
    "nbr2": (("swir1", "swir2"), "swir1", lambda a, b: _guard(a + b, a - b)),
    "ndvi": (("nir", "red"), "nir", lambda a, b: _guard(a + b, a - b)),
    "ndmi": (("nir", "swir1"), "nir", lambda a, b: _guard(a + b, a - b)),
    "savi": (("nir", "red"), "nir", lambda n, r: _guard(
        (n + r + f32(1)) * f32(2), n - r)),
    "sipi": (("nir", "red", "blue"), "nir", lambda n, r, b: _guard(
        n - r, n - b)),
    "ebbi": (("red", "swir1", "tir"), "red", lambda r, s, t: _guard(
        f32(10) * np.sqrt(s + t), s - r)),
}


def evi_tolerance(n, r, b, ref):
    """One rounding of evi's denominator's largest term, relative to the
    denominator, plus the roundings of the quotient."""
    s = np.abs(n) + 6 * np.abs(r) + 7.5 * np.abs(b) + 1
    den = np.abs(n + f32(6) * r - f32(7.5) * b + f32(1))
    with np.errstate(divide="ignore"):
        return np.abs(ref) * 4 * EPS * (s / den + 1)


@pytest.mark.parametrize("name", list(INDICES))
def test_index_matches_the_jax_package(name):
    bands, source, _ = INDICES[name]
    j, t = both(band_values())
    ref = getattr(jm, name)(*(j[b] for b in bands))
    got = getattr(tm, name)(*(t[b] for b in bands))
    r, g = np.asarray(ref.data), got.values
    assert got.data.dtype == torch.float32 and g.dtype == r.dtype
    np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
    if name == "evi":
        fin = ~np.isnan(r)
        tol = evi_tolerance(*(band_values()[b] for b in bands), r)
        assert (np.abs(g - r)[fin] <= tol[fin]).all()
    else:
        np.testing.assert_allclose(g, r, rtol=RTOL, equal_nan=True)
    assert got.name == ref.name == name and got.dims == ref.dims
    assert got.attrs == {"band": source} == dict(ref.attrs)
    for d in ("y", "x"):
        np.testing.assert_array_equal(got.coords[d].values,
                                      np.asarray(ref.coords[d].data))


def ulps(a, b):
    """Float32 ulps between `a` and `b` of one sign (NaN masks equal)."""
    assert np.array_equal(np.isnan(a), np.isnan(b))
    fin = ~np.isnan(a)
    return np.abs(a[fin].view(np.int32).astype(np.int64)
                  - b[fin].view(np.int32))


@pytest.mark.parametrize("name", list(INDICES))
def test_index_rounds_each_op_apart(name):
    """The port's index equals its numpy float32 formula bit for bit;
    ebbi within 2 ulps, since torch's float32 sqrt on the CPU is off by 1
    ulp in about 0.6% of values (numpy's, and the card's, is correctly
    rounded)."""
    bands, _, formula = INDICES[name]
    values = band_values()
    _, t = both(values)
    got = getattr(tm, name)(*(t[b] for b in bands)).values
    expected = formula(*(values[b] for b in bands))
    assert expected.dtype == np.float32
    if name == "ebbi":
        assert ulps(got, expected).max() <= 2
    else:
        np.testing.assert_array_equal(got, expected)


def test_xla_fuses_evis_products_into_its_sums():
    """Why evi has its own tolerance: the JAX package's evi on the CPU is
    the fused-multiply-add evaluation of the denominator."""
    values = band_values()
    n, r, b = (values[k] for k in ("nir", "red", "blue"))
    j, _ = both(values)
    d = np.float64
    t1 = f32(d(n) + d(6) * d(r))
    den = f32(d(t1) - d(7.5) * d(b)) + f32(1)
    fused = f32(2.5) * _guard(den, n - r)
    np.testing.assert_array_equal(
        np.asarray(jm.evi(j["nir"], j["red"], j["blue"]).data), fused)


@pytest.mark.parametrize("kwargs", [
    dict(c1=4.0, c2=3.5, soil_factor=-0.3, gain=1.7), dict(soil_factor=0.3)])
def test_evi_and_savi_constants_round_to_float32(kwargs):
    j, t = both(band_values((16, 16), seed=3))
    name = "evi" if "gain" in kwargs else "savi"
    bands = INDICES[name][0]
    ref = np.asarray(getattr(jm, name)(*(j[b] for b in bands),
                                       **kwargs).data)
    got = getattr(tm, name)(*(t[b] for b in bands), **kwargs).values
    if name == "savi":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-3, equal_nan=True)


def test_zero_denominators_are_nan():
    one = xt.DataArray(np.array([[1.0, 0.0]], np.float32))
    neg = xt.DataArray(np.array([[-1.0, 0.0]], np.float32))
    assert np.isnan(tm.ndvi(one, neg).values).all()


@pytest.mark.parametrize("call", [
    lambda m, a: m.evi(a, a, a, c1="x"), lambda m, a: m.evi(a, a, a, c2=None),
    lambda m, a: m.evi(a, a, a, soil_factor=2.0),
    lambda m, a: m.evi(a, a, a, gain=-1.0),
    lambda m, a: m.savi(a, a, soil_factor=-1.5),
    lambda m, a: m.ndvi(a, a[:2]), lambda m, a: m.arvi(a, a, a[:, :3]),
], ids=["c1", "c2", "soil", "gain", "savi_soil", "shape", "shape3"])
def test_errors_match_the_jax_package(call):
    values = np.ones((4, 4), np.float32)
    with pytest.raises(ValueError) as ref:
        call(jm, JaxDataArray(values, dims=("y", "x")))
    with pytest.raises(ValueError) as got:
        call(tm, xt.DataArray(values, dims=("y", "x")))
    assert str(got.value) == str(ref.value)


def test_dataset_band_aliases():
    values = band_values((8, 8))
    jd = JaxDataset({"B8": JaxDataArray(values["nir"], dims=("y", "x")),
                     "B4": JaxDataArray(values["red"], dims=("y", "x"))})
    td = xt.Dataset({"B8": xt.DataArray(values["nir"], dims=("y", "x")),
                     "B4": xt.DataArray(values["red"], dims=("y", "x"))})
    np.testing.assert_array_equal(
        tm.ndvi(td, nir="B8", red="B4").values,
        np.asarray(jm.ndvi(jd, nir="B8", red="B4").data))
    assert xt.ndvi(td, nir="B8", red="B4", name="v").name == "v"
    with pytest.raises(TypeError, match="'red' keyword required"):
        tm.ndvi(td, nir="B8")
    with pytest.raises(ValueError, match="'B2' not in Dataset"):
        tm.ndvi(td, nir="B8", red="B2")


def test_exported_indices_are_the_jax_packages():
    for name in ("arvi", "evi", "nbr", "ndvi", "savi", "sipi"):
        assert getattr(xt, name) is getattr(tm, name)
        assert hasattr(xrspatial_tpu, name)
    for name in ("gci", "nbr2", "ndmi", "ebbi", "true_color"):
        assert not hasattr(xt, name) and hasattr(tm, name)


def test_true_color_matches_the_jax_package():
    values = band_values()
    values["red"][0, :5] = [np.nan, 0.5, 1.0, 1.5, 0.0]
    j, t = both(values)
    ref = jm.true_color(j["red"], j["green"], j["blue"])
    got = tm.true_color(t["red"], t["green"], t["blue"])
    g, r = got.values, np.asarray(ref.data)
    assert g.dtype == r.dtype == np.uint8 and g.shape == r.shape == (64, 64,
                                                                     4)
    assert np.abs(g.astype(int) - r.astype(int)).max() <= 1
    np.testing.assert_array_equal(g[..., 3], r[..., 3])  # alpha exactly
    assert got.dims == ref.dims == ("y", "x", "band")
    assert list(got.coords) == list(ref.coords)
    np.testing.assert_array_equal(got.coords["band"].values, [0, 1, 2, 3])
    assert got.attrs == dict(ref.attrs) and got.name == "true_color"


def test_uint8_cast_saturates_like_xla():
    """XLA's float -> uint8 is saturating (NaN -> 0); torch's ``.to``
    wraps (300 -> 44, -5 -> 251, 1e10 -> 0 here)."""
    x = np.array([np.nan, 300, -5, 255.9, 1e10, np.inf, -np.inf, 3.7],
                 np.float32)
    expected = np.asarray(jnp.asarray(x).astype(jnp.uint8))
    np.testing.assert_array_equal(expected, [0, 255, 0, 255, 255, 255, 0, 3])
    np.testing.assert_array_equal(
        _saturate_uint8(torch.from_numpy(x)).numpy(), expected)


def test_true_color_of_a_constant_band():
    """A constant band normalises to NaN (its range is 0), which both
    packages cast to 0; the nodata rule sets alpha."""
    values = {"r": np.full((6, 8), 3.0, np.float32),
              "g": np.full((6, 8), 0.5, np.float32),
              "b": np.linspace(0, 1, 48, dtype=np.float32).reshape(6, 8)}
    j, t = both(values)
    ref = np.asarray(jm.true_color(j["r"], j["g"], j["b"]).data)
    got = tm.true_color(t["r"], t["g"], t["b"]).values
    assert (ref[..., :2] == 0).all() and (ref[..., 3] == 255).all()
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    np.testing.assert_array_equal(got[..., :2], ref[..., :2])
    np.testing.assert_array_equal(got[..., 3], ref[..., 3])


def test_indices_stay_on_the_bands_device():
    values = band_values((8, 8))
    t = {k: xt.DataArray(torch.from_numpy(v), dims=("y", "x"))
         for k, v in values.items()}
    for name, (bands, _, _) in INDICES.items():
        out = getattr(tm, name)(*(t[b] for b in bands)).data
        assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    out = tm.true_color(t["red"], t["green"], t["blue"]).data
    assert isinstance(out, torch.Tensor) and out.dtype == torch.uint8
