"""Parity of the torch port's focal statistics with the JAX package (CPU).

The same numpy rasters go through ``xrspatial_tpu`` and ``xrspatial_torch``;
on the CPU the port runs its torch twin.  Tolerance: rtol 1e-5, atol 1e-5
(the JAX package's own bar for its focal kernels), NaN masks equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xrspatial_torch as xt
import xrspatial_tpu.convolution as jconv
import xrspatial_tpu.focal as jfocal
from xrspatial_torch import convolution as tconv
from xrspatial_torch.kernels.window import kernel_offsets, window_stats
from xrspatial_tpu.kernels.window import window_stats as jax_window_stats
from xrspatial_tpu.xrlib import DataArray as JaxDataArray

RTOL, ATOL = 1e-5, 1e-5
ALL_STATS = ("mean", "max", "min", "range", "std", "var", "sum")
KERNELS = {
    "circle_r1": tconv.circle_kernel(1, 1, 1.5),
    "circle_r2": tconv.circle_kernel(1, 1, 2.5),
    "custom_3x5": np.array([[1, 0, 1, 1, 0],
                            [0, 1, 1, 0, 1],
                            [1, 1, 0, 0, 0]], dtype=float),
}


def make_raster(with_inf: bool) -> np.ndarray:
    rng = np.random.default_rng(9)
    data = (rng.random((70, 300)) * 50).astype(np.float32)
    data[30:34, 120:135] = np.nan   # patch crossing the JAX th=32 seam
    data[31:33, 128] = np.nan       # on the tw=128 seam column
    data[60:70, 250:260] = np.nan   # all-NaN windows at the edge
    if with_inf:
        data[10, 10] = np.inf
        data[50, 200] = -np.inf
        data[0, 299] = np.inf       # corner: window partly outside
    return data


def assert_matches(got, ref, msg=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, msg
    assert np.array_equal(np.isnan(got), np.isnan(ref)), msg
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL,
                               equal_nan=True, err_msg=msg)


@pytest.mark.parametrize("with_inf", [False, True], ids=["nan", "nan_inf"])
@pytest.mark.parametrize("kname", list(KERNELS))
def test_window_stats_matches_jax(kname, with_inf):
    data = make_raster(with_inf)
    offsets = kernel_offsets(KERNELS[kname])
    ref = jax_window_stats(jnp.asarray(data), offsets, ALL_STATS)
    got = window_stats(torch.from_numpy(data), offsets, ALL_STATS)
    assert set(got) == set(ALL_STATS)
    for s in ALL_STATS:
        assert got[s].dtype == torch.float32
        assert_matches(got[s].numpy(), ref[s], s)


@pytest.mark.parametrize("stats", [ALL_STATS, ("std", "mean"), ("range",)],
                         ids=["all", "std_mean", "range"])
@pytest.mark.parametrize("kname", list(KERNELS))
def test_focal_stats_matches_jax(kname, stats):
    data = make_raster(with_inf=True)
    h, w = data.shape
    coords = {"y": np.arange(h, dtype=float)[::-1],
              "x": np.arange(w, dtype=float) * 2.0}
    attrs = {"res": (2.0, 1.0), "units": "m"}
    ja = JaxDataArray(data, dims=("y", "x"), coords=coords, attrs=attrs)
    ta = xt.DataArray(data, dims=("y", "x"), coords=coords, attrs=attrs)
    ref = jfocal.focal_stats(ja, KERNELS[kname], stats_funcs=list(stats))
    got = xt.focal_stats(ta, KERNELS[kname], stats_funcs=list(stats))
    assert isinstance(got.data, torch.Tensor)
    assert got.dims == ref.dims == ("stats", "y", "x")
    assert got.name == ref.name
    assert got.attrs == ref.attrs
    assert list(got.coords) == list(ref.coords)
    for c in ref.coords:
        np.testing.assert_array_equal(got.coords[c].values,
                                      ref.coords[c].values)
    assert_matches(got.values, ref.values)


def test_circle_kernel_r1_is_the_5_cell_plus():
    """circle_kernel(1, 1, 1.5), the main path's default footprint, keeps
    the cells within one cell size of the centre: a plus of 5 offsets, not
    the full 3x3 window, in both packages."""
    offsets = kernel_offsets(tconv.circle_kernel(1, 1, 1.5))
    assert offsets == ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))
    from xrspatial_tpu.kernels.window import kernel_offsets as jax_offsets
    assert offsets == jax_offsets(jconv.circle_kernel(1, 1, 1.5))


@pytest.mark.parametrize("build", [
    lambda m: m.circle_kernel(1, 1, 1.5),
    lambda m: m.circle_kernel(2, 1, 5),
    lambda m: m.circle_kernel(30, 30, "0.1 km"),
    lambda m: m.annulus_kernel(1, 1, 4, 2),
    lambda m: m.custom_kernel(np.ones((3, 5))),
], ids=["circle_r1", "ellipse", "circle_km", "annulus", "custom"])
def test_kernel_builders_match_jax(build):
    np.testing.assert_array_equal(build(tconv), build(jconv))


def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError as exc:
        return ("ValueError", str(exc))


@pytest.mark.parametrize("text", ["5", "2 km", "3.5 ft", "1 miles", "1 mile",
                                  "-2", "abc"])
def test_distance_parsing_matches_jax(text):
    assert (_outcome(tconv._get_distance, text)
            == _outcome(jconv._get_distance, text))


@pytest.mark.parametrize("call", [
    lambda m, a: m.focal_stats(np.ones((5, 5)), np.ones((3, 3))),
    lambda m, a: m.focal_stats(a, np.ones((3, 3)), stats_funcs=["median"]),
    lambda m, a: m.focal_stats(a, np.ones((2, 3))),
    lambda m, a: m.focal_stats(type(a)(np.ones((2, 5, 5), np.float32)),
                               np.ones((3, 3))),
], ids=["not_dataarray", "unknown_stat", "even_kernel", "3d_input"])
def test_focal_stats_errors_match_jax(call):
    data = np.ones((5, 5), np.float32)
    ja = JaxDataArray(data, dims=("y", "x"))
    ta = xt.DataArray(data, dims=("y", "x"))
    with pytest.raises(Exception) as ref:
        call(jfocal, ja)
    with pytest.raises(type(ref.value)) as got:
        call(xt, ta)
    assert str(got.value) == str(ref.value)


def test_large_footprint_is_not_ported_yet():
    big = tconv.circle_kernel(1, 1, 19)   # 1129 offsets
    a = xt.DataArray(np.ones((40, 40), np.float32), dims=("y", "x"))
    with pytest.raises(NotImplementedError, match="ROADMAP A3"):
        xt.focal_stats(a, big)


@pytest.mark.parametrize("name", ["mean", "apply", "hotspots"])
def test_unported_focal_functions_raise(name):
    from xrspatial_torch import focal
    with pytest.raises(NotImplementedError, match="ROADMAP A3"):
        getattr(focal, name)(None, None)
