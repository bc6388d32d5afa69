"""Parity of the torch port's convolution with the JAX package (CPU).

``convolve_2d`` and ``convolution_2d`` on the same numpy rasters through
``xrspatial_tpu`` and ``xrspatial_torch``: a cross-correlation (un-flipped
kernel) with a NaN ring of the kernel radius, NaNs inside not skipped.
Tolerance rtol 1e-5, atol 1e-5 (float32 sums in another order), NaN masks
equal.  The kernels' weights are positive, so no cancellation makes a
relative tolerance meaningless.

A raster smaller than its kernel (ROADMAP C3): ``convolve_2d``,
``convolution_2d`` and ``hotspots`` give the input-shaped all-NaN plane
(int8 zeros for ``hotspots``), exactly the JAX package's result where its
shape is the input's (k - 1 cells a side); below that the JAX package's
result is larger than its input and all NaN / zeros, and the port keeps
the input's shape.
"""

import numpy as np
import pytest
import torch

import xrspatial_torch as xt
import xrspatial_tpu.convolution as jconv
import xrspatial_tpu.focal as jfocal
from xrspatial_torch import convolution as tconv
from xrspatial_torch import focal as tfocal
from xrspatial_tpu.xrlib import DataArray as JaxDataArray


@pytest.fixture(autouse=True)
def numpy_rasters_on_the_cpu():
    """These tests give numpy rasters and compare on the CPU."""
    saved = xt.default_device()
    xt.set_default_device("cpu")
    yield
    xt.set_default_device(saved)


TOL = dict(rtol=1e-5, atol=1e-5)

KERNELS = {
    "ones_3x3": np.ones((3, 3)),
    "plus_r1": tconv.circle_kernel(1, 1, 1.5),
    "weighted_5x5": np.outer([1, 4, 6, 4, 1], [1, 4, 6, 4, 1]) / 256.0,
    "rows_3x7": np.arange(1, 22, dtype=float).reshape(3, 7) / 21.0,
    "col_5x1": np.array([[1.0], [2.0], [3.0], [2.0], [1.0]]) / 9.0,
}


def raster(with_nan):
    rng = np.random.default_rng(17)
    data = (rng.random((37, 53)) * 200 - 50).astype(np.float32)
    if with_nan:
        data[10:13, 20:26] = np.nan
        data[0, 5] = np.nan           # inside the ring: stays NaN
        data[30, 50] = np.nan
    return data


def assert_matches(got, ref, msg=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, msg
    assert np.array_equal(np.isnan(got), np.isnan(ref)), msg
    np.testing.assert_allclose(got, ref, equal_nan=True, err_msg=msg, **TOL)


@pytest.mark.parametrize("with_nan", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("kname", list(KERNELS))
def test_convolve_2d_matches_jax(kname, with_nan):
    data = raster(with_nan)
    kernel = KERNELS[kname]
    ref = np.asarray(jconv.convolve_2d(data, kernel))
    got = tconv.convolve_2d(data, kernel)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert_matches(got.numpy(), ref, kname)
    ry, rx = kernel.shape[0] // 2, kernel.shape[1] // 2
    ring = np.ones(data.shape, bool)
    ring[ry:data.shape[0] - ry, rx:data.shape[1] - rx] = False
    assert np.isnan(got.numpy()[ring]).all()


def test_convolve_2d_propagates_nan_without_skipping():
    data = raster(with_nan=False)
    data[15, 15] = np.nan
    got = tconv.convolve_2d(torch.from_numpy(data), np.ones((3, 3))).numpy()
    window = np.zeros(data.shape, bool)
    window[14:17, 14:17] = True
    assert np.isnan(got[window]).all()
    assert not np.isnan(got[1:-1, 1:-1][~window[1:-1, 1:-1]]).any()


@pytest.mark.parametrize("kname", ["ones_3x3", "weighted_5x5", "rows_3x7"])
def test_convolution_2d_matches_jax(kname):
    data = raster(with_nan=True)
    h, w = data.shape
    coords = {"y": np.arange(h, dtype=float)[::-1],
              "x": np.arange(w, dtype=float) * 0.5}
    attrs = {"res": (0.5, 1.0), "crs": "EPSG:5070"}
    ja = JaxDataArray(data, dims=("y", "x"), coords=coords, attrs=attrs,
                      name="r")
    ta = xt.DataArray(data, dims=("y", "x"), coords=coords, attrs=attrs,
                      name="r")
    ref = jconv.convolution_2d(ja, KERNELS[kname])
    got = tconv.convolution_2d(ta, KERNELS[kname], name="conv")
    assert got.name == "conv" and ref.name == "convolution_2d"
    assert got.dims == ref.dims and got.attrs == ref.attrs
    for c in ref.coords:
        np.testing.assert_array_equal(got.coords[c].values,
                                      ref.coords[c].values)
    assert_matches(got.values, ref.values, kname)


def test_convolution_2d_refuses_an_even_kernel_as_jax_does():
    data = np.ones((6, 6), np.float32)
    with pytest.raises(ValueError) as ref:
        jconv.convolution_2d(JaxDataArray(data, dims=("y", "x")),
                             np.ones((2, 3)))
    with pytest.raises(ValueError) as got:
        tconv.convolution_2d(xt.DataArray(data, dims=("y", "x")),
                             np.ones((2, 3)))
    assert str(got.value) == str(ref.value)


# (raster shape, kernel): k - 1 cells a side, where the JAX package's result
# has the input's shape, and below it
SMALLER_THAN_KERNEL = {
    "10x10_circle11": ((10, 10), tconv.circle_kernel(1, 1, 5)),
    "2x9_ones3": ((2, 9), np.ones((3, 3))),
    "8x4_ones3x5": ((8, 4), np.ones((3, 5))),
    "1x9_ones3": ((1, 9), np.ones((3, 3))),
    "40x50_ones51": ((40, 50), np.ones((51, 51))),
}


def small_call(func, pkg, data, kernel):
    """`func` of the port ("torch") or the JAX package on `data`, as a
    numpy array."""
    if pkg == "torch":
        conv, foc, da = tconv, tfocal, xt.DataArray
    else:
        conv, foc, da = jconv, jfocal, JaxDataArray
    if func == "convolve_2d":
        return np.asarray(conv.convolve_2d(data, kernel))
    agg = da(data, dims=("y", "x"), attrs={"res": (1.0, 1.0)})
    if func == "convolution_2d":
        return np.asarray(conv.convolution_2d(agg, kernel).values)
    return np.asarray(foc.hotspots(agg, kernel).values)


@pytest.mark.parametrize("func", ["convolve_2d", "convolution_2d",
                                  "hotspots"])
@pytest.mark.parametrize("case", list(SMALLER_THAN_KERNEL))
def test_a_raster_smaller_than_its_kernel(case, func):
    shape, kernel = SMALLER_THAN_KERNEL[case]
    rng = np.random.default_rng(31)
    data = (rng.random(shape) * 100).astype(np.float32)
    got = small_call(func, "torch", data, kernel)
    ref = small_call(func, "jax", data, kernel)
    assert got.shape == shape
    if func == "hotspots":
        assert got.dtype == ref.dtype == np.int8
        assert not got.any() and not ref.any()
    else:
        assert got.dtype == np.float32
        assert np.isnan(got).all() and np.isnan(ref).all()
    exact = all(n >= k - 1 for n, k in zip(shape, kernel.shape))
    if exact:
        # the JAX result has the input's shape: equal, NaN mask and classes
        assert ref.shape == shape
        np.testing.assert_array_equal(got, ref)
    else:
        assert ref.shape == tuple(max(n, k - 1)
                                  for n, k in zip(shape, kernel.shape))
