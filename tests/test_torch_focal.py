"""Parity of the torch port's focal statistics with the JAX package (CPU).

The same numpy rasters go through ``xrspatial_tpu`` and ``xrspatial_torch``;
on the CPU the port runs its torch twin.  Tolerance: rtol 1e-5, atol 1e-5
(the JAX package's own bar for its focal kernels), NaN masks equal.  The
conv path of footprints of more than 1024 cells is held to the JAX suite's
own tolerances for it (``tests/test_focal.py``): mean/sum/min/max/range
rtol 1e-5 / atol 1e-4, std/var 1e-3, because the global mean it centres
on differs in its last bits between backends.  ``mean`` runs in float64
and is held to rtol 1e-12; hotspot classes are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xrspatial_torch as xt
import xrspatial_tpu.convolution as jconv
import xrspatial_tpu.focal as jfocal
import xrspatial_tpu.kernels.window as jwindow
from xrspatial_torch import convolution as tconv
from xrspatial_torch import focal as tfocal
from xrspatial_torch.kernels import window as twindow
from xrspatial_torch.kernels.window import kernel_offsets, window_stats
from xrspatial_tpu.kernels.pallas_window2 import tiled_radius_supported
from xrspatial_tpu.kernels.window import window_stats as jax_window_stats
from xrspatial_tpu.xrlib import DataArray as JaxDataArray


@pytest.fixture(autouse=True)
def numpy_rasters_on_the_cpu():
    """These tests give numpy rasters and compare on the CPU."""
    saved = xt.default_device()
    xt.set_default_device("cpu")
    yield
    xt.set_default_device(saved)


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


CONV_TOL = {"mean": dict(rtol=1e-5, atol=1e-4), "sum": dict(rtol=1e-5, atol=1e-4),
            "max": dict(rtol=1e-5, atol=1e-4), "min": dict(rtol=1e-5, atol=1e-4),
            "range": dict(rtol=1e-5, atol=1e-4), "std": dict(rtol=1e-3, atol=1e-3),
            "var": dict(rtol=1e-3, atol=1e-3)}


def test_large_footprint_is_not_ported_yet():
    """A footprint of more than 1024 cells (here 1129) takes the conv path
    and matches the JAX package's focal_stats at its conv tolerances."""
    big = tconv.circle_kernel(1, 1, 19)
    assert len(kernel_offsets(big)) == 1129
    data = make_raster(with_inf=False)[:40, :60]
    got = xt.focal_stats(xt.DataArray(data, dims=("y", "x")), big).values
    ref = jfocal.focal_stats(JaxDataArray(data, dims=("y", "x")), big).values
    for i, s in enumerate(ALL_STATS):
        np.testing.assert_allclose(got[i], ref[i], equal_nan=True,
                                   err_msg=s, **CONV_TOL[s])


@pytest.mark.parametrize("name", ["mean", "apply", "hotspots"])
def test_unported_focal_functions_raise(name):
    """mean, apply and hotspots are ported: on a raster they return what
    the JAX package's return, where they raised NotImplementedError."""
    data = make_raster(with_inf=False)[:20, :30]
    args = {"mean": (), "apply": (np.ones((3, 3)),),
            "hotspots": (np.ones((3, 3)),)}[name]
    got = getattr(tfocal, name)(xt.DataArray(data, dims=("y", "x")), *args)
    ref = getattr(jfocal, name)(JaxDataArray(data, dims=("y", "x")), *args)
    assert isinstance(got.data, torch.Tensor)
    assert got.values.dtype == ref.values.dtype
    np.testing.assert_allclose(got.values, ref.values, rtol=RTOL, atol=ATOL)


# -- routing: the JAX package's gate without its TPU-only size gates ----------

def jax_route(offsets):
    """xrspatial_tpu/focal.py::_stats_kernel_pallas's choice for a raster
    large enough for every Pallas kernel."""
    if len(offsets) > jwindow.UNROLL_MAX_OFFSETS:
        return "conv"
    ry = max(abs(dy) for dy, _ in offsets)
    rx = max(abs(dx) for _, dx in offsets)
    return "tiled" if tiled_radius_supported(ry, rx) else "halo"


def irregular_mask(shape, n_ones, seed):
    """A seeded 0/1 footprint with `n_ones` ones, one of them on the top
    row (so ry = shape[0] // 2)."""
    rng = np.random.default_rng(seed)
    mask = np.zeros(shape)
    mask.flat[rng.choice(mask.size, n_ones, replace=False)] = 1
    mask[0, shape[1] // 3] = 1
    return mask


ROUTE_CASES = {
    "plus_r1": (tconv.circle_kernel(1, 1, 1.5), "tiled"),
    "point": (np.ones((1, 1)), "tiled"),
    "row_513": (np.ones((1, 513)), "tiled"),
    "row_515": (np.ones((1, 515)), "halo"),
    "row_601": (np.ones((1, 601)), "halo"),
    "col_65": (np.ones((65, 1)), "tiled"),
    "col_67": (np.ones((67, 1)), "halo"),
    "circle_r20": (tconv.circle_kernel(1, 1, 20), "conv"),
    "circle_r18": (tconv.circle_kernel(1, 1, 18), "tiled"),
    "annulus_40_38": (tconv.annulus_kernel(1, 1, 40, 38), "halo"),
    "irregular_81x41": (irregular_mask((81, 41), 600, 3), "halo"),
    "square_33": (np.ones((33, 33)), "conv"),
    "ends_1x1025": (np.pad(np.ones((1, 1)), ((0, 0), (512, 512)),
                           constant_values=0) + np.eye(1, 1025, 0)
                    + np.eye(1, 1025, 1024), "halo"),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_route_matches_the_jax_gate(case):
    kernel, expected = ROUTE_CASES[case]
    offsets = kernel_offsets(kernel)
    assert tfocal._route(offsets) == jax_route(offsets) == expected


def test_tiled_radius_supported_matches_jax():
    for ry in range(0, 40, 3):
        for rx in range(0, 300, 17):
            assert (twindow.tiled_radius_supported(ry, rx)
                    == tiled_radius_supported(ry, rx)), (ry, rx)


# -- footprints the halo kernel takes on the card: the twin against JAX -------

def halo_raster():
    rng = np.random.default_rng(19)
    data = (rng.random((90, 700)) * 50).astype(np.float32)
    data[20:35, 300:340] = np.nan
    data[70:90, 0:25] = np.nan       # all-NaN windows at the edge
    data[45, 650] = np.inf
    data[5, 10] = -np.inf
    return data


@pytest.mark.parametrize("kname", ["annulus_40_38", "row_601", "col_67"])
def test_halo_footprints_match_jax(kname):
    data = halo_raster()
    offsets = kernel_offsets(ROUTE_CASES[kname][0])
    ref = jax_window_stats(jnp.asarray(data), offsets, ALL_STATS)
    got = window_stats(torch.from_numpy(data), offsets, ALL_STATS)
    for s in ALL_STATS:
        assert_matches(got[s].numpy(), ref[s], s)


# -- the conv path (more than 1024 offsets) -----------------------------------

def conv_raster(shape, seed):
    rng = np.random.default_rng(seed)
    data = (rng.random(shape) * 50).astype(np.float32)
    data[5, 7] = np.nan
    data[shape[0] - 8:, :6] = np.nan
    return data


@pytest.mark.parametrize("case", ["annulus_capped", "circle_r20"])
def test_conv_path_matches_jax(case, monkeypatch):
    if case == "annulus_capped":
        data = conv_raster((40, 60), 21)
        offsets = kernel_offsets(tconv.annulus_kernel(1, 1, 5.5, 2.0))
        monkeypatch.setattr(twindow, "UNROLL_MAX_OFFSETS", 4)
    else:
        data = conv_raster((64, 80), 22)
        offsets = kernel_offsets(tconv.circle_kernel(1, 1, 20))
    got = window_stats(torch.from_numpy(data), offsets, ALL_STATS)
    ref = jwindow._window_stats_conv(jnp.asarray(data), offsets, ALL_STATS)
    for s in ALL_STATS:
        g, r = got[s].numpy(), np.asarray(ref[s])
        assert np.array_equal(np.isnan(g), np.isnan(r)), s
        np.testing.assert_allclose(g, r, equal_nan=True, err_msg=s,
                                   **CONV_TOL[s])


def test_conv_path_all_nan_sum_is_zero():
    data = torch.full((8, 9), np.nan)
    offsets = kernel_offsets(tconv.circle_kernel(1, 1, 2))
    out = twindow._window_stats_conv(data, offsets, ("sum", "mean", "max"))
    assert bool((out["sum"] == 0).all())
    assert bool(out["mean"].isnan().all()) and bool(out["max"].isnan().all())


def test_conv_path_runs_conv2d_in_full_fp32(monkeypatch):
    """Every F.conv2d of the conv path runs with cuDNN on and its TF32
    switched off, whatever the global flags say, and the flags come back
    afterwards."""
    cudnn = torch.backends.cudnn
    new_api = hasattr(cudnn, "conv") and hasattr(cudnn.conv,
                                                 "fp32_precision")

    def tf32_allowed():
        return (cudnn.conv.fp32_precision == "tf32") if new_api \
            else cudnn.allow_tf32

    seen = []
    conv2d = torch.nn.functional.conv2d

    def recording(*args, **kwargs):
        seen.append((cudnn.enabled, tf32_allowed()))
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv2d", recording)
    before = tf32_allowed()
    assert before, "PyTorch's default allows TF32 in cuDNN convolutions"
    data = torch.from_numpy(conv_raster((64, 80), 22))
    window_stats(data, kernel_offsets(tconv.circle_kernel(1, 1, 20)),
                 ("mean", "std"))
    tconv.convolve_2d(data, np.ones((3, 3)))
    assert seen == [(True, False)] * 4
    assert tf32_allowed() == before


# -- mean, apply, hotspots ----------------------------------------------------

def mean_raster(dtype):
    rng = np.random.default_rng(31)
    data = (rng.random((23, 31)) * 100).astype(dtype)
    if np.issubdtype(dtype, np.floating):
        data[4:7, 10:14] = np.nan
        data[0, 0] = -999.0
        data[12, 20] = -999.0
    return data


@pytest.mark.parametrize("passes,excludes,dtype", [
    (1, [np.nan], np.float32),
    (3, [np.nan], np.float32),
    (2, [-999.0, np.nan], np.float32),
    (1, [-999.0], np.float64),
    (2, [np.nan], np.int32),
], ids=["one_pass", "three_passes", "excludes", "f64_exclude_value",
        "int32_truncates"])
def test_mean_matches_jax(passes, excludes, dtype):
    data = mean_raster(dtype)
    got = xt.mean(xt.DataArray(data, dims=("y", "x")), passes=passes,
                  excludes=excludes)
    ref = jfocal.mean(JaxDataArray(data, dims=("y", "x")), passes=passes,
                      excludes=excludes)
    assert got.name == ref.name == "mean"
    assert got.values.dtype == ref.values.dtype == dtype
    np.testing.assert_allclose(got.values, ref.values, rtol=1e-12,
                               equal_nan=True)


@pytest.mark.parametrize("func", ["mean", "sum", "min", "max", "std", "var",
                                  "range", "python_callable"])
def test_apply_matches_jax(func):
    data = make_raster(with_inf=False)[:30, :50]
    kernel = tconv.circle_kernel(1, 1, 2.5)
    if func == "python_callable":
        def tfn(buf):
            return np.nanmean(buf > 25)
        jfn = tfn
    else:
        tfn = getattr(tfocal, f"_calc_{func}")
        jfn = getattr(jfocal, f"_calc_{func}")
    got = tfocal.apply(xt.DataArray(data, dims=("y", "x")), kernel, tfn)
    ref = jfocal.apply(JaxDataArray(data, dims=("y", "x")), kernel, jfn)
    assert got.name == ref.name == "focal_apply"
    assert isinstance(got.data, torch.Tensor)
    assert got.data.dtype == torch.float32
    assert_matches(got.values, ref.values, func)


def test_apply_errors_match_jax():
    data = np.ones((5, 5), np.float32)
    for call in (lambda m, a: m.apply("nope", np.ones((3, 3))),
                 lambda m, a: m.apply(a, np.ones((2, 2)))):
        with pytest.raises(Exception) as ref:
            call(jfocal, JaxDataArray(data, dims=("y", "x")))
        with pytest.raises(type(ref.value)):
            call(tfocal, xt.DataArray(data, dims=("y", "x")))


def test_hotspots_docstring_golden():
    kernel = tconv.custom_kernel(np.array([[1, 1, 0]]))
    data = np.array([[0, 1000, 1000, 0, 0, 0],
                     [0, 0, 0, -1000, -1000, 0],
                     [0, -900, -900, 0, 0, 0],
                     [0, 100, 1000, 0, 0, 0]], dtype=float)
    out = tfocal.hotspots(xt.DataArray(data, dims=("y", "x")), kernel)
    expected = np.array([[0, 0, 95, 0, 0, 0],
                         [0, 0, 0, 0, -90, 0],
                         [0, 0, -90, 0, 0, 0],
                         [0, 0, 0, 0, 0, 0]], dtype=np.int8)
    np.testing.assert_array_equal(out.values, expected)
    assert out.data.dtype == torch.int8
    assert out.attrs.get("unit") == "%"


@pytest.mark.parametrize("kname", ["circle_r1", "circle_r2", "custom_3x5"])
def test_hotspots_matches_jax(kname):
    rng = np.random.default_rng(41)
    data = (rng.normal(size=(40, 50)) * 10).astype(np.float32)
    data[10:14, 20:30] += 40.0     # a hot spot
    data[30:33, 5:12] -= 40.0      # a cold spot
    data[2, 3] = np.nan
    attrs = {"res": (1.0, 1.0), "crs": "EPSG:32633"}
    got = tfocal.hotspots(xt.DataArray(data, dims=("y", "x"), attrs=attrs),
                          KERNELS[kname])
    ref = jfocal.hotspots(JaxDataArray(data, dims=("y", "x"), attrs=attrs),
                          KERNELS[kname])
    assert got.attrs == ref.attrs and got.attrs["unit"] == "%"
    assert attrs == {"res": (1.0, 1.0), "crs": "EPSG:32633"}
    assert got.values.dtype == ref.values.dtype == np.int8
    np.testing.assert_array_equal(got.values, ref.values)
    assert set(np.unique(got.values)) >= {0, 99, -99}


@pytest.mark.parametrize("data", [np.ones((4, 4)), np.full((4, 4), 7, np.int32)],
                         ids=["float", "int"])
def test_hotspots_zero_std_raises(data):
    with pytest.raises(ZeroDivisionError):
        tfocal.hotspots(xt.DataArray(data, dims=("y", "x")), np.ones((3, 3)))
