"""Parity of the torch port's zonal functions with the JAX package (CPU).

The same numpy rasters, made from seeds, go through ``xrspatial_tpu.zonal``
and ``xrspatial_torch.zonal``; the JAX package runs its CPU path (the
sorted segment reduction, host majority and unique).

Tolerances, per statistic:
- count, min, max, majority, custom functions, the zone column, crosstab
  counts and percentages, regions, trim and crop: equal;
- mean and sum: rtol 1e-6 (both round a float64 sum to float32, summed
  in another order);
- var and std: rtol 1e-5 / atol 1e-6 against a float64 numpy oracle.
  Against the JAX package the atol is its own rounding: it squares each
  float32 value in float32 before its float64 prefix sums, an error up to
  half an ulp of v**2 a cell, so var gets atol ``2**-23 * max(v**2)``
  and std the square root of that (a one-cell zone reads std ~8e-4 there,
  0 here).
"""

import importlib

import numpy as np
import pandas as pd
import pytest
import torch

import xrspatial_torch as xt
from xrspatial_torch import zonal as TZ
from xrspatial_tpu.xrlib import DataArray as JaxDataArray
from xrspatial_tpu.xrlib import Dataset as JaxDataset

JZ = importlib.import_module("xrspatial_tpu.zonal")
DEFAULT = ["mean", "max", "min", "sum", "std", "var", "count"]


@pytest.fixture(autouse=True)
def numpy_rasters_on_the_cpu():
    """These tests give numpy rasters and compare on the CPU."""
    saved = xt.default_device()
    xt.set_default_device("cpu")
    yield
    xt.set_default_device(saved)


def pair(data, dims=("y", "x"), name=None, coords=None):
    """(JAX DataArray, port DataArray) of the same numpy data, with
    tests/general_checks.py's coordinates for 2-D data."""
    if coords is None and len(dims) == 2:
        h, w = data.shape[-2:]
        coords = {dims[0]: np.linspace((h - 1) * 0.5, 0, h),
                  dims[1]: np.linspace(0, (w - 1) * 0.5, w)}
    attrs = {"res": (0.5, 0.5)}
    return (JaxDataArray(data.copy(), dims=dims, name=name, coords=coords,
                         attrs=attrs),
            xt.DataArray(data.copy(), dims=dims, name=name, coords=coords,
                         attrs=attrs))


def oracle(zones, values, nodata=None):
    """Float64 per-zone loop: {stat: [...]} over the finite zones."""
    out = {k: [] for k in ["zone"] + DEFAULT}
    v32 = values.astype(np.float32)
    for z in np.unique(zones[np.isfinite(zones)]):
        sel = (zones == z) & np.isfinite(v32)
        if nodata is not None:
            sel &= v32 != np.float32(nodata)
        vals = v32[sel].astype(np.float64)
        out["zone"].append(z)
        stats = (dict(mean=vals.mean(), max=vals.max(), min=vals.min(),
                      sum=vals.sum(), std=vals.std(), var=vals.var(),
                      count=len(vals)) if len(vals)
                 else dict.fromkeys(DEFAULT, np.nan))
        for k in DEFAULT:
            out[k].append(stats[k])
    return {k: np.asarray(v) for k, v in out.items()}


def assert_stats(got, ref, values, exact_ref=False, stat=None):
    """Column by column, with the module docstring's tolerances: each
    column's own, or `stat`'s for every column (crosstab's categories)."""
    np.testing.assert_array_equal(got["zone"], ref["zone"])
    assert got["zone"].dtype == np.asarray(ref["zone"]).dtype
    v2 = float(np.nanmax(np.where(np.isfinite(values), values, 0.0)
                         .astype(np.float32).astype(np.float64) ** 2))
    var_atol = 1e-6 if exact_ref else max(1e-6, 2.0 ** -23 * v2)
    tol = {"mean": (1e-6, 0), "sum": (1e-6, 0), "var": (1e-5, var_atol),
           "std": (1e-5, max(1e-6, np.sqrt(var_atol)))}
    for c in got.columns if hasattr(got, "columns") else got:
        if c == "zone":
            continue
        g, r = np.asarray(got[c], np.float64), np.asarray(ref[c], np.float64)
        s = stat or c
        if s in tol:
            np.testing.assert_allclose(g, r, rtol=tol[s][0], atol=tol[s][1],
                                       err_msg=str(c))
        else:
            np.testing.assert_array_equal(g, r, err_msg=str(c))


def quadrants():
    """Reference docstring setup (zonal.py:540-560): quadrant zones over
    values 0..99 -> means 22/27/72/77, std 14.21267, count 25 each."""
    zones = np.zeros((10, 10), dtype=np.int64)
    zones[:5, 5:] = 10
    zones[5:, :5] = 20
    zones[5:, 5:] = 30
    return zones, np.arange(100, dtype=np.float64).reshape(10, 10)


def random_case(seed, zone_dtype, nzones, shape=(48, 64), nan_zone=False):
    rng = np.random.default_rng(seed)
    zones = rng.integers(0, nzones, shape).astype(zone_dtype)
    values = (rng.random(shape) * 100 - 20).astype(np.float32)
    values[5:9, 10:20] = np.nan
    values[rng.integers(0, shape[0], 30), rng.integers(0, shape[1], 30)] = \
        np.round(values[0, 0])
    if nan_zone:     # every value of zone 3 NaN
        values[zones == 3] = np.nan
    return zones, values


def stats_case(name):
    """(zones, values, nodata) of each stats case."""
    if name == "quadrants":
        return (*quadrants(), None)
    if name == "int32_nodata":
        z, v = random_case(1, np.int32, 9)
        return z, v, float(np.round(v[0, 0]))
    if name == "all_nan_zone":
        return (*random_case(2, np.int16, 6, nan_zone=True), None)
    if name == "float_zones":
        z, v = random_case(3, np.float64, 7)
        z = z * 0.25 - 1.0
        z[0, :] = np.nan
        z[1, :3] = np.inf
        return z, v, None
    if name == "int64_beyond_int32":
        z, v = random_case(4, np.int64, 5)
        return z + 2 ** 31, v, None
    if name == "int64_across_2_31":
        z, v = random_case(4, np.int64, 5)
        return z + 2 ** 31 - 2, v, None
    if name == "wide_int_range":    # not a dense range: the unique path
        z, v = random_case(5, np.int64, 4)
        return z * 100000, v, None
    if name == "large_mean_low_spread":
        rng = np.random.default_rng(6)
        z = rng.integers(0, 3, (64, 64)).astype(np.int32)
        return z, (1000.0 + rng.random((64, 64)) * 0.01).astype(
            np.float32), None
    raise KeyError(name)


STATS_CASES = ["quadrants", "int32_nodata", "all_nan_zone", "float_zones",
               "int64_beyond_int32", "wide_int_range",
               "large_mean_low_spread"]


@pytest.mark.parametrize("case", STATS_CASES)
def test_stats_default_matches_jax(case):
    zones, values, nodata = stats_case(case)
    jz, tz = pair(zones)
    jv, tv = pair(values)
    got = xt.zonal_stats(tz, tv, stats_funcs=DEFAULT, nodata_values=nodata)
    ref = JZ.stats(jz, jv, stats_funcs=DEFAULT, nodata_values=nodata)
    assert isinstance(got, pd.DataFrame)
    assert list(got.columns) == list(ref.columns)
    assert_stats(got, ref, values)
    assert_stats(got, oracle(zones, values, nodata), values, exact_ref=True)


def test_stats_int64_zones_across_2_31():
    """Zones on both sides of 2**31: exact here.  The JAX package's CPU
    path uploads the zones as int32 (x64 off), which wraps the ids above
    2**31 below those under it, so its segments miss and every statistic
    is NaN (ROADMAP queue C); the port is held to the float64 oracle."""
    zones, values, _ = stats_case("int64_across_2_31")
    _, tz = pair(zones)
    _, tv = pair(values)
    got = xt.zonal_stats(tz, tv, stats_funcs=DEFAULT)
    assert_stats(got, oracle(zones, values), values, exact_ref=True)
    assert not got[DEFAULT].isna().any().any()


def test_stats_docstring_golden():
    zones, values = quadrants()
    _, tz = pair(zones)
    _, tv = pair(values)
    df = xt.zonal_stats(tz, tv)
    np.testing.assert_array_equal(df["zone"], [0, 10, 20, 30])
    np.testing.assert_allclose(df["mean"], [22.0, 27.0, 72.0, 77.0])
    np.testing.assert_allclose(df["max"], [44, 49, 94, 99])
    np.testing.assert_allclose(df["min"], [0, 5, 50, 55])
    np.testing.assert_allclose(df["sum"], [550, 675, 1800, 1925])
    np.testing.assert_allclose(df["std"], [14.21267] * 4, rtol=1e-5)
    np.testing.assert_allclose(df["var"], [202.0] * 4, rtol=1e-5)
    np.testing.assert_allclose(df["count"], [25] * 4)
    np.testing.assert_array_equal(df["majority"], [0, 5, 50, 55])


MAJORITY_CASES = {
    # ties: the smallest tied value (reference test_zonal.py:567-590)
    "ties": (np.array([[1, 1, 1, 1], [1, 1, 2, 2], [2, 2, 2, 2]],
                      dtype=np.int64),
             np.array([[1, 1, 2, 2], [3, 3, 5, 5], [5, 5, 6, 6]],
                      dtype=np.float64), None),
    "quantised": (*random_case(7, np.int32, 5), None),
    "nodata": (*random_case(8, np.int32, 5), 3.0),
    "float_zones": stats_case("float_zones"),
    "int_values": (np.tile(np.arange(6) % 3, (5, 1)).astype(np.int64),
                   (np.arange(30).reshape(5, 6) % 4).astype(np.int32), 0),
}


@pytest.mark.parametrize("case", list(MAJORITY_CASES))
def test_majority_matches_jax(case):
    zones, values, nodata = MAJORITY_CASES[case]
    if case in ("quantised", "nodata"):
        values = np.round(values / 10)
    jz, tz = pair(zones)
    jv, tv = pair(values)
    got = xt.zonal_stats(tz, tv, stats_funcs=["majority"],
                         nodata_values=nodata)
    ref = JZ.stats(jz, jv, stats_funcs=["majority"], nodata_values=nodata)
    np.testing.assert_array_equal(got["zone"], ref["zone"])
    np.testing.assert_array_equal(got["majority"], ref["majority"])
    assert got["majority"].dtype == np.float64


def test_custom_funcs_match_jax():
    zones, values, _ = stats_case("int32_nodata")
    jz, tz = pair(zones)
    jv, tv = pair(values)
    funcs = {"double_sum": lambda v: v.sum() * 2, "p90": lambda v:
             np.percentile(v, 90), "n": len}
    for zone_ids, nodata in ((None, None), ([2, 5, 7, 99], 3.0)):
        got = xt.zonal_stats(tz, tv, zone_ids=zone_ids, stats_funcs=funcs,
                             nodata_values=nodata)
        ref = JZ.stats(jz, jv, zone_ids=zone_ids, stats_funcs=funcs,
                       nodata_values=nodata)
        assert list(got.columns) == list(ref.columns)
        for c in got.columns:
            np.testing.assert_array_equal(got[c], ref[c])


@pytest.mark.parametrize("zone_ids", [[10, 30], [30, 10, 10, 77], [77]])
def test_zone_ids_match_jax(zone_ids):
    zones, values = quadrants()
    jz, tz = pair(zones)
    jv, tv = pair(values)
    got = xt.zonal_stats(tz, tv, zone_ids=zone_ids)
    ref = JZ.stats(jz, jv, zone_ids=zone_ids)
    assert_stats(got, ref, values)


@pytest.mark.parametrize("case", ["quadrants", "float_zones",
                                  "int32_nodata"])
def test_dataarray_return_matches_jax(case):
    zones, values, nodata = stats_case(case)
    jz, tz = pair(zones)
    jv, tv = pair(values)
    kw = dict(zone_ids=None if case != "quadrants" else [0, 30],
              stats_funcs=["mean", "count", "majority", "max"],
              nodata_values=nodata, return_type="xarray.DataArray")
    got = xt.zonal_stats(tz, tv, **kw)
    ref = JZ.stats(jz, jv, **kw)
    assert isinstance(got, xt.DataArray) and isinstance(got.data,
                                                        torch.Tensor)
    assert got.dims == ref.dims == ("stats", "y", "x")
    assert got.data.dtype == torch.float32
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    assert list(got.coords["stats"].data) == list(ref.coords["stats"].data)
    np.testing.assert_array_equal(got.coords["x"].data, ref.coords["x"].data)
    assert got.attrs == ref.attrs


def test_dataset_merge_matches_jax():
    zones, values = quadrants()
    jz, tz = pair(zones)
    other = values[::-1].copy() * 0.5
    jds = JaxDataset({"a": pair(values)[0], "b": pair(other)[0]})
    tds = xt.Dataset({"a": pair(values)[1], "b": pair(other)[1]})
    got = xt.zonal_stats(tz, tds, stats_funcs=["mean", "max", "count"])
    ref = JZ.stats(jz, jds, stats_funcs=["mean", "max", "count"])
    assert list(got.columns) == list(ref.columns)
    assert_stats(got, ref, values)
    with pytest.raises(ValueError, match="return_type"):
        xt.zonal_stats(tz, tds, return_type="xarray.DataArray")


def test_stats_validation_matches_jax():
    zones, values = quadrants()
    for args, kw in (((zones, values), dict(stats_funcs=["bogus"])),
                     ((zones, np.zeros((3, 3))), {}),
                     ((zones, values), dict(stats_funcs="mean")),
                     ((zones.astype(bool), values), {})):
        for mod, k in ((JZ.stats, 0), (xt.zonal_stats, 1)):
            rz, rv = pair(args[0])[k], pair(args[1])[k]
            with pytest.raises(ValueError):
                mod(rz, rv, **kw)


def test_stats_inputs_unmodified():
    zones = np.array([[1, 1, 2], [2, 2, 2]], dtype=np.int64)
    values = np.array([[1.0, np.nan, 3.0], [4.0, 5.0, 6.0]])
    _, tz = pair(zones)
    _, tv = pair(values)
    xt.zonal_stats(tz, tv)
    np.testing.assert_array_equal(tz.values, zones)
    np.testing.assert_array_equal(tv.values, values)


def test_dense_and_unique_segments_agree():
    """An integer zone range within _DENSE_MAX_BINS takes the dense path;
    the same zones spread wider take torch.unique: the same segments."""
    rng = np.random.default_rng(9)
    z = torch.from_numpy(rng.integers(-40, 40, 3000).astype(np.int32))
    u_dense, s_dense = TZ._zone_segments(z)
    u_uniq = torch.unique(z)
    assert torch.equal(u_dense, u_uniq) and u_dense.dtype == z.dtype
    assert torch.equal(s_dense, TZ._segment_ids(z, u_uniq))


# -- crosstab ---------------------------------------------------------------

def crosstab_case(name):
    """(zones, values, nodata) of each 2-D crosstab case."""
    rng = np.random.default_rng(len(name))
    zones = rng.integers(0, 5, (40, 52)).astype(np.int64)
    if name == "float_cats":
        v = np.round(rng.random((40, 52)) * 6) * 0.5
        v[3:7, 2:9] = np.nan
        return zones, v, None
    if name == "float32_nodata":
        v = np.floor(rng.random((40, 52)) * 8).astype(np.float32)
        return zones, v, 3.0
    if name == "int_cats":
        return zones, rng.integers(-3, 9, (40, 52)).astype(np.int32), 5
    if name == "int_beyond_f32":    # codes above 2^24 collide in float32
        a, b = 100000000, 100000004
        return zones, rng.choice([a, b, a + 1], (40, 52)).astype(np.int64), \
            None
    if name == "float_zones":
        z = zones * 1.5
        z[0, :4] = np.nan
        return z, rng.integers(0, 4, (40, 52)).astype(np.float32), None
    raise KeyError(name)


CROSSTAB_CASES = ["float_cats", "float32_nodata", "int_cats",
                  "int_beyond_f32", "float_zones"]


def assert_frames_equal(got, ref):
    assert isinstance(got, pd.DataFrame)
    assert list(got.columns) == list(ref.columns)
    for c in got.columns:
        np.testing.assert_array_equal(np.asarray(got[c]), np.asarray(ref[c]),
                                      err_msg=str(c))
        assert got[c].dtype == ref[c].dtype, c


@pytest.mark.parametrize("agg", ["count", "percentage"])
@pytest.mark.parametrize("case", CROSSTAB_CASES)
def test_crosstab_2d_matches_jax(case, agg):
    zones, values, nodata = crosstab_case(case)
    jz, tz = pair(zones)
    jv, tv = pair(values)
    for zone_ids, cat_ids in ((None, None), ([1, 3, 9], None),
                              (None, "subset")):
        if cat_ids == "subset":
            cats = np.unique(values[np.isfinite(values)])
            cat_ids = list(cats[::2]) + [12345]
        kw = dict(zone_ids=zone_ids, cat_ids=cat_ids, agg=agg,
                  nodata_values=nodata)
        assert_frames_equal(xt.zonal_crosstab(tz, tv, **kw),
                            JZ.crosstab(jz, jv, **kw))


def test_crosstab_int_categories_beyond_f32_stay_apart():
    zones, values, _ = crosstab_case("int_beyond_f32")
    _, tz = pair(zones)
    _, tv = pair(values)
    df = xt.zonal_crosstab(tz, tv)
    assert list(df.columns) == ["zone", 100000000, 100000001, 100000004]
    for c in df.columns[1:]:
        np.testing.assert_array_equal(
            df[c], [((zones == z) & (values == c)).sum() for z in range(5)])


def cube_case():
    rng = np.random.default_rng(12)
    zones = rng.integers(0, 4, (24, 30)).astype(np.int32)
    cube = (rng.random((3, 24, 30)) * 10).astype(np.float32)
    cube[1, zones == 2] = np.nan    # an empty zone in one layer
    cube[2, :3, :] = np.nan
    return zones, cube


@pytest.mark.parametrize("agg", ["min", "max", "mean", "sum", "std", "var",
                                 "count"])
def test_crosstab_3d_matches_jax(agg):
    zones, cube = cube_case()
    jz, tz = pair(zones)
    for layer, data, dims in ((0, cube, ("cat", "y", "x")),
                              (2, np.moveaxis(cube, 0, 2), ("y", "x", "cat"))):
        coords = {"cat": np.array([10, 20, 30])}
        jv, tv = pair(data, dims=dims, coords=coords)
        for cat_ids, zone_ids in ((None, None), ([30, 10, 99], [0, 2])):
            kw = dict(zone_ids=zone_ids, cat_ids=cat_ids, layer=layer,
                      agg=agg)
            got = xt.zonal_crosstab(tz, tv, **kw)
            ref = JZ.crosstab(jz, jv, **kw)
            assert list(got.columns) == list(ref.columns)
            assert_stats(got, ref, cube, stat=agg)


def test_crosstab_validation_matches_jax():
    zones, values = quadrants()
    cases = [((zones, values), dict(agg="sum")),
             ((zones, np.zeros((3, 3))), {}),
             ((zones, np.zeros((2, 3, 4, 5))), {}),
             ((zones, np.zeros((2, 10, 10))), dict(agg="percentage")),
             ((zones, np.zeros((2, 10, 10))), dict(layer=5))]
    for (z, v), kw in cases:
        dims = ("y", "x") if v.ndim == 2 else tuple("abcd"[:v.ndim])
        coords = None if v.ndim == 2 else {}
        for fn, k in ((JZ.crosstab, 0), (xt.zonal_crosstab, 1)):
            rz = pair(z)[k]
            rv = pair(v, dims=dims, coords=coords)[k]
            with pytest.raises(ValueError):
                fn(rz, rv, **kw)


# -- apply --------------------------------------------------------------------

@pytest.mark.parametrize("ndim", [2, 3])
def test_apply_in_place_matches_jax(ndim):
    zones = np.array([[1, 1, 0, 2], [0, 2, 1, 2]], dtype=np.int64)
    values = np.array([[2., -1., 5., 3.], [3., np.nan, 20., 10.]])
    dims = ("y", "x")
    if ndim == 3:
        values = np.stack([values, values * 2, -values], axis=-1)
        dims = ("y", "x", "band")
    for func in (lambda x: 0 * x, lambda x: x ** 2 + 1.5,
                 lambda x: float(x) if x > 2 else -1.0):
        jz, tz = pair(zones)
        jv, tv = pair(values, dims=dims, coords={})
        before = tv.data
        JZ.apply(jz, jv, func)
        assert xt.zonal_apply(tz, tv, func) is None
        assert isinstance(tv.data, torch.Tensor) and tv.data is not before
        np.testing.assert_array_equal(tv.values, np.asarray(jv.data))
    # the documented golden
    jz, tz = pair(zones)
    _, tv = pair(values if ndim == 2 else values[..., 0])
    xt.zonal_apply(tz, tv, lambda x: 0 * x)
    np.testing.assert_array_equal(
        tv.values, [[0., 0., 5., 0.], [3., np.nan, 0., 0.]])


def test_apply_errors_match_jax():
    z2, v2 = np.zeros((2, 2), np.int64), np.zeros((2, 2), np.float32)

    def da(k, a, dims=("y", "x")):
        return pair(a, dims=dims, coords={})[k]

    cases = [
        (TypeError, "zones must be instance", lambda k: (z2, da(k, v2))),
        (TypeError, "values must be instance", lambda k: (da(k, z2), v2)),
        (ValueError, "zones must be 2D", lambda k: (
            da(k, np.zeros((2, 2, 2), np.int64), ("y", "x", "b")),
            da(k, v2))),
        (ValueError, "either 2D or 3D", lambda k: (
            da(k, z2), da(k, np.zeros(4, np.float32), ("y",)))),
        (ValueError, "Incompatible shapes", lambda k: (
            da(k, z2), da(k, np.zeros((3, 2), np.float32)))),
        (ValueError, "array of integers$", lambda k: (
            da(k, z2.astype(np.float32)), da(k, v2))),
        (ValueError, "integers or float", lambda k: (
            da(k, z2), da(k, v2.astype(bool)))),
    ]
    for exc, msg, args in cases:
        for fn, k in ((JZ.apply, 0), (xt.zonal_apply, 1)):
            with pytest.raises(exc, match=msg):
                fn(*args(k), lambda x: x)


# -- regions ------------------------------------------------------------------

def asymmetric_pairs(n, seed):
    """n float32 pairs (c, b), c < b, where b takes c's label (|c - b| <=
    1e-8 + 1e-5 |b|) and c does not take b's (the same test with |c|
    fails): the connectivity test is not symmetric."""
    f32 = np.float32
    rng = np.random.default_rng(seed)
    c = (rng.random(400_000) * 900 + 10).astype(f32)
    rhs_c = f32(1e-8) + f32(1e-5) * c
    b = (c + rhs_c).astype(f32)
    for _ in range(3):
        b = np.where(b - c <= rhs_c, np.nextafter(b, f32(np.inf)), b)
    asym = (b - c > rhs_c) & (b - c <= f32(1e-8) + f32(1e-5) * b)
    return c[asym][:n], b[asym][:n]


def connected(c, nb):
    """The JAX package's float32 connectivity test, cell c to nb."""
    return np.abs(nb - c) <= (np.float32(1e-8) + np.float32(1e-5) * np.abs(c))


def near_tolerance_raster(shape, seed):
    """Quantised values, asymmetric near-tolerance pairs placed side by
    side and one above the other, NaN cells, and a long snake of equal
    cells."""
    rng = np.random.default_rng(seed)
    h, w = shape
    data = np.round(rng.random(shape) * 3).astype(np.float32) * 100.0 + 50.0
    snake = np.zeros(shape, dtype=bool)
    for r in range(1, h - 1, 4):
        snake[r, 1:w - 1] = True
        c = w - 2 if (r // 4) % 2 == 0 else 1
        snake[r:r + 4, c] = True
    data[snake] = 7.0
    cs, bs = asymmetric_pairs(h * w // 16, seed)
    for i, (c, b) in enumerate(zip(cs, bs)):
        r, col = rng.integers(0, h - 1), rng.integers(0, w - 1)
        if i % 2:
            data[r, col:col + 2] = (c, b) if i % 4 == 1 else (b, c)
        else:
            data[r:r + 2, col] = (c, b) if i % 4 == 0 else (b, c)
    data[rng.integers(0, h, 6), rng.integers(0, w, 6)] = np.nan
    # the raster holds pairs connected one way only
    one_way = connected(data[:, :-1], data[:, 1:]) != connected(
        data[:, 1:], data[:, :-1])
    assert one_way.sum() >= 4
    return data


@pytest.mark.parametrize("neighborhood", [4, 8])
@pytest.mark.parametrize("shape", [(40, 56), (33, 17), (64, 64)])
def test_regions_match_jax(shape, neighborhood):
    data = near_tolerance_raster(shape, sum(shape))
    jr, tr = pair(data)
    got = xt.regions(tr, neighborhood=neighborhood)
    ref = JZ.regions(jr, neighborhood=neighborhood)
    assert got.data.dtype == torch.float32
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    assert got.name == "regions" and got.dims == ref.dims


@pytest.mark.parametrize("neighborhood", [4, 8])
def test_regions_labels_and_steps(neighborhood):
    """The labels before renumbering equal the JAX package's fixpoint;
    the 64x64 snake (about 1000 cells long), which the plain propagation
    crosses one cell a step, takes the pointer jump far fewer steps."""
    data = near_tolerance_raster((64, 64), 128)
    labels, steps = TZ._label_propagate(torch.from_numpy(data),
                                        neighborhood == 8)
    ref = np.asarray(JZ._label_propagate(data, neighborhood == 8))
    np.testing.assert_array_equal(labels.numpy(), ref)
    assert labels.dtype == torch.int32
    assert steps < 200, steps


def test_regions_goldens():
    data = np.array([[1, 1, 0, 0], [1, 0, 0, 2], [0, 0, 2, 2], [3, 0, 2, 2]],
                    dtype=np.float32)
    out = xt.regions(pair(data)[1]).data.numpy()
    np.testing.assert_array_equal(out, [[1, 1, 2, 2], [1, 2, 2, 3],
                                        [2, 2, 3, 3], [4, 2, 3, 3]])
    diag = pair(np.array([[1, 0], [0, 1]], dtype=np.float32))[1]
    assert xt.regions(diag, 4).data[1, 1] != 1
    assert xt.regions(diag, 8).data[1, 1] == 1
    with pytest.raises(ValueError):
        xt.regions(diag, neighborhood=6)


# -- trim, crop, canvas -------------------------------------------------------

TRIM_CASES = {
    "zeros": (np.pad(np.array([[4, 0, 3], [4, 4, 3], [1, 1, 3]]), 2)
              .astype(np.int64), (0,)),
    "two_values": (np.pad(np.arange(12.0).reshape(3, 4) + 1, 1,
                          constant_values=9.0), (9.0, 0.0)),
    "nan_edges_kept": (np.pad(np.ones((3, 3), np.float32), 1,
                              constant_values=np.nan), (np.nan,)),
    "all_trimmed": (np.zeros((4, 5)), (0,)),
    "nothing": (np.arange(20).reshape(4, 5), (-1,)),
}


@pytest.mark.parametrize("case", list(TRIM_CASES))
def test_trim_matches_jax(case):
    data, values = TRIM_CASES[case]
    jr, tr = pair(data)
    got = xt.trim(tr, values=values)
    ref = JZ.trim(jr, values=values)
    assert got.shape == ref.shape and got.name == "trim"
    np.testing.assert_array_equal(got.values, np.asarray(ref.data))
    for d in ("y", "x"):
        np.testing.assert_array_equal(got[d].data, ref[d].data)


CROP_CASES = {
    "one_zone": (np.pad(np.full((2, 2), 5), 1).astype(np.int64), (5,)),
    "two_zones": (np.array([[0, 0, 0, 0, 0], [0, 3, 0, 0, 0],
                            [0, 0, 0, 7, 0], [0, 0, 0, 0, 0]]), (7, 3)),
    "float_zones": (np.array([[np.nan, 1.5], [2.5, np.nan]]), (2.5,)),
    "absent": (np.zeros((4, 5), np.int64), (9,)),
    "everything": (np.pad(np.ones((2, 3), np.int64), 1), (0,)),
}


@pytest.mark.parametrize("case", list(CROP_CASES))
def test_crop_matches_jax(case):
    zones, ids = CROP_CASES[case]
    values = np.arange(zones.size, dtype=np.float64).reshape(zones.shape)
    jz, tz = pair(zones)
    jv, tv = pair(values)
    got = xt.crop(tz, tv, zones_ids=ids)
    ref = JZ.crop(jz, jv, zones_ids=ids)
    assert got.shape == ref.shape and got.name == "crop"
    np.testing.assert_array_equal(got.values, np.asarray(ref.data))


@pytest.mark.parametrize("args", [
    (8e9, (-20e6, 20e6), (-20e6, 20e6), "Mercator", 20),
    (1e6, (-1e6, 3e6), (2e5, 9e5), "Mercator", 25),
    (0.5, (-10, 30), (5, 55), "Geographic", 25),
    (2.0, (0, 180), (-90, 0), "Geographic", 100)])
def test_suggest_zonal_canvas_matches_jax(args):
    area, xr, yr, crs, mp = args
    got = xt.suggest_zonal_canvas(smallest_area=area, x_range=xr, y_range=yr,
                                  crs=crs, min_pixels=mp)
    assert got == JZ.suggest_zonal_canvas(smallest_area=area, x_range=xr,
                                          y_range=yr, crs=crs, min_pixels=mp)


def test_suggest_zonal_canvas_goldens():
    h, w = xt.suggest_zonal_canvas(smallest_area=8e9, min_pixels=20,
                                   x_range=(-20e6, 20e6),
                                   y_range=(-20e6, 20e6), crs="Mercator")
    assert (h, w) == (2000, 2000)
    assert TZ.get_full_extent("Geographic") == ((-180, 180), (-90, 90))
    assert TZ.get_full_extent("Mercator") == ((-20e6, 20e6), (-20e6, 20e6))
