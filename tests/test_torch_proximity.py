"""Parity of the torch port's proximity family with the JAX package (CPU).

The same numpy rasters go through ``xrspatial_tpu`` and ``xrspatial_torch``.
On the CPU the JAX package runs its XLA scan rounds (or its Manhattan
scans) and the port its torch twins: the packed-state twin for exactly
affine axes, the coordinate-state twin otherwise.

Tolerances, the JAX suite's own bars (``tests/test_proximity.py``):
- distances rtol 1e-5 / atol 1e-5 for EUCLIDEAN and MANHATTAN, rtol 1e-4
  for GREAT_CIRCLE; NaN masks equal;
- allocation equal at every cell, direction at rtol 1e-5, for EUCLIDEAN
  and MANHATTAN: both packages take the same candidate order, so they pick
  the same target at ties;
- GREAT_CIRCLE allocation and direction may differ only where the two
  packages' targets are equidistant within rtol 1e-4 (their trig differs by
  an ulp, which can turn a near-tie).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xrspatial_torch as xt
from xrspatial_torch.kernels import jfa as tjfa
from xrspatial_torch.kernels import jfa_rounds
from xrspatial_torch.kernels.emulate import GC_RTOL, TOL, axes, layout
from xrspatial_tpu.kernels import jfa as jjfa
from xrspatial_tpu.xrlib import DataArray as JaxDataArray
from xrspatial_tpu.xrlib import Dataset as JaxDataset


@pytest.fixture(autouse=True)
def numpy_rasters_on_the_cpu():
    """These tests give numpy rasters and compare on the CPU."""
    saved = xt.default_device()
    xt.set_default_device("cpu")
    yield
    xt.set_default_device(saved)


# the modules, not the functions of the same name the packages export
jprox = importlib.import_module("xrspatial_tpu.proximity")
tprox = importlib.import_module("xrspatial_torch.proximity")

FUNCS = ("proximity", "allocation", "direction")


# name -> (shape, target density, seed, axes kind)
CASES = {
    "fixture_8x6": ((8, 6), None, None, "affine_desc"),
    "rand_64x80_desc": ((64, 80), 0.03, 1, "affine_desc"),
    "rand_129x257_asc": ((129, 257), 0.01, 2, "affine_asc"),
    "rand_64x80_nonaffine": ((64, 80), 0.03, 3, "nonaffine"),
    "rand_33x47_nonmonotone": ((33, 47), 0.05, 4, "nonmonotone"),
    "no_targets_16x20": ((16, 20), 0.0, 5, "affine_desc"),
}
GC_CASES = {
    "gc_64x80": ((64, 80), 0.02, 6, "lonlat"),
    "gc_129x257": ((129, 257), 0.003, 7, "lonlat"),
}


def make_case(name, request):
    shape, density, seed, kind = {**CASES, **GC_CASES}[name]
    if density is None:
        data = request.getfixturevalue("raster")   # tests/conftest.py
    else:
        data = layout(shape, density, seed)
    ys, xs = axes(kind, *shape, seed=seed or 0)
    return data, np.ascontiguousarray(xs), np.ascontiguousarray(ys)


def both_rasters(data, xs, ys, name="prox"):
    coords = {"y": ys, "x": xs}
    attrs = {"res": (1.0, 1.0), "units": "m"}
    return (JaxDataArray(data, dims=("y", "x"), coords=coords, name=name,
                         attrs=attrs),
            xt.DataArray(data, dims=("y", "x"), coords=coords, name=name,
                         attrs=attrs))


def assert_same_layout(got, ref):
    assert isinstance(got.data, torch.Tensor)
    assert got.data.dtype == torch.float32
    assert got.dims == ref.dims
    assert got.attrs == ref.attrs
    assert got.name == ref.name
    for c in ref.coords:
        np.testing.assert_array_equal(got.coords[c].values,
                                      ref.coords[c].values)


def assert_planar_match(func, got, ref):
    """The EUCLIDEAN/MANHATTAN bar of the module docstring."""
    assert np.array_equal(np.isnan(got), np.isnan(ref)), func
    if func == "allocation":
        np.testing.assert_array_equal(got, ref, err_msg=func)
    elif func == "direction":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0,
                                   equal_nan=True, err_msg=func)
    else:
        np.testing.assert_allclose(got, ref, equal_nan=True, err_msg=func,
                                   **TOL)


def haversine(x1, x2, y1, y2):
    """float64 great-circle distance, the scalar helper's formula."""
    lat1, lon1, lat2, lon2 = map(np.radians, (y1, x1, y2, x2))
    a = (np.sin((lat2 - lat1) / 2.0) ** 2
         + np.cos(lat1) * np.cos(lat2) * np.sin((lon2 - lon1) / 2.0) ** 2)
    return 6378137.0 * 2 * np.arcsin(np.sqrt(a))


def targets_both(data, xs, ys, metric):
    """Each package's jump-flood (dist, tx, ty) on the same mask."""
    mask = (data != 0) & np.isfinite(data)
    ref = jjfa.jump_flood(jnp.asarray(mask), jnp.asarray(xs, jnp.float32),
                          jnp.asarray(ys, jnp.float32), metric)
    got = tjfa.jump_flood(torch.from_numpy(mask),
                          torch.from_numpy(xs.astype(np.float32)),
                          torch.from_numpy(ys.astype(np.float32)), metric)
    return ([np.asarray(a) for a in ref[:3]],
            [a.numpy() for a in got[:3]])


@pytest.mark.parametrize("func", FUNCS)
@pytest.mark.parametrize("metric", ["EUCLIDEAN", "MANHATTAN"])
@pytest.mark.parametrize("case", list(CASES))
def test_public_function_matches_jax(case, metric, func, request):
    data, xs, ys = make_case(case, request)
    ja, ta = both_rasters(data, xs, ys)
    ref = getattr(jprox, func)(ja, distance_metric=metric)
    got = getattr(xt, func)(ta, distance_metric=metric)
    assert_same_layout(got, ref)
    assert_planar_match(func, got.values, np.asarray(ref.values))


@pytest.mark.parametrize("func", FUNCS)
@pytest.mark.parametrize("case", list(GC_CASES))
def test_great_circle_matches_jax(case, func, request):
    data, xs, ys = make_case(case, request)
    ja, ta = both_rasters(data, xs, ys)
    ref_da = getattr(jprox, func)(ja, distance_metric="GREAT_CIRCLE")
    got_da = getattr(xt, func)(ta, distance_metric="GREAT_CIRCLE")
    assert_same_layout(got_da, ref_da)
    got, ref = got_da.values, np.asarray(ref_da.values)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    (dj, txj, tyj), (dt, txt, tyt) = targets_both(data, xs, ys, 1)
    np.testing.assert_allclose(dt, dj, rtol=GC_RTOL)
    # where the packages chose different targets, both are nearest
    other = (txj != txt) | (tyj != tyt)
    cy, cx = np.nonzero(other)
    np.testing.assert_allclose(
        haversine(xs[cx], txt[other], ys[cy], tyt[other]),
        haversine(xs[cx], txj[other], ys[cy], tyj[other]), rtol=GC_RTOL)
    if func == "proximity":
        np.testing.assert_allclose(got, ref, rtol=GC_RTOL, equal_nan=True)
    else:
        close = np.isclose(got, ref, rtol=1e-5, atol=0, equal_nan=True)
        assert not (~close & ~other).any(), func


OPTIONS = {
    "target_values": dict(target_values=[3, 7]),
    "max_distance": dict(max_distance=4.0),
    "both": dict(target_values=[5], max_distance=6.5),
    "values_absent": dict(target_values=[42]),
}


@pytest.mark.parametrize("func", FUNCS)
@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("metric", ["EUCLIDEAN", "MANHATTAN"])
def test_options_match_jax(metric, option, func):
    data = layout((40, 52), 0.05, 11)
    ys, xs = axes("affine_desc", 40, 52)
    ja, ta = both_rasters(data, xs, ys)
    kw = dict(OPTIONS[option], distance_metric=metric)
    ref = getattr(jprox, func)(ja, **kw)
    got = getattr(xt, func)(ta, **kw)
    assert_same_layout(got, ref)
    assert_planar_match(func, got.values, np.asarray(ref.values))


def test_dataset_input_maps_each_variable():
    a = layout((20, 24), 0.05, 12)
    b = layout((20, 24), 0.08, 13)
    ys, xs = axes("affine_desc", 20, 24)
    coords = {"y": ys, "x": xs}

    def ds(cls_da, cls_ds):
        return cls_ds({k: cls_da(v, dims=("y", "x"), coords=coords)
                       for k, v in (("a", a), ("b", b))},
                      attrs={"source": "test"})

    ref = jprox.allocation(ds(JaxDataArray, JaxDataset))
    got = xt.allocation(ds(xt.DataArray, xt.Dataset))
    assert got.attrs == ref.attrs
    assert list(got.data_vars) == list(ref.data_vars) == ["a", "b"]
    for k in ("a", "b"):
        np.testing.assert_array_equal(got[k].values, np.asarray(ref[k].values))


@pytest.mark.parametrize("kind,twin", [
    ("affine_desc", "round_packed"), ("affine_asc", "round_packed"),
    ("nonaffine", "round_coords"), ("nonmonotone", "round_coords"),
    ("lonlat", "round_coords")])
def test_cpu_path_takes_the_expected_twin(kind, twin, monkeypatch):
    """Affine axes run the packed twin, any other axes (and great circle)
    the coordinate twin: the CPU tests exercise both."""
    calls = {"round_packed": 0, "round_coords": 0}
    for name in calls:
        real = getattr(jfa_rounds, name)

        def spy(*args, _real=real, _name=name):
            calls[_name] += 1
            return _real(*args)
        monkeypatch.setattr(jfa_rounds, name, spy)
    data = layout((20, 30), 0.05, 14)
    ys, xs = axes(kind, 20, 30)
    metric = "GREAT_CIRCLE" if kind == "lonlat" else "EUCLIDEAN"
    _, ta = both_rasters(data, np.ascontiguousarray(xs),
                         np.ascontiguousarray(ys))
    xt.proximity(ta, distance_metric=metric)
    rounds = len(tjfa._stride_schedule(30))
    assert calls == {n: rounds if n == twin else 0 for n in calls}


# -- errors ------------------------------------------------------------------

@pytest.mark.parametrize("call", [
    lambda m, a: m.proximity(a, x="lon", y="lat"),
    lambda m, a: m.direction(a, x="y", y="x"),
], ids=["dims_named_otherwise", "dims_swapped"])
def test_dims_check_matches_jax(call):
    data = layout((6, 7), 0.2, 16)
    ja, ta = both_rasters(data, *reversed(axes("affine_desc", 6, 7)))
    with pytest.raises(ValueError) as ref:
        call(jprox, ja)
    with pytest.raises(ValueError) as got:
        call(xt, ta)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("bad", ["x", "y"])
def test_great_circle_range_check_matches_jax(bad):
    data = layout((6, 7), 0.2, 17)
    ys, xs = axes("lonlat", 6, 7)
    if bad == "x":
        xs = xs * 2.0
    else:
        ys = ys * 2.0
    ja, ta = both_rasters(data, xs, ys)
    with pytest.raises(ValueError) as ref:
        jprox.proximity(ja, distance_metric="GREAT_CIRCLE")
    with pytest.raises(ValueError) as got:
        xt.proximity(ta, distance_metric="GREAT_CIRCLE")
    assert str(got.value) == str(ref.value)


def test_scalar_distances_match_jax():
    for fn in ("euclidean_distance", "manhattan_distance",
               "great_circle_distance"):
        args = (123.2, 178.0, 82.32, 65.09)
        assert getattr(tprox, fn)(*args) == getattr(jprox, fn)(*args)
    with pytest.raises(ValueError):
        tprox.great_circle_distance(200, 0, 0, 0)
