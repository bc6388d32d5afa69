"""Parity of the torch port's diagnostics and unit heuristics with the JAX
package (CPU).

The same rasters go through ``xrspatial_tpu`` and ``xrspatial_torch``:
``diagnose`` (the report's text, issues and inferred fields),
``warn_if_unit_mismatch`` (the same warnings) and the sampled min/max
behind them, on numpy and tensor payloads.  Everything is compared
exactly: the heuristics are host code on the same values.
"""

import warnings

import numpy as np
import pytest
import torch

import xrspatial_torch as xt
from xrspatial_torch import diagnostics as TDG
from xrspatial_torch import utils as TU
from xrspatial_tpu import diagnose as jax_diagnose
from xrspatial_tpu import utils as JU
from xrspatial_tpu.xrlib import DataArray as JaxDataArray


def case(name):
    """(data, coords, attrs, coord attrs) of one raster."""
    rng = np.random.default_rng(len(name))
    elev = (rng.random((40, 50)) * 900 + 100).astype(np.float32)
    deg = {"y": np.linspace(45.0, 44.9, 40), "x": np.linspace(7.0, 7.1, 50)}
    metres = {"y": np.linspace(5000.0, 0.0, 40),
              "x": np.linspace(0.0, 6000.0, 50)}
    if name == "degrees_elevation":
        return elev, deg, {}, {}
    if name == "degrees_elevation_res":
        return elev, deg, {"res": (0.002, 0.0025)}, {}
    if name == "metres_elevation":
        return elev, metres, {}, {}
    if name == "degree_units_angles":
        return (rng.random((40, 50)) * 80).astype(np.float32), deg, \
            {"units": "degrees"}, {"units": "degree"}
    if name == "linear_units_attr":
        return elev, deg, {"units": "m"}, {"units": "m"}
    if name == "nan_patch":
        data = elev.copy()
        data[:20] = np.nan
        return data, deg, {}, {}
    if name == "all_nan":
        return np.full((40, 50), np.nan, np.float32), deg, {}, {}
    if name == "big_raster_windows":
        data = (rng.random((700, 300)) * 15000).astype(np.float32)
        return data, {"y": np.linspace(45.0, 44.3, 700),
                      "x": np.linspace(7.0, 7.3, 300)}, {}, {}
    raise KeyError(name)


CASES = ["degrees_elevation", "degrees_elevation_res", "metres_elevation",
         "degree_units_angles", "linear_units_attr", "nan_patch", "all_nan",
         "big_raster_windows"]


def rasters(name, tensor):
    data, coords, attrs, cattrs = case(name)
    jax_agg = JaxDataArray(data, dims=("y", "x"), coords=coords,
                           attrs=dict(attrs))
    port = xt.DataArray(torch.from_numpy(data) if tensor else data,
                        dims=("y", "x"), coords=coords, attrs=dict(attrs))
    for c in ("x", "y"):
        jax_agg[c].attrs.update(cattrs)
        port[c].attrs.update(cattrs)
    return port, jax_agg


@pytest.mark.parametrize("tensor", [False, True])
@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("tool", [None, "slope", "zonal_stats"])
def test_diagnose_matches_jax(name, tensor, tool):
    port, jax_agg = rasters(name, tensor)
    got, ref = xt.diagnose(port, tool=tool), jax_diagnose(jax_agg, tool=tool)
    assert str(got) == str(ref)
    assert [vars(i) for i in got.issues] == [vars(i) for i in ref.issues]
    for f in ("horizontal_unit_type", "vertical_unit_type", "resolution",
              "has_issues", "has_warnings", "has_errors"):
        assert getattr(got, f) == getattr(ref, f), f


def test_diagnose_reports_a_mismatch():
    port, _ = rasters("degrees_elevation", True)
    report = xt.diagnose(port)
    assert report.has_warnings and not report.has_errors
    assert report.issues[0].code == "UNIT_MISMATCH"
    assert str(report).startswith("[WARNING] UNIT_MISMATCH: ")
    assert str(TDG.DiagnosticReport()) == "No issues detected."


@pytest.mark.parametrize("tensor", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_warn_if_unit_mismatch_matches_jax(name, tensor):
    port, jax_agg = rasters(name, tensor)
    with warnings.catch_warnings(record=True) as ref:
        warnings.simplefilter("always")
        JU.warn_if_unit_mismatch(jax_agg)
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        TU.warn_if_unit_mismatch(port)
    assert [(w.category, str(w.message)) for w in got] == \
        [(w.category, str(w.message)) for w in ref]


@pytest.mark.parametrize("shape", [(0,), (7,), (300, 700), (3, 100, 400)])
def test_sampled_min_max_matches_jax(shape):
    rng = np.random.default_rng(5)
    data = (rng.random(shape) * 1000 - 300).astype(np.float32)
    if data.size > 10:
        data.reshape(-1)[::97] = np.nan
    ref = JU._sample_windows_min_max(data)
    for payload in (data, torch.from_numpy(data)):
        got = TU._sample_windows_min_max(payload)
        np.testing.assert_array_equal(np.array(got), np.array(ref))


def test_sampled_min_max_reads_only_its_windows():
    """Five windows of 65536 cells move to the host, never the whole
    tensor: a tensor whose `.cpu()` refuses anything larger shows it."""

    class Guarded(torch.Tensor):
        def cpu(self, *a, **kw):
            assert self.numel() <= 65536, self.numel()
            return super().cpu(*a, **kw)

    data = torch.rand(700, 1000).as_subclass(Guarded)
    vmin, vmax = TU._sample_windows_min_max(data)
    assert 0 <= vmin <= vmax <= 1


@pytest.mark.parametrize("coord", [np.linspace(7.0, 7.1, 50),
                                   np.linspace(0.0, 6000.0, 50),
                                   np.array([1.0]), np.array(["a", "b"])])
@pytest.mark.parametrize("cellsize", [0.002, 120.0, 1e-7])
def test_coord_unit_type_matches_jax(coord, cellsize):
    port = xt.DataArray(np.zeros(coord.shape), dims=("x",),
                        coords={"x": coord})
    jax_agg = JaxDataArray(np.zeros(coord.shape), dims=("x",),
                           coords={"x": coord})
    assert TU._infer_coord_unit_type(port["x"], cellsize) == \
        JU._infer_coord_unit_type(jax_agg["x"], cellsize)
