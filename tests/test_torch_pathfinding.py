"""Parity of the torch port's A* search with the JAX package (CPU).

``a_star_search`` is host code in both packages: the same surface goes
through ``xrspatial_tpu`` and ``xrspatial_torch`` on both routes, the C++
library (``native/astar.cpp``, a copy of the JAX package's) and the
Python heap (``XRSPATIAL_NO_NATIVE=1``).  Paths and accumulated costs are
compared exactly (the same float64 operations in the same order); the
goldens of ``tests/test_pathfinding.py`` are checked at its rtol 1e-6.
"""

import importlib

import numpy as np
import pytest
import torch

import xrspatial_torch as xt
from xrspatial_tpu import a_star_search as jax_a_star
from xrspatial_tpu.xrlib import DataArray as JaxDataArray

TPF = importlib.import_module("xrspatial_torch.pathfinding")


@pytest.fixture(autouse=True)
def numpy_rasters_on_the_cpu():
    """These tests give numpy rasters and compare on the CPU."""
    saved = xt.default_device()
    xt.set_default_device("cpu")
    yield
    xt.set_default_device(saved)


@pytest.fixture(params=["native", "python"])
def route(request, monkeypatch):
    """Run the test on one route of both packages; yields the port's
    counter that must move."""
    if request.param == "python":
        monkeypatch.setenv("XRSPATIAL_NO_NATIVE", "1")
    else:
        from xrspatial_torch.native import get_astar
        if get_astar() is None:
            pytest.skip("g++ could not build native/astar.cpp here")
    yield request.param


def rasters(data, dims=("y", "x"), coords=None, name="s", res=(1, 1)):
    """The same surface as a DataArray of each package; `res` is (x, y),
    the y coordinates descend."""
    h, w = data.shape
    if coords is None:
        coords = {dims[0]: np.linspace((h - 1) * res[1], 0, h),
                  dims[1]: np.linspace(0, (w - 1) * res[0], w)}
    attrs = {"res": res}
    return (xt.DataArray(data, dims=dims, coords=coords, name=name,
                         attrs=attrs),
            JaxDataArray(data, dims=dims, coords=coords, name=name,
                         attrs=attrs))


def both(port, jax_agg, *args, **kw):
    """(the port's output, the JAX package's as numpy), after checking
    the route counter and the output's contract."""
    native, python = TPF.NATIVE_CALLS, TPF.PYTHON_CALLS
    out = xt.a_star_search(port, *args, **kw)
    ref = np.asarray(jax_a_star(jax_agg, *args, **kw).data)
    assert TPF.NATIVE_CALLS + TPF.PYTHON_CALLS - native - python <= 1
    assert out.data.dtype == torch.float64
    assert out.data.device.type == "cpu"
    assert out.dims == port.dims and out.name == port.name
    got = out.data.numpy()
    np.testing.assert_array_equal(got, ref)
    return got, ref


DOC_GRID = np.array([[0, 1, 0, 0],
                     [1, 1, 0, 0],
                     [0, 1, 2, 2],
                     [1, 0, 2, 0],
                     [0, 2, 2, 2]], dtype=np.float64)


def test_docstring_golden(route):
    port, jax_agg = rasters(DOC_GRID, dims=("lat", "lon"), coords={
        "lon": np.arange(4, dtype=float),
        "lat": np.arange(4, -1, -1, dtype=float)})
    before = getattr(TPF, f"{route.upper()}_CALLS")
    got, _ = both(port, jax_agg, start=(3, 0), goal=(0, 1), barriers=[0],
                  x="lon", y="lat")
    assert getattr(TPF, f"{route.upper()}_CALLS") == before + 1
    expected = np.array([
        [np.nan, np.nan, np.nan, np.nan],
        [0.0, np.nan, np.nan, np.nan],
        [np.nan, 1.41421356, np.nan, np.nan],
        [np.nan, np.nan, 2.82842712, np.nan],
        [np.nan, 4.24264069, np.nan, np.nan]])
    np.testing.assert_allclose(got, expected, equal_nan=True, rtol=1e-6)


def test_straight_path_no_path_and_connectivity(route):
    port, jax_agg = rasters(np.zeros((5, 5)))
    got, _ = both(port, jax_agg, (2.0, 0.0), (2.0, 4.0))
    np.testing.assert_allclose(got[2], [0, 1, 2, 3, 4])
    wall = np.zeros((3, 5))
    wall[:, 2] = -1
    port, jax_agg = rasters(wall)
    got, _ = both(port, jax_agg, (1.0, 0.0), (1.0, 4.0), barriers=[-1])
    assert np.isnan(got).all()
    port, jax_agg = rasters(np.zeros((3, 3)))
    out8, _ = both(port, jax_agg, (2.0, 0.0), (0.0, 2.0))
    out4, _ = both(port, jax_agg, (2.0, 0.0), (0.0, 2.0), connectivity=4)
    assert np.nanmax(out8) == pytest.approx(2 * np.sqrt(2))
    assert np.nanmax(out4) == pytest.approx(4.0)


def test_snap_and_warnings(route):
    data = np.zeros((4, 4))
    data[0, 0] = -1
    port, jax_agg = rasters(data)
    with pytest.warns(Warning, match="Start at a non crossable"):
        both(port, jax_agg, (3.0, 0.0), (0.0, 3.0), barriers=[-1])
    got, _ = both(port, jax_agg, (3.0, 0.0), (0.0, 3.0), barriers=[-1],
                  snap_start=True)
    assert np.isfinite(got).sum() > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("connectivity", [4, 8])
def test_random_surfaces_match_jax(route, seed, connectivity):
    """NaN cells and two barrier values, start and goal snapped off
    blocked cells, on both routes of both packages."""
    rng = np.random.default_rng(seed)
    data = np.floor(rng.random((37, 53)) * 6)
    data[rng.random((37, 53)) < 0.05] = np.nan
    port, jax_agg = rasters(data, res=(2.0, 0.5))
    h, w = data.shape
    start = (float((h - 1) * 0.5), 0.0)
    goal = (0.0, float((w - 1) * 2.0))
    both(port, jax_agg, start, goal, barriers=[0, 5],
         connectivity=connectivity, snap_start=True, snap_goal=True)


def test_validation_errors_match_jax():
    port, jax_agg = rasters(DOC_GRID, dims=("lat", "lon"), coords={
        "lon": np.arange(4, dtype=float),
        "lat": np.arange(4, -1, -1, dtype=float)})
    for kw in (dict(x="bogus"), dict(x="lon", y="lat", connectivity=6),
               dict(x="lon", y="lat", start=(99, 99))):
        args = dict(start=(0, 0), goal=(1, 1))
        args.update(kw)
        with pytest.raises(ValueError) as jax_err:
            jax_a_star(jax_agg, **args)
        with pytest.raises(ValueError, match=str(jax_err.value)[:20]):
            xt.a_star_search(port, **args)
    with pytest.raises(ValueError, match="2D"):
        xt.a_star_search(xt.DataArray(np.zeros(4), dims=("x",)), (0,), (1,))


def test_native_and_python_routes_agree():
    """The port's two routes: the same path and the same costs on it."""
    from xrspatial_torch.native import get_astar
    if get_astar() is None:
        pytest.skip("g++ could not build native/astar.cpp here")
    rng = np.random.default_rng(7)
    for conn in (4, 8):
        for _ in range(3):
            blocked = rng.random((37, 53)) < 0.3
            blocked[0, 0] = blocked[-1, -1] = False
            nat = TPF._astar_native(blocked, (0, 0), (36, 52), conn)
            py = TPF._astar(blocked, (0, 0), (36, 52),
                            TPF._neighborhood(conn))
            assert (nat[0] is None) == (py[0] is None)
            if nat[0] is not None:
                assert nat[0] == py[0]
                cells = np.array(nat[0])
                np.testing.assert_array_equal(
                    nat[1][cells[:, 0], cells[:, 1]],
                    py[1][cells[:, 0], cells[:, 1]])


def test_a_tensor_surface_keeps_its_device():
    data = np.zeros((6, 7))
    port, jax_agg = rasters(data)
    tensor = xt.DataArray(torch.from_numpy(data), dims=("y", "x"),
                          coords=port.coords, attrs=port.attrs, name="s")
    xt.set_default_device("meta")
    out = xt.a_star_search(tensor, (5.0, 0.0), (0.0, 6.0))
    assert out.data.device.type == "cpu"
    np.testing.assert_array_equal(
        out.data.numpy(),
        np.asarray(jax_a_star(jax_agg, (5.0, 0.0), (0.0, 6.0)).data))
