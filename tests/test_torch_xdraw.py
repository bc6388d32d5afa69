"""Parity of the torch port's XDraw viewshed with the JAX package (CPU).

The same numpy rasters, made from seeds, go through ``xrspatial_tpu`` and
``xrspatial_torch``.  On the CPU the port runs its scan twin
``kernels/viewshed.py::xdraw_scan_twin``; the CUDA kernel
``csrc/xdraw.cu`` is held to the twin bit for bit in
``tests/test_torch_cuda.py``, and here its algorithm, emulated with the
kernel's steps, lanes and writes (``kernels/emulate.py::emulate_xdraw``).

Tolerances:
- the twin's max-slope field against the JAX package's
  ``_halfplane_scan4`` plus its combine, on the JAX package's slope field:
  XLA on the CPU contracts ``prim * (1 - wsec) + sec * wsec`` into
  ``fma(prim, 1 - wsec, sec * wsec)`` and the twin rounds the product
  apart, a difference the scan carries along each ray (up to 18 ulps on
  these rasters).  So the twin with that one expression evaluated as the
  FMA (exactly, in float64, then rounded) must equal the JAX scan bit for
  bit, and the twin as it is within `SCAN_RTOL`;
- ``viewshed``: visibility equal to the JAX package's except at cells
  whose margin ``|inward_max - slope_tgt|`` is within `TIE_RTOL` of the
  target's slope (the same FMA, and 2 ulps of the slope fields, where XLA
  contracts ``wx * wx + wy * wy``): at most 0.1% of the cells, reported;
  angles of cells visible in both within `ANGLE_RTOL`; float32 out;
- the XDraw route against the exact one: agreement at least 0.985, as
  ``tests/test_viewshed.py::test_los_matches_pairwise`` pins for the JAX
  package.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xrspatial_torch as xt
from xrspatial_torch.kernels import viewshed as TV
from xrspatial_torch.kernels.emulate import emulate_xdraw, same_bits
from xrspatial_tpu.kernels import viewshed as JV
from xrspatial_tpu.xrlib import DataArray as JaxDataArray

SCAN_RTOL = 1e-5
TIE_RTOL = 1e-5
TIE_SHARE = 1e-3
ANGLE_RTOL = 1e-6

jvs = importlib.import_module("xrspatial_tpu.viewshed")
tvs = importlib.import_module("xrspatial_torch.viewshed")


@pytest.fixture(autouse=True)
def numpy_rasters_on_the_cpu():
    """These tests give numpy rasters and compare on the CPU."""
    saved = xt.default_device()
    xt.set_default_device("cpu")
    yield
    xt.set_default_device(saved)


def terrain(shape, seed, nan=3):
    """Random float32 terrain with a mesa and `nan` NaN cells."""
    rng = np.random.default_rng(seed)
    h, w = shape
    data = (rng.random(shape) * 50).astype(np.float32)
    data[h // 3:h // 3 + max(1, h // 10), w // 2:w // 2 + max(1, w // 10)] \
        += 150.0
    if nan:
        data[rng.integers(0, h, nan), rng.integers(0, w, nan)] = np.nan
    return data


# (shape, viewpoint): square, h > w, w > h, an edge, every corner, a row
# and a column
SCAN_CASES = {
    "square_mid": ((48, 48), (20, 27)),
    "tall": ((64, 40), (10, 33)),
    "wide": ((40, 64), (30, 5)),
    "top_edge": ((40, 56), (0, 30)),
    "left_edge": ((56, 40), (21, 0)),
    "corner_00": ((33, 47), (0, 0)),
    "corner_0w": ((33, 47), (0, 46)),
    "corner_h0": ((47, 33), (46, 0)),
    "corner_hw": ((47, 33), (46, 32)),
    "row": ((1, 23), (0, 7)),
    "column": ((17, 1), (9, 0)),
}


def jax_scan(data, vp):
    """The JAX package's slope field and its scan's combined field."""
    h, w = data.shape
    dy, dx, _, slope, _, dy_vec, dx_vec, _ = JV._xdraw_fields(
        jnp.asarray(data), jnp.int32(vp[0]), jnp.int32(vp[1]),
        jnp.float32(2.0), jnp.float32(0.0), jnp.float32(1.0),
        jnp.float32(-1.0), (h, w))
    m_e, m_w, m_s, m_n = JV._halfplane_scan4(
        slope, dy_vec, dx_vec, jnp.int32(vp[0]), jnp.int32(vp[1]), (h, w))
    x_dom = jnp.abs(dx) >= jnp.abs(dy)
    m = jnp.where(x_dom, jnp.where(dx >= 0, m_e, m_w),
                  jnp.where(dy >= 0, m_s, m_n))
    return np.array(slope), np.array(m)


def fma_interp(prim, sec, wsec):
    """fma(prim, 1 - wsec, sec * wsec), the expression XLA emits: the
    product and sum in float64 (exact product), rounded once to float32."""
    return (prim.double() * (1.0 - wsec).double()
            + (sec * wsec).double()).float()


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_twin_matches_jax_scan(case, monkeypatch):
    shape, vp = SCAN_CASES[case]
    slope, ref = jax_scan(terrain(shape, sum(shape)), vp)
    ref = torch.from_numpy(ref)
    got = TV.xdraw_scan_twin(torch.from_numpy(slope), *vp)
    assert got.dtype == torch.float32 and got.shape == shape
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert torch.equal(torch.isinf(got), torch.isinf(ref))
    fin = torch.isfinite(ref)
    torch.testing.assert_close(got[fin], ref[fin], rtol=SCAN_RTOL, atol=0)
    monkeypatch.setattr(TV, "_xdraw_interp", fma_interp)
    assert same_bits(TV.xdraw_scan_twin(torch.from_numpy(slope), *vp), ref)


@pytest.mark.parametrize("nan", [0, 4])
@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_kernel_emulation_equals_twin(case, nan):
    """The kernel's algorithm (steps from the viewpoint on, the cone's
    lanes, each cell written by its own octant) gives the twin's bits; a
    NaN-free raster shows that every cell is written."""
    shape, vp = SCAN_CASES[case]
    slope = TV._xdraw_fields(torch.from_numpy(terrain(shape, 7, nan)), *vp,
                             2.0, 0.0, 1.0, -1.0)[3]
    got = emulate_xdraw(slope, *vp)
    assert same_bits(got, TV.xdraw_scan_twin(slope, *vp))
    if not nan:
        assert not bool(torch.isnan(got).any())


def rasters(data, res=(1.0, 1.0)):
    """(JAX DataArray, port DataArray), y descending, x ascending."""
    h, w = data.shape
    ys = np.linspace((h - 1) * res[0], 0, h)
    xs = np.linspace(0, (w - 1) * res[1], w)
    jagg = JaxDataArray(data, dims=("y", "x"), coords={"y": ys, "x": xs},
                        attrs={"res": res})
    tagg = xt.DataArray(data.copy(), dims=("y", "x"),
                        coords={"y": ys, "x": xs}, attrs={"res": res})
    return jagg, tagg


VIEWSHED_CASES = {
    # (shape, viewpoint, observer_elev, target_elev, res (y, x))
    "square": ((64, 64), (20, 40), 2.0, 0.0, (1.0, 1.0)),
    "tall": ((96, 48), (80, 10), 5.0, 1.0, (2.0, 1.0)),
    "wide": ((48, 96), (5, 90), 0.0, 0.0, (1.0, 3.0)),
    "corner": ((64, 80), (63, 0), 10.0, 0.0, (1.0, 1.0)),
    "edge": ((80, 64), (40, 63), 3.0, 2.0, (1.0, 1.0)),
}


def port_margin(data, vp, oe, te, res):
    """|inward_max - slope_tgt| / |slope_tgt| of every cell, by the port."""
    t = torch.from_numpy(data)
    dy, dx, _, slope, slope_tgt, _ = TV._xdraw_fields(
        t, *vp, oe, te, res[1], -res[0])
    inward = TV._xdraw_inward_max(TV.xdraw_scan_twin(slope, *vp), dy, dx)
    return ((inward - slope_tgt).abs() / slope_tgt.abs()).numpy()


@pytest.mark.parametrize("route", ["exact_false", "above_ceiling"])
@pytest.mark.parametrize("case", list(VIEWSHED_CASES))
def test_viewshed_xdraw_matches_jax(case, route, monkeypatch):
    shape, vp, oe, te, res = VIEWSHED_CASES[case]
    data = terrain(shape, 3)
    jagg, tagg = rasters(data, res)
    ys, xs = np.asarray(jagg["y"].data), np.asarray(jagg["x"].data)
    exact = False
    if route == "above_ceiling":
        for mod in (jvs, tvs):
            monkeypatch.setattr(mod, "_EXACT_MAX_CELLS", data.size - 1)
        exact = None
    kw = dict(x=xs[vp[1]], y=ys[vp[0]], observer_elev=oe, target_elev=te,
              exact=exact)
    ref = np.asarray(jvs.viewshed(jagg, **kw).data)
    out = xt.viewshed(tagg, **kw)
    got = out.data.numpy()
    assert out.data.dtype == torch.float32 and got.shape == shape
    differ = (got == -1) != (ref == -1)
    margin = port_margin(data, vp, oe, te, res)
    print(f"{case} {route}: {int(differ.sum())} of {differ.size} cells "
          f"differ in visibility, largest margin there "
          f"{margin[differ].max() if differ.any() else 0.0:.3g}")
    assert differ.sum() <= TIE_SHARE * differ.size
    assert (margin[differ] <= TIE_RTOL).all()
    both = (got > -1) & (ref > -1)
    np.testing.assert_allclose(got[both], ref[both], rtol=ANGLE_RTOL, atol=0)
    assert got[vp] == 180.0 and (got[np.isnan(data)] == -1).all()


def test_xdraw_agrees_with_the_exact_predicate():
    """The mesa terrain of tests/test_viewshed.py::test_los_matches_pairwise
    through the port's two routes."""
    rng = np.random.default_rng(11)
    data = (rng.random((48, 64)) * 50).astype(np.float64)
    data[20:24, 30:34] += 200.0
    _, tagg = rasters(data)
    ys, xs = np.asarray(tagg["y"].data), np.asarray(tagg["x"].data)
    kw = dict(x=xs[10], y=ys[10], observer_elev=2.0)
    exact = xt.viewshed(tagg, exact=True, **kw).data
    los = xt.viewshed(tagg, exact=False, **kw).data
    assert exact.dtype == torch.float64 and los.dtype == torch.float32
    vis_e, vis_l = (exact > -1).numpy(), (los > -1).numpy()
    agree = (vis_e == vis_l).mean()
    assert agree > 0.985, agree
    both = vis_e & vis_l
    np.testing.assert_allclose(los.numpy()[both], exact.numpy()[both],
                               rtol=1e-4, atol=1e-3)


# -- the route on the CPU: the torch passes ----------------------------------

# observer_elev, target_elev, ew_res, ns_res (north up: negative)
CELL_GEOMETRY = (160.0, 1.5, 10.0, -7.5)


def torch_passes(data, vp):
    """The torch-op route's angles, called pass by pass: the plain
    versions of the card's kernels around the scans' twin."""
    oe, te, ew, ns = CELL_GEOMETRY
    dy, dx, safe, slope, tgt, vpe = TV._xdraw_fields(data, *vp, oe, te, ew,
                                                      ns)
    m = TV.xdraw_scan_twin(slope, *vp)
    return TV._xdraw_epilogue(m, data, dy, dx, safe, tgt, vpe, te)


def test_viewshed_on_the_cpu_takes_the_torch_passes():
    """On a CPU tensor ``viewshed(exact=False)`` runs the torch-op route:
    one count on ``xdraw.cells_torchops``, none on ``xdraw.cells_kernel``,
    and the bits of the torch passes called directly."""
    from torch.profiler import ProfilerActivity, profile

    from xrspatial_torch import tracing
    oe, te, ew, ns = CELL_GEOMETRY
    h, w = 97, 131
    data, vp = torch.from_numpy(terrain((h, w), h + w)), (48, 65)
    data[vp[0] + 1, vp[1]] = np.nan
    agg = xt.DataArray(data, dims=("y", "x"),
                       coords={"y": (h - 1 - np.arange(h)) * -ns,
                               "x": np.arange(w) * ew})
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        got = xt.viewshed(agg, x=vp[1] * ew, y=(h - 1 - vp[0]) * -ns,
                          observer_elev=oe, target_elev=te, exact=False)
    counters = tracing.counters()
    tracing.clear()
    assert counters.get("xdraw.cells_torchops") == 1
    assert "xdraw.cells_kernel" not in counters
    assert got.data.dtype == torch.float32
    assert same_bits(got.data, torch_passes(data, vp))
