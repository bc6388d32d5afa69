"""The XDraw viewshed on a mesh: X1's strip route and its twin (CPU).

The JAX package's banded distributed scan (``_xdraw_banded_pass``) splits
each half-plane's lanes over the flattened mesh; the port runs the same
scans on strips of lanes with a one-sided halo of L lanes toward the
viewpoint, L steps a window (``kernels/viewshed.py::
xdraw_mesh_max_slope``).  Meshes of ``torch.device("cpu")`` repeated
(2x2, 1x4, 4x2) stand for the cards; on the CPU each window of each strip
runs the strip twin ``xdraw_strip_twin``, and the kernel's algorithm,
``kernels/emulate.py::emulate_xdraw_strip``, stands in for the launch
where a test says so.

Tolerances:
- the strip twin over a whole plane (``strip_scans``' east and west
  fields on row strips) with its
  interpolation evaluated as XLA's FMA (exactly, in float64, then
  rounded) equals ``_xdraw_banded_pass`` bit for bit, NaN where NaN; as
  it is, within rtol 1e-5 (``tests/test_torch_xdraw.py``'s `SCAN_RTOL`);
- the mesh viewshed equals the port's unsharded ``viewshed`` bit for bit
  at every step window L, strips narrower than L included, the viewpoint
  at the centre, at a corner and on a strip's edge lane;
- against the JAX package's ``viewshed`` on its 2x2 mesh of virtual CPU
  devices (``viewshed_grid_los_sharded_banded``): visibility equal but at
  near-tie cells, at most 0.1% of the cells, angles within rtol 1e-6, as
  ``tests/test_torch_xdraw.py::test_viewshed_xdraw_matches_jax`` allows.
"""

import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xrspatial_torch as xt
from xrspatial_torch.kernels import cuda_xdraw, emulate
from xrspatial_torch.kernels import viewshed as TV
from xrspatial_torch.kernels.emulate import same_bits
from xrspatial_torch.parallel import (distribute, get_raster_mesh,
                                      make_raster_mesh)
from xrspatial_torch.parallel import halo as thalo
from xrspatial_tpu.kernels import viewshed as JV

CPU = torch.device("cpu")
SCAN_RTOL = 1e-5
TIE_SHARE = 1e-3
ANGLE_RTOL = 1e-6

jvs = importlib.import_module("xrspatial_tpu.viewshed")


@pytest.fixture(autouse=True)
def numpy_rasters_on_the_cpu():
    saved = xt.default_device()
    xt.set_default_device("cpu")
    yield
    xt.set_default_device(saved)


def cpu_mesh(ny, nx):
    return make_raster_mesh(ny, nx, devices=[CPU] * (ny * nx))


def split(t, mesh):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # a replicated axis
        return distribute(t, mesh)


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


def fma_interp(prim, sec, wsec):
    """fma(prim, 1 - wsec, sec * wsec), the expression XLA emits."""
    return (prim.double() * (1.0 - wsec).double()
            + (sec * wsec).double()).float()


# -- the strip layouts and the plan ------------------------------------------------

@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("mesh_shape,shape", [((2, 2), (13, 17)),
                                              ((1, 4), (40, 48)),
                                              ((2, 4), (5, 9))])
def test_strips_hold_their_lanes_and_halos(mesh_shape, shape, axis):
    """Each strip holds its own lanes and its halos, the fill beyond the
    raster (a short or empty last strip), and the blocks come back."""
    x = torch.from_numpy(terrain(shape, 1, nan=0))
    mesh = cpu_mesh(*mesh_shape)
    parts = mesh.size
    n = shape[axis]
    s = -(-n // parts)
    halos = [(min(3, p * s), 2 if p < parts - 1 else 0)
             for p in range(parts)]
    strips = thalo.to_strips(split(x, mesh), axis, halos, float("-inf"))
    for p, (lo, hi) in enumerate(halos):
        want = torch.full((s + lo + hi,) + (shape[1 - axis],), float("-inf"))
        for k in range(s + lo + hi):
            g = p * s - lo + k
            if 0 <= g < n:
                want[k] = x[g] if axis == 0 else x[:, g]
        got = strips[p] if axis == 0 else strips[p].t()
        assert torch.equal(got, want), p
        assert strips[p].device == thalo.flat_devices(mesh)[p]
    back = thalo.from_strips(strips, split(x, mesh), axis,
                             [lo for lo, _ in halos])
    assert torch.equal(back.gather(), x)


def test_strip_halos_reach_toward_the_viewpoint_only():
    # 4 strips of 10 lanes, the viewpoint's lane 25
    assert TV.strip_halos(40, 4, 25, 4) == [(0, 4), (0, 4), (0, 0), (4, 0)]
    # cut at the viewpoint's lane; strips narrower than L
    assert TV.strip_halos(40, 4, 25, 100) == [(0, 16), (0, 6), (0, 0),
                                              (5, 0)]
    # strips of 3 lanes and an empty last one; the viewpoint on the first
    # lane of strip 1, then on the last lane of strip 0
    assert TV.strip_halos(9, 4, 3, 8) == [(0, 1), (0, 0), (3, 0), (0, 0)]
    assert TV.strip_halos(9, 4, 2, 8) == [(0, 0), (1, 0), (4, 0), (0, 0)]


def test_strip_plan():
    """L lanes of halo on the widest strip, the band rule of xdraw_plan,
    slots for a window's chunks; a given band and chunk taken as they
    are; a window shorter than a chunk."""
    p = TV.xdraw_strip_plan(16384, 16384, 16283, 100, 4, 132, steps=1024)
    assert p.steps == 1024 and p.chunk == 32
    assert p.slots == 1024 // 32 + 1
    # 4 strips of 4096 lanes; strips 0-2 reach 1024 lanes toward the
    # viewpoint's row, the viewpoint's column lies in strip 0
    assert p.blocks == 2 * -(-5120 // p.band) + 2 * -(-5120 // p.band)
    assert p.blocks <= 132 * p.per_sm
    q = TV.xdraw_strip_plan(300, 70, 3, 3, 4, 132, steps=5, band=8, chunk=4)
    assert (q.band, q.chunk, q.slots) == (8, 4, 3)
    with pytest.raises(ValueError):
        TV.xdraw_strip_plan(300, 70, 3, 3, 4, steps=0)


# -- the strip twin against the JAX package's banded pass --------------------------

PASS_CASES = {
    # (plane shape (lanes, steps), viewpoint (minor, major), devices)
    "square_4": ((40, 40), (17, 22), 4),
    "tall_8": ((64, 24), (63, 3), 8),
    "wide_edge_2": ((21, 50), (10, 49), 2),
}


@pytest.fixture(scope="module")
def jax_passes():
    """The JAX package's (forward, reverse) fields of each case, one
    compile a case."""
    from jax.sharding import Mesh
    out = {}
    for name, ((n, s), (vmin, vmaj), nd) in PASS_CASES.items():
        plane = jnp.asarray(TV._xdraw_fields(
            torch.from_numpy(terrain((n, s), n + s)), vmin, vmaj, 2.0, 0.0,
            1.0, -1.0)[3].numpy())
        flat = Mesh(np.array(jax.devices()[:nd]), ("d",))
        run = jax.jit(lambda p, a, b, flat=flat: JV._xdraw_banded_pass(
            p, a, b, 0, flat))
        fwd, rev = run(plane, jnp.float32(vmaj), jnp.float32(vmin))
        out[name] = (np.asarray(plane), np.asarray(fwd), np.asarray(rev))
    return out


def strip_pass(plane, vp_major, vp_minor, parts, steps):
    """The forward and reverse scans of an (n, S) `plane` split into
    `parts` strips of rows: the east and west fields of
    ``strip_scans``, as the JAX package's ``_xdraw_banded_pass`` returns
    them."""
    n = plane.shape[0]
    _, halos, _, fields = TV.strip_scans(split(plane, cpu_mesh(parts, 1)),
                                         vp_minor, vp_major, steps)
    size = -(-n // parts)
    return tuple(torch.cat([f[i][lo:lo + size] for f, (lo, _)
                            in zip(fields, halos)])[:n] for i in (0, 1))


@pytest.mark.parametrize("steps", [1, 5, 64])
@pytest.mark.parametrize("case", list(PASS_CASES))
def test_strip_twin_matches_jax_banded_pass(case, steps, jax_passes,
                                            monkeypatch):
    (_, _), (vmin, vmaj), nd = PASS_CASES[case]
    plane, ref_f, ref_r = jax_passes[case]
    plane = torch.from_numpy(plane)
    fwd, rev = strip_pass(plane, vmaj, vmin, nd, steps)
    for got, ref in ((fwd, ref_f), (rev, ref_r)):
        ref = torch.from_numpy(ref)
        assert torch.equal(torch.isinf(got), torch.isinf(ref))
        fin = torch.isfinite(ref)
        torch.testing.assert_close(got[fin], ref[fin], rtol=SCAN_RTOL,
                                   atol=0)
    monkeypatch.setattr(TV, "_xdraw_interp", fma_interp)
    fwd, rev = strip_pass(plane, vmaj, vmin, nd, steps)
    assert same_bits(fwd, torch.from_numpy(ref_f))
    assert same_bits(rev, torch.from_numpy(ref_r))


# -- the mesh viewshed against the unsharded call ----------------------------------

def vs_case(shape, vp, seed=0):
    data = terrain(shape, seed + sum(shape))
    t = torch.from_numpy(data)
    return t, TV.viewshed_grid_los(t, *vp, 2.0, 1.0, 1.0, -1.0)


# (shape, mesh, viewpoint): the centre, a corner, a strip's edge lane (row
# 20 starts the second of 2x2's row strips of 10; column 24 starts 1x4's
# third column strip), an uneven raster
MESH_CASES = {
    "centre_2x2": ((40, 48), (2, 2), (20, 23)),
    "corner_2x2": ((40, 48), (2, 2), (39, 0)),
    "edge_lane_2x2": ((40, 48), (2, 2), (20, 24)),
    "edge_lane_1x4": ((40, 48), (1, 4), (7, 24)),
    "corner_1x4": ((40, 48), (1, 4), (0, 47)),
    "uneven_2x2": ((41, 38), (2, 2), (30, 11)),
    "uneven_4x2": ((37, 30), (4, 2), (1, 29)),
}


@pytest.mark.parametrize("steps", [1, 3, 16, None])
@pytest.mark.parametrize("case", list(MESH_CASES))
def test_mesh_viewshed_equals_the_unsharded_call(case, steps):
    """Strips of 5-24 lanes, so L = 16 and the plan's 1024 exceed them:
    the scans at each L equal the unsharded scan, and the viewshed (at
    the plan's L) the unsharded call."""
    shape, mesh_shape, vp = MESH_CASES[case]
    t, ref = vs_case(shape, vp)
    mesh = cpu_mesh(*mesh_shape)
    slope = TV._xdraw_fields(t, *vp, 2.0, 1.0, 1.0, -1.0)[3]
    m = TV.xdraw_mesh_max_slope(split(slope, mesh), *vp, steps=steps)
    assert get_raster_mesh(m) is mesh
    assert same_bits(m.gather(), TV.xdraw_scan_twin(slope, *vp))
    if steps is None:
        out = TV.viewshed_grid_los_mesh(split(t, mesh), *vp, 2.0, 1.0, 1.0,
                                        -1.0)
        assert get_raster_mesh(out) is mesh
        assert same_bits(out.gather(), ref)


@pytest.mark.parametrize("steps,band,chunk", [(1, 32, 1), (4, 4, 2),
                                              (7, 8, 3), (16, 4, 4),
                                              (None, None, None)])
@pytest.mark.parametrize("case", ["centre_2x2", "edge_lane_1x4",
                                  "uneven_4x2"])
def test_strip_kernel_emulation_equals_the_twin(case, steps, band, chunk,
                                                monkeypatch):
    """The kernel's algorithm (bands of the window, its chunks, the
    carry-in at the window's first chunk, slots and carry-out) in place
    of each launch: the twin's bits, one launch a strip a window."""
    shape, mesh_shape, vp = MESH_CASES[case]
    slope = TV._xdraw_fields(torch.from_numpy(terrain(shape, 3)), *vp,
                             2.0, 0.0, 1.0, -1.0)[3]
    mesh = cpu_mesh(*mesh_shape)
    kw = dict(steps=steps, band=band, chunk=chunk)
    twin = TV.xdraw_mesh_max_slope(split(slope, mesh), *vp, **kw)
    launches = []
    monkeypatch.setattr(cuda_xdraw, "xdraw_strip_cuda",
                        lambda *a: launches.append(a[6]) or
                        emulate.emulate_xdraw_strip(*a))
    monkeypatch.setattr(TV, "_strip_on_card", lambda t: True)
    got = TV.xdraw_mesh_max_slope(split(slope, mesh), *vp, **kw)
    assert same_bits(got.gather(), twin.gather())
    assert same_bits(got.gather(), TV.xdraw_scan_twin(slope, *vp))
    n = TV.xdraw_strip_plan(*shape, *vp, mesh.size, steps=steps).steps
    first = TV._first_window(*shape, *vp, n)
    windows = -(-max(shape) // n) - first
    assert sorted(set(launches)) == [r * n for r in range(first,
                                                          first + windows)]


def test_viewshed_routes_a_mesh_raster_to_the_strips():
    """exact=False, and the default above the ceiling, on a mesh: the
    result on the input's mesh, equal to the unsharded call."""
    data = terrain((40, 48), 5)
    ys, xs = np.arange(40.0)[::-1].copy(), np.arange(48.0)
    mesh = cpu_mesh(2, 2)

    def agg(payload):
        return xt.DataArray(payload, dims=("y", "x"),
                            coords={"y": ys, "x": xs})
    ref = xt.viewshed(agg(torch.from_numpy(data)), x=20.0, y=10.0,
                      observer_elev=3.0, exact=False)
    out = xt.viewshed(agg(split(torch.from_numpy(data), mesh)), x=20.0,
                      y=10.0, observer_elev=3.0, exact=False)
    assert get_raster_mesh(out.data) is mesh
    assert same_bits(out.data.gather(), ref.data)


# -- against the JAX package's sharded viewshed -------------------------------------

@pytest.mark.parametrize("case", ["square", "corner"])
def test_mesh_viewshed_matches_the_jax_package(case, monkeypatch):
    from xrspatial_tpu.parallel import distribute as jax_distribute
    from xrspatial_tpu.parallel import make_raster_mesh as jax_mesh
    from xrspatial_tpu.xrlib import DataArray as JaxDataArray
    shape, vp = {"square": ((48, 48), (20, 30)),
                 "corner": ((40, 56), (39, 0))}[case]
    data = terrain(shape, 7)
    ys = np.arange(shape[0], dtype=np.float64)[::-1].copy()
    xs = np.arange(shape[1], dtype=np.float64)
    kw = dict(x=xs[vp[1]], y=ys[vp[0]], observer_elev=2.0, exact=False)
    jagg = JaxDataArray(data, dims=("y", "x"), coords={"y": ys, "x": xs})
    jagg.data = jax_distribute(jnp.asarray(data), jax_mesh(2, 2))
    ref = np.asarray(jvs.viewshed(jagg, **kw).data)
    mesh = cpu_mesh(2, 2)
    tagg = xt.DataArray(split(torch.from_numpy(data), mesh), dims=("y", "x"),
                        coords={"y": ys, "x": xs})
    got = xt.viewshed(tagg, **kw).data.gather().numpy()
    differ = (got == -1) != (ref == -1)
    print(f"{case}: {int(differ.sum())} of {differ.size} cells differ")
    assert differ.sum() <= TIE_SHARE * differ.size
    both = (got > -1) & (ref > -1)
    np.testing.assert_allclose(got[both], ref[both], rtol=ANGLE_RTOL, atol=0)
    assert got[vp] == 180.0
