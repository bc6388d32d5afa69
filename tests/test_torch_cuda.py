"""The port's CUDA kernels against their torch twins, on the card.

Tests marked ``gpu`` skip where ``torch.cuda.is_available()`` is false;
the decision is taken inside a fixture, so every pytest worker collects
the same tests.  On a machine with a card and without jax, run them with

    python -m pytest --noconftest tests/test_torch_cuda.py -m gpu -q

(``--noconftest`` skips ``tests/conftest.py``, which imports jax).  This
file imports neither jax nor the JAX package.

Tolerances: surface products rtol 1e-4 / atol 5e-5, focal stats
rtol 1e-5 / atol 1e-5, NaN masks equal; the fused pipeline kernel equals
the split kernels bit for bit (the same device code).  The surface kernel
B1 and the fused pipeline kernel B4 on their staged routes (TMA, or
cp.async from a base 4 bytes off or where w % 4 != 0) equal their first
ports by name bit for bit, B4 also the split kernels, on the row and
column footprints and the fused gate's largest too; each launch is
counted on the route its plan names.  The torch-op paths
(conv-path focal statistics, convolution, mean, hotspots) on the card
against the same call on the CPU: rtol 1e-5, which a TF32 convolution
would miss by orders of magnitude.  The jump-flood round kernel equals
its twins bit for bit in every state plane for EUCLIDEAN and MANHATTAN;
great-circle distances agree within rtol 1e-4 (libdevice and torch trig
differ by ulps, which may turn a near-tie).  The exact viewshed's
interval-screen kernel equals its twin bit for bit in hi and lo, float32
and float64; ``viewshed`` on the card gives the CPU's visibility at every
cell and its angles within rtol 1e-12 (float64 atan ulps).  The stacked
surface kernel B0 equals the surface kernel bit for bit (the same cell
code) and its twin within the surface tolerance, on each of its routes
(TMA, phased, and its first port by name) at odd H * W, a ragged width and
a base 4 bytes off, each launch counted on its route; the stream kernels
equal
``x.clone()`` and ``x + y`` bit for bit.  Geodesic slope/aspect on the card
match the CPU within rtol 1e-6 (float64 trig ulps); cast shadows give the
CPU's lit mask at every cell and its shade within rtol 1e-6 / atol 1e-6.
A numpy raster, with no device set, runs on the card.  Every
instantiation of the stencil-probe template matches its twin (copy bit
for bit, the rest within the surface tolerance) and its nine-read and
staged slope equal the surface kernel's bit for bit, NaN ring included;
the staged form takes the route its plan names, and B8d's staged
separable form equals the first-port separable form bit for bit on both
routes; B8e's and B8f's staged forms (the interior walk with its edge
bands, the walk alone, and ring_branch) equal the surface kernel's slope
bit for bit (bare on its extent), each launch counted on its plan's route,
and the edge-band launch alone writes only the bands; the stream copy and add
equal their twins at every alignment of their pointers; the
large-footprint focal kernel takes the route its plan names and its
staged routes equal the ring route bit for bit; the jump-flood round
kernel's routes (staged, vector, simple), by name and as
``jfa_plan.round_plan`` names them, equal the twins and the first port
bit for bit, and its launcher refuses an unsafe plan; the fused
jump-flood group equals the round kernel launched once per stride, bit
for bit, in both state forms and at every metric, and its single-buffered
route equals its first port.  The A5/A6 paths (the DataArray shim's
methods, multispectral, local, classify; torch ops, no kernel of ours)
keep their results on the card and equal the same call on the CPU bit for
bit, but reductions and std within rtol 1e-6 (another summation order),
ebbi within 2 ulps (the CPU's float32 sqrt is 1 ulp off in some values)
and ``true_color`` within 1; the Jenks DP's breaks reach the CPU's
float64 within-class variance within rtol 1e-5.  The XDraw scan kernel
X1 equals its twin bit for bit at rows, columns, ragged shapes and one
side above what a block's shared memory holds (its first port's scratch
route), the viewpoint at every corner, one launch a call, on its banded
route (the plan's bands, and tiny ones: many bands and chunks, a halo
wider than a band) and its first port by name, each equal to the other;
``viewshed`` with ``exact=False`` launches the banded route once and never
its twin.  The zonal columns on
the card equal the CPU's (mean and sum rtol 1e-6, var and std 1e-5: the
card adds in another order), crosstab, regions, trim and crop exactly.
The bump kernel X2 equals its twin bit for bit at spreads 0, 1 and 3
(duplicate locations, every edge and corner, non-integer heights), one
launch a call, on its rounds route (the plan's threshold, reaching the
walk; 0; infinity; a sparse map the rounds finish) and its first port by
name, whose counters account for every bump, and ``bump`` launches it
once and never its twin;
``perlin``, ``generate_terrain`` and ``make_terrain`` on the card equal
the CPU's bit for bit; ``a_star_search`` (native route), ``polygonize``
and ``diagnose`` on a raster on the card give the CPU raster's results.
"""

import math

import numpy as np
import pytest
import torch

import xrspatial_torch as xt
from xrspatial_torch import focal
from xrspatial_torch.convolution import (annulus_kernel, circle_kernel,
                                         convolution_2d)
from xrspatial_torch.kernels import _cuda, cuda_jfa, cuda_jfa_group
from xrspatial_torch.kernels import cuda_pipeline, cuda_screen
from xrspatial_torch.kernels import cuda_stencil_probe, cuda_stream
from xrspatial_torch.kernels import cuda_surface, cuda_window, jfa
from xrspatial_torch.kernels import jfa_group, jfa_plan, jfa_rounds, screen
from xrspatial_torch.kernels import pipeline, shadows
from xrspatial_torch.kernels import stencil_probe, stream, surface
from xrspatial_torch.kernels import viewshed_exact
from xrspatial_torch.kernels.focal_halo import halo_plan
from xrspatial_torch.kernels.pipeline import pipeline_multi
from xrspatial_torch.kernels.surface import PRODUCTS, surface_multi
from xrspatial_torch.kernels.window import kernel_offsets, window_stats

SURFACE_TOL = dict(rtol=1e-4, atol=5e-5)
FOCAL_TOL = dict(rtol=1e-5, atol=1e-5)
ALL_STATS = ("mean", "max", "min", "range", "std", "var", "sum")
KERNELS = {
    "circle_r1": circle_kernel(1, 1, 1.5),
    "circle_r2": circle_kernel(1, 1, 2.5),
    "custom_3x5": np.array([[1, 0, 1, 1, 0],
                            [0, 1, 1, 0, 1],
                            [1, 1, 0, 0, 0]], dtype=float),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "false")
    return torch.device("cuda", 0)


def surface_case(name):
    """(raster, (cellsize_x, cellsize_y)), as in test_torch_surface.py."""
    if name == "elevation_8x6":
        rng = np.random.default_rng(7)
        data = (rng.random((8, 6)) * 1000).astype(np.float32)
        data[0, :] = np.nan
        return data, (1.0, 1.0)
    rng = np.random.default_rng(5)
    if name == "patches_70x300":
        data = rng.random((70, 300)).astype(np.float32) * 100
        data[20:23, 120:140] = np.nan
        data[31:33, 40] = np.nan
        return data, (2.0, 3.0)
    shape = (1, 257) if name == "row_1x257" else (300, 2)
    return (rng.random(shape) * 100).astype(np.float32), (1.0, 1.0)


def focal_raster(with_inf):
    """The raster of test_torch_focal.py."""
    rng = np.random.default_rng(9)
    data = (rng.random((70, 300)) * 50).astype(np.float32)
    data[30:34, 120:135] = np.nan
    data[31:33, 128] = np.nan
    data[60:70, 250:260] = np.nan
    if with_inf:
        data[10, 10] = np.inf
        data[50, 200] = -np.inf
        data[0, 299] = np.inf
    return data


def assert_matches(got, ref, tol, msg=""):
    got = got.detach().cpu().numpy()
    ref = ref.detach().cpu().numpy()
    assert got.shape == ref.shape, msg
    assert np.array_equal(np.isnan(got), np.isnan(ref)), msg
    np.testing.assert_allclose(got, ref, equal_nan=True, err_msg=msg, **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["patches_70x300", "row_1x257", "col_300x2",
                                  "elevation_8x6"])
def test_surface_kernel_matches_twin(cuda, name):
    data, (csx, csy) = surface_case(name)
    x = torch.from_numpy(data).to(cuda)
    got = cuda_surface.surface_cuda(x, PRODUCTS, csx, csy, 225.0, 25.0)
    ref = surface_multi(x, csx, csy, 225.0, 25.0, PRODUCTS)
    torch.cuda.synchronize()
    for p, g in zip(PRODUCTS, got):
        assert g.device == x.device
        assert_matches(g, ref[p], SURFACE_TOL, p)


@pytest.mark.gpu
@pytest.mark.parametrize("with_inf", [False, True], ids=["nan", "nan_inf"])
@pytest.mark.parametrize("kname", list(KERNELS))
def test_focal_kernel_matches_twin(cuda, kname, with_inf):
    x = torch.from_numpy(focal_raster(with_inf)).to(cuda)
    offsets = kernel_offsets(KERNELS[kname])
    got = cuda_window.focal_stats_cuda(x, offsets, ALL_STATS)
    ref = window_stats(x, offsets, ALL_STATS)
    torch.cuda.synchronize()
    assert got.shape == (len(ALL_STATS),) + x.shape
    for i, s in enumerate(ALL_STATS):
        assert_matches(got[i], ref[s], FOCAL_TOL, s)


TILED_FOOTPRINTS = {
    "plus": circle_kernel(1, 1, 1.5),
    "3x3": np.ones((3, 3)),
    "1x513": np.ones((1, 513)),
    "65x1": np.ones((65, 1)),
}


def tiled_routes():
    return {"tma": cuda_window.TMA_LAUNCHES,
            "async": cuda_window.ASYNC_LAUNCHES,
            "simple": cuda_window.SIMPLE_LAUNCHES,
            "all": cuda_window.LAUNCHES}


@pytest.mark.gpu
@pytest.mark.parametrize("nodata", [False, True], ids=["dem", "nodata"])
@pytest.mark.parametrize("shape", [(263, 516), (263, 517), (70, 300)])
@pytest.mark.parametrize("fname", list(TILED_FOOTPRINTS))
def test_focal_kernel_staged_route_equals_first_port(cuda, fname, shape,
                                                     nodata):
    """B2 on the route its plan names (TMA at w % 4 == 0, cp.async
    elsewhere) equals its first port by name bit for bit: the same cell
    code and rounding, 16-byte stores where w % 4 == 0."""
    y, xx = np.mgrid[0:shape[0], 0:shape[1]]
    data = (np.sin(y / 9.0) * np.cos(xx / 7.0) * 400.0 + 500.0).astype(
        np.float32)
    if nodata:
        data[::32, 64::128] = np.nan
        data[5, 7] = np.inf
    x = torch.from_numpy(data).to(cuda)
    offsets = kernel_offsets(TILED_FOOTPRINTS[fname])
    route = halo_plan(*shape, offsets, x.data_ptr()).route
    assert route == ("tma" if shape[1] % 4 == 0 else "async")
    before = tiled_routes()
    got = cuda_window.focal_stats_cuda(x, offsets, ALL_STATS)
    torch.cuda.synchronize()
    after = tiled_routes()
    assert {k: after[k] - before[k] for k in after} == {
        "tma": int(route == "tma"), "async": int(route == "async"),
        "simple": 0, "all": 1}
    first = cuda_window.focal_stats_cuda(x, offsets, ALL_STATS,
                                         route="simple")
    assert tiled_routes()["simple"] == after["simple"] + 1
    assert_same_bits(got, first)
    ref = window_stats(x, offsets, ALL_STATS)
    for i, s in enumerate(ALL_STATS):
        assert_matches(got[i], ref[s], FOCAL_TOL, s)


@pytest.mark.gpu
def test_focal_kernel_refuses_a_route_not_its_plans(cuda):
    x = torch.ones((64, 64), device=cuda)
    offsets = kernel_offsets(TILED_FOOTPRINTS["plus"])
    before = tiled_routes()
    for route in ("async", "ring"):
        with pytest.raises(ValueError, match="route"):
            cuda_window.focal_stats_cuda(x, offsets, ("mean",), route=route)
    k = np.zeros((1001, 1001))
    k[[0, 1000], [0, 1000]] = 1
    with pytest.raises(ValueError, match="fits a block"):
        cuda_window.focal_stats_cuda(x, kernel_offsets(k), ("mean",))
    assert tiled_routes() == before


@pytest.mark.gpu
def test_terrain_pipeline_launches_each_kernel_once(cuda):
    data, _ = surface_case("patches_70x300")
    attrs = {"res": (2.0, 3.0)}
    on_card = xt.DataArray(torch.from_numpy(data).to(cuda), dims=("y", "x"),
                           name="dem", attrs=attrs)
    on_host = xt.DataArray(torch.from_numpy(data), dims=("y", "x"),
                           name="dem", attrs=attrs)
    before = (cuda_surface.LAUNCHES, cuda_window.LAUNCHES,
              cuda_window.TMA_LAUNCHES + cuda_window.ASYNC_LAUNCHES,
              cuda_window.SIMPLE_LAUNCHES, cuda_surface.STAGED_TMA_LAUNCHES,
              cuda_surface.SIMPLE_LAUNCHES)
    got = xt.terrain_pipeline(on_card)
    torch.cuda.synchronize()
    # B1 and B2 each on its staged route (TMA: w % 4 == 0), not the first
    # port
    assert (cuda_surface.LAUNCHES, cuda_window.LAUNCHES,
            cuda_window.TMA_LAUNCHES + cuda_window.ASYNC_LAUNCHES,
            cuda_window.SIMPLE_LAUNCHES, cuda_surface.STAGED_TMA_LAUNCHES,
            cuda_surface.SIMPLE_LAUNCHES) == (
        before[0] + 1, before[1] + 1, before[2] + 1, before[3],
        before[4] + 1, before[5])
    ref = xt.terrain_pipeline(on_host)
    assert list(got.data_vars) == list(ref.data_vars)
    for k in ("dem-slope", "dem-hillshade", "focal_stats"):
        assert got[k].data.device.type == "cuda", k
        tol = FOCAL_TOL if k == "focal_stats" else SURFACE_TOL
        assert_matches(got[k].data, ref[k].data, tol, k)


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["slope", "aspect", "curvature", "hillshade"])
def test_public_op_runs_the_kernel(cuda, op):
    data, res = surface_case("patches_70x300")
    attrs = {"res": res}
    on_card = xt.DataArray(torch.from_numpy(data).to(cuda), dims=("y", "x"),
                           attrs=attrs)
    before = cuda_surface.LAUNCHES
    got = getattr(xt, op)(on_card)
    torch.cuda.synchronize()
    assert cuda_surface.LAUNCHES == before + 1
    ref = getattr(xt, op)(xt.DataArray(torch.from_numpy(data),
                                       dims=("y", "x"), attrs=attrs))
    assert_matches(got.data, ref.data, SURFACE_TOL, op)


# (metric, axes, value channel): 0 euclidean, 1 great circle, 2 manhattan
JFA_MODES = {
    "euclidean": (0, "affine", False),
    "euclidean_nonaffine_values": (0, "nonaffine", True),
    "manhattan": (2, "affine", False),
    "great_circle": (1, "lonlat", False),
    "allocation_values": (0, "affine", True),
}


def jfa_axes(kind, h, w):
    """(ys, xs) float32 coordinate vectors of one kind."""
    rng = np.random.default_rng(3)
    if kind == "affine":
        ys, xs = np.arange(h)[::-1] * 0.5, np.arange(w) * 0.5
    elif kind == "nonaffine":
        ys = np.sort(rng.uniform(-50, 50, h))[::-1]
        xs = np.sort(rng.uniform(-50, 50, w))
    else:
        ys, xs = np.linspace(75, -75, h), np.linspace(-170, 170, w)
    return (np.ascontiguousarray(ys, dtype=np.float32),
            np.ascontiguousarray(xs, dtype=np.float32))


def jfa_run(rounds_packed, rounds_coords, mask, values, xs, ys, metric):
    """jump_flood's whole stride schedule, run with the given round
    functions; returns the final planes and each cell's key."""
    h, w = mask.shape
    strides = [int(k) for k in jfa._stride_schedule(max(h, w))]
    plan = jfa.packed_state_plan(xs.cpu().numpy(), ys.cpu().numpy(), metric)
    val = None if values is None else torch.where(mask, values, 0.0)
    if plan is not None:
        iy = torch.arange(h, dtype=torch.int32, device=mask.device)[:, None]
        ix = torch.arange(w, dtype=torch.int32, device=mask.device)[None, :]
        state = torch.where(mask, (iy << 15) | ix, -1)
        for k in strides:
            state, val, best = rounds_packed(state, val, k, metric, plan[0])
        return {"state": state, "value": val, "best": best}
    tx = torch.where(mask, xs[None, :], np.inf)
    ty = torch.where(mask, ys[:, None], np.inf)
    for k in strides:
        tx, ty, val = rounds_coords(tx, ty, val, xs, ys, k, metric)
    best = jfa_rounds.coords_key(xs[None, :], ys[:, None], tx, ty, metric)
    return {"tx": tx, "ty": ty, "value": val, "best": best}


def kernel_packed(state, val, k, metric, steps):
    return cuda_jfa.round_packed_cuda(state, val, k, metric, steps,
                                      emit_best=True)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(70, 300), (1, 257), (33, 47), (2, 5)])
@pytest.mark.parametrize("mode", list(JFA_MODES))
def test_jfa_round_kernel_matches_twin(cuda, mode, shape):
    metric, kind, with_val = JFA_MODES[mode]
    rng = np.random.default_rng(11)
    mask_np = rng.random(shape) < 0.02
    mask_np[0, shape[1] // 2] = True
    mask = torch.from_numpy(mask_np).to(cuda)
    values = torch.from_numpy(
        rng.uniform(1, 9, shape).astype(np.float32)).to(cuda)
    ys, xs = (torch.from_numpy(a).to(cuda) for a in jfa_axes(kind, *shape))
    args = (mask, values if with_val else None, xs, ys, metric)
    before = cuda_jfa.LAUNCHES
    got = jfa_run(kernel_packed, cuda_jfa.round_coords_cuda, *args)
    torch.cuda.synchronize()
    assert cuda_jfa.LAUNCHES == before + len(jfa._stride_schedule(max(shape)))
    ref = jfa_run(jfa_rounds.round_packed, jfa_rounds.round_coords, *args)
    assert set(got) == set(ref)
    if metric == 1:
        d_got = jfa._metric_finalize(got["best"], metric).cpu().numpy()
        d_ref = jfa._metric_finalize(ref["best"], metric).cpu().numpy()
        np.testing.assert_allclose(d_got, d_ref, rtol=1e-4)
        return
    for plane, g in got.items():
        r = ref[plane]
        assert (g is None) == (r is None), plane
        if g is not None:
            assert torch.equal(g, r), plane


def round_counts():
    return (cuda_jfa.STAGED_LAUNCHES, cuda_jfa.VECTOR_LAUNCHES,
            cuda_jfa.SIMPLE_LAUNCHES)


def routed(route, phased=None):
    """Round functions on `route` by name where it can take the round,
    else on the simple route by name."""
    def pick(form, state, k, with_val):
        h, w = state.shape
        try:
            jfa_plan.round_plan(h, w, k, form, with_val, route=route)
            return route
        except ValueError:
            return "simple"

    def packed(state, val, k, metric, steps):
        r = pick("packed", state, k, val is not None)
        return cuda_jfa.round_packed_cuda(state, val, k, metric, steps,
                                          emit_best=True, route=r,
                                          phased=phased if r == "vector"
                                          else None)

    def coords(tx, ty, val, xs, ys, k, metric):
        r = pick("coords", tx, k, val is not None)
        return cuda_jfa.round_coords_cuda(tx, ty, val, xs, ys, k, metric,
                                          route=r, phased=phased
                                          if r == "vector" else None)
    return packed, coords


def jfa_case(cuda, mode, shape, seed=11):
    metric, kind, with_val = JFA_MODES[mode]
    rng = np.random.default_rng(seed)
    mask_np = rng.random(shape) < 0.02
    mask_np[0, shape[1] // 2] = True
    mask = torch.from_numpy(mask_np).to(cuda)
    values = torch.from_numpy(
        rng.uniform(1, 9, shape).astype(np.float32)).to(cuda)
    ys, xs = (torch.from_numpy(a).to(cuda) for a in jfa_axes(kind, *shape))
    return (mask, values if with_val else None, xs, ys, metric)


def assert_same_planes(got, ref, metric):
    assert set(got) == set(ref)
    if metric == 1:
        d_got = jfa._metric_finalize(got["best"], metric).cpu().numpy()
        d_ref = jfa._metric_finalize(ref["best"], metric).cpu().numpy()
        np.testing.assert_allclose(d_got, d_ref, rtol=1e-4)
        return
    for plane, g in got.items():
        r = ref[plane]
        assert (g is None) == (r is None), plane
        if g is not None:
            assert torch.equal(g, r), plane


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(70, 300), (1, 257), (33, 47), (2, 5),
                                   (129, 1024)])
@pytest.mark.parametrize("mode", list(JFA_MODES))
@pytest.mark.parametrize("route", ["staged", "vector", "simple"])
def test_jfa_round_route_by_name_matches_twin(cuda, route, mode, shape):
    """Each route by name (simple where it cannot take a stride) over the
    whole schedule, against the twins, every form, metric and value
    plane."""
    args = jfa_case(cuda, mode, shape)
    before = round_counts()
    got = jfa_run(*routed(route), *args)
    torch.cuda.synchronize()
    n = len(jfa._stride_schedule(max(shape)))
    after = round_counts()
    assert sum(after) - sum(before) == n
    if route != "simple" and shape[1] % 4 == 0 and shape != (1, 257):
        assert after[("staged", "vector").index(route)] > \
            before[("staged", "vector").index(route)]
    ref = jfa_run(jfa_rounds.round_packed, jfa_rounds.round_coords, *args)
    assert_same_planes(got, ref, args[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(257, 1025), (1025, 2048), (300, 512)])
@pytest.mark.parametrize("mode", ["euclidean", "allocation_values",
                                  "euclidean_nonaffine_values",
                                  "great_circle"])
def test_jfa_round_plan_equals_simple_by_name(cuda, mode, shape):
    """The plan's routes against the first port by name, bit for bit, and
    the vector route's k-phase row order against its row order."""
    args = jfa_case(cuda, mode, shape, seed=12)
    plan_run = jfa_run(kernel_packed, cuda_jfa.round_coords_cuda, *args)
    simple = jfa_run(*routed("simple"), *args)
    for plane, g in plan_run.items():
        if g is not None:
            assert torch.equal(g, simple[plane]), plane
    if shape[1] % 4 == 0:
        for phased in (True, False):
            got = jfa_run(*routed("vector", phased), *args)
            for plane, g in got.items():
                if g is not None:
                    assert torch.equal(g, simple[plane]), (plane, phased)


@pytest.mark.gpu
def test_jfa_round_takes_cp_async_and_simple_from_an_unaligned_base(cuda):
    """A state that starts 4 bytes past an aligned address: the staged
    route stages by cp.async, the strides the plan gives the vector route
    go to simple, and the bits are the twin's."""
    h, w = 70, 300
    rng = np.random.default_rng(5)
    mask = torch.from_numpy(rng.random((h, w)) < 0.02).to(cuda)
    iy = torch.arange(h, dtype=torch.int32, device=cuda)[:, None]
    ix = torch.arange(w, dtype=torch.int32, device=cuda)[None, :]
    flat = torch.empty(h * w + 1, dtype=torch.int32, device=cuda)
    state = flat[1:].view(h, w)
    state.copy_(torch.where(mask, (iy << 15) | ix, -1))
    assert jfa_plan.round_plan(h, w, 1, "packed", False,
                               state.data_ptr()).stage == "async"
    assert jfa_plan.round_plan(h, w, 64, "packed", False,
                               state.data_ptr()).route == "simple"
    for k in (64, 8, 2, 1):
        before = round_counts()
        got, _, best = cuda_jfa.round_packed_cuda(state, None, k, 0,
                                                  (1.0, 1.0), emit_best=True)
        torch.cuda.synchronize()
        moved = [b - a for a, b in zip(before, round_counts())]
        assert moved == ([0, 0, 1] if k == 64 else [1, 0, 0])
        ref, _, rbest = jfa_rounds.round_packed(state, None, k, 0, (1.0, 1.0))
        assert torch.equal(got, ref) and torch.equal(best, rbest)
        state = flat[1:].view(h, w)
        state.copy_(got)
    with pytest.raises(ValueError, match="vector route cannot"):
        cuda_jfa.round_packed_cuda(state, None, 64, 0, (1.0, 1.0),
                                   route="vector")


@pytest.mark.gpu
def test_jfa_round_launcher_refuses_an_unsafe_plan(cuda):
    """jfa_round_routed launches round_plan's plans and refuses one that
    breaks a safety rule of its route."""
    import ctypes
    h, w = 64, 256
    state = torch.full((h, w), -1, dtype=torch.int32, device=cuda)
    state[10, 20] = (10 << 15) | 20
    out = torch.empty_like(state)
    arr = ctypes.c_void_p * 3

    def launch(plan, stride, **change):
        a = {**plan._asdict(), "k": stride, **change}
        return _cuda.library().jfa_round_routed(
            0, arr(state.data_ptr()), arr(out.data_ptr()), None, None, None,
            h, w, a["k"], 1.0, 1.0, 0, 0,
            {"staged": 0, "vector": 1}.get(a["route"], 7),
            {"tma": 0, "async": 1}.get(a["stage"], 0), a["tile"][0],
            a["pad"], a["pitch"], a["rows"], a["shared_bytes"],
            int(a["phased"]), a["grid"], 0, 0, _cuda.stream_of(cuda))

    staged = jfa_plan.round_plan(h, w, 2, "packed", False, route="staged")
    vector = jfa_plan.round_plan(h, w, 8, "packed", False, route="vector")
    assert launch(staged, 2) == 0 and launch(vector, 8) == 0
    torch.cuda.synchronize()
    for change in (dict(k=3), dict(pad=0), dict(pad=2), dict(pitch=256),
                   dict(rows=staged.rows - 1), dict(stage="async"),
                   dict(shared_bytes=staged.shared_bytes - 4),
                   dict(shared_bytes=232448 + 4), dict(grid=staged.grid + 1),
                   dict(route="simple")):
        assert launch(staged, 2, **change) != 0, change
    for change in (dict(k=2), dict(k=6), dict(grid=vector.grid - 1)):
        assert launch(vector, 8, **change) != 0, change


@pytest.mark.gpu
@pytest.mark.parametrize("func,metric", [
    ("proximity", "EUCLIDEAN"), ("allocation", "EUCLIDEAN"),
    ("direction", "EUCLIDEAN"), ("proximity", "MANHATTAN"),
    ("allocation", "MANHATTAN"), ("direction", "MANHATTAN"),
    ("proximity", "GREAT_CIRCLE")])
def test_proximity_family_runs_the_kernel(cuda, func, metric):
    """The public functions on a raster on the card: every round on the
    kernel (MANHATTAN on monotone axes takes the scans instead), results
    equal to the same call on the CPU up to the last ulp of sqrt and
    atan2, which the CPU does not round correctly.  Great-circle targets
    may differ at near-ties, so only its distances are compared."""
    rng = np.random.default_rng(12)
    data = np.where(rng.random((50, 70)) < 0.03,
                    rng.integers(1, 9, (50, 70)), 0).astype(np.float32)
    ys, xs = jfa_axes("lonlat" if metric == "GREAT_CIRCLE" else "affine",
                      50, 70)
    coords = {"y": ys, "x": xs}
    on_card = xt.DataArray(torch.from_numpy(data).to(cuda), dims=("y", "x"),
                           coords=coords)
    on_host = xt.DataArray(torch.from_numpy(data), dims=("y", "x"),
                           coords=coords)
    before = cuda_jfa.LAUNCHES
    got = getattr(xt, func)(on_card, distance_metric=metric)
    torch.cuda.synchronize()
    rounds = 0 if metric == "MANHATTAN" else len(jfa._stride_schedule(70))
    assert cuda_jfa.LAUNCHES == before + rounds
    assert got.data.device.type == "cuda"
    ref = getattr(xt, func)(on_host, distance_metric=metric)
    tol = dict(rtol=1e-4) if metric == "GREAT_CIRCLE" else \
        dict(rtol=1e-6, atol=0)
    if func == "allocation":
        tol = dict(rtol=0, atol=0)
    assert_matches(got.data, ref.data, tol, func)


def halo_footprint(name):
    """The footprints focal_stats sends to the halo kernel on the card."""
    if name == "annulus_40_38":
        return annulus_kernel(1, 1, 40, 38)     # 512 offsets, ry = 40
    if name == "row_601":
        return np.ones((1, 601))                # rx = 300
    if name == "col_67":
        return np.ones((67, 1))                 # ry = 33
    if name == "ends_1x1025":                   # rx = 512: read from global
        k = np.zeros((1, 1025))
        k[0, [0, 300, 512, 1024]] = 1
        return k
    rng = np.random.default_rng(5)              # irregular, ry = 40
    k = (rng.random((81, 61)) < 0.15).astype(float)
    k[0, 7] = 1
    return k


def halo_routes():
    return {"tma": cuda_window.HALO_TMA_LAUNCHES,
            "async": cuda_window.HALO_ASYNC_LAUNCHES,
            "ring": cuda_window.HALO_RING_LAUNCHES,
            "all": cuda_window.HALO_LAUNCHES}


def assert_one_launch_on(route, before):
    after = halo_routes()
    assert {k: after[k] - before[k] for k in after} == {
        "tma": route == "tma", "async": route == "async",
        "ring": route == "ring", "all": 1}


def assert_same_bits(got, ref, msg=""):
    """Equal bit for bit, every NaN as NaN."""
    assert torch.equal(torch.isnan(got), torch.isnan(ref)), msg
    assert torch.equal(torch.where(torch.isnan(got), 0.0, got).view(
        torch.int32), torch.where(torch.isnan(ref), 0.0, ref).view(
        torch.int32)), msg


HALO_SHAPES = [(90, 700), (2, 5), (1, 1000), (300, 70), (263, 516)]
HALO_NAMES = ["annulus_40_38", "row_601", "col_67", "irregular",
              "ends_1x1025"]


def halo_data(shape, cuda):
    rng = np.random.default_rng(23)
    data = (rng.random(shape) * 50).astype(np.float32)
    data[shape[0] // 3:shape[0] // 2 + 1, shape[1] // 4:shape[1] // 3] = np.nan
    data[-1, -1] = np.inf
    data[0, shape[1] // 2] = -np.inf
    return torch.from_numpy(data).to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", HALO_SHAPES)
@pytest.mark.parametrize("kname", HALO_NAMES)
def test_focal_halo_kernel_matches_twin(cuda, kname, shape):
    """One launch on the route its plan names (TMA where w % 4 == 0),
    within the focal tolerance of the twin."""
    x = halo_data(shape, cuda)
    offsets = kernel_offsets(halo_footprint(kname))
    assert len(offsets) <= 1024 and focal._route(offsets) == "halo"
    route = halo_plan(*shape, offsets, x.data_ptr()).route
    assert route == ("tma" if shape[1] % 4 == 0 else "async")
    before = halo_routes()
    got = cuda_window.focal_stats_halo_cuda(x, offsets, ALL_STATS)
    torch.cuda.synchronize()
    assert_one_launch_on(route, before)
    ref = window_stats(x, offsets, ALL_STATS)
    for i, s in enumerate(ALL_STATS):
        assert_matches(got[i], ref[s], FOCAL_TOL, s)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", HALO_SHAPES)
@pytest.mark.parametrize("kname", HALO_NAMES)
def test_staged_halo_route_equals_the_ring_route(cuda, kname, shape):
    """The staged window (TMA or cp.async) and the ring of rows, called
    by name, give the same bits, NaN and +-inf cells included; with one
    stat, var alone and the main path's four."""
    x = halo_data(shape, cuda)
    offsets = kernel_offsets(halo_footprint(kname))
    for stats in (ALL_STATS, ("var",), ("mean", "max", "min", "std")):
        staged = cuda_window.focal_stats_halo_cuda(x, offsets, stats)
        before = halo_routes()
        ring = cuda_window.focal_stats_halo_cuda(x, offsets, stats, "ring")
        torch.cuda.synchronize()
        assert_one_launch_on("ring", before)
        assert_same_bits(staged, ring, f"{kname} {shape} {stats}")


@pytest.mark.gpu
def test_staged_halo_takes_cp_async_from_an_unaligned_base(cuda):
    """A pitch that suits TMA but a base that is not 16-byte aligned takes
    the cp.async route, with the ring route's bits; the launcher refuses
    a route that is not its plan's."""
    flat = torch.rand(200 * 256 + 1, device=cuda) * 100
    x = flat[1:].view(200, 256)
    offsets = kernel_offsets(halo_footprint("annulus_40_38"))
    assert halo_plan(200, 256, offsets, x.data_ptr()).route == "async"
    before = halo_routes()
    got = cuda_window.focal_stats_halo_cuda(x, offsets, ALL_STATS)
    torch.cuda.synchronize()
    assert_one_launch_on("async", before)
    ring = cuda_window.focal_stats_halo_cuda(x, offsets, ALL_STATS, "ring")
    assert_same_bits(got, ring)
    with pytest.raises(ValueError, match="plan"):
        cuda_window.focal_stats_halo_cuda(x, offsets, ALL_STATS, "tma")


@pytest.mark.gpu
def test_staged_halo_launcher_refuses_an_unsafe_plan(cuda):
    """The staged launcher launches halo_plan's plan and refuses one whose
    route, boxes, window, shared bytes, grid or register class (2 or 3
    blocks an SM) break a safety rule."""
    import ctypes
    from xrspatial_torch.kernels.focal_halo import register_class, run_table
    x = torch.rand(64, 256, device=cuda) * 100
    offsets = kernel_offsets(halo_footprint("annulus_40_38"))
    plan = halo_plan(64, 256, offsets, x.data_ptr())
    runs = torch.tensor(run_table(offsets, plan), dtype=torch.int32,
                        device=cuda)
    out = torch.empty((1, 64, 256), device=cuda)
    slots = (ctypes.c_int * 7)(0, -1, -1, -1, -1, -1, -1)
    args = dict(route=0, th=plan.tile[0], pad=plan.pad, pitch=plan.pitch,
                rows=plan.rows, box_cols=plan.box[0], box_rows=plan.box[1],
                smem=plan.shared_bytes, grid=plan.grid,
                blocks=register_class(plan))

    def launch(**change):
        a = {**args, **change}
        return _cuda.library().focal_halo_staged_launch(
            x.data_ptr(), runs.data_ptr(), runs.shape[0], len(offsets), slots,
            out.data_ptr(), 64, 256, 40, 40, a["route"], a["th"], a["pad"],
            a["pitch"], a["rows"], a["box_cols"], a["box_rows"], a["smem"],
            a["grid"], a["blocks"], _cuda.stream_of(cuda))

    assert plan.route == "tma" and launch() == 0 and launch(blocks=3) == 0
    torch.cuda.synchronize()
    for change in (dict(route=1), dict(th=31), dict(pad=38),
                   dict(pitch=192, box_cols=192), dict(box_cols=112),
                   dict(rows=plan.rows - 1), dict(smem=plan.shared_bytes - 4),
                   dict(smem=232448 + 4), dict(grid=plan.grid + 1),
                   dict(blocks=1), dict(blocks=4)):
        assert launch(**change) != 0, change


@pytest.mark.gpu
def test_focal_halo_kernel_opts_in_to_more_shared_memory(cuda):
    """Called by name on a 1x2001 row (2001 offsets, rx = 1000): its plan
    keeps the staged window at a tile of 8 rows (72 KB, 72 one-row TMA
    boxes) and it runs there; the ring, by name, needs 49.7 KB of shared
    memory, past the default 48 KB.  Both equal bit for bit, and compared
    with the unrolled twin, which window_stats would not take above 1024
    offsets."""
    from xrspatial_torch.kernels.window import _window_stats_unrolled
    rng = np.random.default_rng(31)
    data = (rng.random((9, 2500)) * 50).astype(np.float32)
    data[3, 100:400] = np.nan
    x = torch.from_numpy(data).to(cuda)
    offsets = kernel_offsets(np.ones((1, 2001)))
    plan = halo_plan(9, 2500, offsets, x.data_ptr())
    assert (plan.route, plan.tile, plan.boxes) == ("tma", (8, 128), 72)
    before = halo_routes()
    got = cuda_window.focal_stats_halo_cuda(x, offsets, ALL_STATS)
    torch.cuda.synchronize()
    assert_one_launch_on("tma", before)
    ring = cuda_window.focal_stats_halo_cuda(x, offsets, ALL_STATS, "ring")
    assert_same_bits(got, ring)
    ref = _window_stats_unrolled(x, offsets, ALL_STATS)
    for i, s in enumerate(ALL_STATS):
        assert_matches(got[i], ref[s], FOCAL_TOL, s)


@pytest.mark.gpu
def test_a_window_that_fits_no_block_takes_the_ring(cuda):
    """A sparse footprint of radius 500 plans the ring, and runs there."""
    k = np.zeros((1001, 1001))
    k[[0, 0, 500, 1000, 1000], [0, 1000, 500, 0, 1000]] = 1
    offsets = kernel_offsets(k)
    x = halo_data((1100, 1200), cuda)
    assert halo_plan(1100, 1200, offsets, x.data_ptr()).route == "ring"
    before = halo_routes()
    got = cuda_window.focal_stats_halo_cuda(x, offsets, ALL_STATS)
    torch.cuda.synchronize()
    assert_one_launch_on("ring", before)
    ref = window_stats(x, offsets, ALL_STATS)
    for i, s in enumerate(ALL_STATS):
        assert_matches(got[i], ref[s], FOCAL_TOL, s)


@pytest.mark.gpu
def test_focal_stats_sends_the_annulus_to_the_halo_kernel(cuda):
    data = focal_raster(with_inf=True)
    kernel = halo_footprint("annulus_40_38")
    stats = ["mean", "max", "min", "std"]
    on_card = xt.DataArray(torch.from_numpy(data).to(cuda), dims=("y", "x"))
    before = (cuda_window.LAUNCHES, halo_routes())
    got = xt.focal_stats(on_card, kernel, stats)
    torch.cuda.synchronize()
    assert cuda_window.LAUNCHES == before[0]
    assert_one_launch_on("tma", before[1])
    ref = xt.focal_stats(xt.DataArray(torch.from_numpy(data),
                                      dims=("y", "x")), kernel, stats)
    assert_matches(got.data, ref.data, FOCAL_TOL)


PIPELINE_CASES = {
    "main_path": (("slope", "hillshade"), ("mean", "max", "min", "std"), 1.5),
    "all_r2": (PRODUCTS, ALL_STATS, 2.5),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(PIPELINE_CASES))
@pytest.mark.parametrize("shape", [(70, 300), (2, 5), (1, 1000), (257, 389)])
def test_pipeline_kernel_matches_split_kernels_and_twin(cuda, shape, case):
    which, stats, radius = PIPELINE_CASES[case]
    rng = np.random.default_rng(29)
    data = (rng.random(shape) * 100).astype(np.float32)
    data[shape[0] // 2, :shape[1] // 3] = np.nan
    x = torch.from_numpy(data).to(cuda)
    offsets = kernel_offsets(circle_kernel(1, 1, radius))
    args = (2.0, 3.0, 300.0, 40.0)
    before = cuda_pipeline.LAUNCHES
    got = cuda_pipeline.pipeline_cuda(x, offsets, stats, which, *args)
    torch.cuda.synchronize()
    assert cuda_pipeline.LAUNCHES == before + 1
    split = (*cuda_surface.surface_cuda(x, which, *args),
             cuda_window.focal_stats_cuda(x, offsets, stats))
    twin = pipeline_multi(x, offsets, stats, which, *args)
    assert len(got) == len(split) == len(twin) == len(which) + 1
    for k, (g, s, t) in enumerate(zip(got, split, twin)):
        assert torch.equal(torch.isnan(g), torch.isnan(s))
        assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(s)), k
        tol = FOCAL_TOL if k == len(which) else SURFACE_TOL
        assert_matches(g, t, tol, str(k))


@pytest.mark.gpu
def test_fused_terrain_pipeline_launches_only_the_pipeline_kernel(
        cuda, monkeypatch):
    monkeypatch.setenv("XRSPATIAL_FUSED_PIPELINE", "1")
    data, _ = surface_case("patches_70x300")
    attrs = {"res": (2.0, 3.0)}
    on_card = xt.DataArray(torch.from_numpy(data).to(cuda), dims=("y", "x"),
                           name="dem", attrs=attrs)
    before = (cuda_pipeline.LAUNCHES, cuda_surface.LAUNCHES,
              cuda_window.LAUNCHES, cuda_window.HALO_LAUNCHES,
              cuda_pipeline.TMA_LAUNCHES)
    got = xt.terrain_pipeline(on_card)
    torch.cuda.synchronize()
    # B4 on its staged route (TMA: w % 4 == 0), not the first port
    assert (cuda_pipeline.LAUNCHES, cuda_surface.LAUNCHES,
            cuda_window.LAUNCHES, cuda_window.HALO_LAUNCHES,
            cuda_pipeline.TMA_LAUNCHES) == (
        before[0] + 1, *before[1:4], before[4] + 1)
    monkeypatch.setenv("XRSPATIAL_FUSED_PIPELINE", "0")
    split = xt.terrain_pipeline(on_card)
    assert list(got.data_vars) == list(split.data_vars)
    for k in ("dem-slope", "dem-hillshade", "focal_stats"):
        assert got[k].data.device.type == "cuda", k
        assert torch.equal(torch.nan_to_num(got[k].data),
                           torch.nan_to_num(split[k].data)), k


# -- B1 and B4 on staged windows ------------------------------------------------

SURFACE_MASKS = [("slope",), ("aspect",), ("curvature",), ("hillshade",),
                 ("slope", "hillshade"), PRODUCTS]


def surface_routes():
    return {"tma": cuda_surface.STAGED_TMA_LAUNCHES,
            "async": cuda_surface.STAGED_ASYNC_LAUNCHES,
            "simple": cuda_surface.SIMPLE_LAUNCHES,
            "all": cuda_surface.LAUNCHES}


def pipeline_routes():
    return {"tma": cuda_pipeline.TMA_LAUNCHES,
            "async": cuda_pipeline.ASYNC_LAUNCHES,
            "simple": cuda_pipeline.SIMPLE_LAUNCHES,
            "all": cuda_pipeline.LAUNCHES}


def off_by_four(x):
    """A contiguous copy of `x` whose base is 4 bytes past a 16-byte
    boundary (the staged kernels take cp.async from it)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def staged_raster(shape, seed):
    """NaN patches, +-inf cells and a flat block (aspect -1)."""
    rng = np.random.default_rng(seed)
    data = (rng.random(shape) * 100).astype(np.float32)
    h, w = shape
    data[h // 3:h // 3 + 3, w // 4:w // 4 + 5] = np.nan
    data[h // 2, w // 2] = np.inf
    data[h - 1, 0] = -np.inf
    data[(2 * h) // 3:(2 * h) // 3 + 6, w // 5:w // 5 + 6] = 40.0
    return data


@pytest.mark.gpu
@pytest.mark.parametrize("base", ["aligned", "base+4"])
@pytest.mark.parametrize("which", SURFACE_MASKS,
                         ids=["slope", "aspect", "curvature", "hillshade",
                              "slope+hillshade", "all"])
@pytest.mark.parametrize("shape", [(300, 70), (263, 516), (70, 300), (2, 5),
                                   (1, 1000)])
def test_surface_staged_route_equals_first_port(cuda, shape, which, base):
    """B1 on the route its plan names (TMA from an aligned base where
    w % 4 == 0, cp.async otherwise) equals its first port by name bit for
    bit: NaN ring, NaN patches, +-inf cells, aspect's -1 on flat cells;
    and its twin within the surface tolerance."""
    x = torch.from_numpy(staged_raster(shape, seed=41)).to(cuda)
    if base == "base+4":
        x = off_by_four(x)
    args = (2.0, 3.0, 300.0, 40.0)
    route = surface.surface_plan(*shape, x.data_ptr()).route
    assert route == ("tma" if shape[1] % 4 == 0 and base == "aligned"
                     else "async")
    before = surface_routes()
    got = cuda_surface.surface_cuda(x, which, *args)
    torch.cuda.synchronize()
    after = surface_routes()
    assert {k: after[k] - before[k] for k in after} == {
        "tma": int(route == "tma"), "async": int(route == "async"),
        "simple": 0, "all": 1}
    first = cuda_surface.surface_cuda(x, which, *args, route="simple")
    assert surface_routes()["simple"] == after["simple"] + 1
    ref = surface_multi(x, *args, which)
    for p, g, f in zip(which, got, first):
        assert_same_bits(g, f, p)
        if p != "aspect":
            assert_matches(g, ref[p], SURFACE_TOL, p)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", surface.SURFACE_TILES)
def test_surface_staged_tiles_equal_first_port(cuda, tile):
    x = torch.from_numpy(staged_raster((257, 1024), seed=42)).to(cuda)
    got = cuda_surface.surface_cuda(x, PRODUCTS, tile=tile)
    first = cuda_surface.surface_cuda(x, PRODUCTS, route="simple")
    torch.cuda.synchronize()
    for g, f in zip(got, first):
        assert_same_bits(g, f)


@pytest.mark.gpu
def test_surface_cuda_refuses_a_route_not_its_plans(cuda):
    x = torch.ones((64, 64), device=cuda)
    before = surface_routes()
    for route in ("async", "ring"):
        with pytest.raises(ValueError, match="route"):
            cuda_surface.surface_cuda(x, ("slope",), route=route)
    with pytest.raises(ValueError, match="no tile"):
        cuda_surface.surface_cuda(x, ("slope",), tile=(16, 128))
    assert surface_routes() == before


PIPELINE_FEET = {
    "plus": circle_kernel(1, 1, 1.5), "3x3": np.ones((3, 3)),
    "1x3": np.ones((1, 3)), "3x1": np.ones((3, 1)),
    "gate_65x129": np.ones((65, 129)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("base", ["aligned", "base+4"])
@pytest.mark.parametrize("shape", [(300, 70), (263, 516), (70, 300), (2, 5)])
@pytest.mark.parametrize("foot", list(PIPELINE_FEET))
def test_pipeline_staged_route_equals_first_port_and_split(cuda, foot,
                                                           shape, base):
    """B4 on the route its plan names equals its first port by name and the
    split kernels (staged B1 + staged B2) bit for bit, the row and column
    footprints (radii clamped to 1) and the fused gate's largest footprint
    included, with nodata."""
    x = torch.from_numpy(staged_raster(shape, seed=43)).to(cuda)
    if base == "base+4":
        x = off_by_four(x)
    offsets = kernel_offsets(PIPELINE_FEET[foot])
    args = (2.0, 3.0, 300.0, 40.0)
    route = pipeline.pipeline_plan(*shape, offsets, x.data_ptr()).route
    assert route == ("tma" if shape[1] % 4 == 0 and base == "aligned"
                     else "async")
    before = pipeline_routes()
    got = cuda_pipeline.pipeline_cuda(x, offsets, ALL_STATS, PRODUCTS, *args)
    torch.cuda.synchronize()
    after = pipeline_routes()
    assert {k: after[k] - before[k] for k in after} == {
        "tma": int(route == "tma"), "async": int(route == "async"),
        "simple": 0, "all": 1}
    first = cuda_pipeline.pipeline_cuda(x, offsets, ALL_STATS, PRODUCTS,
                                        *args, route="simple")
    split = (*cuda_surface.surface_cuda(x, PRODUCTS, *args),
             cuda_window.focal_stats_cuda(x, offsets, ALL_STATS))
    torch.cuda.synchronize()
    for k, (g, f, sp) in enumerate(zip(got, first, split)):
        assert_same_bits(g, f, str(k))
        assert_same_bits(g, sp, str(k))


@pytest.mark.gpu
def test_pipeline_cuda_refuses_a_route_not_its_plans(cuda):
    x = torch.ones((64, 64), device=cuda)
    offsets = kernel_offsets(PIPELINE_FEET["plus"])
    before = pipeline_routes()
    for route in ("async", "ring"):
        with pytest.raises(ValueError, match="route"):
            cuda_pipeline.pipeline_cuda(x, offsets, ("mean",), ("slope",),
                                        route=route)
    assert pipeline_routes() == before


def host_and_card(data, cuda):
    return (xt.DataArray(torch.from_numpy(data), dims=("y", "x"),
                         attrs={"res": (1.0, 1.0)}),
            xt.DataArray(torch.from_numpy(data).to(cuda), dims=("y", "x"),
                         attrs={"res": (1.0, 1.0)}))


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["conv_path", "convolution_2d", "mean",
                                "hotspots"])
def test_torch_op_paths_on_the_card_match_the_cpu(cuda, op):
    """PyTorch's default TF32 flags stay as they are: the port's own scope
    keeps cuDNN convolutions in float32."""
    rng = np.random.default_rng(37)
    data = (rng.random((96, 128)) * 100).astype(np.float32)
    data[40:44, 60:70] = np.nan
    host, card = host_and_card(data, cuda)
    if op == "conv_path":
        kernel = circle_kernel(1, 1, 20)
        stats = ["mean", "sum", "max", "min"]
        got = xt.focal_stats(card, kernel, stats).data
        ref = xt.focal_stats(host, kernel, stats).data
        assert_matches(got, ref, dict(rtol=1e-5, atol=1e-4))
    elif op == "convolution_2d":
        kernel = np.outer([1, 4, 6, 4, 1], [1, 4, 6, 4, 1]) / 256.0
        assert_matches(convolution_2d(card, kernel).data,
                       convolution_2d(host, kernel).data,
                       dict(rtol=1e-5, atol=1e-5))
    elif op == "mean":
        assert_matches(xt.mean(card, passes=2).data,
                       xt.mean(host, passes=2).data,
                       dict(rtol=1e-12, atol=0))
    else:
        got = focal.hotspots(card, circle_kernel(1, 1, 1.5)).data
        ref = focal.hotspots(host, circle_kernel(1, 1, 1.5)).data
        assert got.dtype == torch.int8 and got.device.type == "cuda"
        assert torch.equal(got.cpu(), ref)


def test_library_name_hashes_the_headers(tmp_path, monkeypatch):
    """Editing a csrc/*.cuh header, which the kernels share, renames the
    library, so a stale build is never loaded."""
    for src in list(_cuda.CSRC.glob("*.cu")) + list(_cuda.CSRC.glob("*.cuh")):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    first = _cuda._library_path()
    assert first.name.startswith("libxrspatial_torch-")
    assert _cuda._library_path() == first
    header = tmp_path / "focal_cell.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _cuda._library_path() != first
    assert [p.name for p in _cuda._sources()] == sorted(
        p.name for p in tmp_path.glob("*.cu"))


@pytest.mark.parametrize("call", [
    lambda x: cuda_surface.surface_cuda(x, ("slope",)),
    lambda x: cuda_window.focal_stats_cuda(x, ((0, 0), (0, 1)), ("mean",)),
    lambda x: cuda_window.focal_stats_halo_cuda(x, ((0, 0), (0, 300)),
                                                ("mean",)),
    lambda x: cuda_pipeline.pipeline_cuda(x, ((0, 0),), ("mean",),
                                          ("slope",)),
    lambda x: cuda_jfa.round_packed_cuda(x.to(torch.int32), None, 1, 0,
                                         (1.0, 1.0)),
    lambda x: cuda_jfa.round_coords_cuda(x, x, None, x[0], x[:, 0], 1, 0),
    lambda x: cuda_stencil_probe.stencil_probe_cuda(x, "copy"),
    lambda x: cuda_jfa_group.group_packed_cuda(x.to(torch.int32), (2, 1), 0,
                                               (1.0, 1.0)),
    lambda x: cuda_jfa_group.group_coords_cuda(x, x, x[0], x[:, 0], (2, 1),
                                               0),
], ids=["surface_cuda", "focal_stats_cuda", "round_packed_cuda",
        "round_coords_cuda", "focal_stats_halo_cuda", "pipeline_cuda",
        "stencil_probe_cuda", "group_packed_cuda", "group_coords_cuda"])
def test_raw_wrappers_refuse_a_cpu_tensor(call):
    """The kernel wrappers never run the twin: a CPU tensor is refused
    before anything is built or launched."""
    def counts():
        return (cuda_surface.LAUNCHES, cuda_window.LAUNCHES,
                cuda_window.HALO_LAUNCHES, cuda_pipeline.LAUNCHES,
                cuda_jfa.LAUNCHES, cuda_stencil_probe.LAUNCHES,
                cuda_jfa_group.LAUNCHES)

    before = counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        call(torch.ones((4, 5)))
    assert counts() == before


# -- the exact viewshed ---------------------------------------------------------

def vs_ridge(shape, seed):
    """A random ridge raster with NaN cells, as tests/test_torch_viewshed.py
    makes them."""
    rng = np.random.default_rng(seed)
    data = rng.random(shape) * 60.0
    data[shape[0] // 3, :] += 100.0
    data[np.unravel_index(rng.integers(0, data.size, 20), shape)] = np.nan
    return data


SCREEN_CASES = {
    "48x64": ((48, 64), 601, 20, (10, 10), 3.0, 0.5, 1.5),
    "64x48_corner": ((64, 48), 602, 20, (0, 0), 3.0, 0.5, 1.5),
    "96x112_nan_cells": ((96, 112), 603, 200, (50, 30), 3.0, 0.5, 1.0),
    "300x70": ((300, 70), 604, 20, (200, 60), 2.0, 0.0, 1.0),
    "257x1025": ((257, 1025), 605, 50, (100, 700), 2.0, 0.0, 1.0),
}


def screen_case(name, level, device):
    """chip_smoke.py's phase-13 inputs (its ridge rasters)."""
    shape, seed, n_nan, (vr, vc), oe, te, ew = SCREEN_CASES[name]
    rng = np.random.default_rng(seed)
    data = rng.random(shape) * 60.0
    data[shape[0] // 3, :] += 100.0
    data[np.unravel_index(rng.integers(0, data.size, n_nan), shape)] = np.nan
    return viewshed_exact.screen_inputs(data, vr, vc, oe, te, ew, -1.0,
                                        level=level, device=device)


def screen_routes():
    return (cuda_screen.LAUNCHES, cuda_screen.CULLED_LAUNCHES,
            cuda_screen.SIMPLE_LAUNCHES, cuda_screen.BOUNDS_LAUNCHES)


@pytest.mark.gpu
@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("name", list(SCREEN_CASES))
def test_screen_culled_route_equals_twin_and_first_port(cuda, name, level):
    """The culled route (the default) and the first port by name equal the
    twin bit for bit; the pre-pass equals its twin; the kernel's counters
    equal the CPU count of the (warp, chunk) pairs it culls."""
    from xrspatial_torch.kernels.emulate import blocks_of
    args = screen_case(name, level, cuda)
    before = screen_routes()
    stats = torch.zeros(4, dtype=torch.int64, device=cuda)
    hi, lo = cuda_screen.screen_hilo_cuda(*args, stats=stats)
    torch.cuda.synchronize()
    assert screen_routes() == (before[0] + 1, before[1] + 1, before[2],
                               before[3] + 1)
    ref_hi, ref_lo = screen.screen_hilo(*args)
    assert hi.dtype == (torch.float64 if level == 2 else torch.float32)
    assert torch.equal(hi, ref_hi) and torch.equal(lo, ref_lo)
    s_hi, s_lo = cuda_screen.screen_hilo_cuda(*args, route="simple")
    assert screen_routes()[2] == before[2] + 1
    assert torch.equal(s_hi, ref_hi) and torch.equal(s_lo, ref_lo)
    assert torch.equal(cuda_screen.chunk_bounds_cuda(args[0], args[1]),
                       screen.chunk_bounds(args[0], args[1]))
    host = tuple(a.cpu() if torch.is_tensor(a) else a for a in args[2:])
    host_tables = (tuple(t.cpu() for t in args[0]),
                   tuple(tuple(t.cpu() for t in st) for st in args[1]))
    kept = culled = pairs = 0
    for g, sl, a, k, _, _ in blocks_of(host_tables + host):
        live = (~torch.isnan(a)).reshape(-1, 128).sum(dim=1)
        k = k & (live > 0)[:, None]
        kept += int(k.sum())
        culled += int((~k & (live > 0)[:, None]).sum())
        pairs += int((k.sum(dim=1) * live).sum()) * 128
    assert stats.tolist()[:3] == [pairs, kept, culled]


@pytest.mark.gpu
def test_screen_wrapper_refuses_unaligned_tables_and_unknown_routes(cuda):
    args = list(screen_case("48x64", 1, cuda))
    gstk, gidx = args[0]
    odd = torch.empty(gstk.numel() + 1, dtype=gstk.dtype, device=cuda)
    odd = odd[1:].view(gstk.shape)
    odd.copy_(gstk)
    args[0] = (odd, gidx)
    before = screen_routes()
    with pytest.raises(ValueError, match="16-byte"):
        cuda_screen.screen_hilo_cuda(*args)
    with pytest.raises(ValueError, match="route"):
        cuda_screen.screen_hilo_cuda(*args, route="fast")
    stats = torch.zeros(4, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="culled route"):
        cuda_screen.screen_hilo_cuda(*args, route="simple", stats=stats)
    assert screen_routes() == before
    # the first port takes the unaligned table, by name
    hi, lo = cuda_screen.screen_hilo_cuda(*args, route="simple")
    ref = screen.screen_hilo(*args)
    assert torch.equal(hi, ref[0]) and torch.equal(lo, ref[1])


@pytest.mark.gpu
@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("shape,vp", [((48, 64), (10, 10)),
                                      ((64, 48), (0, 0)),
                                      ((300, 70), (200, 60))])
def test_screen_kernel_matches_twin(cuda, shape, vp, level):
    args = viewshed_exact.screen_inputs(vs_ridge(shape, 7), vp[0], vp[1],
                                        3.0, 0.5, 1.5, -1.0, level=level,
                                        device=cuda)
    before = cuda_screen.LAUNCHES
    hi, lo = cuda_screen.screen_hilo_cuda(*args)
    ref_hi, ref_lo = screen.screen_hilo(*args)
    torch.cuda.synchronize()
    assert cuda_screen.LAUNCHES == before + 1
    assert hi.dtype == (torch.float64 if level == 2 else torch.float32)
    assert torch.equal(hi, ref_hi) and torch.equal(lo, ref_lo)


@pytest.mark.gpu
def test_viewshed_on_the_card_matches_the_cpu(cuda):
    data = vs_ridge((96, 112), 9)
    coords = {"y": np.arange(96, dtype=float)[::-1].copy(),
              "x": np.arange(112, dtype=float)}

    def run(t):
        agg = xt.DataArray(t, dims=("y", "x"), coords=coords)
        return xt.viewshed(agg, x=30, y=45, observer_elev=3.0,
                           target_elev=0.5).data

    host = run(torch.from_numpy(data))
    before = cuda_screen.LAUNCHES
    card = run(torch.from_numpy(data).to(cuda))
    torch.cuda.synchronize()
    assert cuda_screen.LAUNCHES > before
    assert card.device.type == "cuda" and card.dtype == torch.float64
    assert torch.equal(card.cpu() == -1, host == -1)
    np.testing.assert_allclose(card.cpu().numpy(), host.numpy(), rtol=1e-12,
                               atol=0)


STACK_ORDERS = {"all": PRODUCTS, "hillshade_slope": ("hillshade", "slope"),
                "curvature": ("curvature",)}


@pytest.mark.gpu
@pytest.mark.parametrize("squeeze", [False, True])
@pytest.mark.parametrize("order", list(STACK_ORDERS))
@pytest.mark.parametrize("name", ["patches_70x300", "row_1x257", "col_300x2",
                                  "elevation_8x6"])
def test_stacked_kernel_matches_surface_kernel_and_twin(cuda, name, order,
                                                         squeeze):
    data, (csx, csy) = surface_case(name)
    which = STACK_ORDERS[order]
    x = torch.from_numpy(data).to(cuda)
    args = (csx, csy, 300.0, 40.0)
    before = (cuda_surface.STACKED_LAUNCHES, cuda_surface.LAUNCHES)
    got = cuda_surface.surface_stacked_cuda(x, which, *args, squeeze=squeeze)
    torch.cuda.synchronize()
    assert cuda_surface.STACKED_LAUNCHES == before[0] + 1
    assert cuda_surface.LAUNCHES == before[1]
    twin = surface.surface_multi_stacked(x, *args, which=which,
                                         squeeze=squeeze)
    assert got.shape == twin.shape and got.device == x.device
    split = cuda_surface.surface_cuda(x, which, *args)
    planes = got[None] if got.ndim == 2 else got
    for k, p in enumerate(which):
        assert torch.equal(torch.isnan(planes[k]), torch.isnan(split[k]))
        assert torch.equal(torch.nan_to_num(planes[k]),
                           torch.nan_to_num(split[k])), p
    assert_matches(got, twin, SURFACE_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(70, 300), (257, 1025), (263, 516),
                                   (2, 5), (40, 119), (1, 1000)])
def test_stacked_routes_match_first_port_and_surface_kernel(cuda, shape):
    """B0 on the plan's route (TMA where w % 4 == 0 and the base is
    aligned, else phased), on the phased route by name and on its first
    port by name: every plane equal to B1's product and to the first
    port's bit for bit, from an aligned base and one 4 bytes off, each
    launch counted on its route."""
    rng = np.random.default_rng(43)
    data = (rng.random(shape) * 500).astype(np.float32)
    data[shape[0] // 3, shape[1] // 4:shape[1] // 2] = np.nan
    data[shape[0] // 2, shape[1] // 2] = np.inf
    flat = torch.empty(data.size + 1, device=cuda)
    for off in (0, 1):
        x = flat[off:off + data.size].view(shape)
        x.copy_(torch.from_numpy(data))
        for which in (PRODUCTS, ("hillshade", "slope"), ("curvature",)):
            b1 = cuda_surface.surface_cuda(x, which, 2.0, 3.0, 300.0, 40.0)
            plan = surface.stacked_plan(*shape, x.data_ptr())
            for route in (None, "phased", "simple"):
                want = plan.route if route is None else route
                before = (cuda_surface.STACKED_TMA_LAUNCHES,
                          cuda_surface.STACKED_PHASED_LAUNCHES,
                          cuda_surface.STACKED_SIMPLE_LAUNCHES)
                got = cuda_surface.surface_stacked_cuda(
                    x, which, 2.0, 3.0, 300.0, 40.0, route=route)
                torch.cuda.synchronize()
                after = (cuda_surface.STACKED_TMA_LAUNCHES,
                         cuda_surface.STACKED_PHASED_LAUNCHES,
                         cuda_surface.STACKED_SIMPLE_LAUNCHES)
                assert tuple(a - b for a, b in zip(after, before)) == tuple(
                    int(want == r) for r in ("tma", "phased", "simple"))
                for k, p in enumerate(which):
                    tag = f"{shape} +{off} {route} {p}"
                    assert torch.equal(torch.isnan(got[k]),
                                       torch.isnan(b1[k])), tag
                    assert torch.equal(torch.nan_to_num(got[k]),
                                       torch.nan_to_num(b1[k])), tag


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 5, 1023, 4096 * 33 + 3])
def test_stream_kernels_match_twins(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    base = torch.randn(n + 1, generator=gen, device=cuda) * 100
    other = torch.randn(n + 1, generator=gen, device=cuda)
    # aligned (the float4 path) and offset by one value (the scalar path)
    for x, y in ((base[:n], other[:n]), (base[1:], other[1:])):
        before = (cuda_stream.COPY_LAUNCHES, cuda_stream.ADD_LAUNCHES)
        c = cuda_stream.stream_copy_cuda(x)
        a = cuda_stream.stream_add_cuda(x, y)
        torch.cuda.synchronize()
        assert (cuda_stream.COPY_LAUNCHES, cuda_stream.ADD_LAUNCHES) == (
            before[0] + 1, before[1] + 1)
        assert torch.equal(c, stream.stream_copy(x))
        assert torch.equal(a, stream.stream_add(x, y))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 17, 1023, 8192 * 5 + 7, 4096 * 257 + 3])
def test_stream_copy_matches_twin_at_every_alignment(cuda, n):
    """The copy at offsets 0-3 floats of each pointer, mismatched ones
    (the scalar route) included: equal to the twin bit for bit, and
    nothing written outside the output."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    base = torch.randn(n + 4, generator=gen, device=cuda) * 1e3
    base[n // 2] = np.nan
    for xo in range(4):
        for yo in range(4):
            x = base[xo:xo + n]
            dest = torch.full((n + 4,), -7.0, device=cuda)
            before = cuda_stream.COPY_LAUNCHES
            cuda_stream.stream_copy_cuda(x, out=dest[yo:yo + n])
            torch.cuda.synchronize()
            assert cuda_stream.COPY_LAUNCHES == before + 1
            assert torch.equal(dest[yo:yo + n].view(torch.int32),
                               stream.stream_copy(x).view(torch.int32)), (
                xo, yo)
            rest = torch.cat([dest[:yo], dest[yo + n:]])
            assert bool((rest == -7.0).all()), (xo, yo)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 17, 1023, 4096 * 5 + 7, 4096 * 257 + 3])
def test_stream_add_matches_twin_at_every_alignment(cuda, n):
    """The add at offsets 0-3 floats of x, y and z: all alike (the bulk
    route, a scalar head and tail) or not (the scalar route), equal to
    the twin bit for bit, and nothing written outside the output."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    xs = torch.randn(n + 4, generator=gen, device=cuda) * 1e3
    ys = torch.randn(n + 4, generator=gen, device=cuda)
    xs[n // 2] = np.nan
    ys[0] = -np.inf
    for xo in range(4):
        for yo in range(4):
            for zo in range(4):
                x, y = xs[xo:xo + n], ys[yo:yo + n]
                dest = torch.full((n + 4,), -7.0, device=cuda)
                before = cuda_stream.ADD_LAUNCHES
                cuda_stream.stream_add_cuda(x, y, out=dest[zo:zo + n])
                torch.cuda.synchronize()
                assert cuda_stream.ADD_LAUNCHES == before + 1
                assert torch.equal(
                    dest[zo:zo + n].view(torch.int32),
                    stream.stream_add(x, y).view(torch.int32)), (xo, yo, zo)
                rest = torch.cat([dest[:zo], dest[zo + n:]])
                assert bool((rest == -7.0).all()), (xo, yo, zo)


@pytest.mark.gpu
def test_a_cuda_tensor_never_reaches_a_twin(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a twin ran on a CUDA tensor")

    for mod, name in ((surface, "surface_multi_stacked"),
                      (surface, "surface_multi"), (stream, "stream_copy"),
                      (stream, "stream_add")):
        monkeypatch.setattr(mod, name, refuse)
    x = torch.from_numpy(surface_case("patches_70x300")[0]).to(cuda)
    before = (cuda_surface.STACKED_LAUNCHES, cuda_surface.LAUNCHES,
              cuda_stream.COPY_LAUNCHES, cuda_stream.ADD_LAUNCHES)
    surface.surface_stacked(x, which=PRODUCTS)
    surface.surface_kernels(x, ("slope",))
    stream.copy(x)
    stream.add(x, x)
    torch.cuda.synchronize()
    assert (cuda_surface.STACKED_LAUNCHES, cuda_surface.LAUNCHES,
            cuda_stream.COPY_LAUNCHES, cuda_stream.ADD_LAUNCHES) == tuple(
        b + 1 for b in before)


@pytest.mark.gpu
def test_numpy_raster_runs_on_the_card(cuda):
    saved = xt.default_device()
    xt.set_default_device("cuda")
    try:
        data, res = surface_case("patches_70x300")
        before = cuda_surface.LAUNCHES
        out = xt.slope(xt.DataArray(data, dims=("y", "x"),
                                    attrs={"res": res})).data
        torch.cuda.synchronize()
    finally:
        xt.set_default_device(saved)
    assert out.device.type == "cuda"
    assert cuda_surface.LAUNCHES == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["slope", "aspect"])
def test_geodesic_on_the_card_matches_the_cpu(cuda, op):
    rng = np.random.default_rng(21)
    data = (rng.random((61, 47)) * 800).astype(np.float32)
    data[20:24, 10:15] = np.nan
    coords = {"y": 46.0 - np.arange(61) / 3600.0,
              "x": 7.0 + np.arange(47) / 3600.0}

    def run(t):
        agg = xt.DataArray(t, dims=("y", "x"), coords=coords)
        return getattr(xt, op)(agg, method="geodesic").data

    got = run(torch.from_numpy(data).to(cuda))
    assert got.device.type == "cuda" and got.dtype == torch.float32
    assert_matches(got, run(torch.from_numpy(data)),
                   dict(rtol=1e-6, atol=1e-8))


@pytest.mark.gpu
@pytest.mark.parametrize("azimuth", [0, 90, 225, 315])
def test_shadows_on_the_card_match_the_cpu(cuda, azimuth):
    iy, ix = np.mgrid[0:83, 0:117].astype(np.float32)
    data = (400 * np.exp(-((iy - 40) ** 2 + (ix - 60) ** 2) / 900)
            + 15 * np.sin(ix / 5) * np.cos(iy / 7)).astype(np.float32)
    data[30:36, 70:80] = np.nan
    host = torch.from_numpy(data)
    lit = shadows.shadow_mask(host.to(cuda), azimuth, 10, 30.0, 30.0)
    assert torch.equal(lit.cpu(), shadows.shadow_mask(host, azimuth, 10,
                                                      30.0, 30.0))
    got = shadows.hillshade_shadows(host.to(cuda), azimuth, 10, 30.0, 30.0)
    ref = shadows.hillshade_shadows(host, azimuth, 10, 30.0, 30.0)
    assert_matches(got, ref, dict(rtol=1e-6, atol=1e-6))


# -- the stencil probes (B8c-f) and the fused jump-flood group (B8g) -----------

PROBE_VARIANTS = [(mode, form, edges, block)
                  for mode, form, edges in stencil_probe.VARIANTS
                  if form not in stencil_probe.STAGED_FORMS
                  for block in stencil_probe.BLOCKS]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(300, 70), (257, 1025), (2, 5), (9, 40)])
def test_stencil_probe_kernel_matches_twin_and_surface_kernel(cuda, shape):
    """Every instantiation against its twin (copy equal to the input, the
    rest within the surface tolerance); ring, interior and the cells bare
    writes equal the surface kernel's slope bit for bit."""
    rng = np.random.default_rng(41)
    data = (rng.random(shape) * 100).astype(np.float32)
    data[shape[0] // 3, shape[1] // 4:shape[1] // 2] = np.nan
    x = torch.from_numpy(data).to(cuda)
    b1 = cuda_surface.surface_cuda(x, ("slope",))[0]
    for mode, form, edges, block in PROBE_VARIANTS:
        r0, r1, c0, c1 = stencil_probe.interior_extent(*shape, block)
        inner = (r1 - r0) * (c1 - c0)
        # ring: one launch; interior and bare: one on the interior blocks,
        # if any; interior: one more on the edge bands
        want = (int(edges == "ring" or inner > 0),
                int(edges == "interior" and inner < x.numel()))
        before = (cuda_stencil_probe.LAUNCHES,
                  cuda_stencil_probe.EDGE_LAUNCHES)
        got = cuda_stencil_probe.stencil_probe_cuda(x, mode, form, edges,
                                                    block)
        torch.cuda.synchronize()
        assert (cuda_stencil_probe.LAUNCHES - before[0],
                cuda_stencil_probe.EDGE_LAUNCHES - before[1]) == want
        ref = stencil_probe.stencil_twin(x, mode, form, edges, block)
        tag = f"{mode} {form} {edges} {block}"
        region = (slice(None), slice(None))
        if edges == "bare":
            region = (slice(r0, r1), slice(c0, c1))
        if mode == "copy":
            assert torch.equal(got.view(torch.int32), x.view(torch.int32)), \
                tag
            continue
        assert_matches(got[region], ref[region], SURFACE_TOL, tag)
        if mode == "slope" and form == "nine":
            g, r = got[region], b1[region]
            assert torch.equal(torch.isnan(g), torch.isnan(r)), tag
            assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(r)), tag


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(300, 70), (257, 1025), (2, 5), (9, 40),
                                   (263, 516)])
def test_staged_stencil_matches_twin_and_surface_kernel(cuda, shape):
    """The staged form (B8c) at every tile: copy equal to the input bit
    for bit, grad and slope within the surface tolerance of the twin,
    slope equal to the surface kernel bit for bit with the NaN ring (the
    TMA map's NaN fill or the cp.async route's NaN stores); one launch on
    the route its plan names (TMA where w % 4 == 0)."""
    rng = np.random.default_rng(47)
    data = (rng.random(shape) * 1000).astype(np.float32)
    data[shape[0] // 3, shape[1] // 4:shape[1] // 2] = np.nan
    x = torch.from_numpy(data).to(cuda)
    b1 = cuda_surface.surface_cuda(x, ("slope",))[0]
    for tile in stencil_probe.TILES:
        route = stencil_probe.staged_plan(*shape, tile, x.data_ptr()).route
        assert route == ("tma" if shape[1] % 4 == 0 else "async")
        for mode in stencil_probe.MODES:
            tag = f"{mode} staged {tile}"
            before = (cuda_stencil_probe.TMA_LAUNCHES,
                      cuda_stencil_probe.ASYNC_LAUNCHES,
                      cuda_stencil_probe.LAUNCHES)
            got = cuda_stencil_probe.stencil_probe_cuda(x, mode, "staged",
                                                        block=tile)
            torch.cuda.synchronize()
            assert (cuda_stencil_probe.TMA_LAUNCHES - before[0],
                    cuda_stencil_probe.ASYNC_LAUNCHES - before[1],
                    cuda_stencil_probe.LAUNCHES - before[2]) == (
                route == "tma", route == "async", 0), tag
            if mode == "copy":
                assert torch.equal(got.view(torch.int32),
                                   x.view(torch.int32)), tag
                continue
            ref = stencil_probe.stencil_twin(x, mode, "staged", block=tile)
            assert_matches(got, ref, SURFACE_TOL, tag)
            if mode == "slope":
                assert torch.equal(torch.isnan(got), torch.isnan(b1)), tag
                assert torch.equal(torch.nan_to_num(got),
                                   torch.nan_to_num(b1)), tag


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(300, 70), (257, 1025), (2, 5), (9, 40),
                                   (263, 516)])
def test_separable_staged_matches_first_port_separable(cuda, shape):
    """B8d's staged separable form at every tile equals the first-port
    separable form bit for bit, NaN ring included, and its twin within the
    surface tolerance; one launch on the route its plan names, from an
    aligned base and one 4 bytes off."""
    rng = np.random.default_rng(49)
    data = (rng.random(shape) * 1000).astype(np.float32)
    data[shape[0] // 3, shape[1] // 4:shape[1] // 2] = np.nan
    flat = torch.empty(data.size + 1, device=cuda)
    for off in (0, 1):
        x = flat[off:off + data.size].view(shape)
        x.copy_(torch.from_numpy(data))
        first = cuda_stencil_probe.stencil_probe_cuda(x, "slope", "separable")
        ref = stencil_probe.stencil_twin(x, "slope", "separable")
        for tile in stencil_probe.TILES:
            route = stencil_probe.staged_plan(*shape, tile,
                                              x.data_ptr()).route
            before = (cuda_stencil_probe.SEP_TMA_LAUNCHES,
                      cuda_stencil_probe.SEP_ASYNC_LAUNCHES,
                      cuda_stencil_probe.TMA_LAUNCHES,
                      cuda_stencil_probe.ASYNC_LAUNCHES)
            got = cuda_stencil_probe.stencil_probe_cuda(
                x, "slope", "separable_staged", block=tile)
            torch.cuda.synchronize()
            after = (cuda_stencil_probe.SEP_TMA_LAUNCHES,
                     cuda_stencil_probe.SEP_ASYNC_LAUNCHES,
                     cuda_stencil_probe.TMA_LAUNCHES,
                     cuda_stencil_probe.ASYNC_LAUNCHES)
            tag = f"{shape} +{off} {tile}"
            assert tuple(a - b for a, b in zip(after, before)) == (
                route == "tma", route == "async", 0, 0), tag
            assert torch.equal(torch.isnan(got), torch.isnan(first)), tag
            assert torch.equal(torch.nan_to_num(got),
                               torch.nan_to_num(first)), tag
            assert_matches(got, ref, SURFACE_TOL, tag)


STAGED_EDGES = ("interior", "bare", "ring_branch")


def staged_edge_counts():
    return (cuda_stencil_probe.INTERIOR_TMA_LAUNCHES,
            cuda_stencil_probe.INTERIOR_ASYNC_LAUNCHES,
            cuda_stencil_probe.RING_TMA_LAUNCHES,
            cuda_stencil_probe.RING_ASYNC_LAUNCHES,
            cuda_stencil_probe.EDGE_LAUNCHES,
            cuda_stencil_probe.TMA_LAUNCHES,
            cuda_stencil_probe.ASYNC_LAUNCHES,
            cuda_stencil_probe.LAUNCHES)


@pytest.mark.gpu
@pytest.mark.parametrize("base", ["aligned", "base+4"])
@pytest.mark.parametrize("shape", [(263, 516), (257, 1025), (45, 300),
                                   (40, 70)])
def test_staged_edges_equal_the_surface_kernel(cuda, shape, base):
    """B8e's and B8f's redesigns at every tile: edges interior (the
    interior walk and the edge bands) and ring_branch equal the surface
    kernel's slope bit for bit, NaN ring included; bare equals it on
    ``staged_interior_extent``.  Each launch counted on the route its plan
    names: the interior walk's on TMA where w % 4 == 0 and the base is
    aligned (263x516, 45x300), else on cp.async; none where the raster
    has no interior (40x70, and 45x300 at 64x128)."""
    data = staged_raster(shape, seed=53)
    x = torch.from_numpy(data).to(cuda)
    b1 = cuda_surface.surface_cuda(x, ("slope",))[0]
    if base == "base+4":
        x = off_by_four(x)
    for tile in stencil_probe.TILES:
        for edges in STAGED_EDGES:
            walk = "full" if edges == "ring_branch" else "interior"
            plan = stencil_probe.staged_plan(*shape, tile, x.data_ptr(),
                                             walk=walk)
            assert plan.route == ("tma" if shape[1] % 4 == 0
                                  and base == "aligned" else "async")
            tma, ran = plan.route == "tma", plan.tiles > 0
            want = {"interior": (tma and ran, ran and not tma, 0, 0, 1),
                    "bare": (tma and ran, ran and not tma, 0, 0, 0),
                    "ring_branch": (0, 0, tma, not tma, 0)}[edges]
            before = staged_edge_counts()
            got = cuda_stencil_probe.stencil_probe_cuda(x, "slope", "staged",
                                                        edges, tile)
            torch.cuda.synchronize()
            tag = f"{shape} {base} {edges} {tile}"
            assert tuple(a - b for a, b in zip(staged_edge_counts(),
                                               before)) == (*want, 0, 0, 0), \
                tag
            r0, r1, c0, c1 = stencil_probe.bare_extent(*shape, "staged", tile)
            if edges == "bare":
                assert (r1 - r0) * (c1 - c0) > 0 or not ran, tag
                got, ref = got[r0:r1, c0:c1], b1[r0:r1, c0:c1]
            else:
                ref = b1
            assert torch.equal(torch.isnan(got), torch.isnan(ref)), tag
            assert torch.equal(torch.nan_to_num(got),
                               torch.nan_to_num(ref)), tag


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(263, 516), (257, 1025), (40, 70)])
def test_edge_bands_alone_write_only_the_bands(cuda, shape):
    """One launch of the edge-band kernel writes the surface kernel's slope
    outside the extent and leaves the interior as it was."""
    data = staged_raster(shape, seed=59)
    x = torch.from_numpy(data).to(cuda)
    b1 = cuda_surface.surface_cuda(x, ("slope",))[0]
    extent = stencil_probe.staged_interior_extent(*shape)
    r0, r1, c0, c1 = extent
    out = torch.full_like(x, 7.0)
    before = cuda_stencil_probe.EDGE_LAUNCHES
    cuda_stencil_probe.edge_bands_cuda(x, out, extent)
    torch.cuda.synchronize()
    assert cuda_stencil_probe.EDGE_LAUNCHES == before + 1
    inside = torch.zeros(shape, dtype=torch.bool, device=cuda)
    inside[r0:r1, c0:c1] = True
    assert bool((out[inside] == 7.0).all())
    got, ref = out[~inside], b1[~inside]
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(ref))


@pytest.mark.gpu
def test_staged_stencil_takes_cp_async_from_an_unaligned_base(cuda):
    """A raster whose pitch suits TMA but whose base is not 16-byte
    aligned takes the cp.async route, with the same bits."""
    flat = torch.rand(65 * 128 + 1, device=cuda) * 100
    x = flat[1:].view(65, 128)
    plan = stencil_probe.staged_plan(65, 128, (32, 128), x.data_ptr())
    assert plan.route == "async"
    before = cuda_stencil_probe.ASYNC_LAUNCHES
    got = cuda_stencil_probe.stencil_probe_cuda(x, "slope", "staged")
    torch.cuda.synchronize()
    assert cuda_stencil_probe.ASYNC_LAUNCHES == before + 1
    ref = cuda_surface.surface_cuda(x.contiguous(), ("slope",))[0]
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(ref))
    assert torch.equal(torch.isnan(got), torch.isnan(ref))


@pytest.mark.gpu
def test_stencil_probe_wrapper_refuses_what_it_cannot_take(cuda):
    x = torch.zeros((8, 8), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        cuda_stencil_probe.stencil_probe_cuda(x.double())
    with pytest.raises(ValueError, match="instantiation"):
        cuda_stencil_probe.stencil_probe_cuda(x, "copy", "separable")
    with pytest.raises(ValueError, match="instantiation"):
        cuda_stencil_probe.stencil_probe_cuda(x, "copy", "staged", "ring",
                                              (32, 8))
    with pytest.raises(ValueError, match="instantiation"):
        cuda_stencil_probe.stencil_probe_cuda(x, "slope", "nine",
                                              "ring_branch", (32, 8))


GROUP_CASES = {"packed_euclidean": ("packed", 0),
               "packed_manhattan": ("packed", 2),
               "coords_euclidean": ("coords", 0),
               "coords_great_circle": ("coords", 1),
               "coords_manhattan": ("coords", 2)}


@pytest.mark.gpu
@pytest.mark.parametrize("ks", [jfa_group.TAIL, (64,), (2, 1)],
                         ids=["tail", "64", "2_1"])
@pytest.mark.parametrize("shape", [(300, 70), (257, 1025)])
@pytest.mark.parametrize("case", list(GROUP_CASES))
def test_jfa_group_kernel_equals_round_kernel(cuda, case, shape, ks):
    """One launch of the group equals the round kernel launched once per
    stride, bit for bit, in every plane."""
    form, metric = GROUP_CASES[case]
    try:
        jfa_group.window_plan(ks, form)
    except ValueError:
        pytest.skip(f"the {form} window of {ks} does not fit, by design")
    rng = np.random.default_rng(43)
    mask = torch.from_numpy(rng.random(shape) < 0.01).to(cuda)
    ys, xs = (torch.from_numpy(a).to(cuda) for a in jfa_axes(
        "lonlat" if metric == 1 else "affine", *shape))
    tx = torch.where(mask, xs[None, :], np.inf)
    ty = torch.where(mask, ys[:, None], np.inf)
    # run the first rounds of the schedule, so the group starts from a
    # state with targets everywhere
    for k in (64, 32):
        tx, ty, _ = cuda_jfa.round_coords_cuda(tx, ty, None, xs, ys, k,
                                               metric)
    before = cuda_jfa_group.LAUNCHES
    if form == "packed":
        steps = jfa.packed_state_plan(xs.cpu().numpy(), ys.cpu().numpy(),
                                      metric)[0]
        iy = torch.arange(shape[0], dtype=torch.int32, device=cuda)[:, None]
        ix = torch.arange(shape[1], dtype=torch.int32, device=cuda)[None, :]
        state = torch.where(mask, (iy << 15) | ix, -1)
        got = (cuda_jfa_group.group_packed_cuda(state, ks, metric, steps),)
        ref = state
        for k in ks:
            ref, _, _ = cuda_jfa.round_packed_cuda(ref, None, k, metric,
                                                   steps)
        ref = (ref,)
    else:
        got = cuda_jfa_group.group_coords_cuda(tx, ty, xs, ys, ks, metric)
        ref = (tx, ty)
        for k in ks:
            ref = cuda_jfa.round_coords_cuda(*ref, None, xs, ys, k,
                                             metric)[:2]
    torch.cuda.synchronize()
    assert cuda_jfa_group.LAUNCHES == before + 1
    for g, r in zip(got, ref):
        assert torch.equal(g, r), case


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(300, 70), (257, 1025), (256, 512)])
@pytest.mark.parametrize("case", list(GROUP_CASES))
def test_jfa_group_single_equals_its_first_port(cuda, case, shape):
    """The single-buffered route (TMA where w % 4 == 0, cp.async
    elsewhere) against the double-buffered first port by name, bit for
    bit, on the tail group."""
    form, metric = GROUP_CASES[case]
    rng = np.random.default_rng(44)
    mask = torch.from_numpy(rng.random(shape) < 0.01).to(cuda)
    ys, xs = (torch.from_numpy(a).to(cuda) for a in jfa_axes(
        "lonlat" if metric == 1 else "affine", *shape))
    tx = torch.where(mask, xs[None, :], np.inf)
    ty = torch.where(mask, ys[:, None], np.inf)
    for k in (64, 32):
        tx, ty, _ = cuda_jfa.round_coords_cuda(tx, ty, None, xs, ys, k,
                                               metric)
    ks = jfa_group.TAIL
    if form == "packed":
        steps = jfa.packed_state_plan(xs.cpu().numpy(), ys.cpu().numpy(),
                                      metric)[0]
        # the packed form of the coordinate state on these affine axes
        iy = (ys.numel() - 1 - (ty / 0.5).round()).int()
        state = torch.where(tx < np.inf, (iy << 15) | (tx / 0.5).round()
                            .int(), -1)

        def run(route):
            return (cuda_jfa_group.group_packed_cuda(state, ks, metric,
                                                     steps, route),)
    else:
        def run(route):
            return cuda_jfa_group.group_coords_cuda(tx, ty, xs, ys, ks,
                                                    metric, route)
    first = run("double")
    before = (cuda_jfa_group.SINGLE_LAUNCHES, cuda_jfa_group.DOUBLE_LAUNCHES)
    got = run("single")
    torch.cuda.synchronize()
    assert (cuda_jfa_group.SINGLE_LAUNCHES,
            cuda_jfa_group.DOUBLE_LAUNCHES) == (before[0] + 1, before[1])
    for g, r in zip(got, first):
        assert torch.equal(g, r), case


@pytest.mark.gpu
def test_jfa_group_wrapper_refuses_what_it_cannot_take(cuda):
    state = torch.full((16, 16), -1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        cuda_jfa_group.group_packed_cuda(
            state, (64, 32, 16, 8, 4, 2, 1, 2, 1), 0, (1.0, 1.0))
    with pytest.raises(ValueError, match="int32"):
        cuda_jfa_group.group_packed_cuda(state.float(), (2, 1), 0,
                                         (1.0, 1.0))
    with pytest.raises(ValueError, match="metrics"):
        cuda_jfa_group.group_packed_cuda(state, (2, 1), 1, (1.0, 1.0))


# -- A5/A6: the shim, multispectral, local and classify as torch ops ----------

def a5_bands(dev):
    rng = np.random.default_rng(21)
    bands = [(rng.random((96, 130)) * 2).astype(np.float32) for _ in range(3)]
    bands[0][4, 5] = np.nan
    for b in bands:
        b[7, 9] = 0.0
    return [xt.DataArray(torch.from_numpy(b).to(dev), dims=("y", "x"))
            for b in bands]


A5_CALLS = {
    "shim_arithmetic": lambda m, b: (b[0] + b[1] * 2 - 1) / (abs(b[2]) + 1),
    "shim_compare_where": lambda m, b: b[0].where(b[0] > 0.5, -1.0),
    "shim_fillna": lambda m, b: b[0].fillna(7.0),
    "shim_reduce_mean": lambda m, b: b[0].mean(),
    "shim_reduce_std_x": lambda m, b: b[0].std(dim="x"),
    "shim_reduce_min": lambda m, b: b[0].min(skipna=False),
    "shim_isel_astype": lambda m, b: b[0].isel(y=slice(3, 40)).astype(
        np.float64),
    "shim_concat": lambda m, b: xt.concat([b[0], b[1]], "t"),
    "ndvi": lambda m, b: m["ms"].ndvi(b[0], b[1]),
    "arvi": lambda m, b: m["ms"].arvi(b[0], b[1], b[2]),
    "evi": lambda m, b: m["ms"].evi(b[0], b[1], b[2]),
    "savi": lambda m, b: m["ms"].savi(b[0], b[1], soil_factor=0.3),
    "ebbi": lambda m, b: m["ms"].ebbi(b[0], b[1], b[2]),
    "cell_stats_median": lambda m, b: m["local"].cell_stats(
        xt.Dataset({"a": b[0], "b": b[1], "c": b[2], "d": b[1]}),
        func="median"),
    "cell_stats_std": lambda m, b: m["local"].cell_stats(
        xt.Dataset({"a": b[0], "b": b[1], "c": b[2]}), func="std"),
    "popularity": lambda m, b: m["local"].popularity(
        xt.Dataset({"a": b[0], "b": b[0], "c": b[2], "r": b[1] * 3 - 2}),
        "r"),
    "rank": lambda m, b: m["local"].rank(
        xt.Dataset({"a": b[0], "b": b[1], "c": b[2], "r": b[1] * 3 - 2}),
        "r"),
    "quantile": lambda m, b: m["cl"].quantile(b[0], k=5),
    "percentiles": lambda m, b: m["cl"].percentiles(b[1]),
    "std_mean": lambda m, b: m["cl"].std_mean(b[1]),
    "head_tail_breaks": lambda m, b: m["cl"].head_tail_breaks(b[2]),
    "box_plot": lambda m, b: m["cl"].box_plot(b[2]),
}


# rtol 1e-6 where the card sums in another order than the CPU; ebbi within
# 2 ulps, since the CPU's float32 sqrt is 1 ulp off in some values
A5_RTOL = {"shim_reduce_mean": 1e-6,
           "shim_reduce_std_x": 1e-6, "cell_stats_std": 1e-6,
           "ebbi": 2.5e-7}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(A5_CALLS))
def test_a5_a6_paths_on_the_card_match_the_cpu(cuda, name):
    """The result stays on the card and equals the same call on the CPU,
    bit for bit but where ``A5_RTOL`` says."""
    from xrspatial_torch import classify, local, multispectral
    mods = {"ms": multispectral, "local": local, "cl": classify}
    got = A5_CALLS[name](mods, a5_bands(cuda))
    ref = A5_CALLS[name](mods, a5_bands("cpu"))
    assert isinstance(got.data, torch.Tensor)
    assert got.data.device.type == "cuda", got.data.device
    g, r = got.values, ref.values
    assert g.dtype == r.dtype and g.shape == r.shape
    assert np.array_equal(np.isnan(g), np.isnan(r))
    np.testing.assert_allclose(g, r, equal_nan=True, atol=0,
                               rtol=A5_RTOL.get(name, 0.0))


@pytest.mark.gpu
def test_true_color_on_the_card(cuda):
    from xrspatial_torch import multispectral
    got = multispectral.true_color(*a5_bands(cuda))
    ref = multispectral.true_color(*a5_bands("cpu"))
    assert got.data.device.type == "cuda" and got.data.dtype == torch.uint8
    diff = np.abs(got.values.astype(int) - ref.values.astype(int))
    assert diff.max() <= 1 and (got.values[..., 3] == ref.values[..., 3]).all()


@pytest.mark.gpu
def test_jenks_on_the_card(cuda):
    """The card's prefix sums add in another order than the CPU's: the
    breaks may differ at a near-tie, the float64 within-class variance
    they reach agrees within rtol 1e-5."""
    from xrspatial_torch import classify
    values = (np.random.default_rng(4).random(800) * 100).astype(np.float32)
    got = classify._run_jenks(values, 5, cuda)[1:]
    ref = classify._run_jenks(values, 5, torch.device("cpu"))[1:]

    def within(bins):
        v = np.sort(values.astype(np.float64))
        idx = np.searchsorted(bins.astype(np.float64), v, side="left")
        return sum(((v[idx == c] - v[idx == c].mean()) ** 2).sum()
                   for c in np.unique(idx))

    np.testing.assert_allclose(within(got), within(ref), rtol=1e-5)
    out = classify.natural_breaks(a5_bands(cuda)[0], k=4, num_sample=300)
    assert out.data.device.type == "cuda"


# -- A7 and A11 (X1): zonal on the card, the XDraw scan kernel -----------------

# h != w both ways, a row and a column, ragged sizes, and one side above
# the 29,056 cells a block's shared memory holds (the scratch route)
XDRAW_SHAPES = ((17, 1), (1, 23), (300, 70), (70, 300), (263, 516),
                (1, 30000), (30000, 2))


def xdraw_slope(shape, vp, dev, seed=0):
    from xrspatial_torch.kernels.viewshed import _xdraw_fields
    rng = np.random.default_rng(seed)
    data = (rng.random(shape) * 50).astype(np.float32)
    h, w = shape
    data[h // 3:h // 3 + max(1, h // 10), w // 2:w // 2 + max(1, w // 10)] \
        += 150.0
    data[rng.integers(0, h, 3), rng.integers(0, w, 3)] = np.nan
    return _xdraw_fields(torch.from_numpy(data).to(dev), *vp, 2.0, 0.0, 1.0,
                         -1.0)[3]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", XDRAW_SHAPES)
def test_xdraw_kernel_equals_its_twin(cuda, shape):
    """Bit for bit, NaN where NaN, at every corner and an inner viewpoint
    (two opposite corners on the long shapes); one launch a call."""
    from xrspatial_torch.kernels import cuda_xdraw
    from xrspatial_torch.kernels.emulate import same_bits
    from xrspatial_torch.kernels.viewshed import xdraw_scan_twin
    h, w = shape
    vps = ((0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1), (h // 3, w // 2))
    if max(shape) > 4096:      # each twin call walks 30000 steps
        vps = vps[::3]
    for vp in vps:
        slope = xdraw_slope(shape, vp, cuda, seed=h + w)
        before = cuda_xdraw.XDRAW_LAUNCHES
        simple = cuda_xdraw.XDRAW_SIMPLE_LAUNCHES
        got = cuda_xdraw.xdraw_scan_cuda(slope, *vp)
        torch.cuda.synchronize()
        assert cuda_xdraw.XDRAW_LAUNCHES == before + 1
        assert cuda_xdraw.XDRAW_SIMPLE_LAUNCHES == simple
        assert got.device.type == "cuda" and got.dtype == torch.float32
        # the twin on the card: at 30000 steps it is slow on the CPU
        ref = xdraw_scan_twin(slope, *vp)
        assert same_bits(got.cpu(), ref.cpu()), (shape, vp)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", XDRAW_SHAPES)
def test_xdraw_banded_kernel_equals_its_first_port(cuda, shape):
    """The banded route on its plan and on tiny bands and chunks (8 and 4,
    4 and 8: a halo wider than a band) against the first port by name,
    bit for bit, and the tiny ones against the twin."""
    from xrspatial_torch.kernels import cuda_xdraw
    from xrspatial_torch.kernels.emulate import same_bits
    from xrspatial_torch.kernels.viewshed import xdraw_scan_twin
    h, w = shape
    vps = ((0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1), (h // 3, w // 2))
    tiny = ((8, 4), (4, 8)) if max(shape) <= 4096 else ()
    for vp in vps:
        slope = xdraw_slope(shape, vp, cuda, seed=h * w)
        before = cuda_xdraw.XDRAW_SIMPLE_LAUNCHES
        first = cuda_xdraw.xdraw_scan_cuda(slope, *vp, route="simple")
        assert cuda_xdraw.XDRAW_SIMPLE_LAUNCHES == before + 1
        assert same_bits(cuda_xdraw.xdraw_scan_cuda(slope, *vp).cpu(),
                         first.cpu()), (shape, vp)
        if tiny:
            ref = xdraw_scan_twin(slope, *vp).cpu()
        for band, chunk in tiny:
            got = cuda_xdraw.xdraw_scan_cuda(slope, *vp, band=band,
                                             chunk=chunk)
            assert same_bits(got.cpu(), ref), (shape, vp, band, chunk)
            assert same_bits(got.cpu(), first.cpu())


# (shape, viewpoint, mesh, step window L, band, chunk): strips narrower
# than L, a viewpoint on a strip's edge lane, at a corner, inside; the
# plan's band and chunk (None) and tiny ones
XDRAW_STRIP_CASES = (
    ((300, 70), (149, 35), (2, 2), 64, None, None),
    ((263, 516), (0, 0), (1, 4), 16, 8, 4),
    ((263, 516), (65, 258), (2, 2), 1000, None, None),
    ((70, 300), (69, 299), (4, 1), 7, 4, 8),
    ((517, 263), (130, 1), (2, 2), 100, 32, 16),
    ((1024, 1024), (256, 700), (1, 4), 256, None, None),
)


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(XDRAW_STRIP_CASES)))
def test_xdraw_strip_route_equals_its_twin(cuda, case):
    """X1's strip route on a mesh of one card, driven window by window by
    ``xdraw_mesh_max_slope``, against the same call on the strip twin
    (the raster's blocks on the CPU) and against the unsharded banded
    kernel, bit for bit, NaN where NaN; every window one strip launch,
    no launch of the single-card route."""
    from xrspatial_torch.kernels import cuda_xdraw, viewshed as kv
    from xrspatial_torch.kernels.emulate import same_bits
    from xrspatial_torch.parallel import distribute, make_raster_mesh
    shape, vp, (ny, nx), steps, band, chunk = XDRAW_STRIP_CASES[case]
    slope = xdraw_slope(shape, vp, cuda, seed=shape[0] + case)
    on_card = make_raster_mesh(ny, nx, devices=[cuda] * (ny * nx))
    on_cpu = make_raster_mesh(ny, nx, devices=["cpu"] * (ny * nx))
    kw = dict(steps=steps, band=band, chunk=chunk)
    before = cuda_xdraw.XDRAW_LAUNCHES
    strips = cuda_xdraw.XDRAW_STRIP_LAUNCHES
    got = kv.xdraw_mesh_max_slope(distribute(slope, on_card), *vp, **kw)
    torch.cuda.synchronize()
    assert cuda_xdraw.XDRAW_LAUNCHES == before
    assert cuda_xdraw.XDRAW_STRIP_LAUNCHES > strips
    assert all(b.device.type == "cuda" for row in got.blocks for b in row)
    twin = kv.xdraw_mesh_max_slope(distribute(slope.cpu(), on_cpu), *vp,
                                   **kw)
    assert same_bits(got.gather("cpu"), twin.gather()), case
    assert same_bits(got.gather("cpu"),
                     cuda_xdraw.xdraw_scan_cuda(slope, *vp).cpu()), case


@pytest.mark.gpu
def test_xdraw_path_goes_through_the_kernel(cuda):
    """viewshed with exact=False on the card: one X1 launch, no twin call,
    the CPU's float32 output at every cell."""
    from xrspatial_torch.kernels import cuda_xdraw, viewshed as kv
    rng = np.random.default_rng(5)
    data = (rng.random((120, 90)) * 40).astype(np.float32)
    ys, xs = np.arange(120.0)[::-1].copy(), np.arange(90.0)

    def agg(dev):
        return xt.DataArray(torch.from_numpy(data).to(dev), dims=("y", "x"),
                            coords={"y": ys, "x": xs})

    twin = kv.xdraw_scan_twin
    calls = []
    kv.xdraw_scan_twin = lambda *a: calls.append(a) or twin(*a)
    try:
        before = cuda_xdraw.XDRAW_LAUNCHES
        simple = cuda_xdraw.XDRAW_SIMPLE_LAUNCHES
        got = xt.viewshed(agg(cuda), x=30.0, y=70.0, observer_elev=3.0,
                          exact=False)
        assert cuda_xdraw.XDRAW_LAUNCHES == before + 1 and not calls
        assert cuda_xdraw.XDRAW_SIMPLE_LAUNCHES == simple
    finally:
        kv.xdraw_scan_twin = twin
    ref = xt.viewshed(agg("cpu"), x=30.0, y=70.0, observer_elev=3.0,
                      exact=False)
    assert got.data.device.type == "cuda" and got.data.dtype == torch.float32
    np.testing.assert_array_equal(got.values == -1, ref.values == -1)
    np.testing.assert_allclose(got.values, ref.values, rtol=1e-6, atol=0)


@pytest.mark.gpu
def test_xdraw_wrapper_refuses_what_it_cannot_take(cuda):
    from xrspatial_torch.kernels import cuda_xdraw
    before = cuda_xdraw.XDRAW_LAUNCHES
    x = torch.zeros((8, 9), device=cuda)
    for bad, match in ((x.cpu(), "CUDA"), (x.double(), "float32"),
                       (x.t(), "contiguous"), (x[None], "2-D")):
        with pytest.raises(ValueError, match=match):
            cuda_xdraw.xdraw_scan_cuda(bad, 1, 1)
    with pytest.raises(ValueError, match="outside"):
        cuda_xdraw.xdraw_scan_cuda(x, 8, 0)
    with pytest.raises(ValueError, match="route"):
        cuda_xdraw.xdraw_scan_cuda(x, 1, 1, route="ring")
    with pytest.raises(ValueError, match="banded"):
        cuda_xdraw.xdraw_scan_cuda(x, 1, 1, route="simple", band=8)
    assert cuda_xdraw.XDRAW_LAUNCHES == before


def test_xdraw_wrapper_refuses_cpu_tensors():
    """Without a card too: a CPU tensor never reaches the launch."""
    from xrspatial_torch.kernels import cuda_xdraw
    before = cuda_xdraw.XDRAW_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        cuda_xdraw.xdraw_scan_cuda(torch.zeros((4, 5)), 1, 1)
    assert cuda_xdraw.XDRAW_LAUNCHES == before


# XDraw's fields and epilogue kernels (csrc/xdraw_cells.cu) against the
# torch-op route on the card: ragged and 16-byte rows, a row and a column
XDRAW_CELL_SHAPES = ((97, 131), (256, 256), (1000, 777), (4096, 4096),
                     (1, 3001), (2999, 1))
# (observer_elev, target_elev, ew_res, ns_res): metres north up, odd
# spacings, and spacings whose distances fall below the 1e-12 floor
XDRAW_CELL_GEOMETRY = ((100.0, 0.0, 10.0, -10.0), (3.0, 1.5, 0.37, -1.9),
                       (5.0, 0.0, 1e-20, -1e-20))


def xdraw_cell_dem(shape, vp, dev, seed):
    """A DEM with a mesa and NaN cells, one of them beside `vp`."""
    rng = np.random.default_rng(seed)
    h, w = shape
    data = (rng.random(shape) * 50).astype(np.float32)
    data[h // 3:h // 3 + max(1, h // 10), w // 2:w // 2 + max(1, w // 10)] \
        += 150.0
    data[rng.integers(0, h, 5), rng.integers(0, w, 5)] = np.nan
    r, c = vp
    if h > 1:
        data[r + 1 if r + 1 < h else r - 1, c] = np.nan
    else:
        data[r, c + 1 if c + 1 < w else c - 1] = np.nan
    return torch.from_numpy(data).to(dev)


def int_bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", XDRAW_CELL_SHAPES)
def test_xdraw_cell_kernels_equal_the_torch_passes(cuda, shape):
    """On the card the fields kernel gives ``_xdraw_fields``' slope and
    the epilogue kernel ``_xdraw_epilogue``'s angles, every 32-bit word
    equal (NaN payloads included), with the viewpoint at the centre, on
    an edge and at a corner, under each geometry; one launch each a call,
    and ``viewshed_grid_los`` on the card is the two kernels around X1."""
    from xrspatial_torch.kernels import cuda_xdraw, cuda_xdraw_cells as xc
    from xrspatial_torch.kernels import viewshed as kv
    h, w = shape
    seen = 0
    for k, vp in enumerate(((h // 2, w // 2), (0, w // 3),
                            (h - 1, w - 1))):
        data = xdraw_cell_dem(shape, vp, cuda, seed=h + w + k)
        for oe, te, ew, ns in XDRAW_CELL_GEOMETRY:
            dy, dx, safe, slope, tgt, vpe = kv._xdraw_fields(
                data, *vp, oe, te, ew, ns)
            f0, e0 = xc.FIELDS_LAUNCHES, xc.EPILOGUE_LAUNCHES
            got = xc.xdraw_fields_cuda(data, *vp, oe, ew, ns)
            assert xc.FIELDS_LAUNCHES == f0 + 1
            assert torch.equal(int_bits(got), int_bits(slope)), (shape, vp,
                                                                 ew)
            m = cuda_xdraw.xdraw_scan_cuda(slope, *vp)
            ref = kv._xdraw_epilogue(m, data, dy, dx, safe, tgt, vpe, te)
            angles = xc.xdraw_epilogue_cuda(m, data, *vp, oe, te, ew, ns)
            assert xc.EPILOGUE_LAUNCHES == e0 + 1
            bad = int_bits(angles) != int_bits(ref)
            assert not bool(bad.any()), (shape, vp, ew, int(bad.sum()),
                                         angles[bad][:4], ref[bad][:4])
            whole = kv.viewshed_grid_los(data, *vp, oe, te, ew, ns)
            assert torch.equal(int_bits(whole), int_bits(ref))
            seen += int(((ref > -1) & (ref < 180)).sum())
    assert seen > 0


@pytest.mark.gpu
def test_xdraw_cell_kernels_take_rows_with_a_stride(cuda):
    """A raster cut out of a wider one (rows not contiguous with each
    other, not 16-byte aligned) gives the contiguous copy's bits."""
    from xrspatial_torch.kernels import cuda_xdraw, cuda_xdraw_cells as xc
    from xrspatial_torch.kernels import viewshed as kv
    big = xdraw_cell_dem((300, 413), (150, 200), cuda, seed=3)
    view = big[7:290, 5:401]
    vp = (140, 190)
    assert not view.is_contiguous()
    slope = kv._xdraw_fields(view.contiguous(), *vp, 20.0, 0.0, 2.0,
                             -2.0)[3]
    assert torch.equal(int_bits(xc.xdraw_fields_cuda(view, *vp, 20.0, 2.0,
                                                     -2.0)),
                       int_bits(slope))
    m = cuda_xdraw.xdraw_scan_cuda(slope, *vp)
    assert torch.equal(
        int_bits(xc.xdraw_epilogue_cuda(m, view, *vp, 20.0, 0.0, 2.0, -2.0)),
        int_bits(xc.xdraw_epilogue_cuda(m, view.contiguous(), *vp, 20.0,
                                        0.0, 2.0, -2.0)))


@pytest.mark.gpu
def test_viewshed_on_the_card_takes_the_cell_kernels(cuda):
    """``viewshed(exact=False)`` on the card: one launch each of the fields
    and epilogue kernels and of X1, one count on ``xdraw.cells_kernel``,
    none on ``xdraw.cells_torchops``, no host wait on XDraw's path
    (``host.syncs``), the ``dispatch.viewshed_*`` spans, and the torch-op
    route's angles on the card bit for bit."""
    from torch.profiler import ProfilerActivity, profile

    from xrspatial_torch import tracing
    from xrspatial_torch.kernels import cuda_xdraw, cuda_xdraw_cells as xc
    from xrspatial_torch.kernels import viewshed as kv
    data = xdraw_cell_dem((700, 900), (300, 410), cuda, seed=9)
    agg = xt.DataArray(data, dims=("y", "x"),
                       coords={"y": (699 - np.arange(700)) * 10.0,
                               "x": np.arange(900) * 10.0})
    before = (xc.FIELDS_LAUNCHES, xc.EPILOGUE_LAUNCHES,
              cuda_xdraw.XDRAW_LAUNCHES)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        got = xt.viewshed(agg, x=4100.0, y=3990.0, observer_elev=60.0,
                          exact=False)
    counters, names = tracing.counters(), [s.name for s in tracing.spans()]
    tracing.clear()
    assert (xc.FIELDS_LAUNCHES, xc.EPILOGUE_LAUNCHES,
            cuda_xdraw.XDRAW_LAUNCHES) == tuple(b + 1 for b in before)
    assert counters == {"xdraw.cells_kernel": 1}
    assert "dispatch.viewshed_fields" in names
    assert "dispatch.viewshed_epilogue" in names
    assert not [n for n in names if n.startswith("torchops.")]
    vp = (300, 410)
    dy, dx, safe, slope, tgt, vpe = kv._xdraw_fields(data, *vp, 60.0, 0.0,
                                                      10.0, -10.0)
    ref = kv._xdraw_epilogue(cuda_xdraw.xdraw_scan_cuda(slope, *vp), data,
                             dy, dx, safe, tgt, vpe, 0.0)
    assert got.data.device.type == "cuda"
    assert torch.equal(int_bits(got.data), int_bits(ref))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,vp", [((258, 302), (129, 151)),
                                      ((255, 256), (0, 255)),
                                      ((301, 97), (300, 0))])
def test_mesh_viewshed_takes_the_cell_kernels(cuda, shape, vp):
    """The mesh route on a 2 x 2 mesh of one card: the fields and epilogue
    kernels once a block (the epilogue on the field's one-cell halo),
    equal cell for cell to the one-card route on the gathered raster."""
    from xrspatial_torch.kernels import cuda_xdraw_cells as xc
    from xrspatial_torch.kernels import viewshed as kv
    from xrspatial_torch.parallel import distribute, make_raster_mesh
    mesh = make_raster_mesh(2, 2, devices=[cuda] * 4)
    data = xdraw_cell_dem(shape, vp, cuda, seed=shape[0])
    f0, e0 = xc.FIELDS_LAUNCHES, xc.EPILOGUE_LAUNCHES
    got = kv.viewshed_grid_los_mesh(distribute(data, mesh), *vp, 40.0, 1.0,
                                    10.0, -10.0)
    assert (xc.FIELDS_LAUNCHES, xc.EPILOGUE_LAUNCHES) == (f0 + 4, e0 + 4)
    ref = kv.viewshed_grid_los(data, *vp, 40.0, 1.0, 10.0, -10.0)
    assert torch.equal(int_bits(got.gather()), int_bits(ref))


def zonal_rasters(dev):
    rng = np.random.default_rng(31)
    zones = rng.integers(0, 9, (150, 170)).astype(np.int32)
    zones[:4, :4] = 700000             # a wide range: the unique path too
    values = (rng.random((150, 170)) * 100).astype(np.float32)
    values[20:30, 40:60] = np.nan
    cats = np.floor(values / 25)
    return [xt.DataArray(torch.from_numpy(a).to(dev), dims=("y", "x"),
                         coords={"y": np.arange(150.0), "x": np.arange(170.0)})
            for a in (zones, values, cats)]


@pytest.mark.gpu
def test_zonal_on_the_card_matches_the_cpu(cuda):
    """The columns of stats (mean and sum within rtol 1e-6, var and std
    1e-5: the card adds in another order; the rest equal), crosstab,
    regions, trim and crop on the card against the same calls on the
    CPU; results stay on the card."""
    from xrspatial_torch import zonal
    card, cpu = zonal_rasters(cuda), zonal_rasters("cpu")
    got = zonal.stats_columns(card[0], card[1])
    ref = zonal.stats_columns(cpu[0], cpu[1])
    rtol = {"mean": 1e-6, "sum": 1e-6, "std": 1e-5, "var": 1e-5}
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=rtol.get(k, 0.0),
                                   atol=1e-6 if k in ("std", "var") else 0,
                                   err_msg=k)
    for kw in (dict(), dict(agg="percentage", zone_ids=[1, 3])):
        got = zonal.crosstab_columns(card[0], card[2], **kw)
        ref = zonal.crosstab_columns(cpu[0], cpu[2], **kw)
        assert list(got) == list(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
    da = zonal.stats_columns(card[0], card[1], stats_funcs=["max"],
                             return_type="xarray.DataArray")
    assert da.data.device.type == "cuda"
    for n in (4, 8):
        out = zonal.regions(card[2], neighborhood=n)
        assert out.data.device.type == "cuda"
        np.testing.assert_array_equal(
            out.values, zonal.regions(cpu[2], neighborhood=n).values)
    for fn in (lambda r: zonal.trim(r[2], values=(0.0, 3.0)),
               lambda r: zonal.crop(r[0], r[1], zones_ids=(700000,))):
        out = fn(card)
        assert out.data.device.type == "cuda"
        np.testing.assert_array_equal(out.values, fn(cpu).values)


# -- A9 and A12 (X2): the bump kernel, synthesis and the host modules on the card

def bump_case(spread, seed):
    """(shape, (N, 2) int32 locations (x, y), (N,) float64 heights): 600
    bumps on 23x17, duplicates forced, a bump on every corner and edge,
    non-integer and negative heights."""
    rng = np.random.default_rng(seed)
    h, w = 17, 23
    locs = np.stack([rng.integers(0, w, 600), rng.integers(0, h, 600)], 1)
    locs[:10] = [[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1], [5, 0],
                 [0, 7], [w - 1, 9], [11, h - 1], [5, 0], [5, 0]]
    heights = rng.random(600) * 7.3 - 1.1
    return (h, w), locs.astype(np.int32), heights


@pytest.mark.gpu
@pytest.mark.parametrize("spread", [0, 1, 3])
def test_bump_kernel_equals_its_twin(cuda, spread):
    """X2 against its twin on the card, bit for bit; one launch."""
    from xrspatial_torch.kernels import cuda_bump
    from xrspatial_torch.kernels.bump import bump_scan_twin
    shape, locs, heights = bump_case(spread, seed=spread)
    args = (torch.from_numpy(locs).to(cuda),
            torch.from_numpy(heights).to(cuda), spread)
    before = cuda_bump.BUMP_LAUNCHES
    counts = bump_counts()
    got = cuda_bump.bump_scan_cuda(
        torch.zeros(shape, dtype=torch.float64, device=cuda), *args)
    torch.cuda.synchronize()
    assert cuda_bump.BUMP_LAUNCHES == before + 1
    rounds, done, tail, simple = (a - b for a, b in zip(bump_counts(),
                                                       counts))
    # the rounds route, at the plan's threshold: this crowded map reaches
    # the walk, and the two account for every bump
    assert simple == 0 and rounds >= 1 and tail > 0 and done + tail == 600
    ref = bump_scan_twin(torch.zeros(shape, dtype=torch.float64,
                                     device=cuda), *args)
    assert torch.equal(got.view(torch.int64), ref.view(torch.int64))
    cpu = bump_scan_twin(torch.zeros(shape, dtype=torch.float64),
                         *(a.cpu() for a in args[:2]), spread)
    assert torch.equal(got.cpu().view(torch.int64), cpu.view(torch.int64))


def bump_counts():
    from xrspatial_torch.kernels import cuda_bump
    return (cuda_bump.BUMP_ROUNDS, cuda_bump.BUMP_ROUND_BUMPS,
            cuda_bump.BUMP_TAIL_BUMPS, cuda_bump.BUMP_SIMPLE_LAUNCHES)


@pytest.mark.gpu
@pytest.mark.parametrize("spread", [0, 1, 3])
def test_bump_rounds_equal_the_first_port(cuda, spread):
    """The rounds route at thresholds 0 (rounds only) and infinity (the
    walk only), and on a sparse 256^2 map its rounds finish, against the
    first port by name, bit for bit; the counters account for every
    bump."""
    from xrspatial_torch.kernels import cuda_bump
    shape, locs, heights = bump_case(spread, seed=40 + spread)
    rng = np.random.default_rng(spread)
    sparse = ((256, 256), np.stack([rng.integers(0, 256, 1000),
                                    rng.integers(0, 256, 1000)],
                                   1).astype(np.int32),
              rng.random(1000) * 3)
    for (shape, locs, heights), threshold, route in (
            ((shape, locs, heights), 0, "rounds"),
            ((shape, locs, heights), math.inf, "walk"),
            (sparse, None, "rounds")):
        args = (torch.from_numpy(locs).to(cuda),
                torch.from_numpy(heights).to(cuda), spread)
        before = cuda_bump.BUMP_SIMPLE_LAUNCHES
        first = cuda_bump.bump_scan_cuda(
            torch.zeros(shape, dtype=torch.float64, device=cuda), *args,
            route="simple")
        assert cuda_bump.BUMP_SIMPLE_LAUNCHES == before + 1
        counts = bump_counts()
        got = cuda_bump.bump_scan_cuda(
            torch.zeros(shape, dtype=torch.float64, device=cuda), *args,
            threshold=threshold)
        rounds, done, tail, simple = (a - b for a, b in zip(bump_counts(),
                                                           counts))
        assert torch.equal(got.view(torch.int64), first.view(torch.int64))
        assert simple == 0 and done + tail == len(locs)
        if route == "walk":
            assert rounds == 0 and tail == len(locs)
        else:
            assert rounds >= 1 and tail == 0


@pytest.mark.gpu
def test_bump_path_goes_through_the_kernel(cuda):
    """bump() with the card as the default device: one X2 launch, no twin
    call, float64 on the card, the CPU's map bit for bit."""
    from xrspatial_torch.kernels import bump as kb
    from xrspatial_torch.kernels import cuda_bump
    twin = kb.bump_scan_twin
    calls = []
    kb.bump_scan_twin = lambda *a: calls.append(a) or twin(*a)
    saved = xt.default_device()
    try:
        xt.set_default_device(cuda)
        np.random.seed(3)
        before = cuda_bump.BUMP_LAUNCHES
        counts = bump_counts()
        got = xt.bump(64, 48, spread=2)
        assert cuda_bump.BUMP_LAUNCHES == before + 1 and not calls
        rounds, done, tail, simple = (a - b for a, b in zip(bump_counts(),
                                                           counts))
        assert simple == 0 and rounds >= 1 and done + tail == 64 * 48 // 10
    finally:
        kb.bump_scan_twin = twin
        xt.set_default_device(saved)
    assert got.data.device.type == "cuda" and got.data.dtype == torch.float64
    xt.set_default_device("cpu")
    try:
        np.random.seed(3)
        ref = xt.bump(64, 48, spread=2)
    finally:
        xt.set_default_device(saved)
    assert torch.equal(got.data.cpu().view(torch.int64),
                       ref.data.view(torch.int64))


@pytest.mark.gpu
def test_bump_wrapper_refuses_what_it_cannot_take(cuda):
    from xrspatial_torch.kernels import cuda_bump
    before = cuda_bump.BUMP_LAUNCHES
    out = torch.zeros((5, 6), dtype=torch.float64, device=cuda)
    locs = torch.tensor([[1, 2]], dtype=torch.int32, device=cuda)
    z = torch.ones(1, dtype=torch.float64, device=cuda)
    for bad, match in ((out.float(), "float64"), (out.t(), "contiguous"),
                       (out[None], "2-D")):
        with pytest.raises(ValueError, match=match):
            cuda_bump.bump_scan_cuda(bad, locs, z, 1)
    for bad_locs in (torch.tensor([[6, 0]], device=cuda),
                     torch.tensor([[0, 5]], device=cuda),
                     torch.tensor([[-1, 0]], device=cuda)):
        with pytest.raises(ValueError, match="outside"):
            cuda_bump.bump_scan_cuda(out, bad_locs, z, 1)
    with pytest.raises(ValueError, match="heights"):
        cuda_bump.bump_scan_cuda(out, locs, torch.ones(2, device=cuda), 1)
    with pytest.raises(ValueError, match="route"):
        cuda_bump.bump_scan_cuda(out, locs, z, 1, route="batched")
    for threshold, route in ((-1, None), (4, "simple")):
        with pytest.raises(ValueError, match="threshold"):
            cuda_bump.bump_scan_cuda(out, locs, z, 1, route=route,
                                     threshold=threshold)
    assert cuda_bump.BUMP_LAUNCHES == before


def test_bump_wrapper_refuses_cpu_tensors():
    """Without a card too: a CPU tensor never reaches the launch."""
    from xrspatial_torch.kernels import cuda_bump
    before = cuda_bump.BUMP_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        cuda_bump.bump_scan_cuda(torch.zeros((4, 5), dtype=torch.float64),
                                 torch.zeros((1, 2), dtype=torch.int32),
                                 torch.ones(1, dtype=torch.float64), 1)
    assert cuda_bump.BUMP_LAUNCHES == before


@pytest.mark.gpu
def test_synthesis_on_the_card_matches_the_cpu(cuda):
    """perlin, generate_terrain and make_terrain on the card equal the
    CPU's bit for bit (float32 and float64 ops, each rounded once, and the
    multiply-adds exact in float64 before one rounding); outputs on the
    card."""
    from xrspatial_torch import datasets
    saved = xt.default_device()
    outs = {}
    try:
        for dev in (cuda, torch.device("cpu")):
            xt.set_default_device(dev)
            blank = xt.DataArray(np.zeros((97, 131), np.float32),
                                 dims=("y", "x"))
            outs[dev.type] = (
                xt.perlin(blank, freq=(4, 3), seed=11).data,
                xt.generate_terrain(blank, x_range=(-20e6, 20e6),
                                    y_range=(-20e6, 20e6)).data,
                datasets.make_terrain(shape=(50, 70), octaves=5,
                                      persistence=0.37).data)
    finally:
        xt.set_default_device(saved)
    for got, ref in zip(outs["cuda"], outs["cpu"]):
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu().view(torch.int32),
                           ref.view(torch.int32))


@pytest.mark.gpu
def test_host_modules_take_card_rasters(cuda):
    """a_star_search, polygonize and diagnose on a raster on the card give
    the CPU raster's results; the path lands on the card."""
    from xrspatial_torch import pathfinding
    from xrspatial_torch.experimental import polygonize
    rng = np.random.default_rng(8)
    data = np.floor(rng.random((40, 50)) * 3).astype(np.float32)
    coords = {"y": np.arange(40.0)[::-1].copy(), "x": np.arange(50.0)}

    def agg(dev):
        return xt.DataArray(torch.from_numpy(data).to(dev), dims=("y", "x"),
                            coords=coords, attrs={"res": (1.0, 1.0)})

    before = pathfinding.NATIVE_CALLS
    kw = dict(start=(39.0, 0.0), goal=(0.0, 49.0), barriers=[0],
              snap_start=True, snap_goal=True)
    got = xt.a_star_search(agg(cuda), **kw)
    ref = xt.a_star_search(agg("cpu"), **kw)
    assert got.data.device.type == "cuda"
    assert pathfinding.NATIVE_CALLS == before + 2
    np.testing.assert_array_equal(got.values, ref.values)
    c_got, p_got = polygonize(agg(cuda))
    c_ref, p_ref = polygonize(agg("cpu"))
    assert c_got == c_ref and len(p_got) == len(p_ref)
    for a, b in zip(p_got, p_ref):
        assert len(a) == len(b)
        for ra, rb in zip(a, b):
            np.testing.assert_array_equal(ra, rb)
    geo = {"y": np.linspace(45.0, 44.9, 40), "x": np.linspace(7.0, 7.1, 50)}
    dem = xt.DataArray(torch.from_numpy(data * 300).to(cuda),
                       dims=("y", "x"), coords=geo)
    assert str(xt.diagnose(dem)) == str(xt.diagnose(
        xt.DataArray(data * 300, dims=("y", "x"), coords=geo)))
    assert xt.diagnose(dem).has_warnings


@pytest.mark.gpu
@pytest.mark.parametrize("metric", [0, 2], ids=["euclidean", "manhattan"])
@pytest.mark.parametrize("with_val", [False, True], ids=["state", "valued"])
@pytest.mark.parametrize("route", [None, "simple", "staged", "vector"])
def test_jfa_packed_routes_take_a_block_origin(cuda, route, with_val,
                                               metric):
    """Every packed route, told a block's origin in the whole raster,
    equals the twin told the same origin, bit for bit: the keys see
    global indices (the mesh's extended blocks; targets lie beyond the
    block on every side)."""
    rng = np.random.default_rng(23)
    h, w = 72, 256
    origin = (100, 36)
    tiy = rng.integers(0, 400, (h, w)).astype(np.int32)
    tix = rng.integers(0, 600, (h, w)).astype(np.int32)
    state_np = np.where(rng.random((h, w)) < 0.05, (tiy << 15) | tix, -1)
    state = torch.from_numpy(state_np.astype(np.int32)).to(cuda)
    val = torch.from_numpy(rng.random((h, w)).astype(np.float32)).to(cuda) \
        if with_val else None
    steps = (3.0, 2.0)
    for k in (1, 2, 4, 8, 16, 32):
        if route == "vector" and k % 4:
            continue
        before = round_counts()
        got = cuda_jfa.round_packed_cuda(state, val, k, metric, steps,
                                         emit_best=True, route=route,
                                         origin=origin)
        torch.cuda.synchronize()
        ref = jfa_rounds.round_packed(state.cpu(), None if val is None
                                      else val.cpu(), k, metric, steps,
                                      origin)
        for g, r in zip(got, ref):
            assert (g is None) == (r is None)
            if g is not None:
                assert torch.equal(g.cpu(), r), (route, k)
        planned = jfa_plan.round_plan(h, w, k, "packed", with_val,
                                      route=route).route \
            if route != "simple" else "simple"
        after = round_counts()
        idx = ("staged", "vector", "simple").index(planned)
        assert after[idx] == before[idx] + 1
        # origin 0 keeps the unsharded bits
        plain = cuda_jfa.round_packed_cuda(state, val, k, metric, steps,
                                           emit_best=True, route=route)
        ref0 = jfa_rounds.round_packed(state.cpu(), None if val is None
                                       else val.cpu(), k, metric, steps)
        assert torch.equal(plain[0].cpu(), ref0[0])


def launches_by_route(module, prefix=""):
    """(TMA, cp.async) launch counts of a staged kernel's wrapper."""
    return (getattr(module, f"{prefix}TMA_LAUNCHES"),
            getattr(module, f"{prefix}ASYNC_LAUNCHES"))


@pytest.mark.gpu
def test_mesh_on_one_card_equals_the_unsharded_call(cuda):
    """A 2 x 2 mesh of one card: slope and focal_stats (the tiled kernel
    on the plus, the halo kernel on the annulus) equal the unsharded
    calls bit for bit and stay on the card.  Radius 1 runs in place: one
    launch a 129 x 151 tile, on cp.async (151 columns are not 16-byte
    rows), and two a block on the bands, on TMA (their rows are padded to
    16 bytes).  The annulus's radius 40 is deeper than a quarter tile: one
    launch a block on TMA, on the extended blocks."""
    from xrspatial_torch.parallel import (distribute, get_raster_mesh,
                                          make_raster_mesh)
    mesh = make_raster_mesh(2, 2, devices=[cuda] * 4)
    rng = np.random.default_rng(24)
    data = (rng.random((258, 302)) * 100).astype(np.float32)
    data[40, 77] = np.nan

    def agg(payload):
        return xt.DataArray(payload, dims=("y", "x"),
                            attrs={"res": (1.0, 2.0)})

    whole = torch.from_numpy(data).to(cuda)
    split = distribute(whole, mesh)
    tma, cp = launches_by_route(cuda_surface, "STAGED_")
    out = xt.slope(agg(split)).data
    assert get_raster_mesh(out) is mesh
    assert launches_by_route(cuda_surface, "STAGED_") == (tma + 8, cp + 4)
    assert all(b.device.type == "cuda" for r in out.blocks for b in r)
    ref = xt.slope(agg(whole)).data
    assert torch.equal(out.gather().view(torch.int32),
                       ref.view(torch.int32))
    for kern, prefix, want in ((circle_kernel(1, 1, 1.5), "", (8, 4)),
                               (annulus_kernel(1, 1, 40, 38), "HALO_",
                                (4, 0))):
        tma, cp = launches_by_route(cuda_window, prefix)
        out = focal.focal_stats(agg(split), kern).data
        assert launches_by_route(cuda_window, prefix) == (tma + want[0],
                                                          cp + want[1])
        ref = focal.focal_stats(agg(whole), kern).data
        assert torch.equal(out.gather().view(torch.int32),
                           ref.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4096, 4096), (4096, 4094)])
def test_terrain_pipeline_in_place_on_a_mesh_of_one_card(cuda, shape):
    """terrain_pipeline on a 2 x 2 mesh of one card runs every block in
    place (``mesh.inplace_share`` 1.0): B1 and B2 on each tile as it lies
    and on its two bands, each launch on its plan's route (tiles of 2047
    columns on cp.async), and every plane equal to the unsharded call's
    bit for bit."""
    from torch.profiler import ProfilerActivity, profile

    from xrspatial_torch import tracing
    from xrspatial_torch.parallel import (distribute, get_raster_mesh,
                                          make_raster_mesh)
    from xrspatial_torch.kernels.focal_halo import halo_plan as focal_plan
    from xrspatial_torch.kernels.surface import surface_plan
    mesh = make_raster_mesh(2, 2, devices=[cuda] * 4)
    rng = np.random.default_rng(25)
    data = (rng.random(shape) * 100).astype(np.float32)
    data[1000, 2047] = np.nan
    data[2048, 999] = np.nan
    surface = ("slope", "hillshade", "curvature")

    def call(payload):
        return xt.terrain_pipeline(
            xt.DataArray(payload, dims=("y", "x"), name="dem",
                         attrs={"res": (10.0, 10.0)}), surface=surface)

    whole = torch.from_numpy(data).to(cuda)
    split = distribute(whole, mesh)
    # the tile route each launch plans: four tiles, eight bands of TMA rows
    tile = split.blocks[0][0]
    offsets = kernel_offsets(circle_kernel(1, 1, 1.5))
    tiles_tma = 4 * (surface_plan(*tile.shape, tile.data_ptr()).route
                     == "tma")
    assert tiles_tma == 4 * (focal_plan(*tile.shape, offsets,
                                        tile.data_ptr()).route == "tma")
    assert tiles_tma == (4 if shape[1] % 8 == 0 else 0)
    want = (8 + tiles_tma, 4 - tiles_tma)
    b1 = launches_by_route(cuda_surface, "STAGED_")
    b2 = launches_by_route(cuda_window)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = call(split)
    counters = tracing.counters()
    tracing.clear()
    torch.cuda.synchronize()
    assert counters["mesh.inplace_blocks"] == 8
    assert counters.get("mesh.extended_blocks", 0) == 0
    assert launches_by_route(cuda_surface, "STAGED_") == (
        b1[0] + want[0], b1[1] + want[1])
    assert launches_by_route(cuda_window) == (b2[0] + want[0],
                                              b2[1] + want[1])
    ref = call(whole)
    for p in [f"dem-{q}" for q in surface] + ["focal_stats"]:
        assert get_raster_mesh(out[p].data) is mesh
        assert torch.equal(out[p].data.gather().view(torch.int32),
                           ref[p].data.view(torch.int32)), p
