"""The port's mesh branches on the CPU (ROADMAP A13).

Meshes of ``torch.device("cpu")`` repeated, as the JAX suite's eight
forced host devices: (2, 2), (4, 2), (1, 8) and (8, 1), on rasters that
divide them and on rasters that do not (an axis that does not divide its
mesh axis is replicated by ``distribute`` and cut into tiles, the last
short or empty, by the stencils).  Every op with a mesh branch is held to
the port's unsharded call on the same numpy raster, and its output must
stay split over the same mesh.

Tolerances: bit for bit, except
- slope, aspect and hillshade within 1 float32 ulp: on the CPU torch's
  atan, atan2 and rsqrt take a vector or a scalar path by a cell's place
  in its tensor, and a block places a cell elsewhere than the whole
  raster does (on the card every cell takes one path; ``chip_smoke.py``
  phase 27 holds the mesh there bit for bit);
- the conv path (more than 1024 offsets) and ``convolution_2d`` at the
  focal tolerance, rtol and atol 1e-5: the convolution may take another
  algorithm for a block's shape, and the conv path centres its sums on
  the extended block's mean;
- ``hotspots``' classes equal on a raster with no z-score within 1e-6 of
  a threshold: its global moments are float64 sums over blocks;
- great-circle distances within rtol 1e-6 (trig, as above).
The proximity family is bit for bit on every state: packed, coordinates
and MANHATTAN's scan transform, whose scans carry from tile to tile.
A few cases are held to the JAX package's sharded call on its eight
virtual CPU devices, at the JAX suite's tolerances.
"""

import importlib
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch.profiler import ProfilerActivity, profile

import xrspatial_torch as xt
from xrspatial_torch import focal as tfocal
from xrspatial_torch import tracing
from xrspatial_torch.convolution import (annulus_kernel, circle_kernel,
                                         convolution_2d)
from xrspatial_torch.kernels import jfa as tjfa
from xrspatial_torch.kernels import jfa_rounds
from xrspatial_torch.kernels.dispatch import run_stencil
from xrspatial_torch.kernels.selection import (nanpercentile,
                                               nanpercentile_sharded)
from xrspatial_torch.parallel import (HaloSpec, distribute, get_raster_mesh,
                                      halo_extend, make_raster_mesh,
                                      raster_sharding, stencil_shard_map)
from xrspatial_torch.parallel import halo as thalo
from xrspatial_torch.xrlib import DataArray

CPU = torch.device("cpu")
MESHES = [(2, 2), (4, 2), (1, 8), (8, 1)]
# (rows, cols): one shape every mesh divides, and two that each mesh splits
# on one axis only, its tiles uneven or the other axis replicated
SHAPES = [(40, 48), (42, 36), (41, 38)]

tprox = importlib.import_module("xrspatial_torch.proximity")


@pytest.fixture(autouse=True)
def numpy_rasters_on_the_cpu():
    saved = xt.default_device()
    xt.set_default_device("cpu")
    yield
    xt.set_default_device(saved)


def cpu_mesh(ny, nx):
    return make_raster_mesh(ny, nx, devices=[CPU] * (ny * nx))


@pytest.fixture(params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def mesh(request):
    return cpu_mesh(*request.param)


def elevation(shape, seed, nan_cell=True):
    rng = np.random.default_rng(seed)
    data = (rng.random(shape) * 100).astype(np.float32)
    if nan_cell:
        data[shape[0] // 3, shape[1] // 4] = np.nan
    return data


def raster(data, res=(1.0, 2.0), coords=None):
    h, w = data.shape
    if coords is None:
        coords = {"y": np.arange(h, dtype=np.float64)[::-1] * res[1],
                  "x": np.arange(w, dtype=np.float64) * res[0]}
    return DataArray(torch.from_numpy(np.array(data)), dims=("y", "x"),
                     coords=coords, name="dem", attrs={"res": res})


def sharded(data, mesh, **kw):
    agg = raster(data, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        agg.data = distribute(agg.data, mesh)
    return agg


def gathered(out, mesh):
    """The host copy of a mesh result, which must lie on `mesh`."""
    data = out.data if isinstance(out, DataArray) else out
    assert get_raster_mesh(data) is mesh
    return data.gather()


def assert_same(got, ref):
    """Equal bit for bit, NaN where NaN."""
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def assert_ulp(got, ref, maxulp=1):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_array_equal(np.isnan(got.numpy()),
                                  np.isnan(ref.numpy()))
    np.testing.assert_array_max_ulp(np.nan_to_num(got.numpy()),
                                    np.nan_to_num(ref.numpy()), maxulp)


# -- the engine ---------------------------------------------------------------

def test_make_raster_mesh_factorises_as_the_jax_package():
    from xrspatial_tpu.parallel import make_raster_mesh as jax_mesh
    for n in range(1, 9):
        got = make_raster_mesh(devices=[CPU] * n)
        ref = jax_mesh(devices=jax.devices()[:n])
        assert got.shape == dict(ref.shape) and got.size == n
        assert got.axis_names == ref.axis_names
    assert cpu_mesh(4, 2).shape == {"y": 4, "x": 2}
    assert make_raster_mesh(n_x=2, devices=[CPU] * 8).shape == \
        {"y": 4, "x": 2}
    with pytest.raises(ValueError, match="needs more than"):
        make_raster_mesh(3, 3, devices=[CPU] * 8)


def test_make_raster_mesh_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_raster_mesh(2, 2)


def test_raster_sharding_places_the_trailing_dims():
    m = cpu_mesh(2, 2)
    assert raster_sharding(m).spec == ("y", "x")
    assert raster_sharding(m, 3) == (m, (None, "y", "x"))


def test_distribute_warns_on_indivisible_dim():
    with pytest.warns(UserWarning, match="REPLICATED, not sharded"):
        x = distribute(np.zeros((37, 37), np.float32), cpu_mesh(2, 2))
    assert x.split == (False, False) and get_raster_mesh(x) is None


def test_distribute_no_warning_when_divisible():
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        x = distribute(np.zeros((8, 6), np.float32), cpu_mesh(2, 2))
    assert x.split == (True, True)
    assert [tuple(b.shape) for row in x.blocks for b in row] == [(4, 3)] * 4


def test_get_raster_mesh():
    m = cpu_mesh(2, 2)
    assert get_raster_mesh(torch.zeros(4, 4)) is None
    assert get_raster_mesh(np.zeros((4, 4))) is None
    assert get_raster_mesh(distribute(np.zeros((4, 4)), cpu_mesh(1, 1))) \
        is None
    with pytest.warns(UserWarning):
        one_axis = distribute(np.zeros((4, 5)), m)
    assert one_axis.split == (True, False) and get_raster_mesh(one_axis) is m


def test_sharded_raster_round_trips(mesh):
    data = elevation((42, 36), 1)
    agg = sharded(data, mesh)
    assert agg.shape == data.shape and agg.dtype == torch.float32
    np.testing.assert_array_equal(agg.values, data)
    np.testing.assert_array_equal(np.asarray(agg.data), data)
    ny, nx = mesh.shape["y"], mesh.shape["x"]
    assert repr(agg).endswith(f"on a {ny}x{nx} mesh>")
    dup = agg.copy()
    assert get_raster_mesh(dup.data) is get_raster_mesh(agg.data)
    assert all(a is not b for ra, rb in zip(dup.data.blocks, agg.data.blocks)
               for a, b in zip(ra, rb))
    np.testing.assert_array_equal(dup.values, data)


def padded_slice(data, y0, x0, rows, cols, fill):
    """data[y0:y0+rows, x0:x0+cols], `fill` outside the raster."""
    out = np.full((rows, cols), fill, dtype=data.dtype)
    h, w = data.shape
    ys = slice(max(y0, 0), min(y0 + rows, h))
    xs = slice(max(x0, 0), min(x0 + cols, w))
    if ys.start < ys.stop and xs.start < xs.stop:
        out[ys.start - y0:ys.stop - y0, xs.start - x0:xs.stop - x0] = \
            data[ys, xs]
    return out


@pytest.mark.parametrize("shape,meshshape,halo", [
    ((40, 48), (2, 2), (1, 1)), ((40, 48), (4, 2), (3, 5)),
    ((16, 16), (4, 2), (5, 5)),         # wider than a 4-row shard
    ((42, 9), (8, 1), (13, 1)),         # 3 hops over 6-row shards, padded
    ((42, 36), (2, 2), (0, 7)), ((30, 37), (1, 8), (2, 11)),
    ((41, 30), (4, 2), (20, 20))])      # the halo covers the raster
@pytest.mark.parametrize("dtype,fill", [(np.float32, math.nan),
                                        (np.int32, -1)])
def test_halo_extend_equals_a_padded_global_slice(shape, meshshape, halo,
                                                  dtype, fill):
    """Every extended block, corners and the 16-byte row pitch included,
    is the global raster sliced around its tile, `fill` outside."""
    rng = np.random.default_rng(3)
    data = rng.integers(0, 1000, shape).astype(dtype)
    m = cpu_mesh(*meshshape)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        x = distribute(data, m)
    ry, rx = halo
    ext = halo_extend(x, HaloSpec(ry, rx), fill=fill)
    ty = thalo.tile_size(shape[0], meshshape[0])
    tx = thalo.tile_size(shape[1], meshshape[1])
    pitch = -(-(tx + 2 * rx) // 4) * 4
    for i in range(meshshape[0]):
        for j in range(meshshape[1]):
            got = ext[i][j].numpy()
            assert got.shape == (ty + 2 * ry, pitch)
            ref = padded_slice(data, i * ty - ry, j * tx - rx, ty + 2 * ry,
                               tx + 2 * rx, fill)
            # a short tile's padding is fill too
            ref[ry + min(ty, max(shape[0] - i * ty, 0)):ry + ty] = fill
            ref[:, rx + min(tx, max(shape[1] - j * tx, 0)):rx + tx] = fill
            np.testing.assert_array_equal(got[:, :tx + 2 * rx], ref)
            np.testing.assert_array_equal(got[:, tx + 2 * rx:], fill)


@pytest.mark.parametrize("shift", [(0, 0), (3, -2), (-17, 5), (25, 30),
                                   (-60, 0)])
def test_shifted_blocks_equal_a_shifted_global_slice(shift):
    rng = np.random.default_rng(4)
    data = rng.integers(0, 1000, (42, 36)).astype(np.int32)
    m = cpu_mesh(4, 2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        x = thalo.tiles(distribute(data, m))
    got = thalo.shifted_blocks(x, *shift, -1)
    for i in range(4):
        for j in range(2):
            (y0, y1), (x0, x1) = x.extent(0, i), x.extent(1, j)
            ref = padded_slice(data, y0 + shift[0], x0 + shift[1], y1 - y0,
                               x1 - x0, -1)
            np.testing.assert_array_equal(got[i][j].numpy(), ref)


def mean3x3(a):
    p = torch.nn.functional.pad(a, (1, 1, 1, 1), value=math.nan)
    h, w = a.shape[-2:]
    acc = torch.zeros_like(a)
    for dy in range(3):
        for dx in range(3):
            acc = acc + p[..., dy:dy + h, dx:dx + w]
    return acc / 9.0


def test_run_stencil_keeps_a_leading_dim(mesh):
    data = np.random.default_rng(4).random((3, 16, 24)).astype(np.float32)
    ref = mean3x3(torch.from_numpy(data))
    x = distribute(data, mesh)
    out = run_stencil(mean3x3, 1, x)
    assert out.shape == (3, 16, 24)
    assert_same(gathered(out, mesh), ref)
    lead = stencil_shard_map(mean3x3, mesh, HaloSpec(1, 1),
                             out_leading_dims=1)(x)
    assert_same(lead.gather(), ref)
    with pytest.raises(ValueError, match="expected 2"):
        stencil_shard_map(mean3x3, mesh, HaloSpec(1, 1), 0)(x)


def test_run_stencil_casts_integers_to_float32():
    m = cpu_mesh(2, 2)
    data = np.arange(48, dtype=np.int64).reshape(6, 8)
    out = run_stencil(mean3x3, 1, distribute(data, m))
    assert out.dtype == torch.float32
    assert_same(out.gather(), mean3x3(torch.from_numpy(data).float()))


def test_run_stencil_warns_on_raster_sized_halo():
    m = cpu_mesh(4, 2)
    data = elevation((8, 6), 9, nan_cell=False)
    with pytest.warns(UserWarning, match="raster-sized"):
        out = convolution_2d(sharded(data, m), np.ones((7, 7)))
    ref = convolution_2d(raster(data), np.ones((7, 7)))
    np.testing.assert_allclose(gathered(out, m).numpy(), ref.data.numpy(),
                               rtol=1e-5, atol=1e-5, equal_nan=True)


@pytest.mark.parametrize("shape,meshshape,kshape", [
    ((16, 16), (4, 2), (11, 11)),   # radius 5 over 4-row shards
    ((42, 9), (8, 1), (27, 3)),     # 13 rows: 3 hops over 6-row shards,
])                                  # y padded to 48
def test_halo_wider_than_a_shard(shape, meshshape, kshape):
    """The JAX suite's multi-hop cases (``tests/test_parallel.py:134-171``):
    the convolution stays split and equals the unsharded one."""
    m = cpu_mesh(*meshshape)
    data = (np.random.default_rng(9).random(shape) * 10).astype(np.float32)
    kernel = np.ones(kshape)
    ref = convolution_2d(raster(data), kernel).data
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        out = convolution_2d(sharded(data, m), kernel)
    np.testing.assert_allclose(gathered(out, m).numpy(), ref.numpy(),
                               rtol=1e-5, atol=1e-5, equal_nan=True)


def routes(fn, *args, **kw):
    """``fn(*args, **kw)`` under a CPU profiler (the counters count only
    there): (result, blocks in place, blocks extended)."""
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn(*args, **kw)
    c = tracing.counters()
    tracing.clear()
    return (out, c.get("mesh.inplace_blocks", 0),
            c.get("mesh.extended_blocks", 0))


@pytest.mark.parametrize("op", ["terrain_pipeline", "focal_3x3",
                                "focal_5x5"])
def test_the_in_place_route_takes_every_block(op):
    """On the 2x2 mesh each tile (20 x 24) holds a halo of 1 or 2 four
    times over: every block of every stencil runs in place, and the
    results equal the unsharded call as the op's own test holds them."""
    m = cpu_mesh(2, 2)
    data = elevation((40, 48), 17)
    if op == "terrain_pipeline":
        surface = ("slope", "hillshade", "curvature")
        ref = xt.terrain_pipeline(raster(data), surface=surface)
        out, inplace, extended = routes(xt.terrain_pipeline,
                                        sharded(data, m), surface=surface)
        assert (inplace, extended) == (2 * 4, 0)     # surface, focal
        for p in surface:
            (assert_same if p == "curvature" else assert_ulp)(
                gathered(out[f"dem-{p}"], m), ref[f"dem-{p}"].data)
        assert_same(gathered(out["focal_stats"], m),
                    ref["focal_stats"].data)
        return
    kernel = np.ones((3, 3) if op == "focal_3x3" else (5, 5))
    ref = tfocal.focal_stats(raster(data), kernel).data
    out, inplace, extended = routes(tfocal.focal_stats, sharded(data, m),
                                    kernel)
    assert (inplace, extended) == (4, 0)
    assert_same(gathered(out, m), ref)


@pytest.mark.parametrize("case", ["wide_4x2", "wide_8x1", "conv"])
def test_the_extended_route_takes_what_does_not_fit(case):
    """A halo deeper than a quarter tile (``test_halo_wider_than_a_shard``'s
    cases) and the focal conv path, whose sums centre on their input's
    mean, take the extended blocks on every block, at those tests'
    tolerance; the conv footprint's halo, 16, fits the 64-cell tiles four
    times, so only the kernel's kind sends it there."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        if case == "conv":
            m = cpu_mesh(2, 2)
            data = elevation((128, 128), 8)
            kernel = np.ones((33, 33))          # 1089 offsets
            ref = tfocal.focal_stats(raster(data), kernel).data
            out, inplace, extended = routes(tfocal.focal_stats,
                                            sharded(data, m), kernel)
        else:
            shape, meshshape, kshape = {
                "wide_4x2": ((16, 16), (4, 2), (11, 11)),
                "wide_8x1": ((42, 9), (8, 1), (27, 3))}[case]
            m = cpu_mesh(*meshshape)
            data = (np.random.default_rng(9).random(shape) * 10).astype(
                np.float32)
            kernel = np.ones(kshape)
            ref = convolution_2d(raster(data), kernel).data
            out, inplace, extended = routes(convolution_2d,
                                            sharded(data, m), kernel)
    assert (inplace, extended) == (0, m.size)
    np.testing.assert_allclose(gathered(out, m).numpy(), ref.numpy(),
                               rtol=1e-5, atol=1e-5, equal_nan=True)


def test_the_in_place_route_rebuilds_the_ring_from_its_bands(monkeypatch):
    """With every band all fill the tiles' rings come out NaN and every
    other cell right: the ring is the bands' work, the rest the tiles'."""
    m = cpu_mesh(2, 2)
    data = elevation((40, 48), 18, nan_cell=False)
    ref = mean3x3(torch.from_numpy(data))

    def empty(x, halo, fill):
        return [[tuple(None if b is None else torch.full_like(b, fill)
                       for b in pair) for pair in row]
                for row in bands(x, halo, fill)]
    bands = thalo._bands
    monkeypatch.setattr(thalo, "_bands", empty)
    got = run_stencil(mean3x3, 1, distribute(data, m)).gather()
    ring = torch.zeros(40, 48, dtype=torch.bool)
    for y0 in (0, 20):
        for x0 in (0, 24):
            ring[y0:y0 + 20, x0:x0 + 24] = True
            ring[y0 + 2:y0 + 18, x0 + 1:x0 + 23] = False
    assert torch.isnan(got[ring]).all()
    assert_same(got[~ring], ref[~ring])


def test_run_stencil_unsharded_goes_straight_to_the_kernel():
    x = torch.ones(4, 4)
    assert run_stencil(lambda a: a + 1, 1, x).equal(x + 1)


# -- the surface ops ------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["slope", "aspect", "curvature",
                                  "hillshade"])
def test_surface_ops_on_a_mesh(name, shape, mesh):
    data = elevation(shape, 5)
    fn = getattr(xt, name)
    ref = fn(raster(data)).data
    out = fn(sharded(data, mesh))
    got = gathered(out, mesh)
    if name == "curvature":
        assert_same(got, ref)
    else:
        assert_ulp(got, ref)


def test_summarize_terrain_on_a_mesh():
    m = cpu_mesh(2, 2)
    data = elevation((40, 48), 6)
    ref = xt.summarize_terrain(raster(data))
    out = xt.summarize_terrain(sharded(data, m))
    for p in ("slope", "aspect", "curvature"):
        got = gathered(out[f"dem-{p}"], m)
        (assert_same if p == "curvature" else assert_ulp)(
            got, ref[f"dem-{p}"].data)


# -- focal ----------------------------------------------------------------------

KERNELS = {
    "circle_r1": circle_kernel(1, 1, 1.5),
    "rect_3x5": np.ones((3, 5)),
    "column_27x3": np.ones((27, 3)),
    "annulus": annulus_kernel(1, 1, 4, 2),
}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kname", list(KERNELS))
def test_focal_stats_on_a_mesh(kname, shape, mesh):
    data = elevation(shape, 7)
    ref = tfocal.focal_stats(raster(data), KERNELS[kname]).data
    out = tfocal.focal_stats(sharded(data, mesh), KERNELS[kname])
    assert out.dims == ("stats", "y", "x")
    assert_same(gathered(out, mesh), ref)


def test_focal_stats_conv_path_on_a_mesh(mesh):
    data = elevation((40, 48), 8)
    kernel = np.ones((37, 35))          # 1295 offsets: the conv path
    ref = tfocal.focal_stats(raster(data), kernel).data
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # raster-sized halo
        out = tfocal.focal_stats(sharded(data, mesh), kernel)
    np.testing.assert_allclose(gathered(out, mesh).numpy(), ref.numpy(),
                               rtol=1e-5, atol=1e-5, equal_nan=True)


@pytest.mark.parametrize("func", ["max", "std", "callable"])
def test_apply_on_a_mesh(func, mesh):
    data = elevation((42, 36), 9)
    fn = (lambda a: np.nanmedian(a) if np.isfinite(a).any() else np.nan) \
        if func == "callable" else getattr(tfocal, f"_calc_{func}")
    kernel = KERNELS["rect_3x5"]
    ref = tfocal.apply(raster(data), kernel, fn).data
    out = tfocal.apply(sharded(data, mesh), kernel, fn)
    assert_same(gathered(out, mesh), ref)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_mean_on_a_mesh(dtype, mesh):
    data = elevation((42, 36), 10, nan_cell=dtype == np.float32)
    data = data.astype(dtype)
    for passes, excludes in ((1, [np.nan]), (3, [np.nan, 50])):
        ref = tfocal.mean(raster(data), passes, excludes).data
        out = tfocal.mean(sharded(data, mesh), passes, excludes)
        assert_same(gathered(out, mesh), ref)


def test_hotspots_on_a_mesh(mesh):
    rng = np.random.default_rng(11)
    data = rng.integers(0, 10, (42, 36)).astype(np.float32)
    kernel = circle_kernel(1, 1, 1.5)
    # no z-score near a threshold, so both moments give the same classes
    ref_agg = raster(data)
    conv = tfocal.convolve_2d(ref_agg.data, kernel / kernel.sum())
    d = torch.from_numpy(data)
    z = ((conv - d.mean()) / d.std(unbiased=False)).abs()
    assert float(torch.nan_to_num(
        torch.stack([(z - t).abs() for t in (1.65, 1.96, 2.58)]),
        nan=1.0).min()) > 1e-6
    ref = tfocal.hotspots(ref_agg, kernel).data
    out = tfocal.hotspots(sharded(data, mesh), kernel)
    assert out.attrs["unit"] == "%"
    assert_same(gathered(out, mesh), ref)


@pytest.mark.parametrize("kname", ["circle_r1", "column_27x3"])
def test_convolution_2d_on_a_mesh(kname, mesh):
    data = elevation((42, 36), 12)
    ref = convolution_2d(raster(data), KERNELS[kname]).data
    out = convolution_2d(sharded(data, mesh), KERNELS[kname])
    np.testing.assert_allclose(gathered(out, mesh).numpy(), ref.numpy(),
                               rtol=1e-5, atol=1e-5, equal_nan=True)


@pytest.mark.parametrize("shape", SHAPES)
def test_terrain_pipeline_on_a_mesh(shape, mesh, monkeypatch):
    monkeypatch.setenv("XRSPATIAL_FUSED_PIPELINE", "1")   # not on a mesh
    data = elevation(shape, 13)
    surface = ("slope", "hillshade", "curvature")
    ref = xt.terrain_pipeline(raster(data), surface=surface)
    out = xt.terrain_pipeline(sharded(data, mesh), surface=surface)
    for p in surface:
        got = gathered(out[f"dem-{p}"], mesh)
        (assert_same if p == "curvature" else assert_ulp)(
            got, ref[f"dem-{p}"].data)
    assert_same(gathered(out["focal_stats"], mesh), ref["focal_stats"].data)


# -- the proximity family -------------------------------------------------------

def targets(shape, seed, density=0.02):
    rng = np.random.default_rng(seed)
    data = np.where(rng.random(shape) < density,
                    rng.integers(1, 9, shape), 0).astype(np.float32)
    data[shape[0] // 2, shape[1] // 3] = 5.0
    return data


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fn", ["proximity", "allocation", "direction"])
def test_proximity_family_on_a_mesh(fn, shape, mesh):
    """The packed state (affine axes): bit for bit."""
    data = targets(shape, 14)
    ref = getattr(xt, fn)(raster(data)).data
    out = getattr(xt, fn)(sharded(data, mesh))
    assert_same(gathered(out, mesh), ref)


def lonlat(shape):
    h, w = shape
    return {"y": np.linspace(40.0, 41.0, h), "x": np.linspace(-3.0, -1.5, w)}


def test_proximity_coordinate_state_on_a_mesh(mesh):
    """GREAT_CIRCLE, and EUCLIDEAN on axes the packed plan refuses: the
    coordinate state per block."""
    shape = (42, 36)
    data = targets(shape, 15)
    rng = np.random.default_rng(15)
    uneven = {"y": np.cumsum(rng.random(shape[0]) + 0.5),
              "x": np.cumsum(rng.random(shape[1]) + 0.5)}
    assert tjfa.packed_state_plan(uneven["x"], uneven["y"], 0) is None
    for fn in ("proximity", "allocation"):
        ref = getattr(xt, fn)(raster(data, coords=uneven)).data
        out = getattr(xt, fn)(sharded(data, mesh, coords=uneven))
        assert_same(gathered(out, mesh), ref)
    ref = xt.proximity(raster(data, coords=lonlat(shape)),
                       distance_metric="GREAT_CIRCLE").data
    out = xt.proximity(sharded(data, mesh, coords=lonlat(shape)),
                       distance_metric="GREAT_CIRCLE")
    np.testing.assert_allclose(gathered(out, mesh).numpy(), ref.numpy(),
                               rtol=1e-6, equal_nan=True)


def test_proximity_max_distance_and_targets_on_a_mesh():
    m = cpu_mesh(2, 2)
    data = targets((40, 48), 16, 0.01)
    kw = dict(target_values=[5.0, 3.0], max_distance=9.5)
    ref = xt.allocation(raster(data), **kw).data
    assert_same(gathered(xt.allocation(sharded(data, m), **kw), m), ref)


def test_jump_flood_over_600_rows_takes_the_global_rounds():
    """Strides above 256 run as torch-op rounds over windows of at most
    2 x 2 tiles: 600 rows take a 512 stride."""
    m = cpu_mesh(2, 1)
    rng = np.random.default_rng(17)
    mask = torch.from_numpy(rng.random((600, 40)) < 0.002)
    mask[7, 3] = True
    xs, ys = np.arange(40, dtype=np.float32), np.arange(600, dtype=np.float32)
    vals = torch.from_numpy(rng.random((600, 40)).astype(np.float32))
    assert 512 in tjfa._stride_schedule(600)
    ref = tjfa.jump_flood(mask, torch.from_numpy(xs), torch.from_numpy(ys),
                          0, values=vals)
    got = tjfa.jump_flood(mask, xs, ys, 0, values=vals, mesh=m)
    for r, g in zip(ref, got):
        assert_same(gathered(g, m), r)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("x_order", ["ascending", "descending"])
@pytest.mark.parametrize("fn", ["proximity", "allocation", "direction"])
def test_manhattan_scan_on_a_mesh(fn, x_order, shape, mesh):
    """MANHATTAN's exact scan transform, its scans carried from tile to
    tile: bit for bit, with either x order (a descending axis reverses
    the row scans), ties included (integer coordinates)."""
    data = targets(shape, 18, 0.03)
    h, w = shape
    xs = np.arange(w, dtype=np.float64)
    coords = {"y": np.arange(h, dtype=np.float64)[::-1].copy(),
              "x": xs if x_order == "ascending" else xs[::-1].copy()}
    assert tjfa.manhattan_scan_plan(coords["x"], coords["y"]) == \
        (x_order == "descending")
    kw = dict(distance_metric="MANHATTAN")
    ref = getattr(xt, fn)(raster(data, coords=coords), **kw).data
    out = getattr(xt, fn)(sharded(data, mesh, coords=coords), **kw)
    assert_same(gathered(out, mesh), ref)


def test_manhattan_scan_without_targets_on_a_mesh():
    m = cpu_mesh(2, 2)
    data = np.zeros((16, 18), np.float32)
    ref = xt.proximity(raster(data), distance_metric="MANHATTAN").data
    out = xt.proximity(sharded(data, m), distance_metric="MANHATTAN")
    assert_same(gathered(out, m), ref)
    assert torch.isnan(ref).all()


@pytest.mark.parametrize("k,origin", [(1, (0, 0)), (2, (5, 7)),
                                      (8, (-8, 24)), (4, (30, -4))])
@pytest.mark.parametrize("metric", [0, 2])
def test_packed_round_with_an_origin_equals_the_unsharded_round(k, origin,
                                                               metric):
    """The twin on a window of the state, told the window's origin, gives
    the cells the unsharded round gives them."""
    rng = np.random.default_rng(19)
    h, w = 48, 64
    mask = torch.from_numpy(rng.random((h, w)) < 0.05)
    iy = torch.arange(h, dtype=torch.int32)[:, None]
    ix = torch.arange(w, dtype=torch.int32)[None, :]
    state = torch.where(mask, (iy << 15) | ix, -1)
    value = torch.from_numpy(rng.random((h, w)).astype(np.float32))
    steps = (3.0, 2.0)
    ref = jfa_rounds.round_packed(state, value, k, metric, steps)
    y0, x0 = origin
    rows, cols = 20, 24
    win = [torch.from_numpy(padded_slice(p.numpy(), y0, x0, rows, cols, f))
           for p, f in ((state, -1), (value, 0.0))]
    got = jfa_rounds.round_packed(win[0], win[1], k, metric, steps, origin)
    # the window's cells whose candidates all lie inside the window
    for a, b in zip(got, ref):
        inner = b[max(y0 + k, 0):y0 + rows - k, max(x0 + k, 0):x0 + cols - k]
        sub = a[max(y0 + k, 0) - y0:rows - k, max(x0 + k, 0) - x0:cols - k]
        assert inner.numel() > 0
        assert_same(sub, inner)


# -- the percentile classifiers -------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_nanpercentile_sharded_equals_nanpercentile(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 400))
    v = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 6)).astype(
        np.float32)
    if seed % 2:
        v = np.round(v)                              # ties
    v[rng.random(n) < 0.2] = np.nan
    q = np.sort(rng.random(7) * 100).astype(np.float32)
    q[0], q[-1] = 0.0, 100.0
    t = torch.from_numpy(v)
    cuts = np.sort(rng.integers(0, n + 1, int(rng.integers(0, 5))))
    parts = [t[a:b] for a, b in zip([0, *cuts], [*cuts, n])]
    assert_same(nanpercentile_sharded(parts, q), nanpercentile(t, q))


def test_nanpercentile_sharded_of_no_finite_value_is_nan():
    parts = [torch.full((5,), math.nan), torch.empty(0)]
    assert torch.isnan(nanpercentile_sharded(parts, [50.0])).all()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fn,kw", [("quantile", dict(k=5)),
                                   ("percentiles", {}),
                                   ("percentiles", dict(pct=[10, 90])),
                                   ("box_plot", {})])
def test_percentile_classifiers_on_a_mesh(fn, kw, shape, mesh):
    data = elevation(shape, 20)
    data[2, :] = np.nan
    data[0, 0] = np.inf
    ref = getattr(xt, fn)(raster(data), **kw).data
    out = getattr(xt, fn)(sharded(data, mesh), **kw)
    assert_same(gathered(out, mesh), ref)


def test_box_plot_of_an_all_nan_mesh_raster():
    m = cpu_mesh(2, 2)
    out = xt.box_plot(sharded(np.full((8, 6), np.nan, np.float32), m))
    assert torch.isnan(gathered(out, m)).all()


# -- the ops without a mesh form ------------------------------------------------

def test_exact_viewshed_warns_and_runs_on_one_device():
    m = cpu_mesh(2, 2)
    data = elevation((16, 16), 21, nan_cell=False)
    with pytest.warns(UserWarning, match="ONE device"):
        out = xt.viewshed(sharded(data, m), x=8.0, y=16.0)
    ref = xt.viewshed(raster(data), x=8.0, y=16.0)
    assert_same(out.data, ref.data)


def test_xdraw_viewshed_on_a_mesh_is_not_ported_yet():
    """The XDraw viewshed on a mesh (its strip route; the name is kept
    from when it raised): the result split over the same mesh, equal to
    the unsharded call bit for bit."""
    m = cpu_mesh(2, 2)
    data = elevation((16, 16), 22)
    out = xt.viewshed(sharded(data, m), x=8.0, y=16.0, exact=False)
    ref = xt.viewshed(raster(data), x=8.0, y=16.0, exact=False)
    assert_same(gathered(out, m), ref.data)


def test_a_star_warns_and_runs_on_the_host():
    m = cpu_mesh(2, 2)
    data = np.ones((16, 16), np.float32)
    start, goal = (2.0, 1.0), (28.0, 14.0)
    with pytest.warns(UserWarning, match="gathered"):
        out = xt.a_star_search(sharded(data, m), start, goal)
    assert_same(out.data, xt.a_star_search(raster(data), start, goal).data)


def zonal_apply_result(a, z):
    xt.zonal_apply(z, a, lambda v: v + 1.0)
    return a


def polygonize_result(a, z):
    values, polys = importlib.import_module(
        "xrspatial_torch.experimental.polygonize").polygonize(z)
    return values, [[r.tolist() for r in p] for p in polys]


# (call, what it returns on the mesh, the warning it gives there)
OTHER_OPS = {
    "ndvi": (lambda a, z: xt.ndvi(a, a), "mesh", None),
    "equal_interval": (lambda a, z: xt.equal_interval(a), "mesh", None),
    "natural_breaks": (lambda a, z: xt.natural_breaks(a), "mesh", None),
    "regions": (lambda a, z: xt.regions(z), "mesh", None),
    "zonal_stats": (lambda a, z: xt.zonal_stats(z, a), "frame", None),
    "zonal_crosstab": (lambda a, z: xt.zonal_crosstab(z, z), "frame", None),
    "trim": (lambda a, z: xt.trim(a), "window", None),
    "crop": (lambda a, z: xt.crop(z, a, [1]), "window", None),
    "zonal_apply": (zonal_apply_result, "mesh", "zonal_apply"),
    "hillshade_shadows": (lambda a, z: xt.hillshade(a, shadows=True),
                          "mesh", "covers the whole raster"),
    "geodesic_slope": (lambda a, z: xt.slope(a, method="geodesic"), "mesh",
                       None),
    "polygonize": (polygonize_result, "host", "polygonize"),
}


@pytest.mark.parametrize("name", list(OTHER_OPS))
def test_other_ops_refuse_a_mesh_raster(name):
    """The ops that refused a mesh raster before their mesh forms (the
    name is kept): each on a 2x2 mesh equals the unsharded call, its
    result split over the same mesh (trim and crop: the window as one
    tensor; the frames and polygons on the host); the host functions and
    a halo that covers the raster warn."""
    call, kind, warns = OTHER_OPS[name]
    data = elevation((8, 8), 23, nan_cell=False)
    zones = np.floor(data / 25).astype(np.int64)
    m = cpu_mesh(2, 2)
    ref = call(raster(data), raster(zones))
    ctx = pytest.warns(UserWarning, match=warns) if warns else \
        warnings.catch_warnings()
    with ctx:
        out = call(sharded(data, m), sharded(zones, m))
    if kind == "mesh":
        assert_same(gathered(out, m), ref.data)
    elif kind == "window":
        assert isinstance(out.data, torch.Tensor)
        assert_same(out.data, ref.data)
    elif kind == "frame":
        importlib.import_module("pandas").testing.assert_frame_equal(out,
                                                                     ref)
    else:
        assert out == ref


def test_a_raster_no_block_splits_takes_the_one_device_path():
    """An indivisible raster is replicated on every block: ops run on the
    first block, as the JAX package's jit path."""
    data = elevation((37, 53), 24)
    agg = raster(data)
    with pytest.warns(UserWarning, match="REPLICATED"):
        agg.data = distribute(agg.data, cpu_mesh(2, 2))
    assert get_raster_mesh(agg.data) is None
    assert_same(xt.slope(agg).data, xt.slope(raster(data)).data)


# -- against the JAX package's sharded calls ----------------------------------

def jax_sharded(data, coords, res=(1.0, 2.0)):
    from xrspatial_tpu.parallel import distribute as jax_distribute
    from xrspatial_tpu.parallel import make_raster_mesh as jax_mesh
    from xrspatial_tpu.xrlib import DataArray as JaxDataArray
    agg = JaxDataArray(data, dims=("y", "x"), coords=coords, name="dem",
                       attrs={"res": res})
    agg.data = jax_distribute(jnp.asarray(data), jax_mesh(2, 2))
    return agg


def coords_of(shape):
    h, w = shape
    return {"y": np.arange(h, dtype=np.float64)[::-1] * 2.0,
            "x": np.arange(w, dtype=np.float64)}


def test_slope_matches_the_jax_package_on_a_mesh():
    from xrspatial_tpu import slope as jax_slope
    data = elevation((40, 48), 25)
    ref = np.asarray(jax_slope(jax_sharded(data, coords_of(data.shape))).data)
    m = cpu_mesh(2, 2)
    got = gathered(xt.slope(sharded(data, m)), m).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, equal_nan=True)


def test_focal_stats_matches_the_jax_package_on_a_mesh():
    from xrspatial_tpu.focal import focal_stats as jax_focal_stats
    data = elevation((40, 48), 26)
    kernel = circle_kernel(1, 1, 1.5)
    ref = np.asarray(jax_focal_stats(
        jax_sharded(data, coords_of(data.shape)), kernel).data)
    m = cpu_mesh(2, 2)
    got = gathered(tfocal.focal_stats(sharded(data, m), kernel), m).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6,
                               equal_nan=True)


@pytest.mark.parametrize("metric", ["EUCLIDEAN", "GREAT_CIRCLE"])
def test_proximity_matches_the_jax_package_on_a_mesh(metric):
    from xrspatial_tpu import proximity as jax_proximity
    shape = (32, 32)
    data = targets(shape, 27, 0.01)
    coords = coords_of(shape) if metric == "EUCLIDEAN" else lonlat(shape)
    ref = np.asarray(jax_proximity(jax_sharded(data, coords),
                                   distance_metric=metric).data)
    m = cpu_mesh(2, 2)
    got = gathered(xt.proximity(sharded(data, m, coords=coords),
                                distance_metric=metric), m).numpy()
    if metric == "EUCLIDEAN":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-4, equal_nan=True)


def test_quantile_matches_the_jax_package_on_a_mesh():
    from xrspatial_tpu.classify import quantile as jax_quantile
    data = (np.random.default_rng(28).random((16, 16)) * 100).astype(
        np.float32)
    ref = np.asarray(jax_quantile(jax_sharded(data, coords_of(data.shape)),
                                  k=4).data)
    m = cpu_mesh(2, 2)
    got = gathered(xt.quantile(sharded(data, m), k=4), m).numpy()
    np.testing.assert_array_equal(got, ref)
