"""B1, B4 and B0 on staged windows: their plans and windows, on the CPU.

``cuda_surface.surface_cuda`` (B1, the port of ``xrspatial_tpu/kernels/
pallas_surface2.py::surface_tiled``) runs ``csrc/surface.cu::
surface_staged_kernel`` on the route ``surface.surface_plan`` names:
persistent blocks walking ``SURFACE_TILE`` tiles through a ring of
windows staged by TMA (cp.async where TMA refuses the pitch or base).
``cuda_pipeline.pipeline_cuda`` (B4, the port of ``pallas_pipeline.py::
pipeline_tiled``) runs B2's staged template of ``csrc/focal_halo.cu``
with a surface epilogue, on ``pipeline.pipeline_plan``'s window, whose
radii are at least 1.  Their first ports stay by name (route "simple").
Pinned here without a card:

- B1's plan (tile, stages, shared bytes, grid) and its route rule at each
  alignment; the tiles and blocks an SM the source compiles;
- B4's plan: radii clamped to 1 for a row or a column footprint, the
  fused gate's largest footprint fits a staged window, the register
  class;
- torch emulations of both kernels (``kernels/emulate.py``), written with
  their loops, index arithmetic and NaN-filled windows, equal to the
  plain versions ``surface_multi`` and ``pipeline_multi`` bit for bit;
- both emulations against the JAX package's ``surface_tiled`` and
  ``pipeline_tiled`` in interpret mode (surface rtol 1e-4 / atol 5e-5,
  focal rtol 1e-5 / atol 1e-5: libdevice-free torch math against the
  TPU's polynomial atan);
- the wrappers refuse a CPU tensor on every route without counting;
- B0 (``cuda_surface.surface_stacked_cuda``, the port of
  ``pallas_surface.py::surface_pallas``) on B1's ring: ``stacked_plan``'s
  route rule (TMA where w % 4 == 0 and the bases are aligned, else the
  phased route), tiles, stages and refusals; ``emulate_stacked``, a torch
  emulation of both routes in a flat model of device memory (plane
  addressing at odd H * W, each window row's phase and its split into
  16-byte body copies and 4-byte head and tail copies, the phased loads'
  shift, each plane's 32-byte-aligned spans, the ring schedule), equal to
  ``surface_multi_stacked`` bit for bit at every plane order, input base
  and output base, and within the surface tolerance of the JAX package's
  ``surface_multi`` stacked in `which` order (``surface_pallas`` has no
  interpret mode on the CPU).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrspatial_torch.convolution import circle_kernel
from xrspatial_torch.kernels import cuda_pipeline, cuda_surface
from xrspatial_torch.kernels import focal_halo as fh
from xrspatial_torch.kernels import pipeline as tp
from xrspatial_torch.kernels import staged
from xrspatial_torch.kernels import surface as ts
from xrspatial_torch.kernels.emulate import (emulate_pipeline,
                                             emulate_stacked,
                                             emulate_surface_staged,
                                             halo_case, ring_schedule,
                                             same_bits)
from xrspatial_torch.kernels.window import kernel_offsets

SURFACE_TOL = dict(rtol=1e-4, atol=5e-5)
FOCAL_TOL = dict(rtol=1e-5, atol=1e-5)
PRODUCTS = ts.PRODUCTS
STATS = ("mean", "max", "min", "std")
ALL_STATS = ("mean", "max", "min", "range", "std", "var", "sum")
CSRC = Path(ts.__file__).resolve().parent.parent / "csrc"
MASKS = {"slope": ("slope",), "aspect": ("aspect",),
         "curvature": ("curvature",), "hillshade": ("hillshade",),
         "slope+hillshade": ("slope", "hillshade"), "all": PRODUCTS}
ARGS = (2.0, 3.0, 300.0, 40.0)   # cellsize x, y, azimuth, altitude


@pytest.fixture(autouse=True)
def one_thread():
    """The emulations are many small torch ops: one thread each, the same
    for the plain versions they are held to."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dem(shape, seed=7):
    """halo_case's raster (a NaN block, +-inf cells) with a flat 6x6 block,
    where aspect is -1."""
    x = halo_case(shape, seed)
    h, w = shape
    x[(2 * h) // 3:(2 * h) // 3 + 6, w // 2:w // 2 + 6] = 25.0
    return x


# -- B1's plan -----------------------------------------------------------------

def test_b1_takes_the_64x128_tile_at_three_blocks_an_sm():
    """The tile and blocks an SM chosen by timing on the card (chip_smoke.py
    phase 5), and what the source compiles: every tile of SURFACE_TILES,
    launch bounds of SURFACE_BLOCKS_PER_SM."""
    assert ts.SURFACE_TILE == (64, 128)
    assert ts.SURFACE_TILES == ((32, 128), (64, 128), (32, 248))
    assert ts.SURFACE_BLOCKS_PER_SM == 3
    src = (CSRC / "surface.cu").read_text()
    assert re.search(r"constexpr int kSurfaceBlocksPerSm = 3;", src)
    compiled = re.findall(r"if \(th == (\d+) && tw == (\d+)\)\n\s+return "
                          r"staged_on_route", src)
    assert tuple((int(a), int(b)) for a, b in compiled) == ts.SURFACE_TILES


@pytest.mark.parametrize("shape,tile,ptr,plan", [
    ((16384, 16384), (64, 128), 0,
     ((136, 66), 2, 35968, 72192, "tma", 32768, 396)),
    ((16384, 16384), (32, 128), 0,
     ((136, 34), 4, 18560, 74496, "tma", 65536, 396)),
    ((16384, 16384), (32, 248), 0,
     ((256, 34), 2, 34816, 69888, "tma", 34304, 396)),
    ((16384, 16384), (64, 128), 4,
     ((136, 66), 2, 35968, 72192, "async", 32768, 396)),
    ((16384, 16382), (64, 128), 0,
     ((136, 66), 2, 35968, 72192, "async", 32768, 396)),
    ((263, 516), (64, 128), 16,
     ((136, 66), 2, 35968, 72192, "tma", 25, 25)),
    ((300, 70), (64, 128), 0, ((136, 66), 2, 35968, 72192, "async", 5, 5)),
    ((1, 1000), (64, 128), 0, ((136, 66), 2, 35968, 72192, "tma", 8, 8)),
    ((2, 5), (64, 128), 0, ((136, 66), 2, 35968, 72192, "async", 1, 1)),
], ids=["16384-64x128", "16384-32x128", "16384-32x248", "16384-base+4",
        "16384x16382", "263x516", "300x70", "1x1000", "2x5"])
def test_surface_plan(shape, tile, ptr, plan):
    """The box, stages, shared bytes, route and grid: TMA exactly where the
    row pitch and the base are 16-byte aligned; a ring that lets three
    blocks share an SM."""
    p = ts.surface_plan(*shape, ptr, tile)
    assert tuple(p) == plan
    assert 3 * (p.shared_bytes + 1024) <= staged.SMEM_PER_SM
    assert p.shared_bytes == 256 + p.stages * p.stage_bytes


@pytest.mark.parametrize("tile", [(32, 64), (16, 128), (64, 248)])
def test_surface_plan_refuses_a_tile_the_kernel_lacks(tile):
    with pytest.raises(ValueError, match="no tile"):
        ts.surface_plan(256, 256, 0, tile)


def test_b8c_keeps_its_two_blocks_an_sm():
    """The staged probe B8c shares the ring's plan and keeps its own
    sizing, two blocks an SM."""
    from xrspatial_torch.kernels import stencil_probe as sp
    assert tuple(sp.staged_plan(16384, 16384, (64, 128))) == (
        (136, 66), 3, 35968, 108160, "tma", 32768, 264)
    assert sp.staged_plan is staged.staged_plan


@pytest.mark.parametrize("tiles,grid,stages", [
    (32768, 396, 2), (25, 25, 2), (7, 2, 3), (10, 4, 4), (1, 396, 2)])
def test_ring_schedule_walks_every_tile_once(tiles, grid, stages):
    """The persistent loop: each block's k-th tile is b + k * grid, every
    tile once; stage k % stages, parity flipping each pass of the ring."""
    seen = []
    for b, k, t, s, parity in ring_schedule(tiles, grid, stages):
        assert t == b + k * grid and t < tiles
        assert s == k % stages and parity == (k // stages) % 2
        seen.append(t)
    assert sorted(seen) == list(range(tiles))


# -- B1's emulation ------------------------------------------------------------

@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("shape", [(1, 1000), (2, 5), (263, 516), (300, 70),
                                   (70, 301)])
def test_emulated_b1_equals_surface_multi(shape, mask):
    """Bit for bit at every mask: the NaN ring from the windows' NaN fill
    (every cell where h < 3 or w < 3), NaN patches, +-inf cells and
    aspect's -1 on flat cells; sms=1, so each block walks many tiles."""
    which = MASKS[mask]
    x = dem(shape)
    got = emulate_surface_staged(x, which, *ARGS, sms=1)
    ref = ts.surface_multi(x, *ARGS, which)
    assert list(got) == list(which)
    for p in which:
        assert same_bits(got[p], ref[p]), p
    if "aspect" in which and shape[0] > 8 and shape[1] > 8:
        assert bool((got["aspect"] == -1.0).any())


@pytest.mark.parametrize("tile", ts.SURFACE_TILES)
def test_emulated_b1_equals_surface_multi_at_every_tile(tile):
    x = dem((263, 516), seed=8)
    got = emulate_surface_staged(x, PRODUCTS, *ARGS, tile=tile)
    ref = ts.surface_multi(x, *ARGS, PRODUCTS)
    for p in PRODUCTS:
        assert same_bits(got[p], ref[p]), p


# -- B4's plan -----------------------------------------------------------------

@pytest.mark.parametrize("kernel,radii,pad,rows", [
    (circle_kernel(1, 1, 1.5), (1, 1), 4, 34),
    (np.ones((1, 3)), (1, 1), 4, 34),
    (np.ones((3, 1)), (1, 1), 4, 34),
], ids=["plus", "1x3", "3x1"])
def test_pipeline_plan_clamps_the_radii_to_one(kernel, radii, pad, rows):
    """A row or a column footprint (ry = 0 or rx = 0) gets the window of
    radius 1 the surface half needs, and its run table is addressed on
    that window: row dy + 1, column pad + dx0, 40 16-byte groups a row."""
    offsets = kernel_offsets(kernel)
    assert tp.pipeline_supported(offsets)
    assert tp.pipeline_radii(offsets) == radii
    p = tp.pipeline_plan(16384, 16384, offsets)
    assert (p.route, p.tile, p.pad, p.pitch, p.rows, p.box) == (
        "tma", (32, 128), pad, 160, rows, (160, rows))
    assert p.shared_bytes == 128 + 128 + 128 + rows * 160 * 4 + 64
    assert fh.register_class(p) == 3
    got = fh.run_table(offsets, p, tp.SURFACE_RADIUS)
    assert len(got) == len(fh.footprint_runs(offsets))
    expect = []
    for dy, dx0, length in fh.footprint_runs(offsets):
        col = pad + dx0
        expect.append(((dy + 1) * 40 + col // 4, col % 4 + 4 * length))
    assert got == tuple(expect)
    # the unclamped table would address row dy + 0 for the 1x3 row
    if max(abs(dy) for dy, _ in offsets) == 0:
        assert fh.run_table(offsets, p) != got


def gate_footprints():
    """The fused gate's largest footprints (ry = 32, rx = 64): the full
    65x129 rectangle, and the sparsest, every other cell of each row."""
    full = np.ones((65, 129))
    sparse = np.zeros((65, 129))
    sparse[:, ::2] = 1
    return {"full": full, "sparse": sparse}


@pytest.mark.parametrize("w", [16384, 16382, 5])
@pytest.mark.parametrize("name", ["full", "sparse"])
def test_the_gates_largest_footprint_fits_a_staged_window(name, w):
    offsets = kernel_offsets(gate_footprints()[name])
    assert tp.pipeline_supported(offsets)
    assert tp.pipeline_radii(offsets) == (32, 64)
    p = tp.pipeline_plan(16384, w, offsets)
    assert p.route == ("tma" if w % 4 == 0 else "async")
    assert p.shared_bytes <= fh.SMEM_PER_BLOCK
    assert p.pad == 64 and p.pitch == 256 and p.rows >= p.tile[0] + 64
    assert fh.register_class(p) == 2
    runs = len(fh.footprint_runs(offsets))
    assert runs == (65 if name == "full" else 65 * 65)
    assert p.tile == ((32, 128) if name == "full" else (8, 128))


def test_wider_than_the_gate_is_refused_by_the_gate():
    for k in (np.ones((1, 131)), np.ones((67, 1))):
        assert not tp.pipeline_supported(kernel_offsets(k))


# -- B4's emulation ------------------------------------------------------------

PIPE_FEET = {"plus": circle_kernel(1, 1, 1.5), "r2": circle_kernel(1, 1, 2.5),
             "3x3": np.ones((3, 3)), "1x3": np.ones((1, 3)),
             "3x1": np.ones((3, 1))}


@pytest.mark.parametrize("foot", list(PIPE_FEET))
@pytest.mark.parametrize("shape", [(263, 516), (70, 300), (2, 5), (1, 1000),
                                   (300, 70)])
def test_emulated_b4_equals_pipeline_multi(shape, foot):
    """Bit for bit, every product and stat, the row and column footprints
    on their clamped windows included."""
    offsets = kernel_offsets(PIPE_FEET[foot])
    x = dem(shape, seed=11)
    got = emulate_pipeline(x, offsets, ALL_STATS, PRODUCTS, *ARGS)
    ref = tp.pipeline_multi(x, offsets, ALL_STATS, PRODUCTS, *ARGS)
    assert len(got) == len(ref) == len(PRODUCTS) + 1
    for g, r in zip(got, ref):
        assert same_bits(g, r)


def test_emulated_b4_main_path_case():
    offsets = kernel_offsets(PIPE_FEET["plus"])
    x = dem((140, 300), seed=12)
    got = emulate_pipeline(x, offsets, STATS, ("slope", "hillshade"), *ARGS)
    ref = tp.pipeline_multi(x, offsets, STATS, ("slope", "hillshade"), *ARGS)
    for g, r in zip(got, ref):
        assert same_bits(g, r)


# -- against the JAX package -----------------------------------------------------

def assert_close(got, ref, tol, msg=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, msg
    assert np.array_equal(np.isnan(got), np.isnan(ref)), msg
    np.testing.assert_allclose(got, ref, equal_nan=True, err_msg=msg, **tol)


def jax_raster(shape, seed):
    """A float32 DEM with a NaN patch (on a 32-row seam, as the JAX tests
    place one)."""
    rng = np.random.default_rng(seed)
    data = (rng.random(shape) * 100).astype(np.float32)
    data[20:23, 120:140] = np.nan
    data[31:33, 40] = np.nan
    return data


@pytest.mark.parametrize("which", [PRODUCTS, ("slope", "hillshade")],
                         ids=["all", "slope+hillshade"])
def test_emulated_b1_matches_jax_surface_tiled(which):
    from xrspatial_tpu.kernels.pallas_surface2 import surface_tiled
    data = jax_raster((37, 300), seed=21)
    f32 = jnp.float32
    ref = surface_tiled(jnp.asarray(data), f32(2.0), f32(3.0), f32(300.0),
                        f32(40.0), which, interpret=True)
    got = emulate_surface_staged(torch.from_numpy(data), which, *ARGS)
    for p, r in zip(which, ref):
        assert_close(got[p].numpy(), np.asarray(r), SURFACE_TOL, p)


@pytest.mark.parametrize("foot", ["plus", "1x3", "3x1"])
def test_emulated_b4_matches_jax_pipeline_tiled(foot):
    from xrspatial_tpu.kernels.pallas_pipeline import pipeline_tiled
    data = jax_raster((70, 300), seed=22)
    offsets = kernel_offsets(PIPE_FEET[foot])
    which = ("slope", "hillshade")
    f32 = jnp.float32
    ref = pipeline_tiled(jnp.asarray(data), f32(2.0), f32(3.0), f32(300.0),
                         f32(40.0), offsets, STATS, which=which, th=32,
                         tw=128, interpret=True)
    got = emulate_pipeline(torch.from_numpy(data), offsets, STATS, which,
                           *ARGS)
    for k, (g, r) in enumerate(zip(got, ref)):
        tol = FOCAL_TOL if k == len(which) else SURFACE_TOL
        assert_close(g.numpy(), np.asarray(r), tol, str(k))


# -- the wrappers ------------------------------------------------------------------

def counts():
    return (cuda_surface.LAUNCHES, cuda_surface.STAGED_TMA_LAUNCHES,
            cuda_surface.STAGED_ASYNC_LAUNCHES, cuda_surface.SIMPLE_LAUNCHES,
            cuda_pipeline.LAUNCHES, cuda_pipeline.TMA_LAUNCHES,
            cuda_pipeline.ASYNC_LAUNCHES, cuda_pipeline.SIMPLE_LAUNCHES)


@pytest.mark.parametrize("route", [None, "tma", "async", "simple"])
def test_wrappers_refuse_a_cpu_tensor_on_every_route(route):
    before = counts()
    x = torch.ones((8, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_surface.surface_cuda(x, ("slope",), route=route)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_pipeline.pipeline_cuda(x, ((0, 0), (0, 1)), ("mean",),
                                    ("slope",), route=route)
    assert counts() == before


def test_the_dispatchers_take_the_twins_on_the_cpu():
    x = dem((40, 60))
    before = counts()
    got = ts.surface_kernels(x, ("slope",))
    assert same_bits(got["slope"], ts.surface_multi(x, 1.0, 1.0, 225.0,
                                                    25.0, ("slope",))["slope"])
    offsets = kernel_offsets(PIPE_FEET["plus"])
    got = tp.pipeline_kernels(x, offsets, STATS, ("slope",))
    ref = tp.pipeline_multi(x, offsets, STATS, ("slope",))
    assert all(same_bits(g, r) for g, r in zip(got, ref))
    assert counts() == before


# -- B0 on the ring: the plan -------------------------------------------------

def test_b0_source_compiles_the_plans_tiles():
    """The stacked launcher dispatches exactly STACKED_TILES on each route,
    and the phased kernel's span and row pad are the plan's."""
    src = (CSRC / "surface.cu").read_text()
    body = src[src.index("int surface_stacked_staged_launch("):]
    body = body[:body.index("\n}\n")]
    phased = re.findall(r"if \(th == (\d+) && tw == xrt::kSpanCells\)", body)
    assert tuple((int(th), ts.SPAN_CELLS) for th in phased) == \
        ts.STACKED_TILES["phased"]
    tma = re.findall(r"if \(th == (\d+) && tw == (\d+)\)\n\s+return "
                     r"launch_staged<", body)
    assert tuple((int(a), int(b)) for a, b in tma) == ts.STACKED_TILES["tma"]
    cell = (CSRC / "surface_cell.cuh").read_text()
    assert f"kSpanCells = {ts.SPAN_CELLS}, kSpanShift = {ts.SPAN_SHIFT};" \
        in cell
    ring = (CSRC / "staged_window.cuh").read_text()
    assert f"kPhasedPitch = kCols + {ts.PHASED_ROW_PAD};" in ring
    assert ts.STACKED_TILE["tma"] in ts.STACKED_TILES["tma"]
    assert ts.STACKED_TILE["phased"] in ts.STACKED_TILES["phased"]


@pytest.mark.parametrize("args,plan", [
    ((16384, 16384, 0, 0, None, None, None),
     ("tma", (64, 128), 2, 35968, 72192, 32768, 396)),
    ((16383, 16383, 0, 0, None, None, None),
     ("phased", (64, 120), 2, 36992, 74240, 35072, 396)),
    ((16384, 16384, 4, 0, None, None, None),
     ("phased", (64, 120), 2, 36992, 74240, 35072, 396)),
    ((16384, 16384, 0, 4, None, None, None),
     ("phased", (64, 120), 2, 36992, 74240, 35072, 396)),
    ((16384, 16384, 0, 0, "phased", None, None),
     ("phased", (64, 120), 2, 36992, 74240, 35072, 396)),
    ((16383, 16383, 0, 0, None, (32, 120), None),
     ("phased", (32, 120), 4, 19072, 76544, 70144, 396)),
    ((16384, 16384, 0, 0, None, (32, 128), 3),
     ("tma", (32, 128), 3, 18560, 55936, 65536, 396)),
    ((40, 119, 0, 0, None, None, None),
     ("phased", (64, 120), 2, 36992, 74240, 2, 2)),
    ((263, 516, 16, 256, None, (32, 248), None),
     ("tma", (32, 248), 2, 34816, 69888, 27, 27)),
    ((2, 5, 0, 0, None, None, None),
     ("phased", (64, 120), 2, 36992, 74240, 1, 1)),
], ids=["16384", "16383", "16384-base+4", "16384-out+4", "16384-phased",
        "16383-32x120", "16384-32x128-s3", "40x119", "263x516-32x248",
        "2x5"])
def test_stacked_plan(args, plan):
    """Route, tile, stages, stage and shared bytes, tiles and grid: a
    phased window row 4 floats longer; phased tiles 120 columns apart
    covering w + 7 columns (two tiles at w = 119); three blocks an SM."""
    h, w, ptr, out_ptr, route, tile, stages = args
    p = ts.stacked_plan(h, w, ptr, out_ptr, route, tile, stages)
    assert tuple(p) == plan
    assert 3 * (p.shared_bytes + 1024) <= staged.SMEM_PER_SM
    assert p.shared_bytes == 256 + p.stages * p.stage_bytes


@pytest.mark.parametrize("w", [16384, 16383, 16382, 16381])
@pytest.mark.parametrize("ptr", [0, 4, 8, 12, 16])
def test_stacked_route_rule(w, ptr):
    """TMA exactly where the pitch and both bases are 16-byte aligned (the
    planes of a w % 4 == 0 stack then are too); the phased route by name
    everywhere; TMA by name refused elsewhere."""
    for out_ptr in (0, 4, 256):
        want = "tma" if w % 4 == 0 and ptr % 16 == 0 and out_ptr % 16 == 0 \
            else "phased"
        assert ts.stacked_plan(64, w, ptr, out_ptr).route == want
        assert ts.stacked_plan(64, w, ptr, out_ptr, "phased").route == \
            "phased"
        if want == "phased":
            with pytest.raises(ValueError, match="takes 'phased'"):
                ts.stacked_plan(64, w, ptr, out_ptr, "tma")


@pytest.mark.parametrize("route,tile,stages,match", [
    ("tma", (64, 120), None, "has no tile"),
    ("phased", (64, 128), None, "has no tile"),
    ("phased", (32, 248), None, "has no tile"),
    (None, (16, 128), None, "has no tile"),
    ("async", None, None, "no route"),
    ("simple", None, None, "no route"),
    (None, None, 1, "takes 2 to"),
    (None, None, 5, "takes 2 to"),
])
def test_stacked_plan_refuses_what_the_kernel_lacks(route, tile, stages,
                                                    match):
    with pytest.raises(ValueError, match=match):
        ts.stacked_plan(16384, 16384, 0, 0, route, tile, stages)


# -- B0 on the ring: the emulation ---------------------------------------------

STACK_ORDERS = {"all": PRODUCTS, "hillshade_slope": ("hillshade", "slope"),
                "curvature": ("curvature",),
                "mixed": ("aspect", "hillshade", "slope", "curvature")}


@pytest.mark.parametrize("x_off", [0, 1], ids=["base", "base+4"])
@pytest.mark.parametrize("shape", [(1, 1000), (2, 5), (70, 301), (300, 70),
                                   (40, 119), (9, 240)])
@pytest.mark.parametrize("order", list(STACK_ORDERS))
def test_emulated_b0_equals_surface_multi_stacked(order, shape, x_off):
    """Bit for bit on the plan's route, every plane: the NaN ring from the
    windows' NaN fill (every cell where h < 3 or w < 3), NaN patches, +-inf
    cells, aspect's -1; odd and even H * W; the input 0 or 4 bytes past a
    16-byte boundary; sms=1, so each block walks many tiles."""
    which = STACK_ORDERS[order]
    x = dem(shape, seed=31)
    got, info = emulate_stacked(x, which, *ARGS, x_off=x_off, sms=1,
                                stats=True)
    assert info["route"] == ts.stacked_plan(*shape, 4 * x_off).route
    ref = ts.surface_multi_stacked(x, *ARGS, which=which)
    assert got.shape == ref.shape == (len(which), *shape)
    for k, p in enumerate(which):
        assert same_bits(got[k], ref[k]), p


@pytest.mark.parametrize("out_off", [0, 1, 2, 3])
@pytest.mark.parametrize("shape,x_off", [((257, 1025), 0), ((263, 516), 1),
                                         ((70, 301), 1)])
def test_emulated_phased_route_at_every_output_phase(shape, x_off, out_off):
    """The phased route with the stack 0-3 floats past a 16-byte boundary
    (and so at every plane phase): bit for bit, each plane cell written
    once; only the sectors that hold a plane row's start are written by
    two warps (every other 32-byte sector by one 16-byte store pair)."""
    x = dem(shape, seed=32)
    got, info = emulate_stacked(x, PRODUCTS, *ARGS, route="phased",
                                x_off=x_off, out_off=out_off, stats=True)
    ref = ts.surface_multi_stacked(x, *ARGS, which=PRODUCTS)
    for k, p in enumerate(PRODUCTS):
        assert same_bits(got[k], ref[k]), p
    assert info["split_sectors"] == info["row_end_sectors"]
    assert info["scalar_stores"] <= 2 * 7 * shape[0] * len(PRODUCTS)


@pytest.mark.parametrize("shape", [(9, 240), (263, 516), (1, 1000)])
def test_emulated_phased_route_by_name_on_an_aligned_raster(shape):
    x = dem(shape, seed=33)
    got = emulate_stacked(x, ("slope", "aspect"), *ARGS, route="phased")
    ref = ts.surface_multi_stacked(x, *ARGS, which=("slope", "aspect"))
    assert same_bits(got, ref)


@pytest.mark.parametrize("x_off", [0, 1, 2, 3])
@pytest.mark.parametrize("shape", [(70, 301), (263, 516), (5, 113)])
def test_phased_staging_splits_each_row_into_body_head_and_tail(shape,
                                                                x_off):
    """Each window row lies in shared memory at its phase: the 16-byte
    chunks wholly inside the raster are single copies (their sources
    16-byte aligned, which the emulation checks), at most 3 cells at each
    raster edge are 4-byte copies, the rest NaN."""
    x = dem(shape, seed=34)
    _, info = emulate_stacked(x, ("slope",), *ARGS, route="phased",
                              x_off=x_off, stats=True)
    th = ts.STACKED_TILE["phased"][0]
    assert info["edge_cells_a_row"] <= 6
    rows = info["tiles"] * (th + 2)
    pitch = 128 + 8 + ts.PHASED_ROW_PAD
    assert 4 * info["body_chunks"] + info["edge_cells"] + \
        info["nan_cells"] == rows * pitch
    if shape[1] >= 256:
        assert info["body_chunks"] > 20 * info["edge_cells"]


@pytest.mark.parametrize("tile", ts.STACKED_TILES["tma"])
def test_emulated_b0_tma_route_at_every_tile(tile):
    x = dem((70, 516), seed=35)
    got, info = emulate_stacked(x, STACK_ORDERS["mixed"], *ARGS, tile=tile,
                                stats=True)
    assert info["route"] == "tma" and info["scalar_stores"] == 0
    ref = ts.surface_multi_stacked(x, *ARGS, which=STACK_ORDERS["mixed"])
    assert same_bits(got, ref)


@pytest.mark.parametrize("order", ["all", "mixed"])
@pytest.mark.parametrize("shape", [(37, 300), (37, 301)],
                         ids=["tma", "phased"])
def test_emulated_b0_matches_jax_surface_multi(shape, order):
    """Against the JAX package's ``surface_multi`` stacked in `which`
    order, within the surface tolerance (libdevice-free torch math against
    XLA's)."""
    from xrspatial_tpu.kernels.surface import surface_multi as jax_multi
    which = STACK_ORDERS[order]
    data = jax_raster(shape, seed=36)
    f32 = jnp.float32
    ref = jax_multi(jnp.asarray(data), f32(2.0), f32(3.0), f32(300.0),
                    f32(40.0), which)
    got = emulate_stacked(torch.from_numpy(data), which, *ARGS)
    for k, p in enumerate(which):
        assert_close(got[k].numpy(), np.asarray(ref[p]), SURFACE_TOL, p)


def stacked_counts():
    return (cuda_surface.STACKED_LAUNCHES, cuda_surface.STACKED_TMA_LAUNCHES,
            cuda_surface.STACKED_PHASED_LAUNCHES,
            cuda_surface.STACKED_SIMPLE_LAUNCHES, cuda_surface.LAUNCHES)


@pytest.mark.parametrize("route", [None, "tma", "phased", "simple"])
def test_stacked_wrapper_refuses_a_cpu_tensor_on_every_route(route):
    before = stacked_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_surface.surface_stacked_cuda(torch.ones((8, 8)), ("slope",),
                                          route=route)
    assert stacked_counts() == before


def test_surface_stacked_takes_the_twin_on_the_cpu():
    x = dem((40, 61))
    before = stacked_counts()
    got = ts.surface_stacked(x, *ARGS, which=STACK_ORDERS["mixed"])
    assert same_bits(got, ts.surface_multi_stacked(
        x, *ARGS, which=STACK_ORDERS["mixed"]))
    assert stacked_counts() == before
