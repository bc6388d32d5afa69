"""The stencil probes' plain versions against the JAX package (CPU).

``kernels/stencil_probe.py::stencil_twin`` is the plain version of every
instantiation of the CUDA template ``csrc/stencil_probe.cu``, the port of
the TPU probes ``tools/exp_stencil2.py`` (B8c, the staged form, and its
first port, the nine-read form), ``exp_separable_horn.py`` (B8d),
``exp_padfree_stencil.py`` (B8e) and ``exp_seam_cost.py`` (B8f).
The same numpy rasters (NaN cells inside) go through the twin and
through:

- ``xrspatial_tpu/kernels/surface.py::slope_jit``, the JAX package's
  slope;
- the TPU probes' own arithmetic, evaluated with the JAX package's
  helpers ``pallas_surface._atan``/``DEG`` and
  ``pallas_surface2._atan_of_sqrt`` (their polynomial atan);
- ``pallas_surface2.surface_tiled(..., interpret=True)``, B1 itself, at a
  ragged shape.

Tolerance: the surface tolerance, rtol 1e-4 / atol 5e-5, NaN masks
equal; copy equals its input bit for bit.  The tools under ``tools/`` are
not imported: they set JAX's compilation cache and ``sys.path``.
``staged_plan``, which the staged kernel's launcher checks, is pinned
here: the TMA box rules, the shared memory, the route per pitch.  B8d's
redesign, form separable_staged (the separable arithmetic on the staged
windows), is held through ``emulate.emulate_separable_staged``, written
with its windows and quad arithmetic: equal to the separable twin bit for
bit and within the surface tolerance of the TPU probe's separable
arithmetic.  B8e's and B8f's redesigns, form staged with edges interior,
bare and ring_branch, are held through ``staged.tile_origin`` (the
interior walk's windows all inside the raster, its tiles covering the
interior) and ``emulate.emulate_interior_staged``, written with the walk
and the edge-band kernel's index arithmetic: equal to ``surface_multi``'s
slope bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrspatial_torch.kernels import cuda_stencil_probe
from xrspatial_torch.kernels import stencil_probe as sp
from xrspatial_torch.kernels import surface as ts
from xrspatial_torch.kernels.emulate import (emulate_interior_staged,
                                             emulate_separable_staged,
                                             same_bits)
from xrspatial_torch.kernels.staged import tile_origin, walk_tiles
from xrspatial_tpu.kernels.pallas_surface import DEG, _atan
from xrspatial_tpu.kernels.pallas_surface2 import _atan_of_sqrt, surface_tiled
from xrspatial_tpu.kernels.surface import slope_jit

SURFACE_TOL = dict(rtol=1e-4, atol=5e-5)
HORN_DEG = 57.29577951308232        # tools/exp_separable_horn.py's DEG


def raster(shape=(45, 70), seed=3):
    """A random float32 DEM with a NaN patch and scattered NaN cells."""
    rng = np.random.default_rng(seed)
    a = (rng.random(shape) * 100).astype(np.float32)
    h, w = shape
    a[h // 3:h // 3 + 3, w // 4:w // 4 + 5] = np.nan
    a[rng.integers(0, h, 4), rng.integers(0, w, 4)] = np.nan
    return a


def assert_surface_close(got, ref, region=(slice(None), slice(None))):
    got, ref = np.asarray(got)[region], np.asarray(ref)[region]
    assert got.shape == ref.shape
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, equal_nan=True, **SURFACE_TOL)


def twin(data, *args, **kw):
    return sp.stencil_twin(torch.from_numpy(data), *args, **kw).numpy()


VARIANTS = [(mode, form, edges, block) for mode, form, edges in sp.VARIANTS
            for block in (sp.TILES if form in sp.STAGED_FORMS else sp.BLOCKS
                          if edges == "bare" else sp.BLOCKS[:1])]


def variant_id(v):
    mode, form, edges, (bx, by) = v
    return f"{mode}-{form}-{edges}-{bx}x{by}"


@pytest.mark.parametrize("variant", VARIANTS, ids=map(variant_id, VARIANTS))
def test_twin_of_every_instantiation_matches_slope_jit(variant):
    """Slope instantiations against the JAX package's slope; grad against
    tan(slope); copy is its input."""
    mode, form, edges, block = variant
    data = raster()
    got = twin(data, mode, form, edges, block)
    assert got.dtype == np.float32 and got.shape == data.shape
    if mode == "copy":
        assert np.array_equal(got.view(np.int32), data.view(np.int32))
        return
    ref = np.asarray(slope_jit(jnp.asarray(data), jnp.float32(1.0),
                               jnp.float32(1.0)))
    if mode == "grad":
        ref = np.where(np.isnan(ref), np.nan,
                       np.tan(np.radians(ref.astype(np.float64))))
    region = (slice(None), slice(None))
    if edges == "bare":
        r0, r1, c0, c1 = sp.bare_extent(*data.shape, form, block)
        region = (slice(r0, r1), slice(c0, c1))
        outside = np.ones(data.shape, bool)
        outside[region] = False
        assert np.isnan(got[outside]).all()
    assert_surface_close(got, ref, region)


def pipe_stencil_arithmetic(data, mode):
    """tools/exp_stencil2.py:72-84 on the whole raster with its NaN pad."""
    h, w = data.shape
    p = jnp.pad(jnp.asarray(data), 1, constant_values=jnp.nan)

    def s(dy, dx):
        return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    if mode == "copy":
        return np.asarray(s(0, 0))
    a, b, c = s(-1, -1), s(-1, 0), s(-1, 1)
    d, f = s(0, -1), s(0, 1)
    g, hh, ii = s(1, -1), s(1, 0), s(1, 1)
    dzdx = ((c + 2.0 * f + ii) - (a + 2.0 * d + g)) * 0.125
    dzdy = ((g + 2.0 * hh + ii) - (a + 2.0 * b + c)) * 0.125
    mag = jnp.sqrt(dzdx * dzdx + dzdy * dzdy)
    return np.asarray(mag if mode == "grad" else _atan(mag) * DEG)


def horn_arithmetic(data, kind):
    """tools/exp_separable_horn.py:31-45 with the raster as one tile: the
    interior [1:-1, 1:-1]."""
    x = jnp.asarray(data)
    if kind == "nine":
        a, b, c = x[:-2, :-2], x[:-2, 1:-1], x[:-2, 2:]
        d, f = x[1:-1, :-2], x[1:-1, 2:]
        g, hh, ii = x[2:, :-2], x[2:, 1:-1], x[2:, 2:]
        dzdx8 = (c + 2.0 * f + ii) - (a + 2.0 * d + g)
        dzdy8 = (g + 2.0 * hh + ii) - (a + 2.0 * b + c)
    else:
        s = x[:-2, :] + 2.0 * x[1:-1, :] + x[2:, :]
        dv = x[2:, :] - x[:-2, :]
        dzdx8 = s[:, 2:] - s[:, :-2]
        dzdy8 = dv[:, :-2] + 2.0 * dv[:, 1:-1] + dv[:, 2:]
    gx, gy = dzdx8 * 0.125, dzdy8 * 0.125
    return np.asarray(_atan_of_sqrt(gx * gx + gy * gy) * HORN_DEG)


@pytest.mark.parametrize(
    "mode,form", [(m, f) for f in ("nine", "staged") for m in sp.MODES],
    ids=[*sp.MODES, *(f"staged-{m}" for m in sp.MODES)])
def test_twin_matches_pipe_stencil_arithmetic(mode, form):
    """B8c: every cell, ring included (the TPU probe's NaN pad makes its
    ring NaN in grad and slope, and copy passes it through), in the
    staged form and its first port, the nine-read form."""
    data = raster()
    got = twin(data, mode, form)
    ref = pipe_stencil_arithmetic(data, mode)
    if mode == "copy":
        assert np.array_equal(got.view(np.int32), ref.view(np.int32))
    else:
        assert_surface_close(got, ref)


@pytest.mark.parametrize("form", ["nine", "separable", "separable_staged"])
def test_twin_matches_separable_horn_arithmetic(form):
    """B8d: the interior the TPU probe writes; the twin's ring is NaN."""
    data = raster((40, 66), seed=4)
    got = twin(data, "slope", form)
    inner = (slice(1, -1), slice(1, -1))
    assert_surface_close(got[inner], horn_arithmetic(data, form))
    ring = np.ones(data.shape, bool)
    ring[inner] = False
    assert np.isnan(got[ring]).all()


def test_nine_and_separable_forms_agree():
    """dzdy rounds differently in the two forms; on this raster of noise
    up to 1000 they agree within the surface tolerance and their NaN masks
    agree (on a smooth 1000 m DEM at 16384^2 they part by more)."""
    data = raster((64, 96), seed=5)
    data[np.isnan(data)] = 50.0
    data *= 10.0
    nine, sep = twin(data, "slope", "nine"), twin(data, "slope", "separable")
    assert_surface_close(sep, nine)


@pytest.mark.parametrize(
    "form,edges", [("nine", "ring"), ("nine", "interior"), ("nine", "bare"),
                   ("staged", "ring"), ("staged", "interior"),
                   ("staged", "bare"), ("staged", "ring_branch")],
    ids=["ring", "interior", "bare", "staged-ring", "staged-interior",
         "staged-bare", "staged-ring_branch"])
def test_twin_matches_surface_tiled_interpret_at_a_ragged_shape(form, edges):
    """B1 itself, the TPU kernel the probes measure, at 37 x 300 in
    interpret mode (its ragged NaN pad and seam bands included)."""
    data = raster((37, 300), seed=6)
    one = jnp.float32(1.0)
    ref = np.asarray(surface_tiled(jnp.asarray(data), one, one,
                                   jnp.float32(225.0), jnp.float32(25.0),
                                   ("slope",), interpret=True)[0])
    got = twin(data, "slope", form, edges)
    region = (slice(None), slice(None))
    if edges == "bare":
        r0, r1, c0, c1 = sp.bare_extent(37, 300, form)
        assert r1 > r0 and c1 > c0
        region = (slice(r0, r1), slice(c0, c1))
    assert_surface_close(got, ref, region)


@pytest.mark.parametrize("shape,block,extent", [
    ((16384, 16384), (32, 8), (8, 16376, 32, 16352)),
    ((17, 65), (32, 8), (8, 16, 32, 64)),
    ((300, 70), (64, 4), (4, 296, 64, 64)),
    ((2, 5), (32, 16), (2, 2, 5, 5)),
    ((1, 1000), (32, 8), (1, 1, 32, 992)),
])
def test_interior_extent(shape, block, extent):
    """The interior blocks lie wholly inside the 1-cell ring, on the grid
    anchored at (0, 0); everything else is the edge bands."""
    r0, r1, c0, c1 = got = sp.interior_extent(*shape, block)
    assert got == extent
    h, w = shape
    bx, by = block
    assert (r1 - r0) % by == 0 and (c1 - c0) % bx == 0
    if r1 > r0 and c1 > c0:
        assert r0 >= 1 and r1 <= h - 1 and c0 >= 1 and c1 <= w - 1


@pytest.mark.parametrize("args", [
    ("copy", "separable", "ring", (32, 8)), ("grad", "nine", "interior",
                                             (32, 8)),
    ("slope", "separable", "bare", (32, 8)), ("slope", "nine", "ring",
                                              (16, 16)),
    ("aspect", "nine", "ring", (32, 8)), ("grad", "staged", "interior",
                                         (64, 128)),
    ("slope", "staged", "ring", (32, 8)), ("copy", "nine", "ring", (32, 128)),
    ("slope", "separable_staged", "ring", (32, 8)),
    ("grad", "separable_staged", "ring", (32, 128)),
    ("slope", "separable_staged", "interior", (64, 128))])
def test_uninstantiated_variants_are_refused(args):
    with pytest.raises(ValueError, match="no stencil_probe instantiation"):
        sp.stencil_twin(torch.zeros((4, 4)), *args)


def test_dispatch_takes_the_twin_on_the_cpu():
    x = torch.from_numpy(raster())
    for mode, form, edges in sp.VARIANTS:
        got = sp.stencil(x, mode, form, edges)
        ref = sp.stencil_twin(x, mode, form, edges)
        assert torch.equal(torch.isnan(got), torch.isnan(ref))
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(ref))


# -- the staged form's plan -------------------------------------------------

@pytest.mark.parametrize("shape,tile,ptr,plan", [
    ((16384, 16384), (32, 128), 0,
     ((136, 34), 4, 18560, 74496, "tma", 65536, 264)),
    ((16384, 16384), (64, 128), 0,
     ((136, 66), 3, 35968, 108160, "tma", 32768, 264)),
    ((16384, 16384), (32, 248), 0,
     ((256, 34), 3, 34816, 104704, "tma", 34304, 264)),
    ((16384, 16384), (32, 128), 4,
     ((136, 34), 4, 18560, 74496, "async", 65536, 264)),
    ((300, 70), (32, 128), 0, ((136, 34), 4, 18560, 74496, "async", 10, 10)),
    ((257, 1025), (64, 128), 0,
     ((136, 66), 3, 35968, 108160, "async", 45, 45)),
    ((263, 516), (32, 248), 0, ((256, 34), 3, 34816, 104704, "tma", 27, 27)),
    ((2, 5), (32, 128), 0, ((136, 34), 4, 18560, 74496, "async", 1, 1)),
], ids=["16384-32x128", "16384-64x128", "16384-32x248", "16384-unaligned",
        "300x70", "257x1025", "263x516", "2x5"])
def test_staged_plan(shape, tile, ptr, plan):
    """The box, stages, shared bytes, route and grid at each probe shape;
    the route is TMA exactly where the pitch and the base are 16-byte
    aligned."""
    assert tuple(sp.staged_plan(*shape, tile, ptr)) == plan


@pytest.mark.parametrize("tile", sp.TILES)
@pytest.mark.parametrize("shape", [(16384, 16384), (300, 70), (257, 1025),
                                   (9, 40), (263, 516)])
def test_staged_plan_keeps_the_box_and_shared_memory_rules(shape, tile):
    p = sp.staged_plan(*shape, tile)
    th, tw = tile
    assert max(p.box) <= 256 and p.box[0] * 4 % 16 == 0
    assert p.box == (tw + 8, th + 2)
    assert p.stage_bytes % 128 == 0 and p.stage_bytes >= p.box[0] * p.box[1] * 4
    assert 2 <= p.stages <= sp.MAX_STAGES
    assert p.shared_bytes == 256 + p.stages * p.stage_bytes <= 232448
    assert 2 * (p.shared_bytes + 1024) <= 233472     # two blocks an SM
    assert p.route == ("tma" if shape[1] % 4 == 0 else "async")
    assert p.tiles == -(-shape[0] // th) * -(-shape[1] // tw)
    assert p.grid == min(p.tiles, 264)


@pytest.mark.parametrize("tile,rule", [
    ((32, 256), "box dimension is at most 256"),
    ((32, 252), "box dimension is at most 256"),
    ((255, 64), "box dimension is at most 256"),
    ((32, 130), "multiple of 4"),
    ((32, 0), "multiple of 4"),
    ((200, 248), "bytes of shared memory"),
])
def test_staged_plan_refuses_a_tile_that_breaks_a_rule(tile, rule):
    with pytest.raises(ValueError, match=rule):
        sp.staged_plan(16384, 16384, tile)


# -- B8d's redesign: the separable arithmetic on the staged windows ----------

@pytest.mark.parametrize("tile", sp.TILES)
@pytest.mark.parametrize("shape", [(45, 70), (2, 5), (1, 300), (70, 301),
                                   (263, 516)])
def test_emulated_separable_staged_equals_the_separable_twin(shape, tile):
    """Bit for bit, the NaN ring (from the windows' NaN fill), NaN cells and
    their neighbours included: the quad's 6 smooths and differences are the
    first port's expressions, combined as it combines them."""
    x = torch.from_numpy(raster(shape, seed=7))
    got = emulate_separable_staged(x, tile)
    ref = sp.stencil_twin(x, "slope", "separable")
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(ref))


@pytest.mark.parametrize("tile", sp.TILES)
def test_emulated_separable_staged_matches_separable_horn_arithmetic(tile):
    """Against the TPU probe's separable arithmetic on the interior it
    writes (its polynomial atan): the surface tolerance."""
    data = raster((40, 66), seed=4)
    got = emulate_separable_staged(torch.from_numpy(data), tile).numpy()
    inner = (slice(1, -1), slice(1, -1))
    assert_surface_close(got[inner], horn_arithmetic(data, "sep"))


@pytest.mark.parametrize("block", sp.TILES + sp.BLOCKS)
def test_separable_staged_is_instantiated_only_at_the_tiles(block):
    """At B8c's tiles (the staged ring's plan), never at the first ports'
    blocks."""
    if block in sp.TILES:
        sp.check_variant("slope", "separable_staged", "ring", block)
        assert sp.shapes_of("separable_staged") == sp.TILES
    else:
        with pytest.raises(ValueError, match="no stencil_probe"):
            sp.check_variant("slope", "separable_staged", "ring", block)


@pytest.mark.parametrize("form", sp.STAGED_FORMS)
@pytest.mark.parametrize("tile", sp.TILES)
def test_staged_forms_refuse_a_cpu_tensor(form, tile):
    """Each staged route of the wrapper takes only a tensor on the card,
    and counts nothing when it refuses."""
    def counts():
        return (cuda_stencil_probe.TMA_LAUNCHES,
                cuda_stencil_probe.ASYNC_LAUNCHES,
                cuda_stencil_probe.SEP_TMA_LAUNCHES,
                cuda_stencil_probe.SEP_ASYNC_LAUNCHES,
                cuda_stencil_probe.INTERIOR_TMA_LAUNCHES,
                cuda_stencil_probe.INTERIOR_ASYNC_LAUNCHES,
                cuda_stencil_probe.RING_TMA_LAUNCHES,
                cuda_stencil_probe.RING_ASYNC_LAUNCHES,
                cuda_stencil_probe.EDGE_LAUNCHES,
                cuda_stencil_probe.LAUNCHES)
    before = counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_stencil_probe.stencil_probe_cuda(torch.ones((8, 8)), "slope",
                                              form, block=tile)
    assert counts() == before


# -- B8e's and B8f's redesigns: the staged ring's interior walk --------------

WALK_SHAPES = [(16384, 16384), (263, 516), (257, 1025), (45, 300), (66, 136),
               (34, 256), (300, 70), (40, 70)]


@pytest.mark.parametrize("tile", sp.TILES)
@pytest.mark.parametrize("shape", WALK_SHAPES)
def test_interior_walk_keeps_every_window_inside_the_raster(shape, tile):
    """Every tile's window (rows r0 - 1 .. r0 + TH, columns c0 - 4 ..
    c0 + TW + 3) lies inside the raster; the tiles cover [1, h - 1) x
    [4, w - 4) and nothing else; c0 - 4 is a multiple of 4 where
    w % 4 == 0 (TMA's 16-byte rule); the plan counts the walk's tiles."""
    h, w = shape
    th, tw = tile
    ty, tx = walk_tiles(h, w, tile, "interior")
    plan = sp.staged_plan(h, w, tile, walk="interior")
    assert plan.tiles == ty * tx
    assert plan.grid == min(plan.tiles, 264)
    assert plan.route == ("tma" if w % 4 == 0 else "async")
    if plan.tiles == 0:
        return
    r0s = {tile_origin(t * tx, h, w, tile, "interior")[0] for t in range(ty)}
    c0s = {tile_origin(t, h, w, tile, "interior")[1] for t in range(tx)}
    assert len(r0s) == ty and len(c0s) == tx
    for r0 in r0s:
        assert r0 - 1 >= 0 and r0 + th <= h - 1
    for c0 in c0s:
        assert c0 - 4 >= 0 and c0 + tw + 3 <= w - 1
        if w % 4 == 0:
            assert (c0 - 4) % 4 == 0
    rows = set().union(*(range(r, r + th) for r in r0s))
    cols = set().union(*(range(c, c + tw) for c in c0s))
    assert rows == set(range(1, h - 1)) and cols == set(range(4, w - 4))
    assert sp.staged_interior_extent(h, w, tile) == (1, h - 1, 4, w - 4)


@pytest.mark.parametrize("tile", sp.TILES)
@pytest.mark.parametrize("short", ["rows", "columns", "both"])
def test_interior_walk_is_empty_below_a_tile_and_its_halo(tile, short):
    """No tile, grid 0 and an empty extent below TH + 2 rows or TW + 8
    columns; at exactly TH + 2 and TW + 8 one tile."""
    th, tw = tile
    h = th + 1 if short in ("rows", "both") else th + 2
    w = tw + 7 if short in ("columns", "both") else tw + 8
    plan = sp.staged_plan(h, w, tile, walk="interior")
    assert (plan.tiles, plan.grid) == (0, 0)
    r0, r1, c0, c1 = sp.staged_interior_extent(h, w, tile)
    assert r0 == r1 and c0 == c1
    assert sp.staged_plan(th + 2, tw + 8, tile, walk="interior").tiles == 1


@pytest.mark.parametrize("tile", sp.TILES)
@pytest.mark.parametrize("shape", [(263, 516), (257, 1025), (45, 300),
                                   (40, 70)])
def test_emulated_interior_walk_and_edge_bands_equal_surface_multi(shape,
                                                                    tile):
    """Edges interior: the interior walk's windows (no fill needed) and the
    edge-band kernel's cells give ``surface_multi``'s slope bit for bit,
    NaN ring, NaN cells and +-inf included; every cell is written, each
    edge-band cell once and by the edge launch alone; bare writes only
    ``staged_interior_extent``'s rectangle and equals the twin."""
    x = torch.from_numpy(raster(shape, seed=8))
    x[shape[0] // 2, shape[1] // 3] = np.inf
    x[shape[0] - 1, 5] = -np.inf
    ref = ts.surface_multi(x, 1.0, 1.0, 225.0, 25.0, ("slope",))["slope"]
    got, writes = emulate_interior_staged(x, tile, "interior")
    assert same_bits(got, ref)
    bare, bare_writes = emulate_interior_staged(x, tile, "bare")
    r0, r1, c0, c1 = sp.staged_interior_extent(*shape, tile)
    inside = torch.zeros(shape, dtype=torch.bool)
    inside[r0:r1, c0:c1] = True
    assert bool((bare_writes[inside] >= 1).all())
    assert bool((bare_writes[~inside] == 0).all())
    assert bool((writes[~inside] == 1).all())
    assert same_bits(bare, sp.stencil_twin(x, "slope", "staged", "bare",
                                           tile))
    assert same_bits(bare[inside], ref[inside])


@pytest.mark.parametrize("edges", ["interior", "ring_branch"])
@pytest.mark.parametrize("shape", [(263, 516), (40, 70), (2, 5)])
def test_staged_edges_twins_equal_the_ring_twin(shape, edges):
    """Edges interior and ring_branch compute what edges ring computes:
    B1's slope, NaN ring included, at every tile."""
    x = torch.from_numpy(raster(shape, seed=9))
    ref = sp.stencil_twin(x, "slope", "staged")
    for tile in sp.TILES:
        assert same_bits(sp.stencil_twin(x, "slope", "staged", edges, tile),
                         ref)


@pytest.mark.parametrize("edges", ["interior", "bare", "ring_branch"])
def test_new_staged_edges_are_instantiated_only_for_staged_slope(edges):
    """At every tile in form staged, mode slope; never in form nine
    (ring_branch) or separable_staged, nor in copy or grad."""
    for tile in sp.TILES:
        sp.check_variant("slope", "staged", edges, tile)
        for mode, form in (("copy", "staged"), ("grad", "staged"),
                           ("slope", "separable_staged")):
            with pytest.raises(ValueError, match="no stencil_probe"):
                sp.check_variant(mode, form, edges, tile)
    if edges == "ring_branch":
        with pytest.raises(ValueError, match="no stencil_probe"):
            sp.check_variant("slope", "nine", edges, (32, 8))


def test_edge_bands_refuse_cpu_tensors():
    """The edge-band launch takes only tensors on the card, and counts
    nothing when it refuses."""
    before = cuda_stencil_probe.EDGE_LAUNCHES
    x = torch.ones((8, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_stencil_probe.edge_bands_cuda(x, torch.empty_like(x),
                                           (1, 7, 4, 4))
    assert cuda_stencil_probe.EDGE_LAUNCHES == before


@pytest.mark.parametrize("edges", ["interior", "bare", "ring_branch"])
@pytest.mark.parametrize("tile", sp.TILES)
def test_staged_edges_refuse_a_cpu_tensor(edges, tile):
    """The interior walk, its edge bands and ring_branch take only a tensor
    on the card, and count nothing when they refuse."""
    def counts():
        return (cuda_stencil_probe.INTERIOR_TMA_LAUNCHES,
                cuda_stencil_probe.INTERIOR_ASYNC_LAUNCHES,
                cuda_stencil_probe.RING_TMA_LAUNCHES,
                cuda_stencil_probe.RING_ASYNC_LAUNCHES,
                cuda_stencil_probe.EDGE_LAUNCHES,
                cuda_stencil_probe.TMA_LAUNCHES,
                cuda_stencil_probe.ASYNC_LAUNCHES)
    before = counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_stencil_probe.stencil_probe_cuda(torch.ones((80, 300)), "slope",
                                              "staged", edges, tile)
    assert counts() == before
