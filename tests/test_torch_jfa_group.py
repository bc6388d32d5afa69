"""The fused jump-flood group's plain version and window plan (CPU).

``kernels/jfa_group.py`` runs a group of strides in one launch of
``csrc/jfa_group.cu`` (the port of ``tools/exp_jfa_fixed.py::
multi_round_fixed``); its twins loop the round twins over the strides.
Checked here, bit for bit:

- the twins against the JAX package's XLA rounds
  ``xrspatial_tpu/kernels/jfa.py::_jfa_rounds`` over proximity's tail
  group, EUCLIDEAN in both state forms and MANHATTAN;
- the twins against the port's ``jfa_rounds.round_*`` looped over the
  strides, and the dispatchers on the CPU;
- an emulation of the kernel's algorithm (one (T+2H)^2 window a block,
  the no-target sentinel outside the raster, double-buffered rounds over
  shrinking regions) against the twins, which is the argument that the
  kernel's T x T centres equal the round kernel bit for bit;
- the same for the single-buffered route (TMA's window with the sentinel
  written over its zero fill, each round's region as one flat index, new
  states computed for the whole region before any is stored);
- the window plan of both routes: the tail group fits (single-buffered at
  T = 128 packed, T = 64 coordinates), a tile whose cells a thread pass
  the registers is refused, H = 130 raises ValueError.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrspatial_torch.kernels import jfa_group, jfa_rounds
from xrspatial_torch.kernels.jfa import packed_state_plan
from xrspatial_tpu.kernels import jfa as jjfa

TAIL = jfa_group.TAIL
SHAPE = (70, 90)


def targets(shape=SHAPE, seed=4, density=0.01):
    rng = np.random.default_rng(seed)
    return rng.random(shape) < density


def coords_state(mask):
    h, w = mask.shape
    xs = (np.arange(w) * 0.5).astype(np.float32)
    ys = (np.arange(h)[::-1] * 2.0).astype(np.float32)
    tx = np.where(mask, xs[None, :], np.inf).astype(np.float32)
    ty = np.where(mask, ys[:, None], np.inf).astype(np.float32)
    return tx, ty, xs, ys


def packed_state(mask):
    iy, ix = np.nonzero(mask)
    state = np.full(mask.shape, -1, np.int32)
    state[iy, ix] = (iy << jfa_rounds.PACK_BITS) | ix
    return state


def unpack(state, xs, ys):
    """(tx, ty) of a packed state, inf where there is no target."""
    ok = state >= 0
    ix = np.where(ok, state & jfa_rounds.PACK_MASK, 0)
    iy = np.where(ok, state >> jfa_rounds.PACK_BITS, 0)
    return (np.where(ok, xs[ix], np.inf).astype(np.float32),
            np.where(ok, ys[iy], np.inf).astype(np.float32))


@pytest.mark.parametrize("metric", [0, 2], ids=["euclidean", "manhattan"])
def test_group_twins_match_jax_rounds(metric):
    """The tail group from a sparse round-0 state: the coordinate twin and
    (EUCLIDEAN) the packed twin equal the JAX package's rounds."""
    mask = targets()
    tx, ty, xs, ys = coords_state(mask)
    rtx, rty, _, _ = jjfa._jfa_rounds(
        *map(jnp.asarray, (tx, ty)), None, jnp.asarray(xs), jnp.asarray(ys),
        strides=TAIL, metric=metric, shape=mask.shape)
    rtx, rty = np.asarray(rtx), np.asarray(rty)
    gtx, gty = jfa_group.group_coords_twin(
        *map(torch.from_numpy, (tx, ty, xs, ys)), TAIL, metric)
    np.testing.assert_array_equal(gtx.numpy(), rtx)
    np.testing.assert_array_equal(gty.numpy(), rty)
    assert np.isfinite(rtx).mean() > 0.5
    steps = packed_state_plan(xs, ys, metric)[0]
    s = jfa_group.group_packed_twin(torch.from_numpy(packed_state(mask)),
                                    TAIL, metric, steps)
    ptx, pty = unpack(s.numpy(), xs, ys)
    np.testing.assert_array_equal(ptx, rtx)
    np.testing.assert_array_equal(pty, rty)


@pytest.mark.parametrize("form", ["packed", "coords"])
def test_dispatch_on_the_cpu_equals_the_round_twins(form):
    mask = targets(seed=5, density=0.02)
    tx, ty, xs, ys = map(torch.from_numpy, coords_state(mask))
    ks = (8, 4, 2, 1)
    if form == "packed":
        steps = packed_state_plan(xs.numpy(), ys.numpy(), 0)[0]
        state = torch.from_numpy(packed_state(mask))
        ref = state
        for k in ks:
            ref, _, _ = jfa_rounds.round_packed(ref, None, k, 0, steps)
        assert torch.equal(jfa_group.group_packed(state, ks, 0, steps), ref)
        return
    ref = (tx, ty)
    for k in ks:
        ref = jfa_rounds.round_coords(*ref, None, xs, ys, k, 1)[:2]
    got = jfa_group.group_coords(tx, ty, xs, ys, ks, 1)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def emulate(planes, sentinels, ks, tile, visit):
    """The kernel's algorithm in torch: for each tile, a (T+2H)^2 window
    (sentinel outside the raster), double-buffered rounds each written on
    the cells within sum(ks[r+1:]) of the centre, the centre copied out.
    ``visit(src, rows, cols, k)`` is one round on the region (rows, cols)
    of the window `src` (a list of planes), returning the new planes."""
    h, w = planes[0].shape
    big = sum(ks)
    side = tile + 2 * big
    outs = [torch.empty_like(p) for p in planes]
    for r0 in range(-big, h - big, tile):
        for c0 in range(-big, w - big, tile):
            rows = torch.arange(r0, r0 + side)
            cols = torch.arange(c0, c0 + side)
            inside = (((rows >= 0) & (rows < h))[:, None]
                      & ((cols >= 0) & (cols < w))[None, :])
            src = []
            for p, fill in zip(planes, sentinels):
                win = torch.full((side, side), fill, dtype=p.dtype)
                win[inside] = p[rows.clamp(0, h - 1)][:, cols.clamp(
                    0, w - 1)][inside]
                src.append(win)
            dst = [s.clone() for s in src]
            m = big
            for k in ks:
                m -= k
                lo, hi = big - m, big + tile + m
                new = visit(src, lo, hi, rows[lo:hi], cols[lo:hi], k)
                keep = inside[lo:hi, lo:hi]
                for d, s, n in zip(dst, src, new):
                    d[lo:hi, lo:hi] = torch.where(keep, n, s[lo:hi, lo:hi])
                src, dst = dst, src
            rr = slice(big, big + min(tile, h - (r0 + big)))
            cc = slice(big, big + min(tile, w - (c0 + big)))
            for o, s in zip(outs, src):
                o[r0 + big:r0 + big + tile, c0 + big:c0 + big + tile] = \
                    s[rr, cc]
    return outs


def visit_packed(metric, steps):
    def visit(src, lo, hi, rows, cols, k):
        s0 = src[0]
        piy = rows.to(torch.int32)[:, None]
        pix = cols.to(torch.int32)[None, :]
        s = s0[lo:hi, lo:hi]
        best = jfa_rounds.key_packed(piy, pix, s, metric, steps)
        for sy, sx in jfa_rounds.CANDIDATES:
            cand = s0[lo + sy * k:hi + sy * k, lo + sx * k:hi + sx * k]
            nd = jfa_rounds.key_packed(piy, pix, cand, metric, steps)
            better = nd < best
            s = torch.where(better, cand, s)
            best = torch.where(better, nd, best)
        return [s]
    return visit


def visit_coords(metric, xs, ys):
    def visit(src, lo, hi, rows, cols, k):
        px = xs[cols.clamp(0, xs.numel() - 1)][None, :]
        py = ys[rows.clamp(0, ys.numel() - 1)][:, None]
        tx, ty = (p[lo:hi, lo:hi] for p in src)
        best = jfa_rounds.coords_key(px, py, tx, ty, metric)
        for sy, sx in jfa_rounds.CANDIDATES:
            ctx, cty = (p[lo + sy * k:hi + sy * k, lo + sx * k:hi + sx * k]
                        for p in src)
            nd = jfa_rounds.coords_key(px, py, ctx, cty, metric)
            better = nd < best
            tx = torch.where(better, ctx, tx)
            ty = torch.where(better, cty, ty)
            best = torch.where(better, nd, best)
        return [tx, ty]
    return visit


@pytest.mark.parametrize("form,metric", [("packed", 0), ("packed", 2),
                                         ("coords", 1)])
@pytest.mark.parametrize("ks,tile", [(TAIL, 16), ((2, 1), 8)])
def test_windowed_algorithm_equals_the_rounds(ks, tile, form, metric):
    """Each tile's centre equals the rounds applied to the whole raster,
    bit for bit, on a ragged 37 x 45 raster with several tiles."""
    mask = targets((37, 45), seed=6, density=0.03)
    tx, ty, xs, ys = map(torch.from_numpy, coords_state(mask))
    if metric == 1:                     # lon/lat axes for great circle
        xs = torch.linspace(-170, 170, 45, dtype=torch.float32)
        ys = torch.linspace(75, -75, 37, dtype=torch.float32)
        tx = torch.where(torch.from_numpy(mask), xs[None, :], math.inf)
        ty = torch.where(torch.from_numpy(mask), ys[:, None], math.inf)
    if form == "packed":
        steps = packed_state_plan(xs.numpy(), ys.numpy(), metric)[0]
        state = torch.from_numpy(packed_state(mask))
        got = emulate([state], [-1], ks, tile, visit_packed(metric, steps))
        assert torch.equal(got[0], jfa_group.group_packed_twin(
            state, ks, metric, steps))
        return
    got = emulate([tx, ty], [math.inf, math.inf], ks, tile,
                  visit_coords(metric, xs, ys))
    ref = jfa_group.group_coords_twin(tx, ty, xs, ys, ks, metric)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("ks,form,route,plan", [
    pytest.param(TAIL, "packed", "double", (64, 34, 139392),
                 id="ks0-packed-plan0"),
    pytest.param(TAIL, "coords", "double", (32, 34, 160000),
                 id="ks1-coords-plan1"),
    pytest.param((64,), "packed", "double", (32, 64, 204800),
                 id="ks2-packed-plan2"),
    pytest.param((1,), "packed", "double", (128, 1, 135200),
                 id="ks3-packed-plan3"),
    # single-buffered: 196 x 200 cells (H = 34 rounded up to 36 on each
    # side of the columns, so a box starts 16-byte aligned), 27 cells a
    # thread in the first region (164^2 / 1024)
    pytest.param(TAIL, "packed", "single", (128, 34, 157056),
                 id="single-tail-packed"),
    pytest.param(TAIL, "coords", "single", (64, 34, 143872),
                 id="single-tail-coords"),
    pytest.param((64,), "packed", "single", (64, 64, 147712),
                 id="single-64-packed"),
    pytest.param((1,), "packed", "single", (128, 1, 71040),
                 id="single-1-packed"),
])
def test_window_plan_takes_the_largest_tile_that_fits(ks, form, route, plan):
    got = jfa_group.window_plan(ks, form, route)
    assert (got.tile, got.halo, got.shared_bytes) == plan
    assert plan[2] <= jfa_group.SHARED_BYTES
    assert got.route == route


def test_single_plan_of_the_tail():
    """T = 128 packed, one buffer: the window and the cells a thread, 8.43
    cell-rounds a cell for the 7 rounds (10.1 at the double route's T =
    64)."""
    p = jfa_group.window_plan(TAIL, "packed", w=16384)
    assert p == ("single", "tma", 128, 34, 36, 200, 196, 28, 157056)
    sides, m = [], 34
    for k in TAIL:
        m -= k
        sides.append(128 + 2 * m)
    assert sides == [164, 148, 140, 136, 134, 130, 128]
    assert sum(s * s for s in sides) == 138136
    assert round(sum(s * s for s in sides) / 128 ** 2, 2) == 8.43
    assert -(-164 ** 2 // jfa_group.SINGLE_THREADS) == 27 <= p.cells
    d = jfa_group.window_plan(TAIL, "packed", "double")
    assert round(sum((d.tile + 2 * m) ** 2 for m in (18, 10, 6, 4, 3, 1, 0))
                 / d.tile ** 2, 1) == 10.1
    # cp.async where TMA refuses the pitch or the base
    assert jfa_group.window_plan(TAIL, "packed", w=1025).stage == "async"
    assert jfa_group.window_plan(TAIL, "packed", w=1024, ptr=4).stage == \
        "async"


@pytest.mark.parametrize("form,ks", [
    ("packed", (1, 16, 8, 4)),   # 184^2 / 1024 = 34 cells a thread
    ("coords", TAIL),            # 27 cells of 2 planes: 54 words
])
def test_single_plan_refuses_what_the_registers_cannot_hold(form, ks):
    with pytest.raises(ValueError, match="words of new state"):
        jfa_group.window_plan(ks, form, tile=128)
    assert jfa_group.window_plan(ks, form).tile == 64


def test_flat_region_index_by_float_reciprocal_is_exact():
    """The kernel's (row, col) of a region's flat index: int((idx + 0.5) *
    (1 / side)) in float32 equals idx // side for every side a window may
    have (at most 256) and every idx of its region."""
    for side in range(1, 257):
        idx = np.arange(side * side, dtype=np.float32)
        inv = np.float32(1.0) / np.float32(side)
        got = ((idx + np.float32(0.5)) * inv).astype(np.int32)
        np.testing.assert_array_equal(got, np.arange(side * side) // side)


def emulate_single(planes, sentinels, ks, plan, visit):
    """The single route's algorithm in torch: each tile's window (rows T +
    2H from the tile's row - H, columns T + 2 pad from its column - pad:
    TMA's zero fill, then the sentinel outside the raster), one buffer,
    each round's region as one flat index over side^2 cells (a thread's
    cells tid + c * threads, c < cells, cover it), new states computed
    for the whole region first, then stored; the T x T centre copied
    out."""
    h, w = planes[0].shape
    t, big, pad = plan.tile, plan.halo, plan.pad
    xo = pad - big
    outs = [torch.empty_like(p) for p in planes]
    for ty in range(-(-h // t)):
        for tx in range(-(-w // t)):
            r0, c0 = ty * t - big, tx * t - big
            rows = torch.arange(r0, r0 + plan.rows)
            cols = torch.arange(c0 - xo, c0 - xo + plan.pitch)
            inside = (((rows >= 0) & (rows < h))[:, None]
                      & ((cols >= 0) & (cols < w))[None, :])
            buf = []
            for p, fill in zip(planes, sentinels):
                g = p[rows.clamp(0, h - 1)][:, cols.clamp(0, w - 1)]
                g = torch.where(inside, g, torch.zeros((), dtype=p.dtype))
                buf.append(torch.where(inside, g, torch.full(
                    (), fill, dtype=p.dtype)))
            m = big
            for k in ks:
                m -= k
                side, lo = t + 2 * m, big - m
                idx = torch.arange(side * side)
                assert idx.numel() <= (jfa_group.SINGLE_THREADS
                                       * plan.cells)
                dy = ((idx.numpy().astype(np.float32) + np.float32(0.5))
                      * (np.float32(1) / np.float32(side))).astype(np.int64)
                dy = torch.from_numpy(dy)
                y, x = lo + dy, lo + idx - dy * side
                ok = ((r0 + y >= 0) & (r0 + y < h) & (c0 + x >= 0)
                      & (c0 + x < w))
                y, x = y[ok], x[ok]
                new = visit(buf, y, x + xo, r0 + y, c0 + x, k)
                for b, n in zip(buf, new):
                    b[y, x + xo] = n
            rr = min(t, h - ty * t)
            cc = min(t, w - tx * t)
            for o, b in zip(outs, buf):
                o[ty * t:ty * t + rr, tx * t:tx * t + cc] = \
                    b[big:big + rr, big + xo:big + xo + cc]
    return outs


def visit_flat_packed(metric, steps):
    def visit(buf, y, x, rows, cols, k):
        s0 = buf[0]
        piy, pix = rows.to(torch.int32), cols.to(torch.int32)
        s = s0[y, x]
        best = jfa_rounds.key_packed(piy, pix, s, metric, steps)
        for sy, sx in jfa_rounds.CANDIDATES:
            cand = s0[y + sy * k, x + sx * k]
            nd = jfa_rounds.key_packed(piy, pix, cand, metric, steps)
            better = nd < best
            s = torch.where(better, cand, s)
            best = torch.where(better, nd, best)
        return [s]
    return visit


def visit_flat_coords(metric, xs, ys):
    def visit(buf, y, x, rows, cols, k):
        px, py = xs[cols], ys[rows]
        tx, ty = (b[y, x] for b in buf)
        best = jfa_rounds.coords_key(px, py, tx, ty, metric)
        for sy, sx in jfa_rounds.CANDIDATES:
            ctx, cty = (b[y + sy * k, x + sx * k] for b in buf)
            nd = jfa_rounds.coords_key(px, py, ctx, cty, metric)
            better = nd < best
            tx = torch.where(better, ctx, tx)
            ty = torch.where(better, cty, ty)
            best = torch.where(better, nd, best)
        return [tx, ty]
    return visit


@pytest.mark.parametrize("form,metric", [("packed", 0), ("packed", 2),
                                         ("coords", 1)])
@pytest.mark.parametrize("ks,tile", [(TAIL, 16), ((2, 1), 8), (TAIL, 64)])
def test_single_buffered_algorithm_equals_the_rounds(ks, tile, form, metric):
    """The single route's flattened, single-buffered rounds on TMA's
    window, tile by tile, equal the rounds applied to the whole raster,
    bit for bit, on a ragged 37 x 45 raster with several tiles."""
    mask = targets((37, 45), seed=6, density=0.03)
    tx, ty, xs, ys = map(torch.from_numpy, coords_state(mask))
    plan = jfa_group.window_plan(ks, form, tile=tile)
    if metric == 1:                     # lon/lat axes for great circle
        xs = torch.linspace(-170, 170, 45, dtype=torch.float32)
        ys = torch.linspace(75, -75, 37, dtype=torch.float32)
        tx = torch.where(torch.from_numpy(mask), xs[None, :], math.inf)
        ty = torch.where(torch.from_numpy(mask), ys[:, None], math.inf)
    if form == "packed":
        steps = packed_state_plan(xs.numpy(), ys.numpy(), metric)[0]
        state = torch.from_numpy(packed_state(mask))
        got = emulate_single([state], [-1], ks, plan,
                             visit_flat_packed(metric, steps))
        assert torch.equal(got[0], jfa_group.group_packed_twin(
            state, ks, metric, steps))
        return
    got = emulate_single([tx, ty], [math.inf, math.inf], ks, plan,
                         visit_flat_coords(metric, xs, ys))
    ref = jfa_group.group_coords_twin(tx, ty, xs, ys, ks, metric)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("ks,form,route", [
    pytest.param((64, 32, 16, 8, 4, 2, 1, 2, 1), "packed", "single",
                 id="ks0-packed"),
    pytest.param((64, 32, 16, 8, 4, 2, 1, 2, 1), "coords", "single",
                 id="ks1-coords"),
    # fits single-buffered at T = 32; the double route's window does not
    pytest.param((64,), "coords", "double", id="ks2-coords"),
    pytest.param((64, 32, 16, 8, 4, 2, 1, 2, 1), "packed", "double",
                 id="ks0-packed-double")])
def test_a_window_that_does_not_fit_raises_naming_the_bytes(ks, form, route):
    with pytest.raises(ValueError, match=r"needs \d+ bytes of shared memory"):
        jfa_group.window_plan(ks, form, route)
    if route == "double":
        return
    with pytest.raises(ValueError, match="bytes"):
        if form == "packed":
            jfa_group.group_packed(torch.full((8, 8), -1, dtype=torch.int32),
                                   ks, 0, (1.0, 1.0))
        else:
            t = torch.full((8, 8), math.inf)
            jfa_group.group_coords(t, t, torch.arange(8.0),
                                   torch.arange(8.0), ks, 0)


@pytest.mark.parametrize("ks", [(), (0,), (2, -1), (1,) * 17])
def test_bad_groups_are_refused(ks):
    with pytest.raises(ValueError, match="a group is"):
        jfa_group.window_plan(ks, "packed")


def test_packed_group_refuses_great_circle():
    with pytest.raises(ValueError, match="metrics"):
        jfa_group.group_packed(torch.full((4, 4), -1, dtype=torch.int32),
                               (1,), 1, (1.0, 1.0))
