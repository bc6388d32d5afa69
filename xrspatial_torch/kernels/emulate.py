"""Torch emulations of CUDA kernels' algorithms, for the CPU tests.

A CUDA kernel cannot run without a card, so the tests hold these
emulations, written with the kernels' own window, index arithmetic and
loop order, to the kernels' plain versions bit for bit:

- ``emulate_staged``: ``csrc/focal_halo.cu::focal_halo_staged_kernel``
  (B2's and B5's staged template), against ``window.window_stats``;
- ``emulate_surface_staged`` (with ``ring_schedule``, the persistent
  loop of ``csrc/staged_window.cuh``): ``csrc/surface.cu::
  surface_staged_kernel`` (B1), against ``surface.surface_multi``;
- ``emulate_pipeline``: the staged template with its surface epilogue
  (B4), against ``pipeline.pipeline_multi``;
- ``emulate_stacked``: B0 on its route, ``csrc/surface.cu::
  surface_staged_kernel`` on the planes of one buffer (TMA) or
  ``surface_phased_kernel`` (phased: ``csrc/staged_window.cuh::
  stage_phased``'s row phases and 16-byte body copies, ``surface_cell.cuh::
  load6_phased`` and ``store_span``), in a flat model of device memory,
  against ``surface.surface_multi_stacked``;
- ``emulate_separable_staged``: ``csrc/stencil_probe.cu``'s form
  separable_staged (B8d), against ``stencil_probe.stencil_twin``;
- ``emulate_interior_staged`` (with ``emulate_edge_bands``): its form
  staged on the interior walk, edges interior (B8e) and bare (B8f),
  against ``surface.surface_multi``;
- ``blocks_of`` and ``emulate_culled``: ``csrc/screen.cu::
  screen_culled_kernel`` (B7's culled route), against
  ``screen.screen_hilo``; ``blocks_of`` also gives the (warp, chunk)
  pairs the kernel keeps, which the card's tests hold its counters to;
- ``emulate_xdraw``: ``csrc/xdraw.cu::xdraw_scan_kernel`` (X1: a block a
  half-plane from the step after the viewpoint, the lanes of the ray
  cone, each cell written by its own octant's scan), against
  ``viewshed.xdraw_scan_twin``;
- ``emulate_xdraw_strip``: its redesign, ``xdraw_banded_kernel`` (X1:
  bands of lanes, K-step chunks, the one-sided halo recomputed, carries
  exchanged only at chunk ends; one window of steps on one strip's four
  half-planes, the bands starting from the carry-in row and writing the
  carry-out row), with ``cuda_xdraw.xdraw_strip_cuda``'s arguments, so
  that it can stand in for the launch in
  ``viewshed.xdraw_mesh_max_slope``; ``emulate_xdraw_banded`` runs it as
  ``xdraw_banded_launch`` does, the whole raster one strip, against the
  same twin;
- ``emulate_bump_rounds``: ``csrc/bump.cu::bump_rounds_kernel`` (X2: the
  claim, test and apply rounds on a retagged owner map, then the walk of
  the rest in order), against ``bump.bump_scan_twin``.

Also the proximity family's test cases (``layout``, ``axes``) and
tolerances, which several test files share.  Nothing in the package
calls any of these.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import bump as TB
from . import focal_halo as fh
from . import screen as TS
from . import surface as TSU
from . import viewshed as TV

__all__ = ["emulate_staged", "ring_schedule", "emulate_surface_staged",
           "emulate_pipeline", "emulate_stacked", "emulate_separable_staged",
           "emulate_interior_staged", "emulate_edge_bands",
           "halo_case", "same_bits", "SCREEN_R",
           "SCREEN_WARP", "SCREEN_BLOCK", "group_segments", "blocks_of",
           "emulate_culled", "TOL", "GC_RTOL", "layout", "axes",
           "emulate_xdraw_banded", "emulate_xdraw_strip",
           "emulate_bump_rounds"]


# -- the staged focal template ------------------------------------------------

def emulate_staged(x, offsets, min_radius=0, windows=False):
    """The staged kernel's statistics of the 2D float32 CPU tensor `x`
    (dict by stat), and each tile's NaN-free flag: each tile's window with
    its NaN fill, the run table's addresses, four cells along x a lane,
    offsets order in every cell, and the NaN-free branch that takes the
    count from the number of offsets.  The window's radii are at least
    `min_radius` (the fused pipeline's plan); with `windows`, also
    ``(plan, ry, wins)``: the plan, the window's row radius and the
    flattened windows, tile by tile in row-major order."""
    h, w = x.shape
    plan = fh.halo_plan(h, w, offsets, min_radius=min_radius)
    if plan.route == "ring":
        raise ValueError("the ring route is not the staged kernel")
    th, tw = plan.tile
    ry = max(max(abs(dy) for dy, _ in offsets), min_radius)
    ty, tx = -(-h // th), -(-w // tw)
    # window (i, k) of the tile at (r0, c0) is raster (r0 - ry + i,
    # c0 - pad + k), NaN outside it: the TMA map's fill
    big = F.pad(x, (plan.pad, tx * tw + plan.pitch, ry, ty * th + plan.rows),
                value=math.nan)
    wins = torch.stack([big[a * th:a * th + plan.rows,
                            b * tw:b * tw + plan.pitch].reshape(-1)
                        for a in range(ty) for b in range(tx)])
    nan_free = ~torch.isnan(wins).any(dim=1)
    # lane l's cell j at tile row tr starts at window float tr*pitch + 4l + j
    tr = torch.arange(th)[:, None, None]
    lane = torch.arange(32)[None, :, None]
    cell = torch.arange(fh.CELLS)[None, None, :]
    base = tr * plan.pitch + 4 * lane + cell
    shape = (wins.shape[0], th, 32, fh.CELLS)

    def values():
        """Each offset's value for every cell, in the kernel's order."""
        for quad, code in fh.run_table(offsets, plan, min_radius):
            for m in range(code >> 2):
                idx = base + 4 * quad + (code & 3) + m
                yield wins[:, idx.reshape(-1)].reshape(shape)

    cnt, ssum = torch.zeros(shape), torch.zeros(shape)
    smin, smax = torch.full(shape, math.inf), torch.full(shape, -math.inf)
    for s in values():
        ok = ~torch.isnan(s)
        cnt = cnt + ok
        ssum = torch.where(ok, ssum + s, ssum)
        smin = torch.where(ok & (s < smin), s, smin)
        smax = torch.where(ok & (s > smax), s, smax)
    # the NaN-free branch: the count is the number of offsets
    cnt = torch.where(nan_free[:, None, None, None], float(len(offsets)), cnt)
    mean = torch.where(cnt > 0, ssum / torch.clamp(cnt, min=1.0), math.nan)
    dev2 = torch.zeros(shape)
    for s in values():
        dv = s - mean
        dev2 = torch.where(torch.isnan(s), dev2, dev2 + dv * dv)
    smin = torch.where(torch.isinf(smin), math.nan, smin)
    smax = torch.where(torch.isinf(smax), math.nan, smax)
    var = torch.where(cnt > 0, dev2 / torch.clamp(cnt, min=1.0), math.nan)
    planes = {"mean": mean, "sum": ssum, "min": smin, "max": smax,
              "range": smax - smin, "var": var, "std": torch.sqrt(var)}

    stats = {k: _tiles_to_raster(v, ty, tx, h, w)
             for k, v in planes.items()}
    if windows:
        return stats, nan_free, (plan, ry, wins)
    return stats, nan_free


def _tiles_to_raster(t, ty, tx, h, w):
    """(ty * tx, TH, ...) tile values, tile-major in row-major tile order,
    as the (h, w) raster they cover."""
    th = t.shape[1]
    t = t.reshape(ty, tx, th, -1).permute(0, 2, 1, 3)
    return t.reshape(ty * th, -1)[:h, :w].contiguous()


# -- the surface kernels' staged windows ---------------------------------------

def ring_schedule(tiles, grid, stages):
    """The persistent loop of ``csrc/staged_window.cuh::staged_tiles``:
    ``(block, k, tile, stage, parity)`` of each tile, in each block's
    order: block b's k-th tile is b + k * grid, staged in stage k % stages,
    whose mbarrier phase has parity (k // stages) & 1."""
    for b in range(grid):
        mine = (tiles - b + grid - 1) // grid if b < tiles else 0
        for k in range(mine):
            yield b, k, b + k * grid, k % stages, (k // stages) & 1


def _products(nb, which, csx, csy, azimuth, angle_altitude):
    """`which` of the surface products from the nine (h, w) neighbour
    tensors `nb` (a ... i), with the twins' functions, and no ring
    applied: NaN neighbours make it."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    csx, csy = f32(csx), f32(csy)
    out = {}
    if "slope" in which:
        out["slope"] = TSU.slope_from_neighbors(nb, csx, csy)
    if "aspect" in which:
        out["aspect"] = TSU.aspect_from_neighbors(nb)
    if "curvature" in which:
        out["curvature"] = TSU.curvature_from_center(nb, (csx + csy) * 0.5)
    if "hillshade" in which:
        out["hillshade"] = TSU.hillshade_from_gradient(
            nb, f32(azimuth), f32(angle_altitude))
    return out


def emulate_surface_staged(x, which, cellsize_x=1.0, cellsize_y=1.0,
                           azimuth=225.0, angle_altitude=25.0,
                           tile=TSU.SURFACE_TILE, sms=132):
    """B1's staged kernel (``csrc/surface.cu::surface_staged_kernel``) on
    the 2D float32 CPU tensor `x`: a dict of the products in `which`.

    Written with the kernel's loop and index arithmetic: the persistent
    blocks' tiles (``ring_schedule`` on ``surface_plan``'s grid and
    stages), each tile's (TH + 2) x (TW + 8) window from (r0 - 1, c0 - 4)
    with TMA's NaN fill outside the raster, thread quad q at tile row
    tr = q // (TW / 4) and column tc = 4 (q mod TW / 4), its 3 x 6 values
    at window floats tr * cols + tc + 3 .. + 8 of rows tr .. tr + 2
    (``load6``, ``_tma_rows``), and only cells inside the raster written.
    The products come from each quad's nine neighbour values through the
    twins' functions."""
    h, w = x.shape
    th, tw = tile
    plan = TSU.surface_plan(h, w, 0, tile, sms)
    vals = _products(_quad_cells(*_tma_rows(x, tile, plan)), tuple(which),
                     cellsize_x, cellsize_y, azimuth, angle_altitude)
    ty, tx = -(-h // th), -(-w // tw)
    return {p: _tiles_to_raster(v.reshape(plan.tiles, th, tw), ty, tx, h, w)
            for p, v in vals.items()}


def _walk(plan):
    """The tiles of ``ring_schedule`` on `plan`'s grid and stages, checked
    to be every tile once."""
    walked = [t for _, _, t, _, _ in ring_schedule(plan.tiles, plan.grid,
                                                   plan.stages)]
    if sorted(walked) != list(range(plan.tiles)):
        raise AssertionError("the persistent loop missed or repeated a tile")
    return walked


def _tma_rows(x, tile, plan):
    """The TMA route's windows of the (h, w) CPU tensor `x` at `tile`
    (``staged_window.cuh``: rows r0 - 1 .. r0 + TH, columns c0 - 4 ..
    c0 + TW + 3, NaN outside), read as ``load6`` reads them: (u, m, d), each
    (tiles, TH, TW / 4, 6), the 6 values of quad (tr, tc / 4) in the rows
    above, at and below, at window floats tr * cols + tc + 3 .. + 8."""
    h, w = x.shape
    th, tw = tile
    cols, rows = tw + 8, th + 2
    ty, tx = -(-h // th), -(-w // tw)
    big = F.pad(x, (4, tx * tw + cols, 1, ty * th + rows), value=math.nan)
    wins = {}
    for t in _walk(plan):
        r0, c0 = t // tx * th, t % tx * tw
        wins[t] = big[r0:r0 + rows, c0:c0 + cols].reshape(-1)
    wins = torch.stack([wins[t] for t in range(plan.tiles)])
    tr = torch.arange(th)[:, None, None]
    tc = 4 * torch.arange(tw // 4)[None, :, None]
    j = torch.arange(6)[None, None, :]
    return tuple(wins[:, (tr + i) * cols + tc + 3 + j]
                 for i in range(3))


def _quad_cells(u, m, d):
    """The nine neighbour tensors (a ... i) of each quad's 4 cells from its
    3 x 6 values, as ``surface_quad_of`` takes them: (..., 4) each."""
    return tuple(r[..., k:k + 4] for r in (u, m, d) for k in range(3))


def emulate_stacked(x, which, cellsize_x=1.0, cellsize_y=1.0,
                    azimuth=225.0, angle_altitude=25.0, route=None,
                    tile=None, x_off=0, out_off=0, sms=132, stats=False):
    """B0 on the 2D float32 CPU tensor `x`: the (K, H, W) stack, plane k =
    ``which[k]``, on ``stacked_plan``'s route (or `route` by name) with
    `x` `x_off` floats and the output `out_off` floats past a 16-byte
    boundary.

    Device memory is modelled as flat float tensors at those offsets.
    Route "tma": B1's windows and quads, each plane's 16-byte stores at
    ``out_off + plane * H * W + row * W + col``.  Route "phased": each tile
    120 columns apart, its warps' 128 cells from cc0 = c0 - 8; every window
    row staged at its phase f (16-byte chunks wholly inside the raster
    copied whole, the head and tail cells one by one, NaN outside), read
    back through ``load6_phased``'s aligned loads and its shift, and each
    plane's span stored by ``store_span`` (the next lane's values by
    shuffle, 16-byte groups, cells outside the raster row skipped).  Raises AssertionError if a copy
    or a store is not aligned as the kernel's instruction needs, a tile is
    walked twice or missed, or a plane cell is written other than once or
    a cell outside the planes at all.  With `stats`, also a dict: the
    route, tiles, 16-byte body chunks, head/tail cells copied, NaN cells,
    the most head/tail cells of one window row, vector and scalar stores,
    and the 32-byte sectors of the planes that more than one warp row
    wrote (``split_sectors``, with the sectors that hold the start of a
    plane row, the buffer's first excepted, ``row_end_sectors``)."""
    which = tuple(which)
    TSU.check_products(which, allow_empty=False)
    h, w = x.shape
    hw = h * w
    plan = TSU.stacked_plan(h, w, 4 * x_off, 4 * out_off, route, tile,
                            sms=sms)
    th, tw = plan.tile
    info = {"route": plan.route, "tiles": plan.tiles}
    if plan.route == "tma":
        u, m, d = _tma_rows(x, plan.tile, plan)
        tx = -(-w // tw)
        t = torch.arange(plan.tiles)
        row = (t // tx * th)[:, None, None] + torch.arange(th)[None, :, None]
        col = (t % tx * tw)[:, None, None] \
            + 4 * torch.arange(tw // 4)[None, None, :]
    else:
        u, m, d, row, col, info2 = _phased_rows(x, plan, x_off)
        info.update(info2)
    vals = _products(_quad_cells(u, m, d), which, cellsize_x, cellsize_y,
                     azimuth, angle_altitude)
    out = torch.full((out_off + len(which) * hw + 8,), -7.0)
    writes = torch.zeros(out.shape, dtype=torch.int64)
    vec = scal = 0
    sector_writers = []
    for k, p in enumerate(which):
        q = vals[p]                                   # (tiles, TH, 32, 4)
        base = out_off + k * hw
        if plan.route == "tma":
            ok = (row < h) & (col < w)                 # whole quads
            addr = base + row * w + col
            if bool((addr[ok] % 4 != 0).any()) or w % 4:
                raise AssertionError("a TMA-route store is not 16-byte "
                                     "aligned")
            a = (addr[..., None] + torch.arange(4))[ok]
            v = q[ok]
            vec += int(ok.sum())
            writer = torch.broadcast_to(
                (torch.arange(plan.tiles)[:, None, None] * th
                 + torch.arange(th)[None, :, None]), ok.shape)[ok]
            writer = writer[:, None].expand(-1, 4)
        else:
            a, v, writer, nv, ns = _span_stores(q, row, col, base, w, h)
            vec, scal = vec + nv, scal + ns
        out[a.reshape(-1)] = v.reshape(-1)
        writes.index_add_(0, a.reshape(-1), torch.ones(a.numel(),
                                                        dtype=torch.int64))
        sector_writers.append(torch.stack([a.reshape(-1) // 8,
                                           writer.reshape(-1)], 1))
    inside = writes[out_off:out_off + len(which) * hw]
    if not bool((inside == 1).all()) or int(writes.sum()) != inside.numel():
        raise AssertionError("a plane cell was written other than once, or "
                             "a cell outside the planes was written")
    res = out[out_off:out_off + len(which) * hw].reshape(len(which), h, w)
    if not stats:
        return res
    pairs = torch.unique(torch.cat(sector_writers), dim=0)
    _, per = torch.unique(pairs[:, 0], return_counts=True)
    # the sectors holding a plane row's start, but the buffer's first
    ends = torch.tensor([out_off + k * hw + r * w
                         for k in range(len(which)) for r in range(h)
                         if (k or r) and (out_off + k * hw + r * w) % 8],
                        dtype=torch.int64)
    info.update(vector_stores=vec, scalar_stores=scal,
                split_sectors=int((per > 1).sum()),
                row_end_sectors=int(torch.unique(ends // 8).numel()))
    return res, info


def _phased_rows(x, plan, x_off):
    """Route phased's windows, staged as ``stage_phased`` does, and read as
    ``load6_phased`` reads them: (u, m, d) as ``_tma_rows``' (32 quads a
    row from cc0), the rows and first columns of the quads, and the
    staging's counts."""
    h, w = x.shape
    th = plan.tile[0]
    cells, shift = TSU.SPAN_CELLS, TSU.SPAN_SHIFT
    pitch = 128 + 8 + TSU.PHASED_ROW_PAD
    chunks = pitch // 4
    tx = -(-(w + shift - 1) // cells)
    mem = torch.cat([torch.full((x_off,), 1e30), x.reshape(-1)])
    t = torch.tensor(_walk(plan))
    order = torch.argsort(t)
    r0 = (t // tx * th)[order]
    cc0 = (t % tx * cells - shift)[order]
    wr = torch.arange(th + 2)
    row = r0[:, None] - 1 + wr[None, :]               # (tiles, TH + 2)
    f = (x_off + row * w + cc0[:, None] - 4) % 4      # each row's phase
    col = cc0[:, None, None] - 4 - f[..., None] \
        + 4 * torch.arange(chunks)[None, None, :]     # chunk m's first cell
    inrow = ((row >= 0) & (row < h))[..., None]
    body = inrow & (col >= 0) & (col + 4 <= w)
    if bool(((x_off + row[..., None] * w + col)[body] % 4 != 0).any()):
        raise AssertionError("a 16-byte cp.async source is not 16-byte "
                             "aligned")
    c4 = col[..., None] + torch.arange(4)
    valid = inrow[..., None] & (c4 >= 0) & (c4 < w)
    src = (x_off + row[..., None, None] * w + c4).clamp(0, mem.numel() - 1)
    win = torch.where(valid, mem[src], math.nan).reshape(
        len(t), th + 2, pitch)
    edge = valid & ~body[..., None]
    staged = {"body_chunks": int(body.sum()), "edge_cells": int(edge.sum()),
              "nan_cells": int((~valid).sum()),
              "edge_cells_a_row": int(edge.sum(dim=(2, 3)).max())}
    lane = torch.arange(32)
    reads = []
    for i in range(3):
        fi = f[:, i:i + th, None, None]                # (tiles, TH, 1, 1)
        o = (fi + 3) % 4
        a = 4 * lane[None, None, :, None] + fi + 3 - o
        if bool((a % 4 != 0).any()):
            raise AssertionError("a load6_phased 16-byte load is not "
                                 "aligned")
        nine = torch.gather(
            win[:, i:i + th], 2,
            (a + torch.arange(9)).reshape(len(t), th, -1)).reshape(
                len(t), th, 32, 9)
        reads.append(torch.gather(nine, 3,
                                  (o + torch.arange(6)).expand(-1, -1, 32,
                                                               -1)))
    rows = (r0[:, None] + torch.arange(th)[None, :])[:, :, None]
    cols = cc0[:, None, None] + 4 * lane[None, None, :]
    return (*reads, rows, cols, staged)


def _span_stores(q, row, col, base, w, h):
    """``store_span`` for every warp row: the addresses, values and writer
    (tile, row) of each stored cell, and the counts of 16-byte and 4-byte
    stores.  `q` holds each lane's 4 values (tiles, TH, 32, 4), `row` and
    `col` the quads' rows and first cells (col = cc0 + 4 l)."""
    n, th = q.shape[:2]
    lane = torch.arange(32)
    cc0 = col[:, :, :1]                               # (tiles, 1, 1)
    o = base + row * w                                # (tiles, TH, 1)
    s = (o + cc0 + TSU.SPAN_SHIFT) % 8
    rel = TSU.SPAN_SHIFT - s
    t, b = rel % 4, rel // 4
    nxt = q[:, :, torch.clamp(lane + 1, max=31), :]   # shfl_down: lane 31 own
    x7 = torch.cat([q, nxt[..., :3]], dim=3)
    g = torch.gather(x7, 3, (t[..., None] + torch.arange(4)).expand(
        -1, -1, 32, -1))
    c = cc0 + 4 * lane + t                            # (tiles, TH, 32)
    stores = (lane >= b) & (lane < b + TSU.SPAN_CELLS // 4) & (row < h)
    vec = stores & (c >= 0) & (c + 4 <= w)
    if bool(((o + c)[vec] % 4 != 0).any()):
        raise AssertionError("a span's 16-byte store is not 16-byte aligned")
    cj = c[..., None] + torch.arange(4)
    ok = stores[..., None] & (cj >= 0) & (cj < w)
    addr = (o[..., None] + cj)[ok]
    writer = torch.broadcast_to(
        torch.arange(n * th).reshape(n, th, 1, 1), ok.shape)[ok]
    n_scalar = int((ok & ~vec[..., None]).sum())
    return addr, g[ok], writer, int(vec.sum()), n_scalar


def emulate_separable_staged(x, tile=(64, 128), sms=132):
    """``csrc/stencil_probe.cu``'s form separable_staged (B8d) on the 2D
    float32 CPU tensor `x` at `tile`: ``staged_plan``'s windows and loop,
    each quad's 6 column smooths ``up + 2 mid + dn`` and differences
    ``dn - up`` once, then ``sx = s[j+2] - s[j]``, ``sy = d[j] + 2 d[j+1] +
    d[j+2]`` and B1's slope of them, the NaN ring from the windows' NaN
    fill."""
    from .staged import staged_plan
    h, w = x.shape
    th, tw = tile
    plan = staged_plan(h, w, tile, 0, sms)
    u, m, d = _tma_rows(x, tile, plan)
    smooth = u + 2.0 * m + d
    diff = d - u
    sx = smooth[..., 2:] - smooth[..., :4]
    sy = diff[..., :4] + 2.0 * diff[..., 1:5] + diff[..., 2:]
    one = torch.tensor(1.0)
    dzdx, dzdy = sx / (8.0 * one), sy / (8.0 * one)
    v = torch.atan(torch.sqrt(dzdx * dzdx + dzdy * dzdy)) * TSU.DEG
    return _tiles_to_raster(v.reshape(plan.tiles, th, tw), -(-h // th),
                            -(-w // tw), h, w)


def emulate_interior_staged(x, tile=(64, 128), edges="interior", sms=132):
    """``csrc/stencil_probe.cu``'s form staged, slope, on the interior walk
    (edges interior, B8e, or bare, B8f) on the 2D float32 CPU tensor `x`
    at `tile`: ``staged_plan(..., walk="interior")``'s tiles in
    ``ring_schedule``'s order, each at ``tile_origin``'s (r0, c0), its
    window rows r0 - 1 .. r0 + TH and columns c0 - 4 .. c0 + TW + 3 read
    from the raster with no fill (AssertionError if a window cell lies
    outside it), each quad's 3 x 6 values read as ``load6`` reads them
    (``_tma_rows``), and every cell of the tile written; overlapping tiles
    write again.  Edges interior then writes the edge bands
    (``emulate_edge_bands`` outside ``staged_interior_extent``); bare
    leaves every other cell NaN.  Returns (slope, writes a cell)."""
    from .staged import staged_plan, tile_origin
    from .stencil_probe import staged_interior_extent
    h, w = x.shape
    th, tw = tile
    cols, rows = tw + 8, th + 2
    plan = staged_plan(h, w, tile, 0, sms, walk="interior")
    out = torch.full_like(x, math.nan)
    writes = torch.zeros(x.shape, dtype=torch.int32)
    origins, wins = [], []
    for _, _, t, _, _ in ring_schedule(plan.tiles, plan.grid, plan.stages):
        r0, c0 = tile_origin(t, h, w, tile, "interior")
        if r0 - 1 < 0 or r0 + th >= h or c0 - 4 < 0 or c0 + tw + 3 >= w:
            raise AssertionError(f"tile {t}'s window at ({r0 - 1}, "
                                 f"{c0 - 4}) leaves the {h}x{w} raster")
        origins.append((r0, c0))
        wins.append(x[r0 - 1:r0 - 1 + rows, c0 - 4:c0 - 4 + cols]
                    .reshape(-1))
    if wins:
        wins = torch.stack(wins)
        tr = torch.arange(th)[:, None, None]
        tc = 4 * torch.arange(tw // 4)[None, :, None]
        j = torch.arange(6)[None, None, :]
        u, m, d = (wins[:, (tr + i) * cols + tc + 3 + j] for i in range(3))
        one = torch.tensor(1.0)
        v = TSU.slope_from_neighbors(_quad_cells(u, m, d), one, one)
        for (r0, c0), tile_v in zip(origins, v.reshape(-1, th, tw)):
            out[r0:r0 + th, c0:c0 + tw] = tile_v
            writes[r0:r0 + th, c0:c0 + tw] += 1
    if edges == "interior":
        band, band_writes = emulate_edge_bands(
            x, staged_interior_extent(h, w, tile))
        out = torch.where(band_writes > 0, band, out)
        writes += band_writes
    return out, writes


def emulate_edge_bands(x, extent):
    """``csrc/stencil_probe.cu::stencil_edge_kernel`` on the 2D float32 CPU
    tensor `x`: cell e of the n cells outside `extent` = (r0, r1, c0, c1)
    at the kernel's (row, col) (the top band, the bottom band, the left
    and the right band of the interior rows, each row-major), its value
    ``checked_cell``'s (NaN on the 1-cell ring, else B1's slope of its
    nine neighbours).  Returns (values, NaN elsewhere; writes a cell)."""
    h, w = x.shape
    r0, r1, c0, c1 = extent
    top, bottom, left = r0 * w, (h - r1) * w, (r1 - r0) * c0
    n = top + bottom + left + (r1 - r0) * (w - c1)
    k = torch.arange(n)
    kb, kl, kr = k - top, k - top - bottom, k - top - bottom - left
    safe = lambda d: max(d, 1)  # noqa: E731  (a band that is empty)
    row = torch.where(k < top, k // w, torch.where(
        kb < bottom, r1 + kb // w, torch.where(
            kl < left, r0 + kl // safe(c0), r0 + kr // safe(w - c1))))
    col = torch.where(k < top, k % w, torch.where(
        kb < bottom, kb % w, torch.where(
            kl < left, kl % safe(c0), c1 + kr % safe(w - c1))))
    ring = (row == 0) | (row == h - 1) | (col == 0) | (col == w - 1)
    nb = tuple(x[(row + dr).clamp(0, h - 1), (col + dc).clamp(0, w - 1)]
               for dr in (-1, 0, 1) for dc in (-1, 0, 1))
    one = torch.tensor(1.0)
    v = torch.where(ring, math.nan, TSU.slope_from_neighbors(nb, one, one))
    out = torch.full_like(x, math.nan)
    writes = torch.zeros(x.shape, dtype=torch.int32)
    out[row, col] = v
    writes.index_put_((row, col), torch.ones(n, dtype=torch.int32),
                      accumulate=True)
    return out, writes


def emulate_pipeline(x, offsets, stats, which, cellsize_x=1.0,
                     cellsize_y=1.0, azimuth=225.0, angle_altitude=25.0):
    """B4's staged kernel (``csrc/focal_halo.cu``, the staged template
    with its surface epilogue) on the 2D float32 CPU tensor `x`:
    ``pipeline_multi``'s outputs, the products in `which` order, then the
    (S, H, W) stack in `stats` order.

    ``emulate_staged`` on the pipeline's plan (radii at least 1) for the
    statistics; from the same windows, lane l's cell j of tile row tr
    reads its 3x3 neighbourhood at window rows tr - 1 + ry .. tr + 1 + ry
    and columns pad - 4 + 4 l + 3 + j .. + 2 (``load6`` at window float
    (tr - 1 + ry) * pitch + pad - 4 + 4 l)."""
    h, w = x.shape
    focal, _, (plan, ry, wins) = emulate_staged(x, offsets, min_radius=1,
                                                windows=True)
    th, tw = plan.tile
    ty, tx = -(-h // th), -(-w // tw)
    tr = torch.arange(th)[:, None, None]
    lane = torch.arange(32)[None, :, None]
    j = torch.arange(4)[None, None, :]
    p = (tr - 1 + ry) * plan.pitch + plan.pad - 4 + 4 * lane
    nb = []
    for dr in range(3):
        for dc in range(3):
            idx = (p + dr * plan.pitch + 3 + j + dc).reshape(-1)
            cells = wins[:, idx].reshape(-1, th, tw)
            nb.append(_tiles_to_raster(cells, ty, tx, h, w))
    surf = _products(tuple(nb), tuple(which), cellsize_x, cellsize_y,
                     azimuth, angle_altitude)
    return (*(surf[p] for p in which),
            torch.stack([focal[s] for s in stats]))


def halo_case(shape, seed):
    """A float32 CPU raster of `shape` made from `seed`, with a NaN block
    and +-inf cells."""
    rng = np.random.default_rng(seed)
    data = (rng.random(shape) * 50).astype(np.float32)
    h, w = shape
    data[h // 8:h // 8 + 3, w // 5:w // 5 + 9] = np.nan
    data[h - 1, w - 1] = np.inf
    data[0, w // 2] = -np.inf
    data[h // 9, 3] = np.inf
    return torch.from_numpy(data)


def same_bits(got, ref):
    """Equal values, NaN where NaN and the same infinities."""
    return (torch.equal(torch.isnan(got), torch.isnan(ref))
            and torch.equal(torch.nan_to_num(got, 0.0, 1.0, -1.0),
                            torch.nan_to_num(ref, 0.0, 1.0, -1.0))
            and torch.equal(torch.isinf(got), torch.isinf(ref)))


# -- the interval screen's culled route ----------------------------------------

SCREEN_R = 4                      # targets a thread (screen.cu kR)
SCREEN_WARP = 32 * SCREEN_R       # targets a warp
SCREEN_BLOCK = 4 * SCREEN_WARP    # targets a block: 128 threads
_F = {k: i for i, k in enumerate(TS.F13)}


def group_segments(args, bounds, g):
    """Group g's candidates as the kernel walks them: the global table,
    then each tier's window; (fields (13, L), idx (L,), bounds (L/128,
    2)).  `args` are ``screen.screen_hilo``'s, on the CPU."""
    glob, stacks, *_, rows, A, C, Es, NBs, B = args
    nglob = glob[1].shape[0] // TS.CHUNK
    fields, idx, bnd = [glob[0]], [glob[1]], [bounds[:nglob]]
    off = nglob
    for t, ((stk, ix), E, NB) in enumerate(zip(stacks, Es, NBs)):
        nblk = ix.shape[0]
        nb = min(NB, nblk)
        r = max(0, min(int(rows[g, t]), nblk - nb))
        fields.append(stk[r:r + nb].transpose(0, 1).reshape(len(TS.F13), -1))
        idx.append(ix[r:r + nb].reshape(-1))
        per = E // TS.CHUNK
        bnd.append(bounds[off + r * per:off + (r + nb) * per])
        off += nblk * per
    return torch.cat(fields, dim=1), torch.cat(idx), torch.cat(bnd)


def blocks_of(args):
    """Each block of the culled kernel: (group, flat target slice, the
    target angles padded with NaN to SCREEN_BLOCK, kept (warp, chunk) mask,
    the group's fields and idx)."""
    glob, stacks, al, klo, khi, it, rows, A, C, Es, NBs, B = args
    G, T = A // B, B * C
    bounds = TS.chunk_bounds(glob, stacks).reshape(-1, 2)
    for g in range(G):
        fields, idx, bnd = group_segments(args, bounds, g)
        lo, hi = bnd[:, 0], bnd[:, 1]
        for b0 in range(0, T, SCREEN_BLOCK):
            sl = slice(g * T + b0, g * T + min(b0 + SCREEN_BLOCK, T))
            a = torch.full((SCREEN_BLOCK,), torch.nan, dtype=al.dtype)
            a[:sl.stop - sl.start] = al[sl]
            warps = a.reshape(-1, SCREEN_WARP)
            ok = ~torch.isnan(warps)
            inf = torch.tensor(torch.inf, dtype=al.dtype)
            wmin = torch.where(ok, warps, inf).amin(dim=1)
            wmax = torch.where(ok, warps, -inf).amax(dim=1)
            bmin, bmax = wmin.min(), wmax.max()
            block_keep = ~((bmax <= lo) | (bmin >= hi))
            kept = block_keep[None] & ~((wmax[:, None] <= lo[None])
                                        | (wmin[:, None] >= hi[None]))
            yield g, sl, a, kept, fields, idx


def emulate_culled(args):
    """The culled kernel's (hi, lo), written with its loop order: each warp
    of each block evaluates its 128 targets against the candidates of the
    chunks it keeps, the wide cover and kt_hi first."""
    glob, stacks, al, klo, khi, it, rows, A, C, Es, NBs, B = args
    ninf = torch.tensor(-torch.inf, dtype=al.dtype)
    hi = torch.full_like(al, -torch.inf)
    lo = torch.full_like(al, -torch.inf)
    lane = torch.arange(TS.CHUNK)
    for g, sl, a, kept, fields, idx in blocks_of(args):
        for w in range(kept.shape[0]):
            t0 = sl.start + w * SCREEN_WARP
            n = min(SCREEN_WARP, sl.stop - t0)
            if n <= 0 or not bool(kept[w].any()):
                continue
            cand = (kept[w].nonzero()[:, 0, None] * TS.CHUNK
                    + lane[None]).reshape(-1)
            f = {k: fields[i][cand][None] for k, i in _F.items()}
            t = a[w * SCREEN_WARP:w * SCREEN_WARP + n, None]
            kl, kh, me = (v[t0:t0 + n, None] for v in (klo, khi, it))
            # first the wide cover and kt_hi: three fields
            m = (t > f["a0w"]) & (t < f["a2w"]) & (f["key"] < kh)
            # then, for the pairs that pass, the index and the rest
            m = m & (idx[cand][None] != me)
            d = t - f["a1e"]
            gi = f["g1"] + d * torch.where(d < 0, -f["s01"], f["s21"])
            gi = torch.minimum(torch.maximum(gi, f["mn"]), f["mx"])
            hi[t0:t0 + n] = torch.where(m, gi + f["tw"], ninf).amax(dim=1)
            s = m & (t > f["a0n"]) & (t < f["a2n"]) & (f["key"] < kl)
            lo[t0:t0 + n] = torch.where(s, gi - f["ts"], ninf).amax(dim=1)
    return hi, lo


# -- the proximity family's test cases ------------------------------------------

TOL = dict(rtol=1e-5, atol=1e-5)   # distances and direction
GC_RTOL = 1e-4                     # great-circle distances


def layout(shape, density, seed):
    """Targets (values 1-8) on a zero background, from a seed."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(1, 9, shape)
    return np.where(rng.random(shape) < density, vals, 0).astype(np.float32)


def axes(kind, h, w, seed=0):
    """(ys, xs) coordinate vectors of one kind."""
    rng = np.random.default_rng(seed)
    if kind == "affine_desc":        # create_test_raster's: y descending
        return (np.arange(h)[::-1] * 0.5, np.arange(w) * 0.5)
    if kind == "affine_asc":         # scaled steps, both ascending
        return (3.0 + np.arange(h) * 0.25, -50.0 + np.arange(w) * 8.0)
    if kind == "nonaffine":          # monotone, not affine
        return (np.sort(rng.uniform(-50, 50, h))[::-1],
                np.sort(rng.uniform(-50, 50, w)))
    if kind == "nonmonotone":
        return (np.arange(h, dtype=float), rng.permutation(w) * 1.5)
    if kind == "lonlat":             # bench.py's great-circle grid
        return np.linspace(75, -75, h), np.linspace(-170, 170, w)
    raise ValueError(kind)


def emulate_xdraw(slope, vp_row, vp_col):
    """``xdraw_scan_kernel``'s algorithm, its four blocks in turn: each
    walks its half-plane from step k0 = (the viewpoint's major index) + 1,
    updates only the lanes of the cone |minor| <= dxf from the previous
    step's carry (both carry buffers start at -inf), and writes the cells
    it owns into one field: east and west every cone cell, south and north
    those with |minor| < dxf, east also the viewpoint (-inf).  Cells no
    block writes stay NaN, which the tests would see."""
    h, w = slope.shape
    f32 = torch.float32
    neginf = float("-inf")
    out = torch.full((h, w), float("nan"), dtype=f32)
    out[vp_row, vp_col] = neginf
    slope_t = slope.t().contiguous()
    for hp in range(4):
        x_major, reverse = hp < 2, hp % 2 == 1
        steps, lanes = (w, h) if x_major else (h, w)
        last = steps - 1
        vp_major = vp_col if x_major else vp_row
        vp_minor = torch.tensor(vp_row if x_major else vp_col, dtype=f32)
        vpm = (torch.tensor(last, dtype=f32) - torch.tensor(vp_major, dtype=f32)
               if reverse else torch.tensor(vp_major, dtype=f32))
        k0 = (last - vp_major if reverse else vp_major) + 1
        src = slope_t if x_major else slope
        minor = torch.arange(lanes, dtype=f32) - vp_minor
        ady = minor.abs()
        lane = torch.arange(lanes)
        cur = torch.full((lanes,), neginf, dtype=f32)
        for k in range(k0, steps):
            dxf = torch.tensor(k, dtype=f32) - vpm
            wden = torch.clamp(dxf, min=1.0)
            line = last - k if reverse else k
            cone = ady <= dxf
            prim = cur
            up = torch.where(lane > 0, cur.roll(1), neginf)
            down = torch.where(lane + 1 < lanes, cur.roll(-1), neginf)
            sec = torch.where(minor > 0, up, torch.where(minor < 0, down,
                                                         prim))
            wsec = torch.where(ady > 0, ady / wden, 0.0)
            interp = torch.where(
                torch.isfinite(prim) & torch.isfinite(sec),
                prim * (1.0 - wsec) + sec * wsec, torch.maximum(prim, sec))
            blocked = torch.full_like(interp, neginf) if dxf == 1.0 \
                else interp
            m = torch.maximum(blocked, src[line])
            nxt = torch.where(cone, m, cur)
            if x_major:
                out[:, line] = torch.where(cone, m, out[:, line])
            else:
                own = ady < dxf
                out[line] = torch.where(own, m, out[line])
            cur = nxt
    return out


def emulate_xdraw_banded(slope, vp_row, vp_col, band=None, chunk=None):
    """``xdraw_banded_kernel``'s algorithm as ``xdraw_banded_launch`` runs
    it on one card: the whole raster one window of all its steps from
    -inf, ``emulate_xdraw_strip`` on a single strip of each orientation.
    A cell no band writes stays NaN, which the tests would see.  `band`
    and `chunk` default to ``viewshed.xdraw_plan``'s."""
    h, w = slope.shape
    plan = TV.xdraw_plan(h, w, band=band, chunk=chunk)
    out = torch.full((h, w), float("nan"), dtype=torch.float32)

    def whole(lanes):
        carry = torch.full((2, lanes), float("-inf"))
        return TV.StripHalf(slope, out, carry, carry.clone(), 0, lanes)
    emulate_xdraw_strip(whole(h), whole(w), h, w, vp_row, vp_col, 0,
                        TV.XDrawStripPlan(max(h, w), *plan), None, None, 0)
    return out


def emulate_xdraw_strip(rows, cols, h, w, vp_row, vp_col, s0, plan, slots,
                        progress, pbase):
    """``xdraw_banded_kernel``'s algorithm on CPU tensors, with
    ``cuda_xdraw.xdraw_strip_cuda``'s arguments (`slots` and `progress`
    are not used: a dict of slots, NaN where no band wrote, stands for
    them).  For each half-plane, the bands of its window [buf_lo, lane_hi)
    in bands of ``plan.band`` lanes walk the window's steps [max(s0, k0),
    min(s0 + L, steps)) in chunks of ``plan.chunk`` from the chunk where
    their nearest lane enters the cone; a band that starts at the window's
    first chunk takes its window's lanes from the carry-in row, a later
    chunk its halo from the owning bands' slots; the bands write their
    cone cells (east and west all, south and north off the diagonals),
    east the viewpoint while its step is in the window, and their lanes
    after the window into the carry-out row."""
    band, chunk, steps_win = plan.band, plan.chunk, plan.steps
    f32 = torch.float32
    neginf = float("-inf")
    for hp in range(4):
        half = (rows, rows, cols, cols)[hp]
        if half is None:
            continue
        x_major, reverse = hp < 2, hp % 2 == 1
        steps, lanes = (w, h) if x_major else (h, w)
        last = steps - 1
        vp_major = vp_col if x_major else vp_row
        vp_lane = vp_row if x_major else vp_col
        vpm_i = last - vp_major if reverse else vp_major
        vpm = (torch.tensor(last, dtype=f32) - torch.tensor(vp_major,
                                                            dtype=f32)
               if reverse else torch.tensor(vp_major, dtype=f32))
        k0 = vpm_i + 1
        s_lo, s_hi = max(s0, k0), min(s0 + steps_win, steps)
        n_chunks = -(-(s_hi - s_lo) // chunk) if s_hi > s_lo else 0
        lo, hi = half.buf_lo, half.lane_hi
        nb = -(-(hi - lo) // band)
        vpb = (-1 if vp_lane < lo else nb if vp_lane >= hi
               else (vp_lane - lo) // band)
        # [line, buffer lane] views of the slope and the field
        src = half.src.t() if x_major else half.src
        out = half.out.t() if x_major else half.out
        c_in, c_out = half.carry_in[hp % 2], half.carry_out[hp % 2]
        if hp == 0 and 0 <= vpb < nb and s0 <= vpm_i < s0 + steps_win:
            out[vp_col, vp_row - lo] = neginf
        if nb == 0:
            continue

        def first_chunk(b0, b1):
            near = (b0 - vp_lane if b0 > vp_lane
                    else vp_lane - (b1 - 1) if b1 <= vp_lane else 0)
            k = vpm_i + max(near, 1)
            if k >= s_hi:
                return n_chunks
            return 0 if k < s_lo else (k - s_lo) // chunk

        o = torch.arange(nb)
        b0 = lo + o * band
        b1 = torch.clamp(b0 + band, max=hi)
        firsts = torch.tensor([first_chunk(int(a), int(b))
                               for a, b in zip(b0, b1)])
        wlo = torch.where(o > vpb, torch.clamp(b0 - chunk,
                                               min=max(vp_lane, lo)), b0)
        whi = torch.where(o < vpb, torch.clamp(b1 + chunk,
                                               max=min(vp_lane + 1, hi)), b1)
        hlo = torch.where(o > vpb, wlo, b1)
        hhi = torch.where(o > vpb, b0, whi)
        wmax = band + chunk
        lane = wlo[:, None] + torch.arange(wmax)[None, :]
        valid = lane < whi[:, None]
        lane_c = torch.clamp(lane, min=lo, max=hi - 1)
        own = valid & (lane >= b0[:, None]) & (lane < b1[:, None])
        halo = valid & (lane >= hlo[:, None]) & (lane < hhi[:, None])
        minor = lane.to(f32) - torch.tensor(vp_lane, dtype=f32)
        ady = minor.abs()
        cur = torch.full((nb, wmax + 2), neginf, dtype=f32)
        start = (firsts == 0)[:, None] & valid
        cur[:, 1:-1] = torch.where(start, c_in[lane_c - lo], neginf)
        slot = {}
        for c in range(n_chunks):
            active = (c >= firsts)[:, None]
            if c > 0:
                started = c - 1 >= firsts[(lane_c - lo) // band]
                taken = torch.where(started, slot[c][lane_c - lo], neginf)
                cur[:, 1:-1] = torch.where(halo & active, taken, cur[:, 1:-1])
            s = s_lo + c * chunk
            for k in range(s, min(s + chunk, s_hi)):
                dxf = torch.tensor(k, dtype=f32) - vpm
                line = last - k if reverse else k
                prim, left, right = cur[:, 1:-1], cur[:, :-2], cur[:, 2:]
                sec = torch.where(minor > 0, left,
                                  torch.where(minor < 0, right, prim))
                wsec = torch.where(ady > 0, ady / torch.clamp(dxf, min=1.0),
                                   0.0)
                interp = torch.where(
                    torch.isfinite(prim) & torch.isfinite(sec),
                    TV._xdraw_interp(prim, sec, wsec),
                    torch.maximum(prim, sec))
                blocked = torch.full_like(interp, neginf) if dxf == 1.0 \
                    else interp
                m = torch.maximum(blocked, src[line][lane_c - lo])
                cone = valid & active & (ady <= dxf)
                write = own & cone & (x_major | (ady < dxf))
                out[line][(lane - lo)[write]] = m[write]
                cur = torch.cat([cur[:, :1], torch.where(cone, m, prim),
                                 cur[:, -1:]], 1)
            nxt = torch.full((hi - lo,), float("nan"), dtype=f32)
            done = own & active
            nxt[(lane - lo)[done]] = cur[:, 1:-1][done]
            slot[c + 1] = nxt
        done = own & (firsts < n_chunks)[:, None]
        c_out[(lane - lo)[done]] = cur[:, 1:-1][done]


# -- the bump rounds (X2) ------------------------------------------------------

def emulate_bump_rounds(out, locs, heights, spread, threshold=None):
    """``bump_rounds_kernel``'s algorithm on `out` (H, W) float64, in
    place; returns (rounds, bumps done in them, bumps the walk took).

    A round runs while bumps remain and the last round (at first: every
    bump) made at least `threshold` ready (default the plan's): each
    remaining bump claims its footprint in a 64-bit owner map with the
    max of (round << 32) | ~index; a bump whose key survives on every
    footprint cell is ready and applied (its height to the centre, then
    centre * k to the ring: ``index_add_`` over pairwise distinct
    cells); the others stay, in order.  The rest goes to the twin's walk
    in order."""
    if threshold is None:
        threshold = TB.rounds_threshold()
    h, w = out.shape
    n = locs.shape[0]
    xs = locs[:, 0].long()
    ys = locs[:, 1].long()
    if spread > 0:
        oy, ox, k = TB.ring_offsets(spread)
    else:
        oy, ox, k = np.zeros(1, np.int64), np.zeros(1, np.int64), None
    ny = ys[:, None] + torch.from_numpy(oy)[None, :]
    nx = xs[:, None] + torch.from_numpy(ox)[None, :]
    inside = (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)
    cells = torch.where(inside, ny * w + nx, h * w)       # spare cell h * w
    buf = torch.zeros(h * w + 1, dtype=torch.float64)
    buf[:h * w] = out.reshape(-1)
    owner = torch.zeros(h * w + 1, dtype=torch.int64)
    remaining = torch.arange(n)
    ready_count, rounds, round_bumps = n, 0, 0
    while remaining.numel() and ready_count >= threshold:
        rounds += 1
        key = (rounds << 32) | (0xFFFFFFFF - remaining)
        fp = cells[remaining]
        owner.scatter_reduce_(0, fp.reshape(-1),
                              key[:, None].expand_as(fp).reshape(-1),
                              "amax")
        ready = ((owner[fp] == key[:, None]) | ~inside[remaining]).all(1)
        done = remaining[ready]
        centre = ys[done] * w + xs[done]
        buf.index_add_(0, centre, heights[done].double())
        if spread > 0:
            cv = buf[centre]
            buf.index_add_(0, cells[done].reshape(-1),
                           (cv[:, None] * torch.from_numpy(k)[None, :])
                           .reshape(-1))
        ready_count = int(ready.sum())
        round_bumps += ready_count
        remaining = remaining[~ready]
    out.copy_(buf[:h * w].view(h, w))
    TB.bump_scan_twin(out, locs[remaining], heights[remaining], spread)
    return rounds, round_bumps, int(remaining.numel())
