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
- ``blocks_of`` and ``emulate_culled``: ``csrc/screen.cu::
  screen_culled_kernel`` (B7's culled route), against
  ``screen.screen_hilo``; ``blocks_of`` also gives the (warp, chunk)
  pairs the kernel keeps, which the card's tests hold its counters to.

Also the proximity family's test cases (``layout``, ``axes``) and
tolerances, which several test files share.  Nothing in the package
calls any of these.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import focal_halo as fh
from . import screen as TS
from . import surface as TSU

__all__ = ["emulate_staged", "ring_schedule", "emulate_surface_staged",
           "emulate_pipeline", "halo_case", "same_bits", "SCREEN_R",
           "SCREEN_WARP", "SCREEN_BLOCK", "group_segments", "blocks_of",
           "emulate_culled", "TOL", "GC_RTOL", "layout", "axes"]


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
    (``load6``), and only cells inside the raster written.  The products
    come from the nine neighbour rasters through the twins' functions."""
    h, w = x.shape
    th, tw = tile
    plan = TSU.surface_plan(h, w, 0, tile, sms)
    cols, rows = plan.box
    ty, tx = -(-h // th), -(-w // tw)
    big = F.pad(x, (4, tx * tw + cols, 1, ty * th + rows), value=math.nan)
    walked = {}
    for _, _, t, _, _ in ring_schedule(plan.tiles, plan.grid, plan.stages):
        r0, c0 = t // tx * th, t % tx * tw
        # window (r, c) = raster (r0 - 1 + r, c0 - 4 + c) = big (r0 + r,
        # c0 + c)
        walked[t] = big[r0:r0 + rows, c0:c0 + cols].reshape(-1)
    if sorted(walked) != list(range(plan.tiles)):
        raise AssertionError("the persistent loop missed or repeated a tile")
    wins = torch.stack([walked[t] for t in range(plan.tiles)])
    q = torch.arange(th * tw // 4)
    tr, tc = q // (tw // 4), 4 * (q % (tw // 4))
    p = (tr * cols + tc)[:, None]                 # window float of (tr, tc)
    j = torch.arange(4)[None, :]
    nb = []
    for dr in range(3):                           # rows above, at, below
        for dc in range(3):
            idx = (p + dr * cols + 3 + j + dc).reshape(-1)
            cells = wins[:, idx].reshape(-1, th, tw)  # quads in row order
            nb.append(_tiles_to_raster(cells, ty, tx, h, w))
    return _products(tuple(nb), tuple(which), cellsize_x, cellsize_y,
                     azimuth, angle_altitude)


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
