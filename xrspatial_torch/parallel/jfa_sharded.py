"""The jump flood over a mesh: the round kernel per block, behind halos.

Counterpart of ``xrspatial_tpu/parallel/jfa_sharded.py``.  The state
lies in the raster's tiles, one per block of the mesh, and each round
refreshes what the round reads from the other tiles:

- strides up to ``SMALL_STRIDE_MAX`` (256, the JAX package's tile width;
  11 of the 16 rounds at 16384^2): each tile's state (fill -1, no target)
  and value channel (fill 0.0) is extended by a width-k halo
  (``halo.halo_extend``) and one round runs on the extended block, on the
  round kernel (``csrc/jfa.cu``, B6) on the card or its twin on the CPU,
  the block's origin in the whole raster passed so that the packed keys
  see global indices; the tile is cropped from the result;
- larger strides run as torch ops: each of the 8 shifted candidates of a
  tile is assembled from the at most 2 x 2 tiles it overlaps
  (``halo.shifted_blocks``), as the JAX package's global shift rounds,
  so no block ever holds more than a tile.

MANHATTAN on monotone axes takes the exact scan transform instead, as on
one device (``manhattan_sharded``): its column and row scans run tile
after tile along each column and row of blocks, a carry of one row or
column handed from each tile to the next.

The packed state's targets stay global ``iy << 15 | ix``: they are not
shifted into a block's coordinates, where targets carried in from far
tiles would go negative and the packing has no sign.  The coordinate
state (great circle, or axes the packed plan refuses) goes the same
way, each extended block with the coordinates of its cells (clamped to
the raster beyond it, where the cells are cropped).

Exactness: a round at stride k reads cells at most k away, and the halo
or window taken just before it holds their round-start state, so each
tile computes the cells the unsharded round computes, with the same
operations in the same order: the result equals the unsharded
``jump_flood`` bit for bit wherever the round kernel equals its twin
(every metric but great circle, whose card trig may differ from torch's
by an ulp in the torch-op rounds).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels.jfa_rounds import (CANDIDATES, PACK_BITS, PACK_MASK,
                                  coords_key, key_packed)
from .halo import HaloSpec, ShardedRaster, halo_extend, shifted_blocks, tiles

__all__ = ["jump_flood_sharded", "manhattan_sharded", "SMALL_STRIDE_MAX"]

# strides up to this run one round kernel launch per block behind a halo
SMALL_STRIDE_MAX = 256


def _grid(x: ShardedRaster, blocks) -> ShardedRaster:
    """A raster of `x`'s layout and spatial shape holding `blocks`."""
    return ShardedRaster(blocks, tuple(blocks[0][0].shape[:-2])
                         + x.shape[-2:], x.mesh, x.split)


def _cells(x: ShardedRaster, i: int, j: int):
    """int32 (rows, 1) and (1, cols) global indices of tile (i, j)."""
    dev = x.blocks[i][j].device
    (y0, y1), (x0, x1) = x.extent(0, i), x.extent(1, j)
    iy = torch.arange(y0, y1, dtype=torch.int32, device=dev)[:, None]
    ix = torch.arange(x0, x1, dtype=torch.int32, device=dev)[None, :]
    return iy, ix


def _coords(x: ShardedRaster, i: int, j: int, xs, ys):
    """float32 (1, cols) and (rows, 1) coordinates of tile (i, j)."""
    dev = x.blocks[i][j].device
    (y0, y1), (x0, x1) = x.extent(0, i), x.extent(1, j)
    return (torch.from_numpy(xs[x0:x1]).to(dev)[None, :],
            torch.from_numpy(ys[y0:y1]).to(dev)[:, None])


def _ext_coords(n: int, start: int, size: int, cs, dev):
    """The coordinates of an extended block's cells along one axis, from
    global index `start`, clamped to the raster."""
    idx = np.clip(np.arange(start, start + size), 0, n - 1)
    return torch.from_numpy(np.ascontiguousarray(cs[idx])).to(dev)


def _small_round(planes, fills, k, run):
    """One round at stride k <= SMALL_STRIDE_MAX: extend every plane by k,
    call ``run(i, j, extended planes, origin)`` on each block and crop the
    tile from the planes it returns."""
    x = planes[0]
    ext = [halo_extend(p, HaloSpec(k, k), fill=f)
           for p, f in zip(planes, fills)]
    outs = [[None] * len(x.blocks[0]) for _ in x.blocks]
    for i, row in enumerate(x.blocks):
        for j, blk in enumerate(row):
            hl, wl = blk.shape
            oy, ox = x.extent(0, i)[0], x.extent(1, j)[0]
            res = run(i, j, [e[i][j] for e in ext], (oy - k, ox - k))
            outs[i][j] = [None if r is None else r[k:k + hl, k:k + wl]
                          for r in res]
    return [None if outs[0][0][q] is None else
            _grid(x, [[o[q] for o in row] for row in outs])
            for q in range(len(outs[0][0]))]


def _big_round(planes, fills, k, key):
    """One round at stride k > SMALL_STRIDE_MAX as torch ops: for each
    candidate (sy, sx) the windows of every plane shifted by (sy*k, sx*k);
    ``key(i, j, planes)`` gives the keys of a block's planes.  Returns the
    new planes and the keys."""
    x = planes[0]
    cur = [[[p.blocks[i][j] for p in planes] for j in range(len(row))]
           for i, row in enumerate(x.blocks)]
    best = [[key(i, j, cur[i][j]) for j in range(len(row))]
            for i, row in enumerate(x.blocks)]
    for sy, sx in CANDIDATES:
        cands = [shifted_blocks(p, sy * k, sx * k, f)
                 for p, f in zip(planes, fills)]
        for i, row in enumerate(cur):
            for j, own in enumerate(row):
                cand = [c[i][j] for c in cands]
                nd = key(i, j, cand)
                better = nd < best[i][j]
                cur[i][j] = [torch.where(better, c, o)
                             for c, o in zip(cand, own)]
                best[i][j] = torch.where(better, nd, best[i][j])
        del cands
    return ([_grid(x, [[c[q] for c in row] for row in cur])
             for q in range(len(planes))], _grid(x, best))


def _packed(mask, values, strides, metric, plan):
    from ..kernels.jfa import _metric_finalize, _round_packed
    steps, (y0, x0) = plan
    with_val = values is not None
    state, value = [], []
    for i, row in enumerate(mask.blocks):
        srow, vrow = [], []
        for j, m in enumerate(row):
            iy, ix = _cells(mask, i, j)
            srow.append(torch.where(m, (iy << PACK_BITS) | ix, -1))
            if with_val:
                vrow.append(torch.where(m, values.blocks[i][j].to(
                    torch.float32), 0.0))
        state.append(srow)
        value.append(vrow)
    planes = [_grid(mask, state)] + ([_grid(mask, value)] if with_val
                                     else [])
    fills = (-1, 0.0)[:len(planes)]

    def key(i, j, cand):
        iy, ix = _cells(mask, i, j)
        return key_packed(iy, ix, cand[0], metric, steps)

    best = None
    for n, k in enumerate(int(s) for s in strides):
        last = n == len(strides) - 1
        if k > SMALL_STRIDE_MAX:
            planes, best = _big_round(planes, fills, k, key)
            continue

        def run(i, j, ext, origin, k=k, last=last):
            s, v, b = _round_packed(ext[0], ext[1] if with_val else None, k,
                                    metric, steps, emit_best=last,
                                    origin=origin)
            return [s, v, b]

        res = _small_round(planes, fills, k, run)
        planes = [res[0]] + ([res[1]] if with_val else [])
        best = res[2]
    out = [[None] * len(row) for row in mask.blocks]
    for i, row in enumerate(mask.blocks):
        for j in range(len(row)):
            s = planes[0].blocks[i][j]
            valid = s >= 0
            tiy = (s >> PACK_BITS).to(torch.float32)
            tix = (s & PACK_MASK).to(torch.float32)
            # bitwise-verified reconstruction (packed_state_plan)
            out[i][j] = (_metric_finalize(best.blocks[i][j], metric),
                         torch.where(valid, x0 + tix * steps[1], math.inf),
                         torch.where(valid, y0 + tiy * steps[0], math.inf),
                         planes[1].blocks[i][j] if with_val else None)
    return _unzip(mask, out)


def _coordinates(mask, values, xs, ys, strides, metric):
    from ..kernels.jfa import _metric_finalize, _round_coords
    h, w = mask.shape
    with_val = values is not None
    tx, ty, value = [], [], []
    for i, row in enumerate(mask.blocks):
        txr, tyr, vr = [], [], []
        for j, m in enumerate(row):
            px, py = _coords(mask, i, j, xs, ys)
            txr.append(torch.where(m, px, math.inf))
            tyr.append(torch.where(m, py, math.inf))
            if with_val:
                vr.append(torch.where(m, values.blocks[i][j].to(
                    torch.float32), 0.0))
        tx.append(txr)
        ty.append(tyr)
        value.append(vr)
    planes = [_grid(mask, tx), _grid(mask, ty)] + (
        [_grid(mask, value)] if with_val else [])
    fills = (math.inf, math.inf, 0.0)[:len(planes)]

    def key(i, j, cand):
        px, py = _coords(mask, i, j, xs, ys)
        return coords_key(px, py, cand[0], cand[1], metric)

    for k in (int(s) for s in strides):
        if k > SMALL_STRIDE_MAX:
            planes, _ = _big_round(planes, fills, k, key)
            continue

        def run(i, j, ext, origin, k=k):
            dev = ext[0].device
            ecx = _ext_coords(w, origin[1], ext[0].shape[1], xs, dev)
            ecy = _ext_coords(h, origin[0], ext[0].shape[0], ys, dev)
            return list(_round_coords(ext[0], ext[1],
                                      ext[2] if with_val else None, ecx,
                                      ecy, k, metric))

        res = _small_round(planes, fills, k, run)
        planes = res[:2] + ([res[2]] if with_val else [])
    out = [[None] * len(row) for row in mask.blocks]
    for i, row in enumerate(mask.blocks):
        for j in range(len(row)):
            tx_b, ty_b = planes[0].blocks[i][j], planes[1].blocks[i][j]
            best = key(i, j, [tx_b, ty_b])
            out[i][j] = (_metric_finalize(best, metric), tx_b, ty_b,
                         planes[2].blocks[i][j] if with_val else None)
    return _unzip(mask, out)


def _unzip(x, out):
    """Four rasters (the fourth None without values) from a grid of
    4-tuples."""
    return tuple(None if out[0][0][q] is None else
                 _grid(x, [[o[q] for o in row] for row in out])
                 for q in range(4))


def _scan_min(key, payloads, reverse: bool):
    """Running minimum of `key` (rows, cols) along the columns, from the
    left (from the right with `reverse`), and the `payloads` at the
    column that holds it; ties go to the column nearest the scan's
    position, as ``torch.cummin`` keeps the last of equal minima."""
    if reverse:
        v, i = _scan_min(key.flip(1), [p.flip(1) for p in payloads], False)
        return v.flip(1), [q.flip(1) for q in i]
    v, idx = torch.cummin(key, dim=1)
    return v, [torch.gather(p.expand_as(key).contiguous(), 1, idx)
               for p in payloads]


def _carried(v, picks, carry, reverse: bool):
    """A tile's running minimum joined to the carry from the tiles before
    it along the scan: the carry wins only where strictly smaller (the
    tile's own columns lie nearer).  Returns the joined planes and the
    carry for the next tile (the column where the scan leaves)."""
    if carry is not None:
        # the carry comes from the previous tile's device
        cv = carry[0].to(v.device)
        cp = [c.to(v.device) for c in carry[1]]
        take = cv < v
        v = torch.where(take, cv, v)
        picks = [torch.where(take, c, p) for c, p in zip(cp, picks)]
    if not v.shape[1]:          # an empty tile hands the carry on
        return v, picks, carry
    edge = 0 if reverse else v.shape[1] - 1
    return v, picks, (v[:, edge:edge + 1],
                      [p[:, edge:edge + 1] for p in picks])


def _column_scan(planes, reverse: bool):
    """For each cell of a column of tiles (top to bottom), the target
    planes `planes` (rows, cols each, inf / 0.0 where no target) of the
    last target at or above it (at or below it, with `reverse`), carried
    across the tiles; (inf, 0.0) where there is none."""
    order = range(len(planes)) if not reverse else \
        range(len(planes) - 1, -1, -1)
    out = [None] * len(planes)
    carry = None
    for i in order:
        ty, val = planes[i]
        rows = ty.shape[0]
        rix = torch.arange(rows, device=ty.device)[:, None]
        valid = torch.isfinite(ty)
        if not reverse:
            idx = torch.cummax(torch.where(valid, rix, -1), dim=0).values
        else:
            idx = torch.cummin(torch.where(valid, rix, rows).flip(0),
                               dim=0).values.flip(0)
        found = (idx >= 0) & (idx < rows)
        safe = idx.clamp(0, max(rows - 1, 0))
        # the carry comes from the previous tile's device
        got = [torch.where(found, torch.gather(p, 0, safe),
                           c.to(ty.device) if torch.is_tensor(c) else c)
               for p, c in zip((ty, val), carry or (math.inf, 0.0))]
        out[i] = got
        if rows:
            edge = 0 if reverse else rows - 1
            carry = [g[edge:edge + 1] for g in got]
    return out


def manhattan_sharded(mask: ShardedRaster, values, xs, ys, need_coords,
                      flip_x):
    """``kernels/jfa.py::_manhattan_flipped`` over a mesh: the exact
    separable scan transform with its scans carried across the tiles, in
    order along each row and column of blocks; every tile computes its
    own cells with the unsharded transform's operations, so the result
    equals it bit for bit.  `flip_x` (a descending x-axis) reverses the
    direction of the row scans instead of the raster."""
    ny, nx = mask.mesh.shape["y"], mask.mesh.shape["x"]
    coords = [[_coords(mask, i, j, xs, ys) for j in range(nx)]
              for i in range(ny)]
    ty0 = [[torch.where(mask.blocks[i][j], coords[i][j][1], math.inf)
            for j in range(nx)] for i in range(ny)]
    pay0 = [[torch.where(mask.blocks[i][j], values.blocks[i][j].to(
        torch.float32), 0.0) if values is not None
        else torch.zeros_like(ty0[i][j]) for j in range(nx)]
        for i in range(ny)]
    # phase 1: each column's nearest target in y, above and below
    g, col_ty, col_val = ([[None] * nx for _ in range(ny)]
                          for _ in range(3))
    for j in range(nx):
        col = [(ty0[i][j], pay0[i][j]) for i in range(ny)]
        dn = _column_scan(col, False)
        up = _column_scan(col, True)
        for i in range(ny):
            py = coords[i][j][1]
            (d, dv), (u, uv) = dn[i], up[i]
            gd = torch.where(torch.isfinite(d), (py - d).abs(), math.inf)
            gu = torch.where(torch.isfinite(u), (py - u).abs(), math.inf)
            use_d = gd <= gu
            g[i][j] = torch.minimum(gd, gu)
            col_ty[i][j] = torch.where(use_d, d, u)
            col_val[i][j] = torch.where(use_d, dv, uv)
    # phase 2: min-plus along each row of tiles, toward ascending x
    out = [[None] * nx for _ in range(ny)]
    for i in range(ny):
        left, right = [None] * nx, [None] * nx
        for reverse, is_left, dest in ((flip_x, True, left),
                                       (not flip_x, False, right)):
            carry = None
            for j in (range(nx - 1, -1, -1) if reverse else range(nx)):
                x = coords[i][j][0]
                gg = g[i][j]
                key = torch.where(torch.isfinite(gg),
                                  gg - x if is_left else gg + x, math.inf)
                v, picks = _scan_min(key, [x, col_ty[i][j], col_val[i][j]],
                                     reverse)
                v, picks, carry = _carried(v, picks, carry, reverse)
                dest[j] = (v, picks)
        for j in range(nx):
            x = coords[i][j][0]
            (lv, lp), (rv, rp) = left[j], right[j]
            dl = lv + x
            dr = rv - x
            lwins = dl <= dr
            dist = torch.where(lwins, dl, dr)
            fin = torch.isfinite(dist)
            pick = [torch.where(lwins, a, b) for a, b in zip(lp, rp)]
            if not need_coords and values is None:
                none_tx = torch.where(fin, 0.0, math.inf)
                out[i][j] = (dist, none_tx, none_tx, None)
                continue
            if need_coords:
                tx = torch.where(fin, pick[0], math.inf)
                ty = torch.where(fin, pick[1], math.inf)
            else:
                tx = ty = torch.where(fin, 0.0, math.inf)
            tval = torch.where(fin, pick[2], 0.0) if values is not None \
                else None
            out[i][j] = (dist, tx, ty, tval)
    return _unzip(mask, out)


def jump_flood_sharded(target_mask: ShardedRaster, values, xs, ys,
                       metric: int, strides, packed_plan,
                       manhattan_plan=None, need_coords=True):
    """``kernels/jfa.py::jump_flood`` over a mesh.

    `target_mask` is a bool ``ShardedRaster``, `values` one of the same
    layout or None, `xs` (w,) and `ys` (h,) the cells' coordinates
    (numpy float32), `strides` the round schedule and `packed_plan` the
    ``packed_state_plan`` result (None: the coordinate state); a
    `manhattan_plan` (``manhattan_scan_plan``'s flip_x) takes the scan
    transform instead, which skips its coordinate payload without
    `need_coords`.  Returns
    (distance, target_x, target_y, target_value or None), each a
    ``ShardedRaster`` split on both axes over the same mesh.
    """
    mask = tiles(target_mask)
    values = None if values is None else tiles(values)
    if manhattan_plan is not None:
        return manhattan_sharded(mask, values, np.asarray(xs, np.float32),
                                 np.asarray(ys, np.float32), need_coords,
                                 manhattan_plan)
    if packed_plan is not None:
        return _packed(mask, values, strides, metric, packed_plan)
    return _coordinates(mask, values, np.asarray(xs, np.float32),
                        np.asarray(ys, np.float32), strides, metric)
