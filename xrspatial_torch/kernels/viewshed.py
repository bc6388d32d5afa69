"""Viewshed: GRASS r.viewshed semantics, reformulated data-parallel.

Counterpart of ``xrspatial_tpu/kernels/viewshed.py``.  A
cell C is visible iff no cell B that is closer to the viewpoint and whose
angular span (enter/exit corner angles) covers C's center angle has an
interpolated gradient (piecewise-linear between enter/center/exit
gradients) above C's gradient: the predicate the reference's radial sweep
evaluates at every CENTER event, without the tree.

Three parts:
- host code in numpy float64 (``cell_attrs_host``, ``cell_attrs_subset``
  and their helpers), copied from the JAX package as it is: it is the
  single source of the predicate attributes, so both packages' attributes
  are equal bit for bit;
- device code as torch float64 ops on the raster's device: the shared
  predicate ``_interp_blocked_max``, the pairwise oracle
  ``_pairwise_visibility`` / ``viewshed_grid`` (O(N^2), the reference the
  bucket path in ``viewshed_exact.py`` is held against) and the vertical-
  angle epilogue;
- the XDraw approximation (``viewshed_grid_los``), float32: on the card
  the slope fields and the epilogue one launch each of
  ``csrc/xdraw_cells.cu`` and the four half-plane scans one launch of
  ``csrc/xdraw.cu`` (bands of lanes across the SMs, planned by
  ``xdraw_plan``); on the CPU the fields and the epilogue as torch ops
  (``_xdraw_fields``, ``_xdraw_epilogue``: the kernels' plain versions)
  and the scans in the twin ``xdraw_scan_twin``; on a mesh
  (``viewshed_grid_los_mesh``, the JAX package's banded distributed
  scan) the scans run on strips of lanes over the flattened mesh, a
  window of L steps a launch of the strip route of
  ``csrc/xdraw.cu`` on the card (``xdraw_strip_twin`` on the CPU), with
  the halo carries exchanged between windows.
"""

from __future__ import annotations

from math import pi as PI
from typing import NamedTuple

import numpy as np
import torch

from ..parallel.halo import _sources
from ..tracing import count, span
from .staged import SMEM_PER_BLOCK, SMEM_PER_SM

__all__ = ["viewshed_grid", "viewshed_grid_los", "xdraw_scan_twin",
           "xdraw_max_slope", "xdraw_plan", "XDrawPlan", "cell_attrs_host",
           "cell_attrs_subset", "INVISIBLE"]

INVISIBLE = -1


def _calculate_angle(ex, ey, vx, vy, xp=torch):
    """Vectorized angle of (ex, ey) seen from (vx, vy), in [0, 2pi).

    `xp` selects the array module: numpy for the host attributes, torch for
    the device expansion of the interval screen.
    """
    ang = xp.arctan(xp.abs(ey - vy) / xp.where(ex == vx, 1.0,
                                               xp.abs(ex - vx)))
    q1 = (ex > vx) & (ey < vy)
    q2 = (vx > ex) & (vy > ey)
    q3 = (vx > ex) & (vy < ey)
    q4 = (vx < ex) & (vy < ey)
    out = xp.where(q1, ang,
          xp.where(q2, PI - ang,
          xp.where(q3, PI + ang,
          xp.where(q4, 2.0 * PI - ang, 0.0))))
    out = xp.where((vx == ex) & (vy > ey), PI / 2.0, out)
    out = xp.where((vx == ex) & (vy < ey), 3.0 * PI / 2.0, out)
    out = xp.where((vy == ey) & (ex > vx), 0.0, out)
    out = xp.where((vy == ey) & (vx > ex), PI, out)
    out = xp.where((ex == vx) & (ey == vy), 0.0, out)
    return out


def _corner_offsets(rows, cols, vp_row, vp_col, xp=torch):
    """(enter_dy, enter_dx, exit_dy, exit_dx) per cell: the reference's
    quadrant table, vectorized.  The offsets are 0 or +-0.5, exact in any
    float type."""
    north = rows < vp_row
    south = rows > vp_row
    west = cols < vp_col
    east = cols > vp_col
    same_row = rows == vp_row
    same_col = cols == vp_col

    # enter corner
    e_dy = xp.where(north & west, -0.5,
            xp.where(north & same_col, 0.5,
            xp.where(north & east, 0.5,
            xp.where(same_row & east, 0.5,
            xp.where(south & east, 0.5,
            xp.where(south & same_col, -0.5,
            xp.where(south & west, -0.5,
            xp.where(same_row & west, -0.5, 0.0))))))))
    e_dx = xp.where(north & west, 0.5,
            xp.where(north & same_col, 0.5,
            xp.where(north & east, 0.5,
            xp.where(same_row & east, -0.5,
            xp.where(south & east, -0.5,
            xp.where(south & same_col, -0.5,
            xp.where(south & west, -0.5,
            xp.where(same_row & west, 0.5, 0.0))))))))
    # exit corner
    x_dy = xp.where(north & west, 0.5,
            xp.where(north & same_col, 0.5,
            xp.where(north & east, -0.5,
            xp.where(same_row & east, -0.5,
            xp.where(south & east, -0.5,
            xp.where(south & same_col, -0.5,
            xp.where(south & west, 0.5,
            xp.where(same_row & west, 0.5, 0.0))))))))
    x_dx = xp.where(north & west, -0.5,
            xp.where(north & same_col, -0.5,
            xp.where(north & east, -0.5,
            xp.where(same_row & east, -0.5,
            xp.where(south & east, 0.5,
            xp.where(south & same_col, 0.5,
            xp.where(south & west, 0.5,
            xp.where(same_row & west, 0.5, 0.0))))))))
    return e_dy, e_dx, x_dy, x_dx


def _np_rects(h, w, vp_row, vp_col):
    """The 3x3 rectangle partition of the grid around the viewpoint:
    row bands [0, vp), [vp, vp+1), (vp, h) x same for columns.  Every
    quadrant mask in the attrs helpers is a union of these rectangles,
    so the host fast paths below replace full-array `where` chains with
    slab writes, bit-identically."""
    r = (slice(0, vp_row), slice(vp_row, vp_row + 1), slice(vp_row + 1, h))
    c = (slice(0, vp_col), slice(vp_col, vp_col + 1), slice(vp_col + 1, w))
    return r, c


def _calculate_angle_np(drows, dcols):
    """Host fast path of `_calculate_angle`: identical values, masked
    writes instead of the 9-deep where chain.  ``drows``/``dcols`` are
    ey - vy and ex - vx; all quantities are exact half-integers in f64
    so the pre-subtraction loses nothing."""
    h, w = drows.shape
    ex_eq = dcols == 0.0
    ang = np.arctan(np.abs(drows) / np.where(ex_eq, 1.0, np.abs(dcols)))

    out = np.zeros((h, w), dtype=np.float64)
    q1 = (dcols > 0) & (drows < 0)
    q2 = (dcols < 0) & (drows < 0)
    q3 = (dcols < 0) & (drows > 0)
    q4 = (dcols > 0) & (drows > 0)
    out[q1] = ang[q1]
    out[q2] = PI - ang[q2]
    out[q3] = PI + ang[q3]
    out[q4] = 2.0 * PI - ang[q4]
    out[ex_eq & (drows < 0)] = PI / 2.0
    out[ex_eq & (drows > 0)] = 3.0 * PI / 2.0
    ey_eq = drows == 0.0
    out[ey_eq & (dcols > 0)] = 0.0
    out[ey_eq & (dcols < 0)] = PI
    out[ex_eq & ey_eq] = 0.0
    return out


def _corner_offsets_np(h, w, vp_row, vp_col):
    """Host fast path of `_corner_offsets`: the quadrant table written
    as 9 rectangle slabs per plane (bit-identical constants)."""
    r, c = _np_rects(h, w, vp_row, vp_col)
    planes = []
    # per-plane constants in (north, same_row, south) x (west, same_col,
    # east) order, transcribed from the generic where chain
    tables = (
        ((-0.5, 0.5, 0.5), (-0.5, 0.0, 0.5), (-0.5, -0.5, 0.5)),   # e_dy
        ((0.5, 0.5, 0.5), (0.5, 0.0, -0.5), (-0.5, -0.5, -0.5)),   # e_dx
        ((0.5, 0.5, -0.5), (0.5, 0.0, -0.5), (0.5, -0.5, -0.5)),   # x_dy
        ((-0.5, -0.5, -0.5), (0.5, 0.0, -0.5), (0.5, 0.5, 0.5)),   # x_dx
    )
    for tab in tables:
        plane = np.empty((h, w), dtype=np.float64)
        for i in range(3):
            for j in range(3):
                plane[r[i], c[j]] = tab[i][j]
        planes.append(plane)
    return tuple(planes)


def _corner_elev_np(data, vp_row, vp_col, enter, pad=None):
    """Host fast path of `_corner_elev`: the (sy, sx) selection masks
    are a 4-rectangle pinwheel around the viewpoint, so the 4-neighbor
    corner average is computed once per cell on its own slab.
    ``enter`` picks the enter- vs exit-corner pinwheel orientation;
    ``pad`` optionally supplies the NaN-padded plane."""
    h, w = data.shape
    p = np.pad(data, 1, constant_values=np.nan) if pad is None else pad
    out = data.copy()  # covers the viewpoint cell (zero offsets)
    vr, vc = vp_row, vp_col
    if enter:
        # (sy,sx) -> rect: NW+W, N+NE, E+SE, S+SW
        rects = (((-1, 1), (0, vr + 1, 0, vc)),
                 ((1, 1), (0, vr, vc, w)),
                 ((1, -1), (vr, h, vc + 1, w)),
                 ((-1, -1), (vr + 1, h, 0, vc + 1)))
    else:
        # exit corner: NW+N, NE+E, SE+S, SW+W
        rects = (((1, -1), (0, vr, 0, vc + 1)),
                 ((-1, -1), (0, vr + 1, vc + 1, w)),
                 ((-1, 1), (vr + 1, h, vc, w)),
                 ((1, 1), (vr, h, 0, vc)))
    for (sy, sx), (r0, r1, c0, c1) in rects:
        if r0 >= r1 or c0 >= c1:
            continue
        center = data[r0:r1, c0:c1]
        diag = p[1 + sy + r0:1 + sy + r1, 1 + sx + c0:1 + sx + c1]
        vert = p[1 + sy + r0:1 + sy + r1, 1 + c0:1 + c1]
        horiz = p[1 + r0:1 + r1, 1 + sx + c0:1 + sx + c1]
        avg = (diag + vert + horiz + center) / 4.0
        out[r0:r1, c0:c1] = np.where(np.isnan(avg), center, avg)
    return out


def _corner_diffs_np(d2, vp_row, vp_col, enter=True, pad=None):
    """`_corner_elev_np` evaluated on a difference plane (elev -
    vp_elev): same pinwheel rectangles and (diag+vert+horiz+center)/4
    association, but averaging DIFFS, equal to avg-then-subtract up to
    f64 association ulps.  Only the interval screen consumes this (its
    tolerance bands dominate the drift by >10^4); the exact f64 oracle
    paths keep `_corner_elev_np` on raw elevations."""
    return _corner_elev_np(d2, vp_row, vp_col, enter=enter, pad=pad)


def _gradient_np(dy_px, dx_px, elev, vp_elev, ew_res, ns_res, vp_cell):
    """Host fast path of `_gradient`: same formula evaluated with
    in-place ufuncs, the d2 == 0 guard applied as a scalar fix at
    ``vp_cell``: for every caller the pixel offsets are zero ONLY at
    the viewpoint (corner offsets are +-0.5 everywhere else)."""
    diff = elev - vp_elev
    d2 = dx_px * ew_res
    d2 *= d2
    t = dy_px * ns_res
    t *= t
    d2 += t
    r, c = vp_cell
    d2[r, c] = 1.0
    np.sqrt(d2, out=d2)
    np.divide(diff, d2, out=d2)
    grad = np.arctan(d2, out=d2)
    grad[r, c] = np.sign(diff[r, c]) * (PI / 2.0)
    return grad


def _corner_elev(data, dy_sign, dx_sign):
    """Mean of the 4 cells sharing the corner at (row+dy, col+dx); falls
    back to the cell's own value when any of the 4 is OOB/NaN.  The
    generic numpy form of `_corner_elev_np`, which the tests hold it to."""
    h, w = data.shape
    p = np.pad(data, 1, constant_values=np.nan)
    center = data

    def nb(dy, dx):
        return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    out = np.full((h, w), np.nan)
    for sy in (-1, 1):
        for sx in (-1, 1):
            diag = nb(sy, sx)
            vert = nb(sy, 0)
            horiz = nb(0, sx)
            avg = (diag + vert + horiz + center) / 4.0
            avg = np.where(np.isnan(avg), center, avg)
            sel = (dy_sign == sy * 0.5) & (dx_sign == sx * 0.5)
            out = np.where(sel, avg, out)
    return np.where((dy_sign == 0.0) & (dx_sign == 0.0), center, out)


def _gradient(dy_px, dx_px, elev, vp_elev, ew_res, ns_res):
    """atan((elev - vp_elev)/dist); +-pi/2 at the viewpoint.  The generic
    numpy form of `_gradient_np`, which the tests hold it to."""
    diff = elev - vp_elev
    d2 = (dx_px * ew_res) ** 2 + (dy_px * ns_res) ** 2
    grad = np.arctan(diff / np.sqrt(np.where(d2 == 0, 1.0, d2)))
    at_vp = d2 == 0
    return np.where(at_vp, np.sign(diff) * PI / 2.0, grad)


def _interp_blocked_max(al, key_t, idx_t, key_b, a0, a1, a2, g0, g1, g2,
                        valid_b, idx_b):
    """Max interpolated blocker gradient per target: the GRASS status-
    structure query, evaluated for a (C, 1) column of targets against a
    (1, E) row of candidate blockers (or with a leading batch axis).
    Shared by the pairwise oracle and the exact bucket path so both
    compute bit-identical results: the candidate SET may differ (the
    bucket path evaluates a superset of the covering cells) but inactive
    candidates contribute -inf and the float max is order-independent.
    No multiply feeds an add, so no fma can be contracted."""
    two_pi = 2.0 * PI
    crossing = a0 > a2
    cover = torch.where(crossing,
                        (al > a0) | (al < a2),
                        (al > a0) & (al < a2))
    closer = key_b < key_t
    not_self = idx_b != idx_t
    active = cover & closer & not_self & valid_b

    # interpolation in unwrapped angle coordinates
    a1e = torch.where(crossing & (a1 < a0), a1 + two_pi, a1)
    a2e = torch.where(crossing & (a2 < a0), a2 + two_pi, a2)
    ale = torch.where(crossing & (al < a0), al + two_pi, al)

    seg1 = ale < a1e
    seg2 = ale > a1e
    d10 = torch.where(a1e != a0, a1e - a0, 1.0)
    d21 = torch.where(a2e != a1e, a2e - a1e, 1.0)
    gi = torch.where(
        seg1, g1 + (g0 - g1) * (a1e - ale) / d10,
        torch.where(seg2,
                    g1 + (g2 - g1) * (ale - a1e) / d21,
                    g1))
    gi = torch.where(active, gi, -torch.inf)
    return torch.amax(gi, dim=-1)


def _pairwise_visibility(key, a0, a1, a2, g0, g1, g2, grad_t, is_vp,
                         chunk=256):
    """Max blocked gradient per cell -> visibility comparison.

    All inputs flat (N,) float64 on one device; evaluated in chunks of
    targets against every potential blocker.
    """
    n = key.shape[0]
    # blocker invalid if its gradients are NaN (NODATA never blocks)
    valid_b = torch.isfinite(g1) & ~is_vp
    idx = torch.arange(n, device=key.device)
    blocked = torch.empty(n, dtype=key.dtype, device=key.device)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        blocked[s:e] = _interp_blocked_max(
            a1[s:e, None], key[s:e, None], idx[s:e, None],
            key[None], a0[None], a1[None], a2[None],
            g0[None], g1[None], g2[None], valid_b[None], idx[None])
    return blocked <= grad_t


def cell_attrs_host(data_np, vp_row: int, vp_col: int, observer_elev: float,
                    target_elev: float, ew_res: float, ns_res: float):
    """All per-cell predicate attributes, computed ONCE on the host in
    numpy float64: the single source both exact paths consume.

    Returns a dict of flat (N,) float64 arrays: key (squared weighted
    distance), a0/a1/a2 (enter/center/exit angles), g0/g1/g2 (gradients),
    grad_t (target gradient), plus is_vp / valid_b masks.
    """
    data = np.asarray(data_np, dtype=np.float64)
    h, w = data.shape
    vp_elev = data[vp_row, vp_col] + observer_elev

    # every coordinate below is an exact half-integer in f64, so the
    # slab-written fast paths (_*_np) produce bit-identical values to
    # the generic xp= helpers regardless of association order
    dr = np.arange(h, dtype=np.float64) - np.float64(vp_row)
    dc = np.arange(w, dtype=np.float64) - np.float64(vp_col)
    drow = np.broadcast_to(dr[:, None], (h, w))
    dcol = np.broadcast_to(dc[None, :], (h, w))

    e_dy, e_dx, x_dy, x_dx = _corner_offsets_np(h, w, vp_row, vp_col)
    enter_elev = _corner_elev_np(data, vp_row, vp_col, enter=True)
    exit_elev = _corner_elev_np(data, vp_row, vp_col, enter=False)
    # corner-relative coordinate grids (reuse the offset buffers)
    e_dy += dr[:, None]
    e_dx += dc[None, :]
    x_dy += dr[:, None]
    x_dx += dc[None, :]

    # angles: _calculate_angle takes (x, y) with y as ROW index and
    # "north" = smaller row
    with np.errstate(invalid="ignore"):
        a0 = _calculate_angle_np(e_dy, e_dx)
        a1 = _calculate_angle_np(drow, dcol)
        a2 = _calculate_angle_np(x_dy, x_dx)

        vp_cell = (vp_row, vp_col)
        g0 = _gradient_np(e_dy, e_dx, enter_elev, vp_elev, ew_res, ns_res,
                          vp_cell)
        g1 = _gradient_np(drow, dcol, data, vp_elev, ew_res, ns_res,
                          vp_cell)
        g2 = _gradient_np(x_dy, x_dx, exit_elev, vp_elev, ew_res, ns_res,
                          vp_cell)
        grad_t = _gradient_np(drow, dcol, data + target_elev,
                              vp_elev, ew_res, ns_res, vp_cell)

    key = (dc * ew_res) ** 2 + ((dr * ns_res) ** 2)[:, None]
    is_vp = np.zeros((h, w), dtype=bool)
    is_vp[vp_row, vp_col] = True
    valid_b = np.isfinite(g1)
    valid_b[vp_row, vp_col] = False
    return {
        "key": key.ravel(), "a0": a0.ravel(), "a1": a1.ravel(),
        "a2": a2.ravel(), "g0": g0.ravel(), "g1": g1.ravel(),
        "g2": g2.ravel(), "grad_t": grad_t.ravel(),
        "is_vp": is_vp.ravel(), "valid_b": valid_b.ravel(),
        "vp_elev": vp_elev, "shape": (h, w),
    }


def cell_attrs_subset(data_np, flat_idx, vp_row: int, vp_col: int,
                      observer_elev: float, target_elev: float,
                      ew_res: float, ns_res: float):
    """f64 predicate attributes at SCATTERED flat indices: bit-identical
    per element to `cell_attrs_host`, at O(|subset|) cost.  The f64
    re-evaluation of screen-ambiguous targets only needs attrs at its
    gathered candidate/target positions."""
    return cell_attrs_subset_fn(data_np, vp_row, vp_col, observer_elev,
                                target_elev, ew_res, ns_res)(flat_idx)


def cell_attrs_subset_fn(data_np, vp_row: int, vp_col: int,
                         observer_elev: float, target_elev: float,
                         ew_res: float, ns_res: float):
    """Factory form of `cell_attrs_subset`: pads the elevation grid once
    and returns ``fn(flat_idx) -> attrs dict`` for repeated gathered
    lookups (one per candidate tier plus the target side)."""
    data = np.asarray(data_np, dtype=np.float64)
    p = np.pad(data, 1, constant_values=np.nan)
    vp_elev = data[vp_row, vp_col] + observer_elev

    def fn(flat_idx):
        return _cell_attrs_at(data, p, flat_idx, vp_row, vp_col, vp_elev,
                              target_elev, ew_res, ns_res)

    return fn


def _cell_attrs_at(data, p, flat_idx, vp_row, vp_col, vp_elev,
                   target_elev, ew_res, ns_res):
    h, w = data.shape
    idx = np.asarray(flat_idx, dtype=np.int64)
    rows, cols = np.divmod(idx, w)

    dr = rows.astype(np.float64) - np.float64(vp_row)
    dc = cols.astype(np.float64) - np.float64(vp_col)

    # corner offsets via the same 3x3 quadrant tables as
    # _corner_offsets_np (band index 0/1/2 = north/same/south etc.)
    bi = (rows >= vp_row).astype(np.int64) + (rows > vp_row)
    bj = (cols >= vp_col).astype(np.int64) + (cols > vp_col)
    tables = (
        ((-0.5, 0.5, 0.5), (-0.5, 0.0, 0.5), (-0.5, -0.5, 0.5)),   # e_dy
        ((0.5, 0.5, 0.5), (0.5, 0.0, -0.5), (-0.5, -0.5, -0.5)),   # e_dx
        ((0.5, 0.5, -0.5), (0.5, 0.0, -0.5), (0.5, -0.5, -0.5)),   # x_dy
        ((-0.5, -0.5, -0.5), (0.5, 0.0, -0.5), (0.5, 0.5, 0.5)),   # x_dx
    )
    e_dy, e_dx, x_dy, x_dx = (np.asarray(t, dtype=np.float64)[bi, bj]
                              for t in tables)
    e_dy = e_dy + dr
    e_dx = e_dx + dc
    x_dy = x_dy + dr
    x_dx = x_dx + dc

    # enter/exit corner elevations: the pinwheel (sy, sx) selection of
    # _corner_elev_np, evaluated per element with the identical
    # (diag + vert + horiz + center) / 4 association
    center = data[rows, cols]

    def corner(enter):
        if enter:
            sy = np.where(rows <= vp_row,
                          np.where(cols < vp_col, -1,
                                   np.where(rows < vp_row, 1,
                                            np.where(cols >= vp_col + 1,
                                                     1, -1))),
                          np.where(cols >= vp_col + 1, 1, -1))
            sx = np.where((rows <= vp_row) & (cols < vp_col), 1,
                          np.where((rows < vp_row) & (cols >= vp_col), 1,
                                   -1))
        else:
            sy = np.where((rows < vp_row) & (cols <= vp_col), 1,
                          np.where((rows <= vp_row) & (cols > vp_col), -1,
                                   np.where((rows > vp_row)
                                            & (cols >= vp_col), -1, 1)))
            sx = np.where((rows < vp_row) & (cols <= vp_col), -1,
                          np.where((rows <= vp_row) & (cols > vp_col), -1,
                                   np.where((rows > vp_row)
                                            & (cols >= vp_col), 1, 1)))
        diag = p[1 + rows + sy, 1 + cols + sx]
        vert = p[1 + rows + sy, 1 + cols]
        horiz = p[1 + rows, 1 + cols + sx]
        avg = (diag + vert + horiz + center) / 4.0
        out = np.where(np.isnan(avg), center, avg)
        return np.where((rows == vp_row) & (cols == vp_col), center, out)

    enter_elev = corner(True)
    exit_elev = corner(False)

    def angle(drows, dcols):
        ex_eq = dcols == 0.0
        ang = np.arctan(np.abs(drows) / np.where(ex_eq, 1.0,
                                                 np.abs(dcols)))
        out = np.zeros(idx.shape, dtype=np.float64)
        out[(dcols > 0) & (drows < 0)] = ang[(dcols > 0) & (drows < 0)]
        q2 = (dcols < 0) & (drows < 0)
        q3 = (dcols < 0) & (drows > 0)
        q4 = (dcols > 0) & (drows > 0)
        out[q2] = PI - ang[q2]
        out[q3] = PI + ang[q3]
        out[q4] = 2.0 * PI - ang[q4]
        out[ex_eq & (drows < 0)] = PI / 2.0
        out[ex_eq & (drows > 0)] = 3.0 * PI / 2.0
        ey_eq = drows == 0.0
        out[ey_eq & (dcols > 0)] = 0.0
        out[ey_eq & (dcols < 0)] = PI
        out[ex_eq & ey_eq] = 0.0
        return out

    at_vp = (rows == vp_row) & (cols == vp_col)

    def gradient(dy_px, dx_px, elev):
        diff = elev - vp_elev
        d2 = dx_px * ew_res
        d2 = d2 * d2
        t = dy_px * ns_res
        t = t * t
        d2 = d2 + t
        d2 = np.where(at_vp, 1.0, d2)
        grad = np.arctan(diff / np.sqrt(d2))
        return np.where(at_vp, np.sign(diff) * (PI / 2.0), grad)

    with np.errstate(invalid="ignore"):
        a0 = angle(e_dy, e_dx)
        a1 = angle(dr, dc)
        a2 = angle(x_dy, x_dx)
        g0 = gradient(e_dy, e_dx, enter_elev)
        g1 = gradient(dr, dc, center)
        g2 = gradient(x_dy, x_dx, exit_elev)
        grad_t = gradient(dr, dc, center + target_elev)

    key = (dc * ew_res) ** 2 + (dr * ns_res) ** 2
    valid_b = np.isfinite(g1)
    valid_b[at_vp] = False
    return {
        "key": key, "a0": a0, "a1": a1, "a2": a2,
        "g0": g0, "g1": g1, "g2": g2, "grad_t": grad_t,
        "is_vp": at_vp, "valid_b": valid_b,
        "vp_elev": vp_elev, "shape": (h, w),
    }


def _visibility_epilogue(data, visible, vp_elev, vp_row, vp_col,
                         target_elev, ew_res, ns_res):
    """Vertical angle for visible cells, float64 on `data`'s device: 0 =
    straight up, 90 = level, 180 = the viewpoint, INVISIBLE elsewhere."""
    h, w = data.shape
    dev = data.device
    f64 = torch.float64
    rows = torch.arange(h, dtype=torch.int32, device=dev).to(f64)[:, None]
    cols = torch.arange(w, dtype=torch.int32, device=dev).to(f64)[None, :]
    vp_r = float(vp_row)
    vp_c = float(vp_col)
    key = ((cols - vp_c) * ew_res) ** 2 + ((rows - vp_r) * ns_res) ** 2
    is_vp = (rows == vp_r) & (cols == vp_c)

    diff = float(vp_elev) - (data + float(target_elev))
    dist = torch.sqrt(torch.where(key == 0, 1.0, key))
    vert = torch.where(
        diff == 0.0, 90.0,
        torch.where(diff > 0,
                    torch.arctan(dist / torch.where(diff == 0, 1.0, diff))
                    * 180.0 / PI,
                    torch.arctan(torch.abs(diff) / dist) * 180.0 / PI
                    + 90.0))
    out = torch.where(visible, vert, float(INVISIBLE))
    return torch.where(is_vp, 180.0, out)


def viewshed_grid(data, vp_row: int, vp_col: int, observer_elev: float,
                  target_elev: float, ew_res: float, ns_res: float):
    """Visibility grid (vertical angles, INVISIBLE=-1, viewpoint=180).

    Exact GRASS predicate, evaluated PAIRWISE (every target against all
    cells) on `data`'s device: the O(N^2) oracle the bucket path in
    viewshed_exact.py equals bit for bit.  `data` is a 2-D tensor; its
    float64 copy on the host feeds the attributes.
    """
    data = torch.as_tensor(data)
    data_np = data.detach().to("cpu", torch.float64).numpy()
    at = cell_attrs_host(data_np, vp_row, vp_col, observer_elev,
                         target_elev, ew_res, ns_res)
    h, w = at["shape"]
    dev = data.device

    def up(f):
        return torch.from_numpy(np.ascontiguousarray(at[f])).to(dev)

    visible = _pairwise_visibility(
        up("key"), up("a0"), up("a1"), up("a2"), up("g0"), up("g1"),
        up("g2"), up("grad_t"), up("is_vp")).reshape(h, w)
    return _visibility_epilogue(data.to(torch.float64), visible,
                                at["vp_elev"], vp_row, vp_col, target_elev,
                                ew_res, ns_res)


# ---------------------------------------------------------------------------
# XDraw: the octant-scan wavefront, an O(N) float32 approximation
# ---------------------------------------------------------------------------


def _scalar32(x, device):
    return torch.tensor(x, dtype=torch.float32, device=device)


def _f32(x, device):
    """`x` as a float32 scalar on `device`: on the card a blocking copy
    from the host, counted on ``host.syncs`` (the twins, which stand in
    for a kernel on the CPU, take ``_scalar32``)."""
    count("host.syncs")
    return _scalar32(x, device)


def _shift(arr, dy, dx, fill):
    """`arr` read at (row + dy, col + dx), `fill` outside."""
    h, w = arr.shape
    py0, py1 = max(-dy, 0), max(dy, 0)
    px0, px1 = max(-dx, 0), max(dx, 0)
    p = torch.nn.functional.pad(arr, (px0, px1, py0, py1), value=fill)
    return p[py0 + dy:py0 + dy + h, px0 + dx:px0 + dx + w]


def _xdraw_interp(prim, sec, wsec):
    """The blocking slope between the primary and secondary cells, each
    product and the sum rounded apart (XLA on the CPU contracts the first
    product and the sum into an FMA; the CUDA kernel does not)."""
    return prim * (1.0 - wsec) + sec * wsec


def _xdraw_fields(data, vp_row, vp_col, observer_elev, target_elev,
                  ew_res, ns_res, origin=(0, 0), vp_elev=None):
    """Per-cell slopes and viewpoint-relative geometry, float32: (dy, dx,
    safe_d, slope_self, slope_tgt, vp_elev).  At the viewpoint slope_self
    is -inf and slope_tgt +inf.  `data` may be a block of a larger raster
    whose cell (0, 0) is the raster's `origin`; `vp_elev` (the viewpoint's
    elevation plus the observer's, on `data`'s device) is then given, as
    the block need not hold the viewpoint."""
    with span("torchops.viewshed_fields"):
        h, w = data.shape
        dev = data.device
        y0, x0 = origin
        vp_r, vp_c = _f32(vp_row, dev), _f32(vp_col, dev)
        if vp_elev is None:
            vp_elev = (data[vp_row - y0, vp_col - x0]
                       + _f32(observer_elev, dev))
        dy = torch.arange(y0, y0 + h, dtype=torch.float32,
                          device=dev)[:, None] - vp_r
        dx = torch.arange(x0, x0 + w, dtype=torch.float32,
                          device=dev)[None, :] - vp_c
        wx = dx * _f32(ew_res, dev)
        wy = dy * _f32(ns_res, dev)
        dist_w = torch.sqrt(wx * wx + wy * wy)
        tiny = _f32(1e-12, dev)
        count("host.syncs")         # .item(): a read back to the host
        safe_d = torch.clamp(dist_w, min=tiny.item())
        slope_self = torch.where(dist_w > 0, (data - vp_elev) / safe_d,
                                 float("-inf"))
        slope_tgt = torch.where(
            dist_w > 0,
            (data + _f32(target_elev, dev) - vp_elev) / safe_d,
            float("inf"))
        dy, dx = torch.broadcast_tensors(dy, dx)
        return dy, dx, safe_d, slope_self, slope_tgt, vp_elev


def xdraw_scan_twin(slope, vp_row: int, vp_col: int) -> torch.Tensor:
    """The XDraw running max slope, (H, W) float32: the plain version of
    the CUDA kernel ``xdraw_scan_kernel``.

    The four half-plane scans of the JAX package's ``_halfplane_scan4``
    as one loop over the major axis with a (4, N) carry, N = max(h, w):
    east and west walk the columns, south and north the rows; padded
    lanes have minor offset 3N, so they never enter the mask, and padded
    steps come after every real one.  Each step's lines are sliced from
    the raster and its results written into the four scans' (H, W) fields
    (the JAX package stacks an (N, 4, N) input and output).  Each cell
    then takes its own octant's scan (``_xdraw_octant_masks``; a diagonal
    cell is east or west).  Every product and sum is rounded apart, as
    the kernel's ``__fmul_rn``/``__fadd_rn`` are.
    """
    h, w = slope.shape
    n = max(h, w)
    dev = slope.device
    neginf = float("-inf")

    def pad1(v):
        return torch.nn.functional.pad(v, (0, n - v.shape[0]),
                                       value=float(3 * n))

    f32 = _scalar32
    dy_vec = torch.arange(h, dtype=torch.float32, device=dev) - f32(
        vp_row, dev)
    dx_vec = torch.arange(w, dtype=torch.float32, device=dev) - f32(
        vp_col, dev)
    minor = torch.stack([pad1(dy_vec), pad1(dy_vec), pad1(dx_vec),
                         pad1(dx_vec)])                         # (4, N)
    vpm = torch.stack([f32(vp_col, dev), f32(w - 1, dev) - f32(vp_col, dev),
                       f32(vp_row, dev), f32(h - 1, dev) - f32(vp_row, dev)])
    ady = torch.abs(minor)
    sy = torch.sign(minor)
    use_sec = ady > 0
    edge = torch.full((4, 1), neginf, device=dev)
    m = torch.full((4, n), neginf, device=dev)
    m_e, m_w, m_s, m_n = (torch.empty((h, w), device=dev) for _ in range(4))
    for k in range(n):
        s_k = torch.full((4, n), neginf, device=dev)
        if k < w:
            s_k[0, :h] = slope[:, k]
            s_k[1, :h] = slope[:, w - 1 - k]
        if k < h:
            s_k[2, :w] = slope[k]
            s_k[3, :w] = slope[h - 1 - k]
        dxf = (f32(k, dev) - vpm)[:, None]
        mask = (ady <= dxf) & (dxf > 0)
        prim = m
        up = torch.cat([edge, m[:, :-1]], 1)
        down = torch.cat([m[:, 1:], edge], 1)
        sec = torch.where(sy > 0, up, torch.where(sy < 0, down, prim))
        wsec = torch.where(use_sec, ady / torch.clamp(dxf, min=1.0), 0.0)
        both = torch.isfinite(prim) & torch.isfinite(sec)
        interp = torch.where(both, _xdraw_interp(prim, sec, wsec),
                             torch.maximum(prim, sec))
        blocked = torch.where(dxf == 1.0, neginf, interp)
        m = torch.where(mask, torch.maximum(blocked, s_k), neginf)
        if k < w:
            m_e[:, k] = m[0, :h]
            m_w[:, w - 1 - k] = m[1, :h]
        if k < h:
            m_s[k] = m[2, :w]
            m_n[h - 1 - k] = m[3, :w]

    east, west, south, _ = _xdraw_octant_masks(dy_vec[:, None],
                                               dx_vec[None, :])
    return torch.where(east, m_e, torch.where(west, m_w,
                       torch.where(south, m_s, m_n)))


# the banded XDraw kernel's plan: the chunks and bands it tries, in that
# order, and what bounds the blocks an SM holds (its registers at most
# 64 a thread, __launch_bounds__(1024))
XDRAW_CHUNKS = (32, 16, 8, 4)
XDRAW_BANDS = tuple(2 ** i for i in range(5, 17))
XDRAW_MAX_THREADS = 1024
XDRAW_REGISTERS = 64
SM_THREADS, SM_REGISTERS, SM_BLOCKS = 2048, 65536, 32


class XDrawPlan(NamedTuple):
    band: int           # lanes a block owns
    chunk: int          # steps between carry exchanges; the halo's lanes
    threads: int        # a block's, one lane of band + chunk each
    shared_bytes: int   # the carry's two windows and two slope tiles
    blocks: int         # 4 half-planes x their bands
    slots: int          # chunk boundaries kept a half-plane
    per_sm: int         # blocks an SM holds at once


def xdraw_plan(h: int, w: int, sms: int = 132, band: int | None = None,
               chunk: int | None = None) -> XDrawPlan:
    """How ``csrc/xdraw.cu::xdraw_banded_kernel`` runs an (h, w) raster on
    `sms` SMs: the longest chunk of ``XDRAW_CHUNKS`` and, for it, the
    smallest band of ``XDRAW_BANDS`` whose blocks can all be resident at
    once (the launch is cooperative).  Smaller bands fill the SMs with
    more, shorter blocks (the card's sweep of bands and chunks: PERF.md).
    A given `band` or `chunk` is taken as it is; a launch whose blocks
    cannot all be resident then fails."""
    return _band_plan((h, h, w, w), lambda c: -(-(max(h, w) - 1) // c) + 1,
                      sms, band, chunk, f"a {h}x{w} raster")


def _band_plan(lanes, slots_of, sms, band, chunk, what) -> XDrawPlan:
    """The band and chunk of a banded launch whose four half-planes have
    `lanes` lanes each (see ``xdraw_plan``); `slots_of(chunk)` is the
    chunk-end slots a half-plane keeps."""
    def plan(b, c):
        wmax = b + c
        threads = min(XDRAW_MAX_THREADS, -(-wmax // 32) * 32)
        shared = 4 * (2 * (wmax + 2) + 2 * c * wmax)
        per_sm = min(SM_BLOCKS, SM_THREADS // threads,
                     SM_REGISTERS // (threads * XDRAW_REGISTERS),
                     SMEM_PER_SM // (shared + 1024))
        return XDrawPlan(b, c, threads, shared,
                         sum(-(-n // b) for n in lanes), slots_of(c),
                         per_sm)

    if band is not None and chunk is not None:
        p = plan(band, chunk)
        if band < 1 or chunk < 1 or p.shared_bytes > SMEM_PER_BLOCK:
            raise ValueError(f"xdraw_plan: band {band} and chunk {chunk} "
                             f"need {p.shared_bytes} bytes of shared memory "
                             f"(a block has {SMEM_PER_BLOCK}), or are < 1")
        return p
    for c in ((chunk,) if chunk is not None else XDRAW_CHUNKS):
        for b in ((band,) if band is not None else XDRAW_BANDS):
            p = plan(b, c)
            if p.shared_bytes <= SMEM_PER_BLOCK and p.blocks <= sms * p.per_sm:
                return p
    raise ValueError(f"xdraw_plan: no band and chunk fit {what} on {sms} "
                     f"SMs")


def _xdraw_octant_masks(dy, dx):
    """Disjoint cell->scan assignment (east, west, south, north)."""
    ady = torch.abs(dy)
    adx = torch.abs(dx)
    x_dom = adx >= ady
    return (x_dom & (dx >= 0), x_dom & (dx < 0),
            ~x_dom & (dy >= 0), ~x_dom & (dy < 0))


def xdraw_max_slope(slope, vp_row: int, vp_col: int) -> torch.Tensor:
    """The XDraw running max slope: the CUDA kernel for a tensor on the
    card (its wrapper raises on one elsewhere), the twin on the CPU."""
    with span("dispatch.xdraw"):
        if slope.device.type == "cpu":
            return xdraw_scan_twin(slope, vp_row, vp_col)
        from .cuda_xdraw import xdraw_scan_cuda
        return xdraw_scan_cuda(slope, vp_row, vp_col)


def _xdraw_inward_max(m, dy, dx):
    """The max slope of the terrain strictly inward of each cell: the
    scan's interpolation read from the combined field `m` at the cell's
    primary and secondary inward neighbours; -inf within one ring of the
    viewpoint."""
    h, w = m.shape
    ady = torch.abs(dy)
    adx = torch.abs(dx)
    sy = torch.sign(dy)
    sx = torch.sign(dx)
    dom_y = ady >= adx
    p_dy = torch.where(dom_y, -sy, 0.0)
    p_dx = torch.where(dom_y, 0.0, -sx)
    s_dy = -sy
    s_dx = -sx
    denom = torch.clamp(torch.maximum(ady, adx), min=1.0)
    minor = torch.minimum(ady, adx)
    use_sec = torch.where(dom_y, adx > 0, ady > 0)
    wsec = torch.where(use_sec, minor / denom, 0.0)
    ring = torch.maximum(ady, adx)
    neginf = float("-inf")

    def shifted_for(offs_dy, offs_dx, arr):
        out = torch.full((h, w), neginf, device=arr.device)
        for ody in (-1, 0, 1):
            for odx in (-1, 0, 1):
                if ody == 0 and odx == 0:
                    continue
                sel = (offs_dy == ody) & (offs_dx == odx)
                out = torch.where(sel, _shift(arr, ody, odx, neginf), out)
        return out

    mp = shifted_for(p_dy, p_dx, m)
    ms = shifted_for(s_dy, s_dx, m)
    both = torch.isfinite(mp) & torch.isfinite(ms)
    inward_max = torch.where(both, _xdraw_interp(mp, ms, wsec),
                             torch.maximum(mp, ms))
    return torch.where(ring <= 1, neginf, inward_max)


def _xdraw_epilogue(m, data, dy, dx, safe_d, slope_tgt, vp_elev,
                    target_elev):
    """Combined max-slope field -> visibility + vertical angles."""
    with span("torchops.viewshed_epilogue"):
        return _xdraw_angles(_xdraw_inward_max(m, dy, dx), data, dy, dx,
                             safe_d, slope_tgt, vp_elev, target_elev)


def _xdraw_angles(inward_max, data, dy, dx, safe_d, slope_tgt, vp_elev,
                  target_elev):
    """The inward max slope of each cell -> visibility + vertical angles,
    cell by cell."""
    visible = inward_max <= slope_tgt
    diff = vp_elev - (data + _f32(target_elev, data.device))
    vert = torch.where(
        diff == 0.0, 90.0,
        torch.where(diff > 0,
                    torch.arctan(safe_d / torch.where(diff == 0, 1.0, diff))
                    * 180.0 / PI,
                    torch.arctan(torch.abs(diff) / safe_d) * 180.0 / PI
                    + 90.0))
    out = torch.where(visible, vert, float(INVISIBLE))
    out = torch.where(torch.isnan(data), float(INVISIBLE), out)
    is_vp = (dy == 0.0) & (dx == 0.0)
    return torch.where(is_vp, 180.0, out)


def viewshed_grid_los(data, vp_row: int, vp_col: int, observer_elev: float,
                      target_elev: float, ew_res: float, ns_res: float):
    """XDraw viewshed (vertical angles, INVISIBLE=-1, viewpoint=180),
    float32 on `data`'s device.  On the card: the slope field, the four
    octant scans (X1) and the epilogue, one launch each
    (``csrc/xdraw_cells.cu``, ``csrc/xdraw.cu``), the host waiting for
    nothing; on the CPU the fields and the epilogue as torch ops around
    the scans' twin.  Counted on ``xdraw.cells_kernel`` or
    ``xdraw.cells_torchops``."""
    data = torch.as_tensor(data).to(torch.float32)
    if data.device.type == "cuda":
        from .cuda_xdraw_cells import xdraw_epilogue_cuda, xdraw_fields_cuda
        count("xdraw.cells_kernel")
        data = data.contiguous()
        with span("dispatch.viewshed_fields"):
            slope_self = xdraw_fields_cuda(data, vp_row, vp_col,
                                           observer_elev, ew_res, ns_res)
        m = xdraw_max_slope(slope_self, vp_row, vp_col)
        del slope_self
        with span("dispatch.viewshed_epilogue"):
            return xdraw_epilogue_cuda(m, data, vp_row, vp_col,
                                       observer_elev, target_elev, ew_res,
                                       ns_res)
    count("xdraw.cells_torchops")
    dy, dx, safe_d, slope_self, slope_tgt, vp_elev = _xdraw_fields(
        data, vp_row, vp_col, observer_elev, target_elev, ew_res, ns_res)
    m = xdraw_max_slope(slope_self, vp_row, vp_col)
    return _xdraw_epilogue(m, data, dy, dx, safe_d, slope_tgt, vp_elev,
                           target_elev)


# ---------------------------------------------------------------------------
# XDraw on a mesh: the half-plane scans on strips of lanes
# ---------------------------------------------------------------------------
#
# The JAX package's banded distributed scan (``_xdraw_banded_pass``) splits
# each half-plane's lanes (its minor axis) over the flattened mesh and
# refreshes a K-lane halo on both sides every K steps.  A lane's secondary
# neighbour is always the lane one nearer the viewpoint's, so one side is
# enough: a strip of lanes extended by L lanes toward the viewpoint's lane
# (cut at it) runs L steps exactly, its halo decaying from the far edge one
# lane a step.  Between two windows of L steps the owned carries at the
# edge of each strip are copied into the halo of the strip beside it.  East
# and west run on strips of rows, south and north on strips of columns,
# each strip on its own device; the fields return to the input's blocks and
# each cell takes its own octant's scan.

# the step window the plan takes: the fastest of L = 64, 256, 1024 and
# 4096 at 16384^2 on a 2x2 mesh of four NVIDIA H100 80GB HBM3 at 700.00 W,
# within 1.2% of the fastest on one such card (PERF.md)
XDRAW_STRIP_DEFAULT = 1024


class XDrawStripPlan(NamedTuple):
    steps: int          # L: steps a launch walks, lanes of a strip's halo
    band: int
    chunk: int
    threads: int
    shared_bytes: int
    blocks: int         # of the widest strip's launch: 4 half-planes
    slots: int          # chunk-end slots a half-plane keeps a launch
    per_sm: int


def strip_halos(n: int, parts: int, vp_lane: int, steps: int) -> list:
    """(lo, hi) halo lanes of each of the `parts` strips of `n` lanes:
    `steps` lanes on the side toward `vp_lane`, cut at it; none for the
    strip that holds it or for a strip beyond the raster."""
    s = -(-n // parts)
    out = []
    for p in range(parts):
        a, b = p * s, min((p + 1) * s, n)
        if a >= b or a <= vp_lane < b:
            out.append((0, 0))
        elif a > vp_lane:
            out.append((min(steps, a - vp_lane), 0))
        else:
            out.append((0, min(steps, vp_lane - (b - 1))))
    return out


def xdraw_strip_plan(h: int, w: int, vp_row: int, vp_col: int, parts: int,
                     sms: int = 132, steps: int | None = None,
                     band: int | None = None,
                     chunk: int | None = None) -> XDrawStripPlan:
    """How the strip route runs an (h, w) raster on `parts` strips: the
    step window L (`steps`, by default ``XDRAW_STRIP_DEFAULT``), and the
    band and chunk of ``xdraw_banded_kernel`` for the widest strip (owned
    lanes plus halo) by ``xdraw_plan``'s rule.  A pass makes
    ``parts * ceil(max(h, w) / L)`` launches and as many exchanges; the
    halo adds up to L lanes a strip."""
    steps = XDRAW_STRIP_DEFAULT if steps is None else int(steps)
    if steps < 1:
        raise ValueError(f"xdraw_strip_plan: steps {steps} < 1")

    def widest(n, vp):
        s = -(-n // parts)
        return max(min((p + 1) * s, n) - p * s + lo + hi for p, (lo, hi)
                   in enumerate(strip_halos(n, parts, vp, steps)))
    wr, wc = widest(h, vp_row), widest(w, vp_col)
    p = _band_plan((wr, wr, wc, wc), lambda c: -(-steps // c) + 1, sms,
                   band, chunk, f"strips of {wr} and {wc} lanes")
    return XDrawStripPlan(steps, *p)


def xdraw_strip_twin(slope, carry, s0: int, steps: int, lane_lo: int,
                     n_lanes: int, vp_lane: int, vp_major: int):
    """One strip's forward and reverse half-plane scans over the window of
    steps ``[s0, s0 + steps)``: the plain version of the strip route of
    ``csrc/xdraw.cu``, and of one device's part of the JAX package's
    ``_xdraw_banded_pass``.

    `slope` is (R, S) float32, lane r the plane's lane ``lane_lo + r``,
    column t its major index t; `carry` (2, R) holds the forward and
    reverse scans' lanes before step s0 (the reverse scan's step k is
    major index S - 1 - k).  Lanes at or beyond `n_lanes` are padding:
    their minor offset is 3 max(n_lanes, S), so they never enter the
    cone.  Returns ((2, R, n) the lanes after each of the window's n
    steps, (2, R) the carry after the last).  Every product and sum is
    rounded apart, as in ``xdraw_scan_twin``.
    """
    r, s = slope.shape
    dev = slope.device
    f32 = _scalar32
    neginf = float("-inf")
    n = max(0, min(steps, s - s0))
    g = torch.arange(lane_lo, lane_lo + r, device=dev)
    minor = torch.where(g < n_lanes,
                        g.to(torch.float32) - f32(vp_lane, dev),
                        float(3 * max(n_lanes, s)))
    ady = torch.abs(minor)[None]
    sy = torch.sign(minor)[None]
    use_sec = ady > 0
    vpm = torch.stack([f32(vp_major, dev),
                       f32(s - 1, dev) - f32(vp_major, dev)])[:, None]
    edge = torch.full((2, 1), neginf, device=dev)
    m = carry
    lines = torch.empty((2, r, n), dtype=torch.float32, device=dev)
    for i in range(n):
        k = s0 + i
        s_k = torch.stack([slope[:, k], slope[:, s - 1 - k]])
        dxf = f32(k, dev) - vpm
        mask = (ady <= dxf) & (dxf > 0)
        up = torch.cat([edge, m[:, :-1]], 1)
        down = torch.cat([m[:, 1:], edge], 1)
        sec = torch.where(sy > 0, up, torch.where(sy < 0, down, m))
        wsec = torch.where(use_sec, ady / torch.clamp(dxf, min=1.0), 0.0)
        both = torch.isfinite(m) & torch.isfinite(sec)
        interp = torch.where(both, _xdraw_interp(m, sec, wsec),
                             torch.maximum(m, sec))
        blocked = torch.where(dxf == 1.0, neginf, interp)
        m = torch.where(mask, torch.maximum(blocked, s_k), neginf)
        lines[:, :, i] = m
    return lines, m


class StripHalf(NamedTuple):
    """One orientation of a strip's launch: its slope lanes and scan field
    (a (R, w) strip of rows or an (h, R) strip of columns), the carries
    before and after the window ((2, R), forward then reverse), the
    plane's lane of buffer lane 0 and the end of the window's lanes."""
    src: torch.Tensor
    out: torch.Tensor
    carry_in: torch.Tensor
    carry_out: torch.Tensor
    buf_lo: int
    lane_hi: int


class _StripScan:
    """One orientation of the strip route: `strips` lane-major (R_p, S)
    views of `parts` strips of an (n_lanes, S) plane with `halos`, their
    ping-pong carries and the exchange of halo carries between windows."""

    def __init__(self, strips, halos, n_lanes, vp_lane, vp_major):
        self.strips, self.halos = strips, halos
        self.n_lanes, self.vp_lane, self.vp_major = n_lanes, vp_lane, vp_major
        self.s = -(-n_lanes // len(strips))
        self.buf_lo = [p * self.s - lo for p, (lo, _) in enumerate(halos)]
        self.lane_hi = [min((p + 1) * self.s, n_lanes) + hi
                        for p, (_, hi) in enumerate(halos)]
        self.carry = [[torch.full((2, t.shape[0]), float("-inf"),
                                  device=t.device) for t in strips]
                      for _ in range(2)]

    def empty(self, p) -> bool:
        return p * self.s >= self.n_lanes

    def carries(self, p, r):
        """Strip p's carries before and after window r."""
        return self.carry[r % 2][p], self.carry[(r + 1) % 2][p]

    def exchange(self, r):
        """After window r: each strip's halo carries from the owned lanes
        of the strips that own them, one copy a piece."""
        cur = self.carry[(r + 1) % 2]
        parts = len(self.strips)
        for p, (lo, hi) in enumerate(self.halos):
            a = p * self.s
            for g0, g1 in ((a - lo, a), (a + self.s, a + self.s + hi)):
                for q, la, lb, off in _sources(self.n_lanes, parts, g0,
                                               g1):
                    src = self.halos[q][0] + la
                    dst = g0 - self.buf_lo[p] + off
                    cur[p][:, dst:dst + lb - la].copy_(
                        cur[q][:, src:src + lb - la], non_blocking=True)

    def twin(self, p, r, steps, fwd, rev):
        """Window r of strip p by the twin, written into its (R, S)
        forward and reverse fields."""
        c_in, c_out = self.carries(p, r)
        s = self.strips[p].shape[1]
        s0 = r * steps
        lines, c = xdraw_strip_twin(self.strips[p], c_in, s0, steps,
                                    self.buf_lo[p], self.n_lanes,
                                    self.vp_lane, self.vp_major)
        n = lines.shape[-1]
        if n:
            fwd[:, s0:s0 + n] = lines[0]
            rev[:, s - s0 - n:s - s0] = lines[1].flip(-1)
        c_out.copy_(c)


def _strip_on_card(t) -> bool:
    """Whether a strip runs on the strip route's kernel (on the card) or
    on the twin (on the CPU)."""
    return t.device.type == "cuda"


def _first_window(h, w, vp_row, vp_col, steps):
    """The first window with a step of any half-plane in the cone, the
    east scan's viewpoint step (dxf = 0) included."""
    return min(vp_col, w - 1 - vp_col, vp_row, h - 1 - vp_row) // steps


def strip_scans(slope, vp_row: int, vp_col: int, steps: int | None = None,
                band: int | None = None, chunk: int | None = None):
    """The four half-plane scans of a raster split over a mesh (a
    ``ShardedRaster``) on strips over the flattened mesh, east and west on
    strips of rows, south and north on strips of columns: each window of
    each strip one launch of the strip route of ``csrc/xdraw.cu`` on the
    card (the twin on the CPU), the halo carries exchanged between
    windows.  Returns (the raster of tiles, the rows' and the columns'
    halos, and each strip's fields: on the card its (R, w) rows field,
    east and west in one, and its (h, R) columns field, south and north in
    one; on the CPU its east, west, south and north fields, the rows'
    (R, w), the columns' (R, h))."""
    from ..parallel.halo import flat_devices, tiles, to_strips
    slope = tiles(slope)
    h, w = slope.shape
    parts = slope.mesh.size
    dev0 = flat_devices(slope.mesh)[0]
    sms = (torch.cuda.get_device_properties(dev0).multi_processor_count
           if dev0.type == "cuda" else 132)
    plan = xdraw_strip_plan(h, w, vp_row, vp_col, parts, sms, steps, band,
                            chunk)
    n_steps = plan.steps
    halos_r = strip_halos(h, parts, vp_row, n_steps)
    halos_c = strip_halos(w, parts, vp_col, n_steps)
    rows = to_strips(slope, 0, halos_r, float("-inf"))
    cols = to_strips(slope, 1, halos_c, float("-inf"))
    scan_r = _StripScan(rows, halos_r, h, vp_row, vp_col)
    scan_c = _StripScan([t.t() for t in cols], halos_c, w, vp_col, vp_row)
    on_card = [_strip_on_card(t) for t in rows]
    if any(on_card):
        from .cuda_xdraw import xdraw_strip_cuda, strip_scratch
    fields = []
    for p in range(parts):
        if on_card[p]:
            fields.append((torch.empty_like(rows[p]),
                           torch.empty_like(cols[p]),
                           *strip_scratch(rows[p], cols[p], plan)))
        else:
            fields.append(tuple(torch.full(t.shape, float("-inf"),
                                           device=t.device)
                                for t in (rows[p], rows[p], cols[p].t(),
                                          cols[p].t())))
    for r in range(_first_window(h, w, vp_row, vp_col, n_steps),
                   -(-max(h, w) // n_steps)):
        for p in range(parts):
            if scan_r.empty(p) and scan_c.empty(p):
                continue
            if on_card[p]:
                out_r, out_c, slots, progress = fields[p]
                halves = [None if sc.empty(p) else StripHalf(
                    src, out, *sc.carries(p, r), sc.buf_lo[p],
                    sc.lane_hi[p]) for sc, src, out in (
                        (scan_r, rows[p], out_r), (scan_c, cols[p], out_c))]
                xdraw_strip_cuda(*halves, h, w, vp_row, vp_col,
                                 r * n_steps, plan, slots, progress,
                                 r * plan.slots)
            else:
                scan_r.twin(p, r, n_steps, *fields[p][:2])
                scan_c.twin(p, r, n_steps, *fields[p][2:])
        scan_r.exchange(r)
        scan_c.exchange(r)
    return slope, halos_r, halos_c, [f[:2] if card else f
                                     for f, card in zip(fields, on_card)]


def xdraw_mesh_max_slope(slope, vp_row: int, vp_col: int,
                         steps: int | None = None, band: int | None = None,
                         chunk: int | None = None):
    """The XDraw running max slope of a raster split over a mesh (a
    ``ShardedRaster``), as a raster of its tiles: the scans of
    ``strip_scans``, then each cell takes its own octant's scan.  Equal to
    ``xdraw_max_slope`` of the gathered raster bit for bit."""
    from ..parallel.halo import from_strips, zip_blocks
    slope, halos_r, halos_c, fields = strip_scans(slope, vp_row, vp_col,
                                                  steps, band, chunk)
    h, w = slope.shape

    def merged(f):
        if len(f) == 2:
            return f
        e, wst, s, n = f
        cx = torch.arange(w, device=e.device) > vp_col
        cy = torch.arange(h, device=s.device) > vp_row
        return torch.where(cx, e, wst), torch.where(cy, s, n).t()
    both = [merged(f) for f in fields]
    m_r = from_strips([b[0] for b in both], slope, 0,
                      [lo for lo, _ in halos_r])
    m_c = from_strips([b[1] for b in both], slope, 1,
                      [lo for lo, _ in halos_c])

    def pick(i, j, a, b):
        (y0, y1), (x0, x1) = slope.extent(0, i), slope.extent(1, j)
        ady = (torch.arange(y0, y1, device=a.device) - vp_row).abs()
        adx = (torch.arange(x0, x1, device=a.device) - vp_col).abs()
        return torch.where(adx[None, :] >= ady[:, None], a, b)
    return zip_blocks(pick, m_r, m_c)


def viewshed_grid_los_mesh(data, vp_row: int, vp_col: int,
                           observer_elev: float, target_elev: float,
                           ew_res: float, ns_res: float):
    """XDraw viewshed of a raster split over a mesh (a ``ShardedRaster``),
    as a raster of its tiles on the same mesh: the fields per block at the
    block's global origin, the scans by ``xdraw_mesh_max_slope``, the
    epilogue per block on a 1-cell halo of the combined field (-inf beyond
    the raster, as the unsharded shifts fill).  Where every block is on a
    card the fields and the epilogue are ``viewshed_grid_los``'s kernels,
    one launch each a block (the viewpoint's terrain copied to each card),
    else its torch passes; one count a block on ``xdraw.cells_kernel`` or
    ``xdraw.cells_torchops``.  Equal to ``viewshed_grid_los`` of the
    gathered raster cell for cell."""
    from ..parallel.halo import HaloSpec, halo_extend, tiles, zip_blocks
    data = tiles(data.map_blocks(lambda b: b.to(torch.float32)))
    i = next(i for i in range(data.mesh.shape["y"])
             if data.extent(0, i)[0] <= vp_row < data.extent(0, i)[1])
    j = next(j for j in range(data.mesh.shape["x"])
             if data.extent(1, j)[0] <= vp_col < data.extent(1, j)[1])
    blk = data.blocks[i][j]
    vp_cell = blk[vp_row - data.extent(0, i)[0],
                  vp_col - data.extent(1, j)[0]]

    def origin(i, j):
        return data.extent(0, i)[0], data.extent(1, j)[0]

    if all(b.device.type == "cuda" for row in data.blocks for b in row):
        return _los_mesh_cuda(data, vp_row, vp_col, observer_elev,
                              target_elev, ew_res, ns_res, origin, vp_cell)
    vp_elev = vp_cell + _f32(observer_elev, blk.device)

    def fields(i, j, b):
        return _xdraw_fields(b, vp_row, vp_col, observer_elev, target_elev,
                             ew_res, ns_res, origin(i, j),
                             vp_elev.to(b.device))
    count("xdraw.cells_torchops", data.mesh.size)
    slope = zip_blocks(lambda i, j, b: fields(i, j, b)[3], data)
    m = xdraw_mesh_max_slope(slope, vp_row, vp_col)
    del slope
    ext = halo_extend(m, HaloSpec(1, 1), fill=float("-inf"))

    def epilogue(i, j, b):
        hb, wb = b.shape
        y0, x0 = origin(i, j)
        dy, dx, safe_d, _, slope_tgt, vpe = fields(i, j, b)
        e = ext[i][j][:hb + 2, :wb + 2]
        ey = torch.arange(y0 - 1, y0 + hb + 1, dtype=torch.float32,
                          device=b.device)[:, None] - _f32(vp_row, b.device)
        ex = torch.arange(x0 - 1, x0 + wb + 1, dtype=torch.float32,
                          device=b.device)[None, :] - _f32(vp_col, b.device)
        ey, ex = torch.broadcast_tensors(ey, ex)
        inward = _xdraw_inward_max(e, ey, ex)[1:-1, 1:-1]
        return _xdraw_angles(inward, b, dy, dx, safe_d, slope_tgt, vpe,
                             target_elev)
    return zip_blocks(epilogue, data)


def _los_mesh_cuda(data, vp_row, vp_col, observer_elev, target_elev, ew_res,
                   ns_res, origin, vp_cell):
    """``viewshed_grid_los_mesh`` where every block is on a card: each
    block's fields and epilogue one launch each of the kernels of
    ``csrc/xdraw_cells.cu`` at the block's origin, the epilogue reading the
    combined field with its one-cell halo in place."""
    from ..parallel.halo import HaloSpec, halo_extend, zip_blocks
    from .cuda_xdraw_cells import xdraw_epilogue_cuda, xdraw_fields_cuda
    count("xdraw.cells_kernel", data.mesh.size)
    # the viewpoint's terrain goes to another card by a queued copy
    with span("dispatch.viewshed_fields"):
        slope = zip_blocks(lambda i, j, b: xdraw_fields_cuda(
            b, vp_row, vp_col, observer_elev, ew_res, ns_res, origin(i, j),
            vp_cell.to(b.device)), data)
    m = xdraw_mesh_max_slope(slope, vp_row, vp_col)
    del slope
    ext = halo_extend(m, HaloSpec(1, 1), fill=float("-inf"))
    del m
    with span("dispatch.viewshed_epilogue"):
        return zip_blocks(lambda i, j, b: xdraw_epilogue_cuda(
            ext[i][j][:b.shape[0] + 2, :b.shape[1] + 2], b, vp_row, vp_col,
            observer_elev, target_elev, ew_res, ns_res, origin(i, j),
            vp_cell.to(b.device), halo=1), data)
