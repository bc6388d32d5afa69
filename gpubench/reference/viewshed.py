"""The plain reference of ``viewshed`` on its XDraw route (``exact=False``):
the XDraw octant-scan approximation of the line of sight, written from
its definition in plain torch, computed in the check's dtype.

The observer stands at the cell whose centre lies nearest (x, y) in the
raster's coordinates (the first of equals), ``observer_elev`` above the
terrain; a target is ``target_elev`` above a cell.  With the grid's
spacing ``ew = (x[-1] - x[0]) / (w - 1)`` and ``ns = (y[-1] - y[0]) /
(h - 1)``, a cell at offset (dy, dx) cells from the viewpoint lies
``d = sqrt((dx ew)^2 + (dy ns)^2)`` away; its own slope is ``(z -
z_vp) / d`` (-inf at the viewpoint) and its target's ``(z + target_elev
- z_vp) / d`` (+inf there), ``z_vp`` the viewpoint's elevation plus the
observer's.

Four half-plane scans walk away from the viewpoint, east and west
along the columns, south and north along the rows, one step t = 1, 2,
... a line of lanes at a time, all four together.  A lane at minor offset
o (|o| <= t inside the scan's cone, -inf outside it) carries the running
max slope m; at step t it takes ``max(blocked, s)``, s its cell's own
slope and ``blocked`` the slope that the cells one step nearer the
viewpoint hide: its own lane's m and the lane one nearer the viewpoint's
axis, interpolated with weight ``|o| / t`` on the latter (the larger of
the two where either is infinite; -inf at t = 1).  Each cell takes the
field of its own octant: east or west where |dx| >= |dy|, else south or
north.

The epilogue reads the field at each cell's primary inward neighbour (one
step toward the viewpoint along its dominant axis, the rows where |dy| >=
|dx|) and secondary (one step diagonally toward it), interpolates them
with weight ``min(|dy|, |dx|) / max(|dy|, |dx|)`` on the secondary, -inf
within one ring of the viewpoint and beyond the raster: the cell is
visible where that inward max is at most its target's slope.  Visible
cells give their vertical angle in degrees (0 straight up, 90 level),
hidden ones and NaN terrain -1, the viewpoint 180.

The scan walks a (4, max(h, w)) carry; besides the DEM and the output it
holds the slope plane and the combined field (two planes), and works the
epilogue in bands of rows.
"""

from __future__ import annotations

import math

import numpy as np
import torch

INVISIBLE = -1.0
# cells of one band of rows in the epilogue
BAND_CELLS = 1 << 22


def planes(args):
    return ["viewshed"]


def viewpoint(coords, x: float, y: float) -> tuple:
    """(row, col) of the cell whose centre lies nearest (x, y), and the
    grid's spacing (ns, ew) in the coordinates' units."""
    ys, xs = (c.detach().to("cpu", torch.float64).numpy() for c in coords)
    if not xs.min() <= x <= xs.max():
        raise ValueError("x argument outside of raster x_range")
    if not ys.min() <= y <= ys.max():
        raise ValueError("y argument outside of raster y_range")
    row = int(np.argmin(np.abs(ys - y)))
    col = int(np.argmin(np.abs(xs - x)))
    ns = (ys[-1] - ys[0]) / (ys.size - 1)
    ew = (xs[-1] - xs[0]) / (xs.size - 1)
    return row, col, float(ns), float(ew)


def _distance(rows, cols, vp, res, dtype, device):
    """(dy, dx, d) for the cells rows [rows) x every column: the offsets
    in cells as a column and a row vector, and the distance, in
    `dtype`."""
    (r, c), (ns, ew) = vp, res
    dy = (torch.arange(*rows, dtype=torch.float64, device=device)
          - r).to(dtype)[:, None]
    dx = (torch.arange(cols, dtype=torch.float64, device=device)
          - c).to(dtype)[None, :]
    wy, wx = dy * ns, dx * ew
    return dy, dx, torch.sqrt(wx * wx + wy * wy)


def _slope(z, dist, vp_elev, lift):
    """((z + lift - vp_elev) / d, d), d at least 1e-12 (the caller puts
    the viewpoint's own value)."""
    safe = torch.clamp(dist, min=1e-12)
    return (z + lift - vp_elev) / safe, safe


def _scan(slope, vp) -> torch.Tensor:
    """The combined field: each cell's running max slope from the scan of
    its own octant; -inf at the viewpoint."""
    h, w = slope.shape
    r, c = vp
    n = max(h, w)
    dev, dtype = slope.device, slope.dtype
    neginf = float("-inf")
    # the lanes' minor offsets: rows for east and west, columns for south
    # and north; padded lanes lie far outside every cone
    pad = torch.full((n,), float(3 * n), dtype=torch.float64, device=dev)
    rows = pad.clone()
    rows[:h] = torch.arange(h, dtype=torch.float64, device=dev) - r
    cols = pad.clone()
    cols[:w] = torch.arange(w, dtype=torch.float64, device=dev) - c
    minor = torch.stack([rows, rows, cols, cols]).to(dtype)
    ady = minor.abs()
    toward = torch.sign(minor)
    use_sec = ady > 0
    edge = torch.full((4, 1), neginf, dtype=dtype, device=dev)
    field = torch.full((h, w), neginf, dtype=dtype, device=dev)
    m = torch.full((4, n), neginf, dtype=dtype, device=dev)
    for t in range(1, max(w - 1 - c, c, h - 1 - r, r) + 1):
        s = torch.full((4, n), neginf, dtype=dtype, device=dev)
        if c + t < w:
            s[0, :h] = slope[:, c + t]
        if c - t >= 0:
            s[1, :h] = slope[:, c - t]
        if r + t < h:
            s[2, :w] = slope[r + t]
        if r - t >= 0:
            s[3, :w] = slope[r - t]
        up = torch.cat([edge, m[:, :-1]], 1)
        down = torch.cat([m[:, 1:], edge], 1)
        sec = torch.where(toward > 0, up, torch.where(toward < 0, down, m))
        if t == 1:
            blocked = torch.full_like(m, neginf)
        else:
            wsec = torch.where(use_sec, ady / t, 0.0)
            both = torch.isfinite(m) & torch.isfinite(sec)
            blocked = torch.where(both, m * (1.0 - wsec) + sec * wsec,
                                  torch.maximum(m, sec))
        m = torch.where(ady <= t, torch.maximum(blocked, s), neginf)
        # the cells of each octant on this step's lines
        r0, r1 = max(r - t, 0), min(r + t, h - 1) + 1
        c0, c1 = max(c - t + 1, 0), min(c + t - 1, w - 1) + 1
        if c + t < w:
            field[r0:r1, c + t] = m[0, r0:r1]
        if c - t >= 0:
            field[r0:r1, c - t] = m[1, r0:r1]
        if r + t < h and c0 < c1:
            field[r + t, c0:c1] = m[2, c0:c1]
        if r - t >= 0 and c0 < c1:
            field[r - t, c0:c1] = m[3, c0:c1]
    return field


def _epilogue(z, field, vp, res, vp_elev, target_elev, out) -> None:
    """`out` (the vertical angles) from the combined field, band by band
    of rows."""
    h, w = z.shape
    r, c = vp
    dev, dtype = z.device, z.dtype
    neginf = float("-inf")
    band = max(1, BAND_CELLS // w)
    jj = torch.arange(w, device=dev)[None, :]
    for a in range(0, h, band):
        b = min(a + band, h)
        # the field's rows [a - 1, b + 1) and columns [-1, w + 1), -inf
        # beyond the raster
        win = torch.full((b - a + 2, w + 2), neginf, dtype=dtype, device=dev)
        lo, hi = max(a - 1, 0), min(b + 1, h)
        win[lo - a + 1:hi - a + 1, 1:w + 1] = field[lo:hi]
        ii = torch.arange(a, b, device=dev)[:, None]
        iy, ix = ii - r, jj - c
        sy, sx = torch.sign(iy), torch.sign(ix)
        ay, ax = iy.abs(), ix.abs()
        dom_y = ay >= ax
        zero = torch.zeros_like(iy * ix)
        p_dy = torch.where(dom_y, -sy, zero)
        p_dx = torch.where(dom_y, zero, -sx)
        row0, col0 = ii - a + 1, jj + 1
        mp = win[row0 + p_dy, col0 + p_dx]
        ms = win[row0 - sy, col0 - sx]
        ring = torch.maximum(ay, ax)
        use_sec = torch.where(dom_y, ax > 0, ay > 0)
        wsec = torch.where(use_sec, torch.minimum(ay, ax).to(dtype)
                           / torch.clamp(ring, min=1).to(dtype),
                           torch.zeros((), dtype=dtype, device=dev))
        both = torch.isfinite(mp) & torch.isfinite(ms)
        inward = torch.where(both, mp * (1.0 - wsec) + ms * wsec,
                             torch.maximum(mp, ms))
        inward = torch.where(ring <= 1, neginf, inward)

        zb = z[a:b]
        _, _, dist = _distance((a, b), w, vp, res, dtype, dev)
        tgt, safe = _slope(zb, dist, vp_elev, target_elev)
        tgt = torch.where(dist > 0, tgt, float("inf"))
        visible = inward <= tgt
        diff = vp_elev - (zb + target_elev)
        deg = 180.0 / math.pi
        vert = torch.where(
            diff == 0.0, 90.0,
            torch.where(diff > 0,
                        torch.atan(safe / torch.where(diff == 0, 1.0, diff))
                        * deg,
                        torch.atan(diff.abs() / safe) * deg + 90.0))
        angle = torch.where(visible & ~torch.isnan(zb), vert, INVISIBLE)
        out[a:b] = torch.where((iy == 0) & (ix == 0), 180.0, angle)


def run(raster, coords, args, dtype=torch.float64):
    if args.get("exact", None) is not False:
        raise NotImplementedError("the reference is XDraw's: exact=False")
    if coords is None:
        raise ValueError("viewshed needs the raster's coordinates")
    h, w = raster.shape
    r, c, ns, ew = viewpoint(coords, float(args["x"]), float(args["y"]))
    vp, res = (r, c), (ns, ew)
    z = raster.to(dtype)
    dev = z.device
    vp_elev = z[r, c] + float(args.get("observer_elev", 0.0))
    target_elev = float(args.get("target_elev", 0.0))
    slope = torch.empty_like(z)
    band = max(1, BAND_CELLS // w)
    for a in range(0, h, band):
        b = min(a + band, h)
        _, _, dist = _distance((a, b), w, vp, res, dtype, dev)
        s, _ = _slope(z[a:b], dist, vp_elev, 0.0)
        slope[a:b] = torch.where(dist > 0, s, float("-inf"))
    field = _scan(slope, vp)
    del slope
    out = torch.empty_like(z)
    _epilogue(z, field, vp, res, vp_elev, target_elev, out)
    return {"viewshed": out}
