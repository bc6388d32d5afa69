"""The plain reference of ``proximity`` (EUCLIDEAN): the exact Euclidean
distance from each cell centre to the nearest target cell centre, in the
coordinates' units, computed in the check's dtype; NaN where the raster
has no target (or, with ``max_distance``, none that near).

Targets are the cells equal to one of ``target_values`` (each as the
op takes it), or every non-zero finite cell where the list is empty.  The
distance transform is separable and exact, and owes nothing to the jump
flood:

1. per column, the nearest target row above and below each cell, by a
   running max (min) of the target rows' indices down (up) the column;
   with monotone y the nearer of the two in y is the column's nearest,
   at ``g`` (inf where the column has none);
2. per row, ``d^2(j) = min_k g_k^2 + (x_j - x_k)^2``.  With monotone x
   the cost is a Monge array, so the leftmost minimising k is monotone
   in j: divide and conquer on it finds each row's minima, the middle
   column of each stretch first, over the candidates its neighbours
   leave, all rows of a band at once and the candidates of a level as
   one flat array (O(w log w) a row).

Both passes work in bands (of columns, then of rows), so beside its
input and output the reference holds one plane of ``g^2``.
"""

from __future__ import annotations

import math

import torch

# candidate pairs of one band of rows at one level of the row pass
BAND_PAIRS = 1 << 24
# cells of one band of columns in the column pass
BAND_CELLS = 1 << 24


def planes(args):
    return ["proximity"]


def as_f32(v) -> float:
    """`v` rounded to float32, as the op compares it with its float32
    raster."""
    return float(torch.tensor(float(v), dtype=torch.float32))


def targets(z, values) -> torch.Tensor:
    """The target cells of the raster `z`."""
    if len(values) == 0:
        return (z != 0) & torch.isfinite(z)
    hit = torch.zeros(z.shape, dtype=torch.bool, device=z.device)
    for v in values:
        hit |= z == as_f32(v)
    return hit


def _monotone(c, what):
    d = torch.diff(c)
    if not (bool((d > 0).all()) or bool((d < 0).all())):
        raise ValueError(f"proximity's reference needs strictly monotone "
                         f"{what} coordinates")


def column_pass(hit, y, out) -> None:
    """``out`` (h, w) = g^2: the squared distance in y from each cell to
    the nearest target of its column (inf where it has none)."""
    h, w = hit.shape
    dev = hit.device
    rows = torch.arange(h, device=dev)[:, None]
    band = max(1, BAND_CELLS // h)
    inf = float("inf")
    yc = y[:, None]
    for a in range(0, w, band):
        t = hit[:, a:a + band]
        above = torch.cummax(torch.where(t, rows, -1), 0).values
        below = torch.cummin(torch.where(t, rows, h).flip(0), 0).values \
            .flip(0)
        ga = torch.where(above >= 0, (yc - y[above.clamp(min=0)]).abs(),
                         inf)
        gb = torch.where(below < h, (y[below.clamp(max=h - 1)] - yc).abs(),
                         inf)
        g = torch.minimum(ga, gb)
        out[:, a:a + band] = g * g


def row_pass(g2, x) -> torch.Tensor:
    """(B, w) ``min_k g2[:, k] + (x_j - x_k)^2`` of a band of rows `g2`,
    by divide and conquer on the monotone leftmost argmin."""
    b, w = g2.shape
    dev = g2.device
    out = torch.empty_like(g2)
    # the stretches [jlo, jhi] of a level, common to every row, and each
    # row's candidates [llo, lhi] for each stretch
    jlo = torch.zeros(1, dtype=torch.int64, device=dev)
    jhi = torch.full((1,), w - 1, dtype=torch.int64, device=dev)
    llo = torch.zeros((b, 1), dtype=torch.int64, device=dev)
    lhi = torch.full((b, 1), w - 1, dtype=torch.int64, device=dev)
    rowsb = torch.arange(b, device=dev)[:, None]
    big = torch.iinfo(torch.int64).max
    while jlo.numel():
        m = jlo.numel()
        jm = (jlo + jhi) // 2
        count = (lhi - llo + 1).reshape(-1)
        seg = torch.repeat_interleave(
            torch.arange(b * m, device=dev), count)
        first = torch.cumsum(count, 0) - count
        k = llo.reshape(-1)[seg] + (torch.arange(seg.numel(), device=dev)
                                    - first[seg])
        row = seg // m
        dx = x[jm[seg % m]] - x[k]
        # each cost rounded in the dtype, then held exactly in float64
        # for the reduction
        cost = (g2[row, k] + dx * dx).to(torch.float64)
        best = torch.full((b * m,), float("inf"), dtype=torch.float64,
                          device=dev)
        best.scatter_reduce_(0, seg, cost, "amin")
        arg = torch.full((b * m,), big, dtype=torch.int64, device=dev)
        arg.scatter_reduce_(0, seg, torch.where(cost == best[seg], k, big),
                            "amin")
        del seg, k, row, dx, cost, first
        out[rowsb, jm[None, :]] = best.view(b, m).to(out.dtype)
        arg = arg.view(b, m)
        left, right = jm > jlo, jm < jhi
        jlo, jhi, llo, lhi = (
            torch.cat([jlo[left], jm[right] + 1]),
            torch.cat([jm[left] - 1, jhi[right]]),
            torch.cat([llo[:, left], arg[:, right]], 1),
            torch.cat([arg[:, left], lhi[:, right]], 1))
    return out


def run(raster, coords, args, dtype=torch.float64):
    metric = args.get("distance_metric", "EUCLIDEAN")
    if metric != "EUCLIDEAN":
        raise NotImplementedError(f"the reference is EUCLIDEAN's, not "
                                  f"{metric}'s")
    if coords is None:
        raise ValueError("proximity needs the raster's coordinates")
    y, x = (c.to(device=raster.device, dtype=torch.float64) for c in coords)
    _monotone(y, "y")
    _monotone(x, "x")
    y, x = y.to(dtype), x.to(dtype)
    z = raster.to(dtype)
    h, w = z.shape
    g2 = torch.empty((h, w), dtype=dtype, device=z.device)
    column_pass(targets(z, args.get("target_values", [])), y, g2)
    out = torch.empty_like(g2)
    band = max(1, BAND_PAIRS // (2 * w))
    for a in range(0, h, band):
        out[a:a + band] = torch.sqrt(row_pass(g2[a:a + band], x))
    del g2
    limit = args.get("max_distance")
    bound = as_f32(math.inf if limit is None else limit)
    near = torch.isfinite(out) & (out <= bound)
    return {"proximity": torch.where(near, out, float("nan"))}
