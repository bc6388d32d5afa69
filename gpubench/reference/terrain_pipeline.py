"""Plain reference of ``terrain_pipeline``: surface products and focal
statistics of one DEM, straight from their definitions.

- slope (Horn): ``dz/dx = ((c + 2f + i) - (a + 2d + g)) / (8 cellsize_x)``,
  ``dz/dy = ((g + 2h + i) - (a + 2b + c)) / (8 cellsize_y)`` over the 3x3
  neighbours ``a b c / d e f / g h i``; slope = atan(|grad z|) in degrees;
- hillshade (from ``np.gradient`` in cell units): ``gx`` along the rows,
  ``gy`` along the columns, central differences; the sun's slope
  ``pi/2 - atan(|g|)`` and aspect ``atan2(-gx, gy)``; shaded =
  ``sin(alt) sin(slope) + cos(alt) cos(slope) cos((360 - azimuth) -
  90 degrees - aspect)``; result ``(shaded + 1) / 2``;
- both NaN on the raster's outer ring of cells and wherever a neighbour
  is NaN;
- focal statistics over the footprint's cells that lie inside the raster
  and are not NaN: mean, max, min and the population std (deviations from
  the window's mean); NaN where no cell counts.

``run`` computes on a window of the DEM that holds the output's cells and
a halo of ``halo(args)`` cells (NaN beyond the raster), in `dtype`.
"""

import functools
import math

import torch

PRODUCTS = ("slope", "hillshade")
STATS = ("mean", "max", "min", "std")


def footprint(args) -> torch.Tensor:
    k = args.get("kernel")
    if k is None:       # the op's default, circle_kernel(1, 1, 1.5)
        k = [[0, 1, 0], [1, 1, 1], [0, 1, 0]]
    return torch.as_tensor(k) != 0


def halo(args) -> tuple:
    fp = footprint(args)
    return max(1, fp.shape[0] // 2), max(1, fp.shape[1] // 2)


def planes(args) -> list:
    surface = list(args.get("surface", PRODUCTS))
    stats = list(args.get("stats_funcs", STATS))
    for p in surface:
        if p not in PRODUCTS:
            raise NotImplementedError(f"no reference for product {p!r}")
    for s in stats:
        if s not in STATS:
            raise NotImplementedError(f"no reference for stat {s!r}")
    return surface + stats


def run(win, origin, shape, args, cellsize, dtype=torch.float64) -> dict:
    """The planes at cells [r0, r0 + h) x [c0, c0 + w) of a raster of
    `shape`, (r0, c0) = `origin`, from `win`: those cells with a halo of
    ``halo(args)`` (NaN beyond the raster)."""
    ry, rx = halo(args)
    x = win.to(dtype)
    h, w = x.shape[0] - 2 * ry, x.shape[1] - 2 * rx
    out = {}
    surface = list(args.get("surface", PRODUCTS))
    if surface:
        def nb(dy, dx):
            return x[ry + dy:ry + dy + h, rx + dx:rx + dx + w]
        a, b, c = nb(-1, -1), nb(-1, 0), nb(-1, 1)
        d, f = nb(0, -1), nb(0, 1)
        g, hh, i = nb(1, -1), nb(1, 0), nb(1, 1)
        rows = torch.arange(origin[0], origin[0] + h, device=x.device)
        cols = torch.arange(origin[1], origin[1] + w, device=x.device)
        ring = ((rows == 0) | (rows == shape[0] - 1))[:, None] | \
            ((cols == 0) | (cols == shape[1] - 1))[None, :]
        csx, csy = cellsize
    for p in surface:
        if p == "slope":
            dzdx = ((c + 2 * f + i) - (a + 2 * d + g)) / (8 * csx)
            dzdy = ((g + 2 * hh + i) - (a + 2 * b + c)) / (8 * csy)
            v = torch.rad2deg(torch.atan(torch.sqrt(dzdx * dzdx
                                                    + dzdy * dzdy)))
        else:
            az = math.radians(360.0 - args.get("azimuth", 225.0))
            alt = math.radians(args.get("angle_altitude", 25.0))
            gx = (hh - b) / 2
            gy = (f - d) / 2
            sl = math.pi / 2 - torch.atan(torch.sqrt(gx * gx + gy * gy))
            aspect = torch.atan2(-gx, gy)
            shaded = math.sin(alt) * torch.sin(sl) + math.cos(alt) * \
                torch.cos(sl) * torch.cos((az - math.pi / 2) - aspect)
            v = (shaded + 1) / 2
        out[p] = torch.where(ring, math.nan, v)
    stats = list(args.get("stats_funcs", STATS))
    if stats:
        fp = footprint(args)
        ky, kx = fp.shape[0] // 2, fp.shape[1] // 2
        cells = [x[ry + dy:ry + dy + h, rx + dx:rx + dx + w]
                 for dy in range(-ky, ky + 1) for dx in range(-kx, kx + 1)
                 if fp[dy + ky, dx + kx]]
        zero = torch.zeros((), dtype=dtype, device=x.device)
        count = sum((~torch.isnan(s)).to(dtype) for s in cells)
        total = sum(torch.where(torch.isnan(s), zero, s) for s in cells)
        none = count == 0
        mean = torch.where(none, math.nan, total / count)
        if "max" in stats:
            mx = functools.reduce(torch.maximum, [
                torch.where(torch.isnan(s), -math.inf, s) for s in cells])
            out["max"] = torch.where(none, math.nan, mx)
        if "min" in stats:
            mn = functools.reduce(torch.minimum, [
                torch.where(torch.isnan(s), math.inf, s) for s in cells])
            out["min"] = torch.where(none, math.nan, mn)
        if "std" in stats:
            dev2 = sum(torch.where(torch.isnan(s), zero, (s - mean) ** 2)
                       for s in cells)
            out["std"] = torch.sqrt(dev2 / count)
        if "mean" in stats:
            out["mean"] = mean
    return {p: out[p] for p in planes(args)}
