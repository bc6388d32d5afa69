"""The check of a local (stencil) op: every cell of every output plane
against the op's plain reference, block by block and in bands of rows.
It judges the job's last step alone (a job of one step).

For each block of the raster's grid, on that block's device, the DEM's
window of a band of rows with the reference's halo is put together from
the benchmark's own DEM blocks (NaN beyond the raster), the reference
computes the band's planes in float64, and what is judged (the program's
output, or the reference again in a lower precision: the control) is
compared with them.  Per plane it keeps the widest gap between two finite
values, the largest finite reference value and the cells where one side
is NaN and the other is not.  So the seams between blocks, the raster's
border and every interior cell are compared.
"""

from __future__ import annotations

import torch

from gpubench import dem as demlib

# cells of one band's window: 256 MiB a float64 plane
BAND_CELLS = 1 << 25


def dem_window(blocks, config, rows, cols, device) -> torch.Tensor:
    """The DEM at rows [rows) x cols [cols) as float64 on `device`, NaN
    outside the raster."""
    out = torch.full((rows[1] - rows[0], cols[1] - cols[0]), float("nan"),
                     dtype=torch.float64, device=device)
    for i, row in enumerate(blocks):
        for j, blk in enumerate(row):
            (y0, y1), (x0, x1) = demlib.block_extents(config, i, j)
            a, b = max(y0, rows[0]), min(y1, rows[1])
            c, d = max(x0, cols[0]), min(x1, cols[1])
            if a < b and c < d:
                out[a - rows[0]:b - rows[0], c - cols[0]:d - cols[0]].copy_(
                    blk[a - y0:b - y0, c - x0:d - x0].to(device))
    return out


def planes(job) -> list:
    """The planes compared: the last step's reference's."""
    return job[-1].reference.planes(job[-1].args)


def fold(acc, r, g, zero) -> None:
    """Fold a reference tile `r` and a judged tile `g` (float64, one
    device) into `acc`, ``[widest gap, largest |reference|, NaN
    mismatches]`` of a plane."""
    nr, ng = torch.isnan(r), torch.isnan(g)
    both = ~(nr | ng)
    gap = torch.where(both, (g - r).abs(), zero).max()
    mag = torch.where(nr, zero, r.abs()).max()
    acc[0] = torch.maximum(acc[0], gap)
    acc[1] = torch.maximum(acc[1], mag)
    acc[2] = acc[2] + (nr != ng).sum()


def merge(acc) -> dict:
    """Per plane ``(gap, mag, bad)`` as numbers, over the devices of `acc`
    (``{device: {plane: fold's list}}``)."""
    out = {}
    for per_dev in acc.values():
        for p, (gap, mag, bad) in per_dev.items():
            g0, m0, b0 = out.get(p, (0.0, 0.0, 0))
            out[p] = (max(g0, gap.item()), max(m0, mag.item()),
                      b0 + int(bad.item()))
    return out


def gaps(config, blocks, job, judged) -> dict:
    """Per plane ``(widest gap, largest |reference|, NaN mismatches)`` of
    the last step of `job` (``jobs.Step``s).

    ``judged(i, j, rows, cols, win)`` gives the judged planes of the cells
    rows [rows) x cols [cols) of block (i, j), as a dict of tensors on the
    block's device (`win` is the DEM band with its halo, for a control that
    computes from it).
    """
    ny, nx = config["shape"]
    reference, args = job[-1].reference, job[-1].args
    cellsize = tuple(config["cellsize_m"])
    ry, rx = reference.halo(args)
    names = reference.planes(args)
    acc = {}
    for i, row in enumerate(blocks):
        for j, blk in enumerate(row):
            dev = blk.device
            (y0, y1), (x0, x1) = demlib.block_extents(config, i, j)
            band = max(1, BAND_CELLS // (x1 - x0 + 2 * rx))
            zero = torch.zeros((), dtype=torch.float64, device=dev)
            a = acc[dev] = acc.get(dev) or {
                p: [zero, zero, zero.to(torch.int64)] for p in names}
            for r0 in range(y0, y1, band):
                r1 = min(r0 + band, y1)
                win = dem_window(blocks, config, (r0 - ry, r1 + ry),
                                 (x0 - rx, x1 + rx), dev)
                ref = reference.run(win, (r0, x0), (ny, nx), args, cellsize)
                got = judged(i, j, (r0, r1), (x0, x1), win)
                for p in names:
                    fold(a[p], ref[p],
                         got[p].to(device=dev, dtype=torch.float64), zero)
                del win, ref, got
    return merge(acc)


def numbers(per_plane: dict) -> dict:
    """The numbers compared: ``nan_mismatch`` (all planes) and, per plane,
    ``<plane>_err``, its widest gap over its largest |reference| (an
    infinite or NaN gap reads as infinity)."""
    out = {"nan_mismatch": float(sum(b for _, _, b in per_plane.values()))}
    for p, (gap, mag, _) in per_plane.items():
        e = gap / mag if mag > 0 else (0.0 if gap == 0 else float("inf"))
        out[f"{p}_err"] = e if e == e else float("inf")
    return out


def program(planes: dict, config):
    """`judged` for the program's output: `planes` maps a plane name to
    its grid of blocks (``[[tensor]]``, block (i, j) on the DEM block's
    device and of its extent)."""
    def judged(i, j, rows, cols, win):
        (y0, _), _ = demlib.block_extents(config, i, j)
        return {p: grid[i][j][rows[0] - y0:rows[1] - y0]
                for p, grid in planes.items()}
    return judged


def control(job, config, dtype):
    """`judged` for the control: the reference itself in `dtype`."""
    ny, nx = config["shape"]
    reference, args = job[-1].reference, job[-1].args
    cellsize = tuple(config["cellsize_m"])

    def judged(i, j, rows, cols, win):
        return reference.run(win, (rows[0], cols[0]), (ny, nx), args,
                             cellsize, dtype)
    return judged
