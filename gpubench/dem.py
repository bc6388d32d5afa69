"""The DEM of a configuration, made from the seed on the device(s).

The recipe is the reference benchmark's (xarray-spatial's
``benchmarks/benchmarks/common.py``: a smooth surface plus normal noise of
sigma 2 m) on the surface of the port's earlier smoke runs: a Gaussian
hill with ripples over [-1, 1]^2,

    z = height * exp(-4 (x^2 + y^2)) + ripple * sin(40 x) cos(40 y)
        + noise_sigma * N(0, 1),

in float32.  A raster on a mesh is made block by block, each block on its
own device: the hill from the whole raster's coordinates (``linspace``
over the whole extent, then the block's slice), the noise from a
generator on the block's device seeded with ``block_seed(seed, i, j)``.
So no block passes through another device or the host, and the whole
raster is the same whichever device makes which block.  One card holds
block (0, 0) of a 1x1 grid.

A configuration whose ``"coords"`` is ``"cell_centres"`` gives its raster
coordinates in metres, north up as a 3DEP GeoTIFF lies: x eastward from
the west edge, ``(j + 0.5) cellsize_x``, and y southward from the north
edge, ``(ny - i - 0.5) cellsize_y`` (``coords``).  Without the key the
raster has none.
"""

from __future__ import annotations

import numpy as np
import torch

MASK64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """splitmix64's finaliser."""
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9 & MASK64
    z = (z ^ (z >> 27)) * 0x94D049BB133111EB & MASK64
    return z ^ (z >> 31)


def block_seed(seed: int, i: int, j: int) -> int:
    """The noise generator's seed of block (i, j), for any whole `seed`
    (negative or above 64 bits included): 63 bits, so every
    ``torch.Generator`` takes it."""
    z = _mix64((int(seed) & MASK64) ^ 0x9E3779B97F4A7C15)
    z = _mix64(z ^ ((int(seed) >> 64) & MASK64))
    z = _mix64(z ^ (i * 0x100000001B3 + j + 1))
    return z >> 1


def tile_extent(n: int, m: int, i: int) -> tuple:
    """(start, stop) of block i when n cells are split over m blocks:
    blocks of ceil(n / m) cells, the last ones shorter."""
    t = -(-n // m)
    return min(i * t, n), min((i + 1) * t, n)


def grid(config) -> tuple:
    """(blocks in y, blocks in x) of a configuration: its "mesh", or 1x1."""
    mesh = config.get("mesh") or (1, 1)
    return int(mesh[0]), int(mesh[1])


def block_extents(config, i: int, j: int) -> tuple:
    """((y0, y1), (x0, x1)) of block (i, j) of the configuration's raster."""
    (ny, nx), (my, mx) = config["shape"], grid(config)
    return tile_extent(ny, my, i), tile_extent(nx, mx, j)


def coords(config):
    """``(y, x)``, the whole raster's cell-centre coordinates as float64
    numpy arrays in metres, where the configuration's ``"coords"`` says
    ``"cell_centres"``; None where it has no ``"coords"``."""
    kind = config.get("coords")
    if kind is None:
        return None
    if kind != "cell_centres":
        raise ValueError(f"coords {kind!r}: only 'cell_centres' is known")
    (ny, nx), (csx, csy) = config["shape"], config["cellsize_m"]
    x = (np.arange(nx, dtype=np.float64) + 0.5) * float(csx)
    y = (ny - np.arange(ny, dtype=np.float64) - 0.5) * float(csy)
    return y, x


def hill(config, rows, cols, device) -> torch.Tensor:
    """The noise-free surface at rows [rows) x cols [cols) of the raster,
    from the whole raster's coordinates."""
    ny, nx = config["shape"]
    d = config["dem"]
    y = torch.linspace(-1.0, 1.0, ny, dtype=torch.float32,
                       device=device)[rows[0]:rows[1], None]
    x = torch.linspace(-1.0, 1.0, nx, dtype=torch.float32,
                       device=device)[None, cols[0]:cols[1]]
    z = float(d["height_m"]) * torch.exp(-(x * x + y * y) * 4.0)
    return z + float(d["ripple_m"]) * torch.sin(x * 40.0) * torch.cos(
        y * 40.0)


def noise(config, seed: int, i: int, j: int, shape, device) -> torch.Tensor:
    """Block (i, j)'s noise: sigma * N(0, 1) from its own generator."""
    g = torch.Generator(device=device)
    g.manual_seed(block_seed(seed, i, j))
    z = torch.randn(tuple(shape), generator=g, dtype=torch.float32,
                    device=device)
    return z.mul_(float(config["dem"]["noise_sigma_m"]))


def make_block(config, seed: int, i: int, j: int, device) -> torch.Tensor:
    """Block (i, j) of the configuration's DEM, made on `device`."""
    rows, cols = block_extents(config, i, j)
    z = hill(config, rows, cols, device)
    return z.add_(noise(config, seed, i, j, z.shape, device))


def make_blocks(config, seed: int, devices) -> list:
    """The DEM as a grid of blocks, block (i, j) on
    ``devices[i * mx + j]``."""
    my, mx = grid(config)
    return [[make_block(config, seed, i, j, devices[i * mx + j])
             for j in range(mx)] for i in range(my)]


def make_whole(config, seed: int, device) -> torch.Tensor:
    """The whole DEM on one device: the hill over the whole raster at
    once, each block's noise in its place."""
    ny, nx = config["shape"]
    z = hill(config, (0, ny), (0, nx), device)
    my, mx = grid(config)
    for i in range(my):
        for j in range(mx):
            (y0, y1), (x0, x1) = block_extents(config, i, j)
            z[y0:y1, x0:x1] += noise(config, seed, i, j, (y1 - y0, x1 - x0),
                                     device)
    return z
