"""Cast shadows for hillshade: a batched ray march toward the sun.

Counterpart of ``xrspatial_tpu/kernels/shadows.py``, which is XLA code (no
Pallas kernel).  All rays share one direction, so each step's terrain
sample is a uniform fractional shift of the whole raster: four shifted
slices of a -inf-padded copy and bilinear weights.  A cell is in shadow
when any step's sample rises above its ray.  Output semantics are the JAX
package's: Lambert shading ``(cos(theta)+1)/2`` from the surface normal,
halved in shadow, clipped to [0, 1].

The per-step offsets are host numbers, since slicing needs host integers:
every step's ``(ry, rx, fy, fx, dz*k)`` is computed at once on the host in
float32, with the JAX package's operation order, so no step waits for the
device.  ``floor`` of a near-integer offset decides which cells a step
reads, so the sun direction must carry the JAX package's bits: XLA folds
``azimuth * pi / 180`` into one multiply by the float32 constant
``f32(pi) * f32(1/180)``, and the port multiplies by the same constant,
then takes float32 ``sin``/``cos`` of the result.  Those agree with XLA's
on the CPU at the angles the tests pin; elsewhere the two may differ by
an ulp.

The bilinear blend keeps the JAX order, so ``-inf * 0`` gives NaN at the
same cells (a NaN sample compares false: it never blocks).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["shadow_mask", "hillshade_shadows", "hillshade_shadows_mesh",
           "step_offsets", "march_halo", "march_steps", "MARCH_STEPS"]

# the constant XLA makes of `* pi / 180.0` (see the module's docstring)
_DEG_TO_RAD = np.float32(np.float32(math.pi) * np.float32(1.0 / 180.0))


def _sin_cos(rad: np.float32):
    t = torch.tensor(rad, dtype=torch.float32)
    return np.float32(torch.sin(t)), np.float32(torch.cos(t))


def _sun_dir(azimuth, altitude):
    """Float32 unit vector toward the sun in world (east, north, up)
    coordinates, as host numbers."""
    sin_az, cos_az = _sin_cos(np.float32(azimuth) * _DEG_TO_RAD)
    sin_alt, cos_alt = _sin_cos(np.float32(altitude) * _DEG_TO_RAD)
    return sin_az * cos_alt, cos_az * cos_alt, sin_alt


def step_offsets(azimuth, altitude, cellsize_x, cellsize_y, n_steps: int):
    """Per-step offsets of the ray march, steps 1 .. n_steps, on the host.

    Returns ``(ry, rx, fy, fx, dzk)``: int64 row and column starts of the
    (0, 0) sample in the padded raster (pad ``n_steps + 1``), float32
    fractional weights, and the float32 height the ray has climbed.
    """
    f32 = np.float32
    sx, sy, sz = _sun_dir(azimuth, altitude)
    csx, csy = abs(f32(cellsize_x)), abs(f32(cellsize_y))
    step = min(csx, csy)
    dc = sx * step / csx                       # east -> +col
    dr = -sy * step / csy                      # north -> -row
    dz = sz / max(np.sqrt(sx * sx + sy * sy), f32(1e-9)) * step
    k = np.arange(1, n_steps + 1, dtype=np.float32)
    oy, ox = dr * k, dc * k
    oy0, ox0 = np.floor(oy), np.floor(ox)
    pad = f32(n_steps + 1)
    return ((pad + oy0).astype(np.int64), (pad + ox0).astype(np.int64),
            oy - oy0, ox - ox0, dz * k)


def march_halo(azimuth, altitude, cellsize_x, cellsize_y, n_steps: int):
    """(rows, columns) the march of `n_steps` steps reads around a cell:
    ``ceil(n |dr|) + 2`` and ``ceil(n |dc|) + 2``, the per-step offsets of
    ``step_offsets``; the halo of its mesh form."""
    f32 = np.float32
    sx, sy, _ = _sun_dir(azimuth, altitude)
    csx, csy = abs(f32(cellsize_x)), abs(f32(cellsize_y))
    step = min(csx, csy)
    dc, dr = sx * step / csx, -sy * step / csy
    return (int(math.ceil(n_steps * abs(float(dr)))) + 2,
            int(math.ceil(n_steps * abs(float(dc)))) + 2)


def _shadow_mask_impl(data: torch.Tensor, azimuth, angle_altitude,
                      cellsize_x, cellsize_y, n_steps: int) -> torch.Tensor:
    pad = n_steps + 1
    # -inf terrain (NaN cells and out of range) never blocks
    terrain = torch.where(torch.isnan(data), -math.inf, data)
    padded = F.pad(terrain, (pad, pad, pad, pad), value=-math.inf)
    del terrain
    return _march(padded, data, (pad, pad), azimuth, angle_altitude,
                  cellsize_x, cellsize_y, n_steps)


def _march(padded, data, at, azimuth, angle_altitude, cellsize_x,
           cellsize_y, n_steps: int) -> torch.Tensor:
    """The lit mask of the cells `data` (H, W), which lie at `at` (row,
    column) in the -inf padded terrain `padded`, reaching far enough."""
    h, w = data.shape
    pad = n_steps + 1
    ry, rx, fy, fx, dzk = step_offsets(azimuth, angle_altitude, cellsize_x,
                                       cellsize_y, n_steps)
    ry, rx = ry - pad + at[0], rx - pad + at[1]
    z0 = data + 1e-3
    blocked = torch.zeros((h, w), dtype=torch.bool, device=data.device)
    one = np.float32(1)
    for r, c, wy, wx, z in zip(ry.tolist(), rx.tolist(), fy, fx, dzk):
        s00 = padded[r:r + h, c:c + w]
        s01 = padded[r:r + h, c + 1:c + 1 + w]
        s10 = padded[r + 1:r + 1 + h, c:c + w]
        s11 = padded[r + 1:r + 1 + h, c + 1:c + 1 + w]
        # float32 scalars as python floats hold their float32 values
        wy0, wx0 = float(one - wy), float(one - wx)
        wy, wx = float(wy), float(wx)
        sample = ((s00 * wy0 + s10 * wy) * wx0
                  + (s01 * wy0 + s11 * wy) * wx)
        blocked |= sample > (z0 + float(z))
    return ~blocked


# the most steps a march takes
MARCH_STEPS = 1024


def march_steps(h: int, w: int, n_steps: int = MARCH_STEPS) -> int:
    """The steps an (h, w) raster's march takes: min(n_steps, 1.5 *
    max(h, w) + 2)."""
    return min(n_steps, int(1.5 * max(h, w)) + 2)


def shadow_mask(data: torch.Tensor, azimuth, angle_altitude, cellsize_x,
                cellsize_y, n_steps: int = MARCH_STEPS) -> torch.Tensor:
    """True where a cell sees the sun (not shadowed); (H, W) bool on
    `data`'s device.  Marches ``march_steps(H, W, n_steps)`` steps."""
    data = data.to(torch.float32)
    return _shadow_mask_impl(data, azimuth, angle_altitude, cellsize_x,
                             cellsize_y, march_steps(*data.shape, n_steps))


def hillshade_shadows(data: torch.Tensor, azimuth, angle_altitude,
                      cellsize_x, cellsize_y) -> torch.Tensor:
    """Lambert-shaded illumination with cast shadows, float32 (H, W) in
    [0, 1] (NaN where `data` is NaN)."""
    data = data.to(torch.float32)
    f32 = np.float32
    csx, csy = float(f32(cellsize_x)), float(f32(cellsize_y))
    # surface normal from central differences (world units)
    p = F.pad(data[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    dzdx = (p[1:-1, 2:] - p[1:-1, :-2]) / float(f32(2.0) * f32(csx))
    dzdy_north = (p[:-2, 1:-1] - p[2:, 1:-1]) / float(f32(2.0) * f32(csy))
    del p
    shade = _lambert(dzdx, dzdy_north, azimuth, angle_altitude)
    lit = shadow_mask(data, azimuth, angle_altitude, csx, csy)
    shade = torch.where(lit, shade, shade / 2.0)
    return torch.clamp(shade, 0.0, 1.0)


def _lambert(dzdx, dzdy_north, azimuth, angle_altitude):
    """Lambert shading (cos(theta) + 1) / 2 from the surface gradient."""
    inv_len = torch.rsqrt(dzdx * dzdx + dzdy_north * dzdy_north + 1.0)
    nx = -dzdx * inv_len
    ny = -dzdy_north * inv_len
    nz = inv_len
    sx, sy, sz = (float(v) for v in _sun_dir(azimuth, angle_altitude))
    cos_theta = nx * sx + ny * sy + nz * sz
    del nx, ny, nz
    return (cos_theta + 1.0) / 2.0


def _shadows_block(ext, origin, shape, halo, azimuth, angle_altitude, csx,
                   csy, n_steps):
    """``hillshade_shadows`` of the cells of the extended block `ext` (the
    raster's cells from `origin` on, -inf beyond the raster) that lie
    `halo` (rows, columns) inside its edges: the central differences read
    the neighbours with the raster's edge replicated, as the unsharded
    edge pad, and the march reads the halo.  Returns `ext`'s shape, NaN
    outside those cells."""
    data = ext.to(torch.float32)
    he, we = data.shape
    (y0, x0), (h, w), (hy, hx) = origin, shape, halo
    dev = data.device

    def near(n0, n1, off, n):
        """The extended block's indices of the neighbours before and after
        its cells [n0, n1), the raster's edge replicated."""
        g = torch.arange(n0, n1, device=dev) + off
        return (g - 1).clamp(0, n - 1) - off, (g + 1).clamp(0, n - 1) - off
    up, down = near(hy, he - hy, y0, h)
    left, right = near(hx, we - hx, x0, w)
    rows = data[hy:he - hy]
    f32 = np.float32
    dzdx = (rows[:, right] - rows[:, left]) / float(f32(2.0) * f32(csx))
    dzdy_north = (data[up][:, hx:we - hx] - data[down][:, hx:we - hx]) \
        / float(f32(2.0) * f32(csy))
    shade = _lambert(dzdx, dzdy_north, azimuth, angle_altitude)
    del dzdx, dzdy_north
    terrain = torch.where(torch.isnan(data), -math.inf, data)
    lit = _march(terrain, data[hy:he - hy, hx:we - hx], (hy, hx), azimuth,
                 angle_altitude, csx, csy, n_steps)
    shade = torch.clamp(torch.where(lit, shade, shade / 2.0), 0.0, 1.0)
    out = torch.full((he, we), math.nan, device=dev)
    out[hy:he - hy, hx:we - hx] = shade
    return out


def hillshade_shadows_mesh(data, azimuth, angle_altitude, cellsize_x,
                           cellsize_y):
    """``hillshade_shadows`` of a raster split over a mesh, as a raster of
    its tiles: ``run_stencil`` with the march's halo (``march_halo`` of
    the steps the whole raster marches), -inf beyond the raster as the
    unsharded pad, each block's origin passed so that the normals
    replicate the raster's edge only."""
    from .dispatch import run_stencil
    f32 = np.float32
    csx, csy = float(f32(cellsize_x)), float(f32(cellsize_y))
    h, w = data.shape[-2:]
    n = march_steps(h, w)
    halo = march_halo(azimuth, angle_altitude, csx, csy, n)
    return run_stencil(_shadows_block, halo, data, (h, w), halo, azimuth,
                       angle_altitude, csx, csy, n, fill=-math.inf,
                       origin=True)
