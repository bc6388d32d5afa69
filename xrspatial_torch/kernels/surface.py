"""3x3 surface stencils: slope / aspect / curvature / hillshade.

Counterpart of ``xrspatial_tpu/kernels/surface.py``.  The functions here
are the torch twins, the plain versions of the CUDA kernel in
``cuda_surface.py``: one shared neighbourhood gather feeds per-product
epilogues, in the same float32 operation order as the JAX package.

Dispatch (``surface_kernels``, ``run_surface_op``, ``surface_stacked``): a
raster split over a mesh goes through ``dispatch.run_stencil``, each
tile and band (or extended block) back through this dispatch (``surface_stacked`` has
no mesh form); a tensor on the CPU goes to the twins, a tensor on the
card to a CUDA kernel
(B1, ``surface_staged_kernel``, on the route ``surface_plan`` names, or B0
for the stacked output, on the route ``stacked_plan`` names), at every
size.  The twins, and the first ports ``surface_kernel`` (B1) and
``surface_stacked_kernel`` (B0), are reached on the card only by calling
them by name (route "simple").

``surface_plan`` plans B1's staged kernel: persistent blocks walking
``SURFACE_TILE`` tiles through a ring of TMA-staged windows
(``kernels/staged.py::staged_plan``), TMA where the row pitch and the base
are 16-byte aligned, cp.async elsewhere.  ``stacked_plan`` plans B0 on the
same ring: route "tma" (B1's staged kernel on the planes of one buffer)
where the pitch and the bases are 16-byte aligned, else route "phased"
(``csrc/surface.cu::surface_phased_kernel``: 16-byte copies of each
window row's aligned body, each plane written in spans that start on its
own 32-byte sectors).

Numerical contracts (all float32):
- slope:   Horn 3x3 gradient, ``atan(|grad z|)*57.29578``;
- aspect:  compass direction, flat -> -1;
- curvature: ``-2*(d+e)*100/cellsize^2`` plus-shaped stencil;
- hillshade: np.gradient-based illumination, ``(shaded+1)/2``, rsqrt form;
- all products: 1-cell NaN border.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..tracing import span
from .staged import SMEM_PER_SM, StagedPlan, staged_plan

DEG = 57.29578  # the reference's degree conversion constant

PRODUCTS = ("slope", "aspect", "curvature", "hillshade")

# B1's staged kernel: the tiles csrc/surface.cu instantiates, (rows,
# columns), and the one the plan takes, the fastest of the three at the
# main path's 16384^2 on an H100 (chip_smoke.py phase 5; at 3 blocks an SM
# all three were faster than at 2)
SURFACE_TILES = ((32, 128), (64, 128), (32, 248))
SURFACE_TILE = (64, 128)
# blocks an SM the kernel is compiled for (csrc/surface.cu kBlocksPerSm,
# its register cap: 80 registers a thread) and the ring is sized for
SURFACE_BLOCKS_PER_SM = 3

# B0 on the ring: its routes, the tiles csrc/surface.cu compiles on each
# (rows, columns written), and the tile each route's plan takes, chosen by
# timing all four products at 16384^2 and 16383^2 on an H100 (chip_smoke.py
# phase 17).  The phased kernel's warps compute 128 cells of a tile row
# (32 quads) from SPAN_SHIFT columns left of the tile and write each
# plane's SPAN_CELLS-cell span that starts on a 32-byte boundary of it
# (csrc/surface_cell.cuh::store_span): its tiles lie SPAN_CELLS apart, and
# one more covers a row whose last span ends past the last tile.
STACKED_ROUTES = ("tma", "phased")
SPAN_CELLS, SPAN_SHIFT = 120, 8
STACKED_TILES = {"tma": SURFACE_TILES,
                 "phased": ((32, SPAN_CELLS), (64, SPAN_CELLS))}
STACKED_TILE = {"tma": (64, 128), "phased": (64, SPAN_CELLS)}
# a phased window row: the TMA box's columns and 4 more, so that a row
# placed at its phase (0-3 floats in) still holds them all
PHASED_ROW_PAD = 4

__all__ = [
    "neighborhood", "slope_from_neighbors", "aspect_from_neighbors",
    "curvature_from_center", "hillshade_from_gradient", "sun_scalars",
    "slope", "aspect", "curvature", "hillshade", "surface_multi",
    "surface_multi_stacked", "surface_kernels", "surface_stacked",
    "check_products", "surface_plan", "StackedPlan", "stacked_plan",
    "run_surface_op", "PRODUCTS", "SURFACE_TILES", "SURFACE_TILE",
    "SURFACE_BLOCKS_PER_SM", "STACKED_ROUTES", "STACKED_TILES",
    "STACKED_TILE", "PHASED_ROW_PAD", "SPAN_CELLS", "SPAN_SHIFT",
]


def _f32(value, device) -> torch.Tensor:
    """A float32 0-d tensor on `device` (the twins' scalar parameters)."""
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def neighborhood(data: torch.Tensor):
    """Return the 9 shifted neighbour views of a 2D tensor.

    Layout: ``a b c`` = row above (y-1), ``d e f`` = center row, ``g h i``
    = row below (y+1).  Borders are NaN-padded; callers NaN the border ring
    anyway.
    """
    p = F.pad(data, (1, 1, 1, 1), value=math.nan)
    a = p[:-2, :-2]
    b = p[:-2, 1:-1]
    c = p[:-2, 2:]
    d = p[1:-1, :-2]
    e = p[1:-1, 1:-1]
    f = p[1:-1, 2:]
    g = p[2:, :-2]
    h = p[2:, 1:-1]
    i = p[2:, 2:]
    return a, b, c, d, e, f, g, h, i


def _nan_border(out: torch.Tensor) -> torch.Tensor:
    """NaN the 1-cell ring of a freshly computed output, in place."""
    out[0, :] = math.nan
    out[-1, :] = math.nan
    out[:, 0] = math.nan
    out[:, -1] = math.nan
    return out


def slope_from_neighbors(nb, cellsize_x, cellsize_y):
    a, b, c, d, e, f, g, h, i = nb
    # Horn gradient; dz_dy sign is irrelevant to the magnitude
    dz_dx = ((c + 2.0 * f + i) - (a + 2.0 * d + g)) / (8.0 * cellsize_x)
    dz_dy = ((g + 2.0 * h + i) - (a + 2.0 * b + c)) / (8.0 * cellsize_y)
    p = torch.sqrt(dz_dx * dz_dx + dz_dy * dz_dy)
    return torch.atan(p) * DEG


def aspect_from_neighbors(nb):
    a, b, c, d, e, f, g, h, i = nb
    dz_dx = ((c + 2.0 * f + i) - (a + 2.0 * d + g)) / 8.0
    dz_dy = ((g + 2.0 * h + i) - (a + 2.0 * b + c)) / 8.0
    angle = torch.atan2(dz_dy, -dz_dx) * (180.0 / math.pi)
    # convert math angle -> compass direction (0-360, 0 = north)
    compass = torch.where(angle < 0.0, 90.0 - angle,
                          torch.where(angle > 90.0, 450.0 - angle,
                                      90.0 - angle))
    flat = (dz_dx == 0.0) & (dz_dy == 0.0)
    return torch.where(flat, -1.0, compass)


def curvature_from_center(nb, cellsize):
    a, b, c, d, e, f, g, h, i = nb
    dd = (h + b) * 0.5 - e
    ee = (f + d) * 0.5 - e
    return -2.0 * (dd + ee) * 100.0 / (cellsize * cellsize)


def sun_scalars(azimuth, angle_altitude):
    """(sin_a, cos_a, sin_p, cos_p) of the sun, from float32 0-d tensors,
    in the order of the JAX package's ``hillshade_from_gradient``."""
    azrad = (360.0 - azimuth) * (math.pi / 180.0)
    altrad = angle_altitude * (math.pi / 180.0)
    phi = azrad - math.pi / 2.0
    return torch.sin(altrad), torch.cos(altrad), torch.sin(phi), torch.cos(phi)


def hillshade_from_gradient(nb, azimuth, angle_altitude):
    """The np.gradient formulation, simplified to one rsqrt per cell.

    With L = |grad| and aspect = atan2(-gx, gy):
      sin(pi/2 - atan L) = 1/sqrt(1+L^2),  cos(pi/2 - atan L) = L/sqrt(1+L^2)
      cos(phi - aspect)  = (cos(phi)*gy - sin(phi)*gx) / L
    so  shaded = (sinA + cosA*(cos(phi)*gy - sin(phi)*gx)) * rsqrt(1+L^2).
    """
    a, b, c, d, e, f, g, h, i = nb
    gx = (h - b) * 0.5  # gradient along axis 0 (rows)
    gy = (f - d) * 0.5  # gradient along axis 1 (cols)
    sin_a, cos_a, sin_p, cos_p = sun_scalars(azimuth, angle_altitude)
    shaded = ((sin_a + cos_a * (cos_p * gy - sin_p * gx))
              * torch.rsqrt(1.0 + gx * gx + gy * gy))
    return (shaded + 1.0) / 2.0


# ---------------------------------------------------------------------------
# single-product twins (the JAX package's slope_jit ... hillshade_jit)
# ---------------------------------------------------------------------------

def slope(data, cellsize_x, cellsize_y):
    data = data.to(torch.float32)
    out = slope_from_neighbors(neighborhood(data),
                               _f32(cellsize_x, data.device),
                               _f32(cellsize_y, data.device))
    return _nan_border(out)


def aspect(data):
    data = data.to(torch.float32)
    return _nan_border(aspect_from_neighbors(neighborhood(data)))


def curvature(data, cellsize):
    data = data.to(torch.float32)
    out = curvature_from_center(neighborhood(data),
                                _f32(cellsize, data.device))
    return _nan_border(out)


def hillshade(data, azimuth, angle_altitude):
    data = data.to(torch.float32)
    out = hillshade_from_gradient(neighborhood(data),
                                  _f32(azimuth, data.device),
                                  _f32(angle_altitude, data.device))
    return _nan_border(out)


def surface_multi(data, cellsize_x, cellsize_y, azimuth, angle_altitude,
                  which=PRODUCTS):
    """Compute several surface products from one neighbourhood gather."""
    data = data.to(torch.float32)
    dev = data.device
    nb = neighborhood(data)
    csx = _f32(cellsize_x, dev)
    csy = _f32(cellsize_y, dev)
    outs = {}
    if "slope" in which:
        outs["slope"] = _nan_border(slope_from_neighbors(nb, csx, csy))
    if "aspect" in which:
        outs["aspect"] = _nan_border(aspect_from_neighbors(nb))
    if "curvature" in which:
        outs["curvature"] = _nan_border(
            curvature_from_center(nb, (csx + csy) * 0.5))
    if "hillshade" in which:
        outs["hillshade"] = _nan_border(hillshade_from_gradient(
            nb, _f32(azimuth, dev), _f32(angle_altitude, dev)))
    return outs


def surface_plan(h: int, w: int, ptr: int = 0, tile=SURFACE_TILE,
                 sms: int = 132) -> StagedPlan:
    """How B1's staged kernel runs an (h, w) float32 raster at input
    address `ptr` on `sms` SMs: ``staged_plan`` at `tile`, one of
    ``SURFACE_TILES``, its ring sized for ``SURFACE_BLOCKS_PER_SM`` blocks
    an SM (2 stages at 64x128).  The route is "tma" where ``w % 4 == 0``
    and ``ptr % 16 == 0``, else "async"."""
    tile = tuple(tile)
    if tile not in SURFACE_TILES:
        raise ValueError(f"surface_staged_kernel has no tile {tile}; it is "
                         f"compiled at {SURFACE_TILES}")
    return staged_plan(h, w, tile, ptr, sms, SURFACE_BLOCKS_PER_SM)


class StackedPlan(NamedTuple):
    route: str          # "tma" or "phased"
    tile: tuple         # (rows, columns) a block writes of a tile
    stages: int         # windows in the shared-memory ring
    stage_bytes: int    # one window, rounded up to 128 bytes
    shared_bytes: int   # the dynamic shared memory a block asks for
    tiles: int          # output tiles of the raster
    grid: int           # persistent blocks


def stacked_plan(h: int, w: int, ptr: int = 0, out_ptr: int = 0,
                 route=None, tile=None, stages=None,
                 sms: int = 132) -> StackedPlan:
    """How B0 runs an (h, w) float32 raster at input address `ptr` into a
    stacked buffer at `out_ptr`, on `sms` SMs.

    The route rule: "tma" where TMA and 16-byte stores take every pointer
    (``w % 4 == 0``, which makes every plane's offset a multiple of 16
    bytes, and both bases 16-byte aligned), else "phased".  `route`
    "phased" may be asked for at any shape; "tma" only where the rule
    gives it.  The tile is ``STACKED_TILE[route]`` unless `tile` names one
    of ``STACKED_TILES[route]``; the ring is ``staged_plan``'s for
    ``SURFACE_BLOCKS_PER_SM`` blocks an SM, `stages` windows if given.
    The phased route's windows are those of 128-column tiles, each row
    ``PHASED_ROW_PAD`` floats longer; its tiles lie ``SPAN_CELLS`` columns
    apart and cover w + SPAN_SHIFT - 1 columns."""
    rule = ("tma" if w % 4 == 0 and ptr % 16 == 0 and out_ptr % 16 == 0
            else "phased")
    route = rule if route is None else route
    if route not in STACKED_ROUTES:
        raise ValueError(f"B0 has no route {route!r}; its staged routes are "
                         f"{STACKED_ROUTES} (and the first port, 'simple')")
    if route == "tma" and rule != "tma":
        raise ValueError(f"B0's route 'tma' needs w % 4 == 0 and 16-byte "
                         f"aligned bases; a {h}x{w} raster at {ptr:#x} into "
                         f"{out_ptr:#x} takes 'phased'")
    tile = STACKED_TILE[route] if tile is None else tuple(tile)
    if tile not in STACKED_TILES[route]:
        raise ValueError(f"B0's route {route!r} has no tile {tile}; it is "
                         f"compiled at {STACKED_TILES[route]}")
    if route == "tma":
        p = staged_plan(h, w, tile, ptr, sms, SURFACE_BLOCKS_PER_SM,
                        stages=stages)
        return StackedPlan(route, tile, p.stages, p.stage_bytes,
                           p.shared_bytes, p.tiles, p.grid)
    p = staged_plan(h, w, (tile[0], 128), ptr, sms, SURFACE_BLOCKS_PER_SM,
                    PHASED_ROW_PAD, stages)
    tiles = -(-h // tile[0]) * -(-(w + SPAN_SHIFT - 1) // SPAN_CELLS)
    per_sm = min(SURFACE_BLOCKS_PER_SM, SMEM_PER_SM // (p.shared_bytes + 1024))
    return StackedPlan(route, tile, p.stages, p.stage_bytes, p.shared_bytes,
                       tiles, min(tiles, per_sm * sms))


def check_products(which, allow_empty=True) -> None:
    """Raise unless `which` names distinct surface products."""
    if (not which and not allow_empty) or len(set(which)) != len(which) \
            or any(p not in PRODUCTS for p in which):
        raise ValueError(f"products must be distinct names from {PRODUCTS}, "
                         f"got {which!r}")


def surface_multi_stacked(data, cellsize_x, cellsize_y, azimuth,
                          angle_altitude, which=("slope",), squeeze=False):
    """(K, H, W) float32 stack of `which`, plane k = ``which[k]``; (H, W)
    when `squeeze` and K == 1.  The plain version of
    ``surface_stacked_kernel``."""
    which = tuple(which)
    check_products(which, allow_empty=False)
    outs = surface_multi(data, cellsize_x, cellsize_y, azimuth,
                         angle_altitude, which)
    out = torch.stack([outs[p] for p in which])
    return out[0] if squeeze and len(which) == 1 else out


# ---------------------------------------------------------------------------
# dispatch: CPU tensor -> twins, CUDA tensor -> kernel
# ---------------------------------------------------------------------------

def _mesh_route(data) -> bool:
    from ..parallel.halo import get_raster_mesh
    return get_raster_mesh(data) is not None


def _surface_block(block, which, cellsize_x, cellsize_y, azimuth,
                   angle_altitude):
    """The products of `which` on one tile, band or extended block, as a
    tuple."""
    outs = surface_kernels(block, which, cellsize_x, cellsize_y, azimuth,
                           angle_altitude)
    return tuple(outs[p] for p in which)


def surface_kernels(data, which, cellsize_x=1.0, cellsize_y=1.0,
                    azimuth=225.0, angle_altitude=25.0):
    """The requested surface products as a dict of (H, W) tensors.

    Curvature uses the mean of the two cell sizes, as ``surface_multi``
    does.  A raster split over a mesh (``parallel.ShardedRaster``) runs
    one pass for all products over the tiles with a 1-cell halo
    (``dispatch.run_stencil``): on the card one kernel launch on each tile
    and on each of its two bands (or on each extended block); the
    products are ``ShardedRaster`` s over the same mesh.
    """
    with span("dispatch.surface"):
        if _mesh_route(data):
            from .dispatch import run_stencil
            outs = run_stencil(_surface_block, 1, data, tuple(which),
                               cellsize_x, cellsize_y, azimuth,
                               angle_altitude)
            return dict(zip(which, outs))
        if data.device.type == "cpu":
            return surface_multi(data, cellsize_x, cellsize_y, azimuth,
                                 angle_altitude, tuple(which))
        from .cuda_surface import surface_cuda
        outs = surface_cuda(data, tuple(which), cellsize_x, cellsize_y,
                            azimuth, angle_altitude)
        return dict(zip(which, outs))


def run_surface_op(name, data, cellsize_x=1.0, cellsize_y=1.0,
                   azimuth=225.0, angle_altitude=25.0):
    """Single-product dispatch shared by slope/aspect/curvature/hillshade.

    Curvature uses ``cellsize_x`` alone, as the JAX package's
    ``curvature_jit`` does.  A raster split over a mesh runs over the
    tiles with a 1-cell halo (``dispatch.run_stencil``), each tile and
    band on this path: the result is a ``ShardedRaster`` over the same
    mesh.
    """
    if name not in PRODUCTS:
        raise ValueError(f"unknown surface op {name!r}")
    if _mesh_route(data):
        from .dispatch import run_stencil
        return run_stencil(_surface_op_block, 1, data, name, cellsize_x,
                           cellsize_y, azimuth, angle_altitude)
    if data.device.type == "cpu":
        if name == "slope":
            return slope(data, cellsize_x, cellsize_y)
        if name == "aspect":
            return aspect(data)
        if name == "curvature":
            return curvature(data, cellsize_x)
        return hillshade(data, azimuth, angle_altitude)
    if name == "curvature":
        cellsize_y = cellsize_x
    return surface_kernels(data, (name,), cellsize_x, cellsize_y, azimuth,
                           angle_altitude)[name]


def _surface_op_block(block, name, cellsize_x, cellsize_y, azimuth,
                      angle_altitude):
    return run_surface_op(name, block, cellsize_x, cellsize_y, azimuth,
                          angle_altitude)


def surface_stacked(data, cellsize_x=1.0, cellsize_y=1.0, azimuth=225.0,
                    angle_altitude=25.0, which=("slope",), squeeze=False):
    """(K, H, W) float32 stack of the products in `which` (any subset and
    order of slope/aspect/curvature/hillshade), 1-cell NaN ring; (H, W)
    when `squeeze` and K == 1.  The JAX package's ``surface_pallas``; on
    the card B0 on the route ``stacked_plan`` names.

    Curvature uses the mean of the two cell sizes.
    """
    if data.device.type == "cpu":
        return surface_multi_stacked(data, cellsize_x, cellsize_y, azimuth,
                                     angle_altitude, which, squeeze)
    from .cuda_surface import surface_stacked_cuda
    return surface_stacked_cuda(data, tuple(which), cellsize_x, cellsize_y,
                                azimuth, angle_altitude, squeeze)
