"""Geodesic (WGS-84 ellipsoidal) slope / aspect as float64 torch programs.

Counterpart of ``xrspatial_tpu/kernels/geodesic.py``, which is XLA code
(no Pallas kernel): the ECEF grid is computed once, its 3x3 neighbourhood
gathered as (9, H, W) stacks, and each cell's local tangent-frame
projection and least-squares plane fit run as elementwise float64 math
over those stacks.  Float64 throughout, as in the JAX package: ECEF
magnitudes (~6.4e6 m) against neighbour deltas (~30 m) make float32
cancellation catastrophic.  Float64 is native in torch, so nothing is
scoped.  The operation order is the JAX package's; the 9-term means are
sums divided by 9, as ``jnp.mean`` computes them, the 9 terms added in
order.

Memory: about 15 float64 (9, H, W) stacks live at the peak, 14 GB for one
3601 x 3601 tile.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..utils import nan_border

# WGS-84 constants
WGS84_A = 6378137.0
WGS84_B = 6356752.314245
WGS84_A2 = WGS84_A * WGS84_A
WGS84_B2 = WGS84_B * WGS84_B
# the reference kernels hard-code this radius
_R_KERNEL = 6370994.884953014
INV_2R = 1.0 / (2.0 * _R_KERNEL)

__all__ = ["geodesic_fit", "geodesic_slope", "geodesic_aspect",
           "geodesic_mesh", "WGS84_A2", "WGS84_B2", "INV_2R"]


def _ecef(lat_rad, lon_rad, h, a2, b2):
    cos_lat, sin_lat = torch.cos(lat_rad), torch.sin(lat_rad)
    cos_lon, sin_lon = torch.cos(lon_rad), torch.sin(lon_rad)
    n = a2 / torch.sqrt(a2 * cos_lat * cos_lat + b2 * sin_lat * sin_lat)
    x = (n + h) * cos_lat * cos_lon
    y = (n + h) * cos_lat * sin_lon
    z = (b2 / a2 * n + h) * sin_lat
    return x, y, z


def _shift9(arr):
    """(9, H, W) stack of the 3x3 neighbourhood (NaN-padded borders)."""
    h, w = arr.shape
    p = F.pad(arr, (1, 1, 1, 1), value=math.nan)
    return torch.stack([p[1 + dy:h + 1 + dy, 1 + dx:w + 1 + dx]
                        for dy in (-1, 0, 1) for dx in (-1, 0, 1)])


def _sum9(stack):
    """The sum of the 9 neighbourhood planes, added one after another: the
    same bits for a block as for the whole raster (a reduction kernel on
    the card may order its adds by the tensor's shape)."""
    acc = stack[0]
    for k in range(1, stack.shape[0]):
        acc = acc + stack[k]
    return acc


def _mean9(stack):
    return _sum9(stack) / 9.0


def geodesic_fit(elev, lat_deg, lon_deg, a2, b2, z_factor):
    """Least-squares tangent-plane fit u = A*e + B*n per pixel.

    `elev`, `lat_deg` and `lon_deg` are (H, W) tensors on one device.
    Returns (A, B, valid): float64, float64 and bool tensors of shape
    (H, W).
    """
    f64 = torch.float64
    elev = elev.to(f64)
    lat = lat_deg.to(device=elev.device, dtype=f64)
    lon = lon_deg.to(device=elev.device, dtype=f64)
    deg2rad = math.pi / 180.0

    h = elev * z_factor
    x, y, z = _ecef(lat * deg2rad, lon * deg2rad, h, a2, b2)

    # centre-frame basis vectors
    lat_r, lon_r = lat * deg2rad, lon * deg2rad
    cos_lat, sin_lat = torch.cos(lat_r), torch.sin(lat_r)
    cos_lon, sin_lon = torch.cos(lon_r), torch.sin(lon_r)
    ex, ey = -sin_lon, cos_lon                      # East  (ez = 0)
    nx, ny, nz = -sin_lat * cos_lon, -sin_lat * sin_lon, cos_lat  # North
    ux, uy, uz = cos_lat * cos_lon, cos_lat * sin_lon, sin_lat    # Up

    dx = _shift9(x) - x[None]
    dy = _shift9(y) - y[None]
    dz = _shift9(z) - z[None]
    e9 = dx * ex[None] + dy * ey[None]
    n9 = dx * nx[None] + dy * ny[None] + dz * nz[None]
    u9 = dx * ux[None] + dy * uy[None] + dz * uz[None]
    del dx, dy, dz
    # curvature correction: compensate the ellipsoid curving away
    u9 = u9 + (e9 * e9 + n9 * n9) * INV_2R

    valid = ~torch.any(torch.isnan(_shift9(elev)), dim=0)

    me, mn, mu = _mean9(e9), _mean9(n9), _mean9(u9)
    de, dn, du = e9 - me[None], n9 - mn[None], u9 - mu[None]
    del e9, n9, u9
    see = _sum9(de * de)
    snn = _sum9(dn * dn)
    sen = _sum9(de * dn)
    seu = _sum9(de * du)
    snu = _sum9(dn * du)

    det = see * snn - sen * sen
    degenerate = torch.abs(det) < 1e-30
    safe_det = torch.where(degenerate, 1.0, det)
    A = torch.where(degenerate, 0.0, (seu * snn - snu * sen) / safe_det)
    B = torch.where(degenerate, 0.0, (snu * see - seu * sen) / safe_det)
    return A, B, valid


def _finish(out, valid):
    """NaN where a neighbour is NaN and on the 1-cell ring, as float32."""
    return nan_border(torch.where(valid, out, math.nan)).to(torch.float32)


def geodesic_slope(elev, lat_deg, lon_deg, a2, b2, z_factor):
    """Slope in degrees, float32 (H, W), 1-cell NaN ring."""
    A, B, valid = geodesic_fit(elev, lat_deg, lon_deg, a2, b2, z_factor)
    deg = torch.atan(torch.sqrt(A * A + B * B)) * (180.0 / math.pi)
    return _finish(deg, valid)


def geodesic_aspect(elev, lat_deg, lon_deg, a2, b2, z_factor):
    """Downslope compass bearing in degrees, -1 where flat; float32
    (H, W), 1-cell NaN ring."""
    A, B, valid = geodesic_fit(elev, lat_deg, lon_deg, a2, b2, z_factor)
    mag = torch.sqrt(A * A + B * B)
    # downslope bearing in (east, north) = (-A, -B), as a compass angle
    angle = torch.atan2(-A, -B) * (180.0 / math.pi)
    angle = torch.where(angle < 0.0, angle + 360.0, angle)
    angle = torch.where(angle >= 360.0, angle - 360.0, angle)
    out = torch.where(mag < 1e-7, -1.0, angle)
    return _finish(out, valid)


def geodesic_mesh(fn, data, lat, lon, a2, b2, z_factor):
    """`fn` (``geodesic_slope`` or ``geodesic_aspect``) of a raster split
    over a mesh (a ``ShardedRaster``), as a raster of its tiles: each
    block's float64 elevation, latitude and longitude stacked as one
    (3, h, w) block, from the global coordinates (`lat` and `lon` numpy,
    1-D per row and column or 2-D grids), then ``run_stencil`` with a
    1-cell halo, so that a block's ring holds its neighbours' real
    elevations and coordinates.  Beyond the raster the halo is NaN, which
    only the raster's edge cells read, and they are NaN anyway."""
    from ..parallel.halo import tiles, zip_blocks
    from .dispatch import run_stencil
    x = tiles(data)
    f64 = torch.float64

    def stack(i, j, b):
        (y0, y1), (x0, x1) = x.extent(0, i), x.extent(1, j)
        if lat.ndim == 1:
            la = torch.from_numpy(lat[y0:y1]).to(b.device, f64)[:, None]
            lo = torch.from_numpy(lon[x0:x1]).to(b.device, f64)[None, :]
            la, lo = torch.broadcast_tensors(la, lo)
        else:
            la = torch.from_numpy(lat[y0:y1, x0:x1]).to(b.device, f64)
            lo = torch.from_numpy(lon[y0:y1, x0:x1]).to(b.device, f64)
        return torch.stack([b.to(f64), la, lo])

    return run_stencil(lambda e: fn(e[0], e[1], e[2], a2, b2, z_factor), 1,
                       zip_blocks(stack, x))
