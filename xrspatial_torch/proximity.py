"""Proximity / allocation / direction via the jump-flood distance transform.

Counterpart of ``xrspatial_tpu/proximity.py``.  One jump-flood transform
(``kernels/jfa.py``) carries each cell's nearest target, from which the
distance (proximity), the target's raster value (allocation) and the
compass bearing to it (direction) follow.  MANHATTAN on monotone axes takes
the exact separable scan transform instead.  ``max_distance`` masks the
result.  A raster on the card runs its rounds on the CUDA round kernel, a
raster on the CPU on the torch twins; a raster split over a mesh runs
them per block behind halo exchanges (``parallel/jfa_sharded.py``) and
gives one split over the same mesh, equal to the unsharded result.

Ties: where several targets are exactly equidistant, the transform's
candidate order picks one; it is the JAX package's order, so allocation
and direction pick the same target as the JAX package wherever the keys
agree bit for bit (every metric but great circle, whose trig may differ by
an ulp).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .dataset_support import supports_dataset
from .kernels.jfa import (EUCLIDEAN, GREAT_CIRCLE, MANHATTAN, jump_flood,
                          manhattan_scan_plan, packed_state_plan)
from .parallel.halo import get_raster_mesh, zip_blocks
from .tracing import count, span
from .utils import raster_payload, wrap_like
from .xrlib import DataArray

__all__ = ["proximity", "allocation", "direction", "euclidean_distance",
           "great_circle_distance", "manhattan_distance",
           "DISTANCE_METRICS"]

DISTANCE_METRICS = {
    "EUCLIDEAN": EUCLIDEAN,
    "GREAT_CIRCLE": GREAT_CIRCLE,
    "MANHATTAN": MANHATTAN,
}

PROXIMITY, ALLOCATION, DIRECTION = 0, 1, 2


# -- scalar distance helpers (host code, as the JAX package's) ---------------

def euclidean_distance(x1: float, x2: float, y1: float, y2: float) -> float:
    """Straight-line distance between (x1, y1) and (x2, y2)."""
    x = x1 - x2
    y = y1 - y2
    return float(np.sqrt(x * x + y * y))


def manhattan_distance(x1: float, x2: float, y1: float, y2: float) -> float:
    """Sum of |dx| + |dy| between (x1, y1) and (x2, y2)."""
    return float(abs(x1 - x2) + abs(y1 - y2))


def great_circle_distance(x1: float, x2: float, y1: float, y2: float,
                          radius: float = 6378137) -> float:
    """Haversine distance between two (lon, lat) points in degrees."""
    for val, name, lo, hi in (
            (x1, "x-coordinate of the first point", -180, 180),
            (x2, "x-coordinate of the second point", -180, 180),
            (y1, "y-coordinate of the first point", -90, 90),
            (y2, "y-coordinate of the second point", -90, 90)):
        if val > hi or val < lo:
            raise ValueError(
                f"Invalid {name}. Must be in the range [{lo}, {hi}]")
    lat1, lon1, lat2, lon2 = (np.radians(y1), np.radians(x1),
                              np.radians(y2), np.radians(x2))
    a = (np.sin((lat2 - lat1) / 2.0) ** 2
         + np.cos(lat1) * np.cos(lat2) * np.sin((lon2 - lon1) / 2.0) ** 2)
    return float(radius * 2 * np.arcsin(np.sqrt(a)))


# -- shared implementation --------------------------------------------------

def _target_mask(img, target_values):
    """Target cells: any non-zero finite cell when `target_values` is
    empty, else the cells equal to one of them."""
    with span("torchops.proximity_mask"):
        if len(target_values) == 0:
            return (img != 0) & torch.isfinite(img)
        mask = torch.zeros(img.shape, dtype=torch.bool, device=img.device)
        for v in target_values:
            mask = mask | (img == v)
        return mask


def _compass_direction(px, tx, py, ty):
    """Compass bearing from each cell to its nearest target, float64 in,
    float32 out: 90 = E, 180 = S, 270 = W, 360 = N, 0 at the target."""
    x = tx - px
    y = ty - py
    d = torch.atan2(-y, x) * 57.29578
    d = torch.where(d < 0, 90.0 - d,
                    torch.where(d > 90.0, 360.0 - d + 90.0, 90.0 - d))
    same = (x == 0) & (y == 0)
    return torch.where(same, 0.0, d).to(torch.float32)


def _coords_of(raster, dim, dtype):
    return np.ascontiguousarray(raster[dim].values, dtype=dtype)


def _process(raster, x, y, target_values, max_distance, distance_metric,
             mode):
    with span("api.args"):
        if tuple(raster.dims) != (y, x):
            raise ValueError(
                "raster.coords should be named as coordinates:"
                "({0}, {1})".format(y, x))

        metric = DISTANCE_METRICS.get(distance_metric, EUCLIDEAN)
        if max_distance is None:
            max_distance = np.inf

        xs_np = _coords_of(raster, x, np.float32)
        ys_np = _coords_of(raster, y, np.float32)
        if metric == GREAT_CIRCLE:
            if xs_np.size and (xs_np.min() < -180 or xs_np.max() > 180):
                raise ValueError(
                    "Invalid x-coordinate for great circle distance. "
                    "Must be in the range [-180, 180]")
            if ys_np.size and (ys_np.min() < -90 or ys_np.max() > 90):
                raise ValueError(
                    "Invalid y-coordinate for great circle distance. "
                    "Must be in the range [-90, 90]")
        img = raster_payload(raster, dtype=None)
        mesh = get_raster_mesh(img)

        targets = tuple(float(v) for v in np.asarray(target_values).ravel())
        mplan = manhattan_scan_plan(xs_np, ys_np) if metric == MANHATTAN \
            else None
        pplan = packed_state_plan(xs_np, ys_np, metric)
        px_np = _coords_of(raster, x, np.float64)
        py_np = _coords_of(raster, y, np.float64)
        bound = float(np.float32(max_distance))
        if mesh is None:
            dev = img.device
            count("host.syncs", 2)      # two blocking copies to the card
            xs = torch.from_numpy(xs_np).to(dev)
            ys = torch.from_numpy(ys_np).to(dev)
    if mesh is not None:
        # the jump flood per block behind halos; the epilogue per block
        mask = img.map_blocks(lambda b: _target_mask(b, targets))
        res = jump_flood(mask, xs_np, ys_np, metric,
                         values=img if mode == ALLOCATION else None,
                         need_coords=(mode == DIRECTION),
                         manhattan_plan=mplan, packed_plan=pplan, mesh=mesh)
        rasters = [r for r in res if r is not None]

        def block(i, j, dist, t_x, t_y, *t_val):
            (y0, y1), (x0, x1) = res[0].extent(0, i), res[0].extent(1, j)
            return _epilogue(mode, dist, t_x, t_y, *(t_val or (None,)),
                             px_np[x0:x1], py_np[y0:y1], bound)

        return zip_blocks(block, *rasters)
    mask = _target_mask(img, targets)
    dist, t_x, t_y, t_val = jump_flood(
        mask, xs, ys, metric, values=img if mode == ALLOCATION else None,
        need_coords=(mode == DIRECTION), manhattan_plan=mplan,
        packed_plan=pplan)
    return _epilogue(mode, dist, t_x, t_y, t_val, px_np, py_np, bound)


def _epilogue(mode, dist, t_x, t_y, t_val, px_np, py_np, bound):
    """The result of `mode` from the jump flood's planes; `bound` is
    max_distance in float32, as the distances are."""
    with span("torchops.proximity_epilogue"):
        reachable = torch.isfinite(t_x) & (dist <= bound)
        if mode == PROXIMITY:
            return torch.where(reachable, dist, math.nan)
        if mode == ALLOCATION:
            return torch.where(reachable, t_val, math.nan)

        # float64 epilogue: the reference computes bearings in float64 with an
        # imprecise degree constant (57.29578), and the branch at exact north
        # matches only in float64.  The carried float32 target coordinates are
        # exact coordinate values, so == against the cells' own coordinates
        # still holds at the target itself.
        dev = dist.device
        count("host.syncs", 2)      # two blocking copies to the card
        px = torch.from_numpy(np.ascontiguousarray(px_np)).to(dev)[None, :]
        py = torch.from_numpy(np.ascontiguousarray(py_np)).to(dev)[:, None]
        return torch.where(reachable,
                           _compass_direction(px, t_x.to(torch.float64), py,
                                              t_y.to(torch.float64)),
                           math.nan)


@supports_dataset
def proximity(raster: DataArray, x: str = "x", y: str = "y",
              target_values: list = [], max_distance: float = np.inf,
              distance_metric: str = "EUCLIDEAN") -> DataArray:
    """Distance from every pixel to the nearest target pixel.

    Targets are pixels whose value is in `target_values` (or any non-zero
    finite pixel when the list is empty).  Distances are measured in
    coordinate space with the chosen metric (EUCLIDEAN, GREAT_CIRCLE,
    MANHATTAN); pixels farther than `max_distance` are NaN.
    """
    with span("api.proximity"):
        out = _process(raster, x, y, target_values, max_distance,
                       distance_metric, PROXIMITY)
        with span("api.dataset"):
            return wrap_like(raster, out, None)


@supports_dataset
def allocation(raster: DataArray, x: str = "x", y: str = "y",
               target_values: list = [], max_distance: float = np.inf,
               distance_metric: str = "EUCLIDEAN") -> DataArray:
    """Raster value of each pixel's nearest target."""
    with span("api.allocation"):
        out = _process(raster, x, y, target_values, max_distance,
                       distance_metric, ALLOCATION)
        with span("api.dataset"):
            return wrap_like(raster, out, None)


@supports_dataset
def direction(raster: DataArray, x: str = "x", y: str = "y",
              target_values: list = [], max_distance: float = np.inf,
              distance_metric: str = "EUCLIDEAN") -> DataArray:
    """Compass direction (90=E, 180=S, 270=W, 360=N, 0=self) from each
    pixel to its nearest target."""
    with span("api.direction"):
        out = _process(raster, x, y, target_values, max_distance,
                       distance_metric, DIRECTION)
        with span("api.dataset"):
            return wrap_like(raster, out, None)
