"""A* pathfinding over a raster with barriers.

Counterpart of ``xrspatial_tpu/pathfinding.py``.  A single-source,
single-goal A* is a sequential frontier expansion, so it runs on the host,
as in the JAX package: the surface is copied to the host once (a tensor
on the card too), the crossable mask is built there, and the search runs
in the C++ library ``native/astar.cpp`` (``NATIVE_CALLS``) or, where it
cannot be built or ``XRSPATIAL_NO_NATIVE=1`` is set, in the Python heap
below (``PYTHON_CALLS``); both give the same path and costs.  The heap is
keyed ``(cost, y, x)``, the reference's row-major first-minimum
tie-breaking.

The output is NaN except along the found path, where cells carry the
accumulated distance from the start, float64 on the surface's device (a
numpy surface: the default device; a surface split over a mesh: its
first block's device).  A surface split over a mesh is gathered to the
host with the JAX package's warning.
"""

from __future__ import annotations

import heapq
import warnings
from typing import Optional

import numpy as np
import torch

from .parallel.halo import get_raster_mesh
from .utils import get_dataarray_resolution, raster_device, wrap_like
from .xr_compat import _to_numpy
from .xrlib import DataArray

__all__ = ["a_star_search"]

NONE = -1

# searches in this process by route, for checks of which one ran
NATIVE_CALLS = 0
PYTHON_CALLS = 0


def _get_pixel_id(point, raster, xdim=None, ydim=None):
    if ydim is None:
        ydim = raster.dims[-2]
    if xdim is None:
        xdim = raster.dims[-1]
    y_coords = np.asarray(raster.coords[ydim].data)
    x_coords = np.asarray(raster.coords[xdim].data)
    cellsize_x, cellsize_y = get_dataarray_resolution(raster, xdim, ydim)
    py = int(abs(point[0] - y_coords[0]) / cellsize_y)
    px = int(abs(point[1] - x_coords[0]) / cellsize_x)
    return py, px


def _not_crossable_mask(data, barriers):
    mask = np.isnan(data)
    for b in np.asarray(barriers).ravel():
        mask |= (data == b)
    return mask


def _find_nearest_pixel(py, px, blocked):
    if not blocked[py, px]:
        return py, px
    valid = np.argwhere(~blocked)
    if len(valid) == 0:
        return NONE, NONE
    d = np.hypot(valid[:, 1] - px, valid[:, 0] - py)
    h, w = blocked.shape
    min_distance = np.hypot(h - 1, w - 1)
    best = np.argmin(d)
    if d[best] < min_distance:
        return int(valid[best, 0]), int(valid[best, 1])
    return NONE, NONE


def _neighborhood(connectivity):
    if connectivity == 8:
        return [(-1, -1), (0, -1), (1, -1), (-1, 0), (1, 0),
                (-1, 1), (0, 1), (1, 1)]
    return [(0, -1), (-1, 0), (1, 0), (0, 1)]


def _astar_native(blocked, start, goal, connectivity):
    """C++ A* (native/astar.cpp); returns (path, d_from_start), or None if
    the native library is unavailable.  The same results as `_astar`."""
    import ctypes

    from .native import get_astar
    fn = get_astar()
    if fn is None:
        return None
    h, w = blocked.shape
    blocked_u8 = np.ascontiguousarray(blocked, dtype=np.uint8)
    d_from_start = np.full((h, w), np.inf, dtype=np.float64)
    path_buf = np.empty((h * w, 2), dtype=np.int64)
    path_len = ctypes.c_int64(0)
    status = fn(
        blocked_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, start[0], start[1], goal[0], goal[1], connectivity,
        d_from_start.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        path_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.byref(path_len))
    if status != 0:
        return (None, d_from_start)
    path = [tuple(p) for p in path_buf[:path_len.value]]
    return (path, d_from_start)


def _astar(blocked, start, goal, neighbors):
    h, w = blocked.shape
    start_py, start_px = start
    goal_py, goal_px = goal

    d_from_start = np.full((h, w), np.inf)
    parent = np.full((h, w, 2), NONE, dtype=np.int64)

    def heuristic(py, px):
        return np.hypot(px - goal_px, py - goal_py)

    if blocked[start_py, start_px]:
        return None, d_from_start

    d_from_start[start_py, start_px] = 0.0
    parent[start_py, start_px] = (start_py, start_px)
    open_heap = [(heuristic(start_py, start_px), start_py, start_px)]
    closed = np.zeros((h, w), dtype=bool)

    while open_heap:
        cost, py, px = heapq.heappop(open_heap)
        if closed[py, px]:
            continue
        if cost > d_from_start[py, px] + heuristic(py, px) + 1e-12:
            continue  # stale entry
        closed[py, px] = True
        if (py, px) == (goal_py, goal_px):
            path = []
            cy, cx = goal_py, goal_px
            while (cy, cx) != (start_py, start_px):
                path.append((cy, cx))
                cy, cx = parent[cy, cx]
            path.append((start_py, start_px))
            return path[::-1], d_from_start
        for dy, dx in neighbors:
            ny, nx = py + dy, px + dx
            if ny < 0 or ny >= h or nx < 0 or nx >= w:
                continue
            if blocked[ny, nx] or closed[ny, nx]:
                continue
            nd = d_from_start[py, px] + np.hypot(dx, dy)
            # `<=`: the last expanded equal-cost predecessor wins, the
            # reference's re-parenting
            if nd <= d_from_start[ny, nx]:
                d_from_start[ny, nx] = nd
                parent[ny, nx] = (py, px)
                heapq.heappush(open_heap,
                               (nd + heuristic(ny, nx), ny, nx))
    return None, d_from_start


def a_star_search(surface: DataArray,
                  start,
                  goal,
                  barriers: list = [],
                  x: Optional[str] = 'x',
                  y: Optional[str] = 'y',
                  connectivity: int = 8,
                  snap_start: bool = False,
                  snap_goal: bool = False) -> DataArray:
    """Shortest path from `start` to `goal` (y, x coordinates) avoiding
    barrier cells; returns the path as accumulated-cost values over NaN.

    Parameters
    ----------
    surface : DataArray
        2D cost surface; NaN cells and cells whose value is in `barriers`
        are not crossable.
    start, goal : (y, x) tuples in coordinate space.
    barriers : list of raster values that block movement.
    connectivity : 4 or 8.
    snap_start, snap_goal : snap to the nearest crossable cell.
    """
    global NATIVE_CALLS, PYTHON_CALLS
    if surface.ndim != 2:
        raise ValueError("input `surface` must be 2D")
    if tuple(surface.dims) != (y, x):
        raise ValueError("`surface.coords` should be named as coordinates:"
                         "({}, {})".format(y, x))
    if connectivity not in (4, 8):
        raise ValueError("Use either 4 or 8-connectivity.")

    start_py, start_px = _get_pixel_id(start, surface, x, y)
    goal_py, goal_px = _get_pixel_id(goal, surface, x, y)
    h, w = surface.shape
    if not (0 <= start_py < h and 0 <= start_px < w):
        raise ValueError("start location outside the surface graph.")
    if not (0 <= goal_py < h and 0 <= goal_px < w):
        raise ValueError("goal location outside the surface graph.")

    device = raster_device(surface)
    if get_raster_mesh(surface.data) is not None:
        # a sequential frontier expansion; the reference has no dask path
        # for pathfinding either
        warnings.warn(
            "a_star_search: input is mesh-sharded but the search runs on "
            "the HOST over a gathered copy (correct, not distributed).",
            UserWarning, stacklevel=2)
    data = _to_numpy(surface.data)
    blocked = _not_crossable_mask(data, barriers)

    if snap_start:
        start_py, start_px = _find_nearest_pixel(start_py, start_px, blocked)
    if start_py != NONE and blocked[start_py, start_px]:
        warnings.warn("Start at a non crossable location", Warning)
    if snap_goal:
        goal_py, goal_px = _find_nearest_pixel(goal_py, goal_px, blocked)
    if goal_py != NONE and blocked[goal_py, goal_px]:
        warnings.warn("End at a non crossable location", Warning)

    path_img = np.full((h, w), np.nan, dtype=np.float64)
    if start_py != NONE and goal_py != NONE:
        res = _astar_native(blocked, (start_py, start_px),
                            (goal_py, goal_px), connectivity)
        if res is None:
            res = _astar(blocked, (start_py, start_px), (goal_py, goal_px),
                         _neighborhood(connectivity))
            PYTHON_CALLS += 1
        else:
            NATIVE_CALLS += 1
        path, d_from_start = res
        if path is not None:
            cells = np.asarray(path, dtype=np.int64)
            path_img[cells[:, 0], cells[:, 1]] = \
                d_from_start[cells[:, 0], cells[:, 1]]

    return wrap_like(surface, torch.from_numpy(path_img).to(device),
                     surface.name)
