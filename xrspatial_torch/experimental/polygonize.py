"""Polygonize: vector polygons for connected same-valued raster regions.

Counterpart of ``xrspatial_tpu/experimental/polygonize.py``, a
raster-to-vector converter.  Host numpy by design, as in the JAX package:
output sizes are data-dependent and the work is pointer-chasing, not array
math.  The raster and the mask are copied to the host once (a tensor on
the card too); the polygons are host numpy arrays.

Algorithm: exact-equality connected-component labelling, then directed
boundary-edge stitching with the region interior kept on the left:
exteriors come out anticlockwise, holes clockwise, in the reference's
(x=i, y=j) corner coordinate frame with the same ``(column,
polygon_points)`` output structure and optional 6-term affine transform.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np

from ..utils import host_copy
from ..xrlib import DataArray

__all__ = ["polygonize"]


def _label_regions(values: np.ndarray, include: np.ndarray,
                   connectivity_8: bool) -> np.ndarray:
    """Connected components of equal-valued included pixels.

    Region ids are 1..n in scan order of each region's first pixel;
    excluded pixels are region 0.
    """
    ny, nx = values.shape
    labels = np.zeros((ny, nx), dtype=np.int64)
    next_id = 1
    stack = []
    if connectivity_8:
        offs = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1),
                (1, -1), (1, 0), (1, 1))
    else:
        offs = ((-1, 0), (1, 0), (0, -1), (0, 1))
    for j in range(ny):
        for i in range(nx):
            if not include[j, i] or labels[j, i]:
                continue
            v = values[j, i]
            labels[j, i] = next_id
            stack.append((j, i))
            while stack:
                cj, ci = stack.pop()
                for dj, di in offs:
                    nj, nci = cj + dj, ci + di
                    if 0 <= nj < ny and 0 <= nci < nx \
                            and include[nj, nci] and not labels[nj, nci] \
                            and values[nj, nci] == v:
                        labels[nj, nci] = next_id
                        stack.append((nj, nci))
            next_id += 1
    return labels


def _region_loops(labels: np.ndarray, region: int, connectivity_8: bool):
    """Closed corner-coordinate loops of one region's boundary.

    Directed edges keep the region on the LEFT in the (x=i, y=j) frame, so
    exterior loops are anticlockwise and holes clockwise.
    """
    ny, nx = labels.shape
    mask = labels == region
    # directed edges: start corner -> end corner
    edges = {}

    def add_edge(a, b):
        edges.setdefault(a, []).append(b)

    js, iis = np.nonzero(mask)
    for j, i in zip(js, iis):
        # south edge (y=j): neighbor (j-1); region above -> edge runs +x
        if j == 0 or not mask[j - 1, i]:
            add_edge((i, j), (i + 1, j))
        # north edge (y=j+1): edge runs -x
        if j == ny - 1 or not mask[j + 1, i]:
            add_edge((i + 1, j + 1), (i, j + 1))
        # west edge (x=i): edge runs -y
        if i == 0 or not mask[j, i - 1]:
            add_edge((i, j + 1), (i, j))
        # east edge (x=i+1): edge runs +y
        if i == nx - 1 or not mask[j, i + 1]:
            add_edge((i + 1, j), (i + 1, j + 1))

    loops = []
    while edges:
        start = min(edges.keys(), key=lambda c: (c[1], c[0]))
        loop = [start]
        cur = start
        prev_dir = None
        while True:
            outs = edges[cur]
            if len(outs) == 1:
                nxt = outs[0]
                del edges[cur]
            else:
                # ambiguous corner: pick the rightmost turn wrt incoming
                # direction (keeps 4-connectivity loops separate; the
                # reference notes 8-connectivity may yield invalid rings)
                dx0, dy0 = prev_dir
                def turn(nc):
                    dx1, dy1 = nc[0] - cur[0], nc[1] - cur[1]
                    return dx0 * dy1 - dy0 * dx1  # cross product
                outs.sort(key=turn)
                nxt = outs[0 if not connectivity_8 else -1]
                outs.remove(nxt)
                if not outs:
                    del edges[cur]
            loop.append(nxt)
            prev_dir = (nxt[0] - cur[0], nxt[1] - cur[1])
            cur = nxt
            if cur == start:
                break
        loops.append(np.array(loop, dtype=np.float64))
    return loops


def _signed_area(pts: np.ndarray) -> float:
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * float(np.sum(x[:-1] * y[1:] - x[1:] * y[:-1]))


def _ring_contains(ring: np.ndarray, px: float, py: float) -> bool:
    """Even-odd ray cast; the query point is a hole-ring vertex, so
    offset it off the lattice to avoid on-boundary ambiguity (rings sit
    on integer grid corners)."""
    px, py = px + 0.25, py + 0.25
    x, y = ring[:-1, 0], ring[:-1, 1]
    x2, y2 = ring[1:, 0], ring[1:, 1]
    crosses = ((y > py) != (y2 > py)) & (
        px < x + (py - y) * (x2 - x) / np.where(y2 == y, 1.0, y2 - y))
    return bool(np.sum(crosses) % 2)


def polygonize(
    raster: DataArray,
    mask: Optional[DataArray] = None,
    connectivity: int = 4,
    transform: Optional[np.ndarray] = None,
    column_name: str = "DN",
    return_type: str = "numpy",
):
    """Create vector polygons for connected regions of equal pixel value.

    Returns ``(column, polygon_points)`` for ``return_type='numpy'``:
    one value and one list of rings ([exterior, *holes]) per region.
    Other return types (geopandas/spatialpandas/awkward) require their
    optional dependencies.  The regions are traced on the host: a raster
    split over a mesh is gathered, with a warning, as ``np.asarray``
    gathers it in the JAX package.
    """
    if raster.ndim != 2 or raster.shape[0] < 1 or raster.shape[1] < 1:
        raise ValueError(
            "Raster array must be 2D with a shape of at least (1, 1)")
    if mask is not None:
        if raster.shape != mask.shape:
            raise ValueError(
                f"raster and mask must have the same shape: {raster.shape} "
                f"and {mask.shape}")
        mask_data = host_copy(mask, "polygonize").astype(bool)
    else:
        mask_data = None
    if connectivity not in (4, 8):
        raise ValueError(
            f"connectivity must be either 4 or 8, not {connectivity}")
    if transform is not None:
        transform = np.asarray(transform)
        if len(transform) != 6:
            raise ValueError(
                f"Incorrect transform length of {len(transform)} "
                "instead of 6")

    values = host_copy(raster, "polygonize")
    include = np.ones(values.shape, dtype=bool) if mask_data is None \
        else mask_data
    include = include & ~np.isnan(values.astype(np.float64, copy=False)) \
        if np.issubdtype(values.dtype, np.floating) else include

    labels = _label_regions(values, include, connectivity == 8)
    n_regions = labels.max()

    column: List[Union[int, float]] = []
    polygon_points: List[List[np.ndarray]] = []
    for region in range(1, n_regions + 1):
        loops = _region_loops(labels, region, connectivity == 8)
        # orientation classifies rings: positive (exterior) vs negative
        # (hole).  Under 8-connectivity a diagonal-touching region traces
        # as SEVERAL disjoint positive rings (the reference emits one
        # self-touching — OGC-invalid — ring there); we emit one polygon
        # per positive ring instead, assigning holes by containment.
        pos = [lp for lp in loops if _signed_area(lp) > 0]
        neg = [lp for lp in loops if _signed_area(lp) <= 0]
        if not pos:  # degenerate; keep old max-area behavior
            pos = [max(loops, key=_signed_area)]
            neg = [lp for lp in loops if lp is not pos[0]]
        groups = [[ext] for ext in pos]
        for hole in neg:
            hx, hy = hole[0, 0], hole[0, 1]
            target = 0
            for gi, ext in enumerate(pos):
                if _ring_contains(ext, hx, hy):
                    target = gi
                    break
            groups[target].append(hole)
        first = np.argwhere(labels == region)[0]
        val = values[first[0], first[1]]
        for rings in groups:
            if transform is not None:
                rings = [
                    np.stack([transform[0] * r[:, 0] + transform[1] * r[:, 1]
                              + transform[2],
                              transform[3] * r[:, 0] + transform[4] * r[:, 1]
                              + transform[5]], axis=1)
                    for r in rings]
            column.append(val)
            polygon_points.append(rings)

    if return_type == "numpy":
        return column, polygon_points
    elif return_type == "awkward":
        import awkward as ak
        return column, ak.Array(polygon_points)
    elif return_type == "geopandas":
        import geopandas as gpd
        from shapely.geometry import Polygon
        polygons = [Polygon(r[0], r[1:]) for r in polygon_points]
        return gpd.GeoDataFrame({column_name: column, "geometry": polygons})
    elif return_type == "spatialpandas":
        from spatialpandas import GeoDataFrame
        from spatialpandas.geometry import PolygonArray
        flat = [[np.reshape(a, -1) for a in rings]
                for rings in polygon_points]
        return GeoDataFrame({column_name: column,
                             "geometry": PolygonArray(flat)})
    raise ValueError(f"Invalid return_type '{return_type}'")
