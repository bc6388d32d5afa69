"""Distributed execution over a 2D grid of devices.

Counterpart of ``xrspatial_tpu/parallel``.  A raster placed on a
``RasterMesh`` by ``distribute`` is a ``ShardedRaster``: one global
raster in per-device blocks, driven by one process.  Dispatch follows
the payload, as the JAX package's follows the sharding: every op that
has a mesh branch takes it for a raster split over a mesh (stencils
through ``kernels/dispatch.py::run_stencil``, on each tile in place with
its ring from bands of halo strips or on ``halo_extend``'s extended
blocks, the jump flood per block in ``jfa_sharded.py``, the
percentiles from per-block counts, the XDraw viewshed on strips of
lanes by ``to_strips``/``from_strips``, the cell-by-cell ops per block,
the zonal reductions from per-block parts, ``regions`` from per-block
labels joined across the seams), and the host functions gather with a
warning; no device op gathers a split raster.
"""

from .halo import (HaloSpec, distribute, get_raster_mesh,  # noqa: F401
                   halo_extend, make_raster_mesh, raster_sharding,
                   stencil_shard_map, RasterMesh, ShardedRaster)

__all__ = [
    "HaloSpec", "distribute", "get_raster_mesh", "halo_extend",
    "make_raster_mesh", "raster_sharding", "stencil_shard_map",
]
