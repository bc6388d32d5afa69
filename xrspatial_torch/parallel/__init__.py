"""Distributed execution over a 2D grid of devices.

Counterpart of ``xrspatial_tpu/parallel``.  A raster placed on a
``RasterMesh`` by ``distribute`` is a ``ShardedRaster``: one global
raster in per-device blocks, driven by one process.  Dispatch follows
the payload, as the JAX package's follows the sharding: every op that
has a mesh branch takes it for a raster split over a mesh (stencils
through ``kernels/dispatch.py::run_stencil`` with halos from
``halo_extend``, the jump flood per block in ``jfa_sharded.py``, the
percentiles from per-block counts), and any other op refuses a split
raster (``utils.to_torch``, ROADMAP A13b) instead of gathering it.
"""

from .halo import (HaloSpec, distribute, get_raster_mesh,  # noqa: F401
                   halo_extend, make_raster_mesh, raster_sharding,
                   stencil_shard_map, RasterMesh, ShardedRaster)

__all__ = [
    "HaloSpec", "distribute", "get_raster_mesh", "halo_extend",
    "make_raster_mesh", "raster_sharding", "stencil_shard_map",
]
