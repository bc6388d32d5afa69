"""Payload-driven stencil dispatch: one device, or the mesh with halos.

Counterpart of ``xrspatial_tpu/kernels/dispatch.py``.  A raster split
over a mesh (``parallel.distribute``) runs the kernel over its tiles
(``parallel/halo.py::stencil_shard_map``): on each tile in place, its
edge ring rebuilt from two small bands a block, or on each tile extended
by its halo; anything else goes straight to the kernel.  Either way the
result equals the unsharded run.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable

import torch

from ..parallel.halo import HaloSpec, get_raster_mesh, stencil_shard_map

__all__ = ["run_stencil"]


def run_stencil(kernel: Callable, radius, data, *args, fill=math.nan,
                origin: bool = False, window_local: bool = True):
    """Run a radius-r local kernel, over the mesh iff `data` is split
    over one.

    `kernel(data, *args)` must compute a full-size output whose outer
    radius-r ring may be garbage or NaN (it is rebuilt from halos on the
    mesh and kept as the NaN border on one device).  On the mesh a
    payload that is not floating point is cast to float32 first (NaN
    fill needs a float), the halos beyond the raster hold `fill`, and the
    result is a ``ShardedRaster`` over the same mesh.  With `origin` the
    kernel also takes the raster's cell of its input's (0, 0):
    ``kernel(data, (y0, x0), *args)`` ((0, 0) on one device).

    The mesh takes one of ``stencil_shard_map``'s two routes by the
    shapes: in place (the kernel on each tile as it lies, then on two
    bands a block that rebuild the tile's edge ring) where every tile is
    at least four halos deep on each axis and the kernel is
    `window_local` and takes no origin; each tile copied into its
    extended block otherwise.  A caller whose kernel reads more than a
    cell's window (the focal conv path centres its sums on its input's
    mean) passes ``window_local=False``.
    """
    mesh = get_raster_mesh(data)
    if mesh is None:
        return kernel(data, (0, 0), *args) if origin else kernel(data, *args)
    halo = HaloSpec.square(radius) if isinstance(radius, int) \
        else HaloSpec(*radius)
    # halos wider than a tile gather from several tiles (halo_extend);
    # warn only when the halo covers the whole raster: each extended
    # block then holds about all of it (still correct)
    if halo.ry >= data.shape[-2] // 2 or halo.rx >= data.shape[-1] // 2:
        warnings.warn(
            f"run_stencil: halo radius ({halo.ry}, {halo.rx}) covers the "
            f"whole raster {data.shape[-2:]}; every shard's extended "
            "block is raster-sized, so distribution saves compute but "
            "not memory.", UserWarning, stacklevel=3)
    if not data.dtype.is_floating_point:
        data = data.map_blocks(lambda b: b.to(torch.float32))
    return stencil_shard_map(kernel, mesh, halo, fill=fill, origin=origin,
                             window_local=window_local)(data, *args)
