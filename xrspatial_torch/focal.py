"""Focal statistics: mean filter, masked-window apply, focal_stats, hotspots.

Counterpart of ``xrspatial_tpu/focal.py``, with its validation, output
layouts and named stat callables.  The window statistics follow the JAX
package's routing (``_stats_kernel_pallas``) without its TPU-only size
gates (``_route``): footprints of more than 1024 offsets take the
convolution path (torch ops, any device); a raster on the CPU takes the
torch twin; a raster on the card takes the tiled CUDA kernel when the
footprint's radii fit it, and the halo kernel otherwise, at every raster
size.  ``mean``, the convolution of ``hotspots`` and the z-score classes
are torch ops on any device, as they are XLA in the JAX package;
``apply`` with an arbitrary Python callable is a host round trip.

A raster split over a mesh (``parallel.ShardedRaster``) takes the JAX
package's mesh branches: every window op runs on each tile with the
footprint's halo (``kernels/dispatch.py::run_stencil``: in place with the
tile's ring from bands of halo strips, or on the extended block), each
launch on the route the footprint chooses (``_route``), so every cell
takes the route the unsharded raster would; ``hotspots`` takes its
global mean and std in float64 from per-block sums.  The results are
split over the same mesh and equal the unsharded ones bit for bit,
except the conv path (another convolution algorithm may serve a block's
shape, and its centring mean is the extended block's: it always takes
the extended blocks) and ``hotspots``' moments, whose summation order
differs.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch

from .convolution import convolve_2d, custom_kernel
from .dataset_support import supports_dataset
from .kernels.window import (UNROLL_MAX_OFFSETS, focal_mean_pass,
                             hotspots_classify, kernel_offsets,
                             tiled_radius_supported, window_stats)
from .kernels.dispatch import run_stencil
from .parallel.halo import get_raster_mesh, tiles
from .tracing import span
from .utils import blockwise, raster_payload, wrap_like
from .xrlib import DataArray

__all__ = ["mean", "apply", "focal_stats", "hotspots"]

_STAT_NAMES = ("mean", "max", "min", "range", "std", "var", "sum")


# Named stat functions, usable as `func=` for apply(); each also works as a
# plain numpy callable on a window buffer.

def _tag(fn, name):
    fn._stat = name
    return fn


_calc_mean = _tag(lambda a: np.nanmean(a), "mean")
_calc_sum = _tag(lambda a: np.nansum(a), "sum")
_calc_min = _tag(lambda a: np.nanmin(a), "min")
_calc_max = _tag(lambda a: np.nanmax(a), "max")
_calc_std = _tag(lambda a: np.nanstd(a), "std")
_calc_var = _tag(lambda a: np.nanvar(a), "var")
_calc_range = _tag(lambda a: np.nanmax(a) - np.nanmin(a), "range")


@supports_dataset
def mean(agg, passes: int = 1, excludes=[np.nan], name: str = 'mean'):
    """3x3 NaN-excluding mean filter, run `passes` times.

    Cells whose value equals any entry of `excludes` (NaN-aware equality)
    are left unchanged; all others become the nanmean of their clipped
    3x3 neighborhood.  Computed in float64 and written back in the INPUT
    dtype, so integer rasters get truncated means.
    """
    data = raster_payload(agg, dtype=None)
    out = blockwise(lambda b: b.to(torch.float64), data)
    for _ in range(passes):
        # on a mesh, clipped windows at the tile edges come from the NaN
        # halo (nanmean ignores it either way)
        out = run_stencil(focal_mean_pass, 1, out, excludes)
    return wrap_like(agg, blockwise(lambda b: b.to(data.dtype), out), name)


def _route(offsets) -> str:
    """Which path computes the statistics of a footprint on the card:
    "conv" (more than 1024 offsets), "tiled" (``focal_stats_cuda``) or
    "halo" (``focal_stats_halo_cuda``)."""
    if len(offsets) > UNROLL_MAX_OFFSETS:
        return "conv"
    ry = max(abs(dy) for dy, _ in offsets)
    rx = max(abs(dx) for _, dx in offsets)
    return "tiled" if tiled_radius_supported(ry, rx) else "halo"


def _window_stats(data: torch.Tensor, kernel: np.ndarray,
                  stats: tuple) -> torch.Tensor:
    """(S, H, W) statistics over the kernel footprint, stacked in `stats`
    order: the torch ops for a CPU tensor or a conv-path footprint, a CUDA
    kernel otherwise; on a mesh, this over the tiles (``run_stencil``)."""
    with span("api.args"):
        offsets = kernel_offsets(kernel)
    with span("dispatch.focal"):
        if get_raster_mesh(data) is not None:
            ry = max((abs(dy) for dy, _ in offsets), default=0)
            rx = max((abs(dx) for _, dx in offsets), default=0)
            # the conv path centres its sums on its input's mean: it
            # takes the extended blocks
            return run_stencil(_window_stats, (ry, rx), data, kernel, stats,
                               window_local=_route(offsets) != "conv")
        route = _route(offsets)
        if data.device.type == "cpu" or route == "conv":
            outs = window_stats(data, offsets, stats)
            return torch.stack([outs[s] for s in stats])
        from .kernels.cuda_window import (focal_stats_cuda,
                                          focal_stats_halo_cuda)
        if route == "tiled":
            return focal_stats_cuda(data, offsets, stats)
        return focal_stats_halo_cuda(data, offsets, stats)


def apply(raster, kernel, func=_calc_mean, name: str = 'focal_apply'):
    """Apply a function over a masked kernel window at every pixel.

    `func` may be one of the named stat functions in this module (the
    focal-statistics path, on the raster's device) or any Python callable
    taking the (Kh, Kw) window buffer (NaN outside the kernel/raster).  A
    callable runs on the host (``_apply_host``): the raster is copied to
    the host, the callable runs once per cell, and the result is copied
    back to the raster's device.
    """
    if not isinstance(raster, DataArray):
        raise TypeError("`raster` must be instance of DataArray")
    if raster.ndim != 2:
        raise ValueError("`raster` must be 2D")
    kernel = custom_kernel(np.asarray(kernel))

    data = raster_payload(raster)
    stat = getattr(func, "_stat", None)
    if stat in _STAT_NAMES:
        out = blockwise(lambda b: b[0], _window_stats(data, kernel, (stat,)))
    else:
        out = run_stencil(_apply_block, (kernel.shape[0] // 2,
                                         kernel.shape[1] // 2), data, kernel,
                          func)
    return wrap_like(raster, out, name)


def _apply_block(data: torch.Tensor, kernel, func) -> torch.Tensor:
    """``_apply_host`` on a raster (or one tile, band or extended block),
    back on its device."""
    return torch.from_numpy(_apply_host(data.cpu().numpy(), kernel,
                                        func)).to(data.device)


def _apply_host(data: np.ndarray, kernel: np.ndarray, func) -> np.ndarray:
    """Host path for arbitrary Python window functions.

    The window gather and kernel masking are vectorized
    (``sliding_window_view`` + one batched ``np.where`` per row chunk,
    bounded to ~160 MB of transient windows); only the user callable runs
    per pixel.  func sees a (Kh, Kw) buffer, NaN outside the kernel
    footprint and the raster.
    """
    from numpy.lib.stride_tricks import sliding_window_view
    rows, cols = data.shape
    krows, kcols = kernel.shape
    hr, hc = krows // 2, kcols // 2
    padded = np.full((rows + 2 * hr, cols + 2 * hc), np.nan, dtype=data.dtype)
    padded[hr:hr + rows, hc:hc + cols] = data
    kmask = kernel == 1
    out = np.empty_like(data)
    oflat = out.reshape(-1)
    wins = sliding_window_view(padded, (krows, kcols))  # (rows, cols, Kh, Kw)
    rows_per_chunk = max(1, int(4e7 // max(cols * krows * kcols, 1)))
    for y0 in range(0, rows, rows_per_chunk):
        m = np.where(kmask, wins[y0:y0 + rows_per_chunk], np.nan)
        mflat = m.reshape(-1, krows, kcols)
        base = y0 * cols
        for i in range(mflat.shape[0]):
            oflat[base + i] = func(mflat[i])
    return out


def stats_dataarray(agg, stacked: torch.Tensor, stats_funcs,
                    name: str) -> DataArray:
    """A (stats, y, x) DataArray holding `stacked`, with `agg`'s coords and
    attrs and a ``stats`` coordinate naming each plane."""
    out = DataArray(stacked, dims=("stats",) + tuple(agg.dims), name=name,
                    attrs=dict(agg.attrs))
    for cname, cval in agg.coords.items():
        out.coords[cname] = cval
    out.coords["stats"] = DataArray(np.asarray(list(stats_funcs)),
                                    dims=("stats",), name="stats")
    return out


def focal_stats(agg, kernel,
                stats_funcs=['mean', 'max', 'min', 'range', 'std', 'var',
                             'sum']):
    """Focal statistics over a kernel neighborhood for every pixel.

    Returns a 3D (stats, y, x) DataArray.  All statistics are computed in
    one pass over the kernel footprint.  Footprints of more than 1024
    cells take the convolution path, whose std/var use a centred sum of
    squares around the raster's global mean, as in the JAX package.
    """
    with span("api.focal_stats"):
        with span("api.args"):
            if not isinstance(agg, DataArray):
                raise TypeError("`agg` must be instance of DataArray")
            if agg.ndim != 2:
                raise ValueError("`agg` must be 2D")
            kernel = custom_kernel(np.asarray(kernel))
            for s in stats_funcs:
                if s not in _STAT_NAMES:
                    raise ValueError(f"unknown stat {s!r}; supported: "
                                     f"{_STAT_NAMES}")
            data = raster_payload(agg)
        stacked = _window_stats(data, kernel, tuple(stats_funcs))
        with span("api.dataset"):
            return stats_dataarray(agg, stacked, stats_funcs, "focal_apply")


def hotspots(raster, kernel) -> DataArray:
    """Statistically significant hot/cold spots (Getis-Ord style).

    Output int8 values in {0, +-90, +-95, +-99} (confidence levels): the
    kernel-mean convolution's z-score against the raster's global mean and
    population std.
    """
    if not isinstance(raster, DataArray):
        raise TypeError("`raster` must be instance of DataArray")
    if raster.ndim != 2:
        raise ValueError("`raster` must be 2D")
    dtype = raster_payload(raster, dtype=None).dtype
    if dtype == torch.bool or dtype.is_complex:
        raise ValueError("data type must be integer or float")

    kernel = custom_kernel(np.asarray(kernel))
    data = raster_payload(raster)

    if get_raster_mesh(data) is not None:
        global_mean, global_std = _sharded_moments(data)
    else:
        global_mean = torch.nanmean(data)
        # jnp.nanstd: the root of the mean squared deviation of the
        # non-NaN cells (torch has no nanstd)
        dev = data - global_mean
        global_std = torch.sqrt(torch.nanmean(dev * dev))
    if float(global_std) == 0:
        raise ZeroDivisionError(
            "Standard deviation of the input raster values is 0.")

    conv = convolve_2d(data, kernel / kernel.sum())
    out = blockwise(lambda c: hotspots_classify(
        (c - global_mean.to(c.device)) / global_std.to(c.device)), conv)

    attrs = copy.deepcopy(dict(raster.attrs))
    attrs['unit'] = '%'
    result = wrap_like(raster, out, None)
    result.attrs = attrs
    return result


def _sharded_moments(data):
    """The mean and population std of the non-NaN cells of a
    mesh raster, taken in float64 from per-block sums (each cell counted
    once), as float32 0-d tensors on the host."""
    t = tiles(data)
    blocks = [b.to(torch.float64) for row in t.blocks for b in row]
    count = sum(int((~torch.isnan(b)).sum()) for b in blocks)
    total = sum(float(torch.nansum(b)) for b in blocks)
    mean = total / count if count else math.nan
    sq = sum(float(torch.nansum((b - mean) ** 2)) for b in blocks)
    std = math.sqrt(sq / count) if count else math.nan
    return (torch.tensor(mean, dtype=torch.float32),
            torch.tensor(std, dtype=torch.float32))
