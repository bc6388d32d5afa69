"""Focal statistics.

Counterpart of ``xrspatial_tpu/focal.py``.  ``focal_stats`` keeps the JAX
package's validation and its (stats, y, x) output; the statistics come
from one pass over the kernel footprint: the CUDA kernel
(``kernels/cuda_window.py``) for a tensor on the card, at every size, and
the torch twin (``kernels/window.py``) for a tensor on the CPU.

``mean``, ``apply`` (with its host escape hatch ``_apply_host``) and
``hotspots`` wait for ROADMAP A3.
"""

from __future__ import annotations

import numpy as np
import torch

from .convolution import custom_kernel
from .kernels.window import kernel_offsets, window_stats
from .utils import to_torch
from .xrlib import DataArray

__all__ = ["focal_stats"]

_STAT_NAMES = ("mean", "max", "min", "range", "std", "var", "sum")


def _window_stats(data: torch.Tensor, kernel: np.ndarray,
                  stats: tuple) -> torch.Tensor:
    """(S, H, W) statistics over the kernel footprint, stacked in `stats`
    order: the twin for a CPU tensor, the CUDA kernel otherwise."""
    offsets = kernel_offsets(kernel)
    if data.device.type == "cpu":
        outs = window_stats(data, offsets, stats)
        return torch.stack([outs[s] for s in stats])
    from .kernels.cuda_window import focal_stats_cuda
    return focal_stats_cuda(data, offsets, stats)


def _not_ported(name):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"focal.{name} is not ported to xrspatial_torch yet (ROADMAP A3)")
    fn.__name__ = name
    return fn


mean = _not_ported("mean")
apply = _not_ported("apply")
hotspots = _not_ported("hotspots")


def focal_stats(agg, kernel,
                stats_funcs=['mean', 'max', 'min', 'range', 'std', 'var',
                             'sum']):
    """Focal statistics over a kernel neighborhood for every pixel.

    Returns a 3D (stats, y, x) DataArray.  All statistics are computed in
    one pass over the kernel footprint.
    """
    if not isinstance(agg, DataArray):
        raise TypeError("`agg` must be instance of DataArray")
    if agg.ndim != 2:
        raise ValueError("`agg` must be 2D")
    kernel = custom_kernel(np.asarray(kernel))
    for s in stats_funcs:
        if s not in _STAT_NAMES:
            raise ValueError(f"unknown stat {s!r}; supported: {_STAT_NAMES}")

    stacked = _window_stats(to_torch(agg), kernel, tuple(stats_funcs))
    out = DataArray(stacked, dims=("stats",) + tuple(agg.dims),
                    name="focal_apply", attrs=dict(agg.attrs))
    for cname, cval in agg.coords.items():
        out.coords[cname] = cval
    out.coords["stats"] = DataArray(np.asarray(list(stats_funcs)),
                                    dims=("stats",), name="stats")
    return out
