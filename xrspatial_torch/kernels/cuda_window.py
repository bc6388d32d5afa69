"""Wrapper of the CUDA focal-statistics kernel (``csrc/focal.cu``).

Replaces ``xrspatial_tpu/kernels/pallas_window2.py::focal_stats_tiled``
(and, for the shapes the JAX package sends elsewhere,
``pallas_window.py::focal_stats_pallas``).  The wrapper takes only a
tensor on the card: it builds the kernel library at the first call,
allocates the stacked output, launches on PyTorch's current stream and
raises if the launch fails.  Its plain version is
``kernels/window.py::window_stats``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _cuda
from .window import check_offsets

__all__ = ["focal_stats_cuda", "LAUNCHES"]

# launches of the kernel in this process, for checks that a path ran on it
LAUNCHES = 0

# the kernel's stat slots, in csrc/focal.cu's order
_SLOT_ORDER = ("mean", "sum", "min", "max", "range", "var", "std")


@functools.lru_cache(maxsize=64)
def _device_offsets(offsets: tuple, device: torch.device) -> torch.Tensor:
    """(n, 2) int32 (dy, dx) pairs on the card, one per offsets tuple."""
    return torch.tensor(offsets, dtype=torch.int32, device=device)


def focal_stats_cuda(data: torch.Tensor, offsets, stats) -> torch.Tensor:
    """(S, H, W) float32 focal statistics, stacked in `stats` order."""
    global LAUNCHES
    if data.device.type != "cuda":
        raise ValueError(
            f"focal_stats_cuda takes a CUDA tensor, got one on {data.device}")
    if data.ndim != 2:
        raise ValueError(
            f"focal_stats_cuda takes a 2D tensor, got {data.ndim}D")
    offsets = tuple((int(dy), int(dx)) for dy, dx in offsets)
    if not offsets:
        raise ValueError("focal_stats_cuda needs at least one offset")
    check_offsets(offsets)
    stats = tuple(stats)
    unknown = [s for s in stats if s not in _SLOT_ORDER]
    if unknown or not stats or len(set(stats)) != len(stats):
        raise ValueError(f"stats must be distinct names from {_SLOT_ORDER}, "
                         f"got {stats!r}")
    x = data.to(torch.float32).contiguous()
    h, w = x.shape
    out = torch.empty((len(stats), h, w), dtype=torch.float32,
                      device=x.device)
    slots = (ctypes.c_int * len(_SLOT_ORDER))(
        *(stats.index(s) if s in stats else -1 for s in _SLOT_ORDER))
    offs = _device_offsets(offsets, x.device)
    lib = _cuda.library()
    with torch.cuda.device(x.device):
        err = lib.focal_launch(x.data_ptr(), offs.data_ptr(), len(offsets),
                               slots, out.data_ptr(), h, w,
                               _cuda.stream_of(x.device))
    _cuda.check(err, "focal_kernel")
    LAUNCHES += 1
    return out
