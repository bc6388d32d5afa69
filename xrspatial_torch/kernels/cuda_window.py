"""Wrappers of the CUDA focal-statistics kernels.

- ``focal_stats_cuda``: replaces
  ``xrspatial_tpu/kernels/pallas_window2.py::focal_stats_tiled``, on the
  staged template of ``csrc/focal_halo.cu`` (each tile's halo window
  staged once, by TMA or by cp.async, as ``halo_plan`` names), or on its
  first port ``csrc/focal.cu::focal_kernel`` by name (route "simple");
- ``focal_stats_halo_cuda``: ``csrc/focal_halo.cu``, replaces
  ``xrspatial_tpu/kernels/pallas_window.py::focal_stats_pallas``, for the
  footprints beyond the tiled kernel's radius, on the route
  ``kernels/focal_halo.py::halo_plan`` names: a whole halo window a tile,
  staged by TMA or by cp.async, or the ring of input rows.

Both take any raster shape; ``focal_stats_halo_cuda`` takes any
footprint, ``focal_stats_cuda`` one whose staged window fits a block
(every footprint within the tiled radii does).  A wrapper takes only a tensor
on the card: it builds the kernel library at the first call, allocates the
stacked output, launches on PyTorch's current stream and raises if the
launch fails.  Their plain version is ``kernels/window.py::window_stats``;
``focal.py::_window_stats`` chooses between them as the JAX package does.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _cuda
from .focal_halo import halo_plan, register_class, run_table

__all__ = ["focal_stats_cuda", "focal_stats_halo_cuda", "LAUNCHES",
           "TMA_LAUNCHES", "ASYNC_LAUNCHES", "SIMPLE_LAUNCHES",
           "HALO_LAUNCHES", "HALO_TMA_LAUNCHES", "HALO_ASYNC_LAUNCHES",
           "HALO_RING_LAUNCHES"]

# launches of each kernel in this process, for checks that a path ran on it
LAUNCHES = 0             # focal_stats_cuda (B2), every route
TMA_LAUNCHES = 0         # ... the staged template, its window by TMA
ASYNC_LAUNCHES = 0       # ... the staged template, its window by cp.async
SIMPLE_LAUNCHES = 0      # ... the first port, focal_kernel, by name
HALO_LAUNCHES = 0        # the large-footprint kernel, every route
HALO_TMA_LAUNCHES = 0    # ... its staged window by TMA
HALO_ASYNC_LAUNCHES = 0  # ... its staged window by cp.async
HALO_RING_LAUNCHES = 0   # ... the ring of input rows

# the kernels' stat slots, in csrc/focal_cell.cuh's order
_SLOT_ORDER = ("mean", "sum", "min", "max", "range", "var", "std")


@functools.lru_cache(maxsize=64)
def _device_offsets(offsets: tuple, device: torch.device) -> torch.Tensor:
    """(n, 2) int32 (dy, dx) pairs on the card, one per offsets tuple."""
    return torch.tensor(offsets, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=64)
def _device_runs(table: tuple, device: torch.device) -> torch.Tensor:
    """(runs, 2) int32 run table on the card, one per table."""
    return torch.tensor(table, dtype=torch.int32, device=device)


def focal_args(data: torch.Tensor, offsets, stats, who: str) -> tuple:
    """Check a focal kernel's inputs; returns ``(x, offsets, offs, slots,
    out)``: the float32 contiguous input, the offsets as a tuple of int
    pairs and as an int32 table on the card, the stat slots as a C array,
    and the (S, H, W) output, allocated."""
    if data.device.type != "cuda":
        raise ValueError(f"{who} takes a CUDA tensor, got one on "
                         f"{data.device}")
    if data.ndim != 2:
        raise ValueError(f"{who} takes a 2D tensor, got {data.ndim}D")
    offsets = tuple((int(dy), int(dx)) for dy, dx in offsets)
    if not offsets:
        raise ValueError(f"{who} needs at least one offset")
    stats = tuple(stats)
    unknown = [s for s in stats if s not in _SLOT_ORDER]
    if unknown or not stats or len(set(stats)) != len(stats):
        raise ValueError(f"stats must be distinct names from {_SLOT_ORDER}, "
                         f"got {stats!r}")
    x = data.to(torch.float32).contiguous()
    out = torch.empty((len(stats),) + tuple(x.shape), dtype=torch.float32,
                      device=x.device)
    slots = (ctypes.c_int * len(_SLOT_ORDER))(
        *(stats.index(s) if s in stats else -1 for s in _SLOT_ORDER))
    return x, offsets, _device_offsets(offsets, x.device), slots, out


def _staged(x, offsets, offs, slots, out, plan) -> None:
    """Launch the staged template (``focal_halo_staged_kernel``) on `plan`,
    a staged route of ``halo_plan``, compiled for ``register_class(plan)``
    blocks an SM."""
    h, w = x.shape
    ry = max(abs(dy) for dy, _ in offsets)
    rx = max(abs(dx) for _, dx in offsets)
    runs = _device_runs(run_table(offsets, plan), x.device)
    lib = _cuda.library()
    with torch.cuda.device(x.device):
        err = lib.focal_halo_staged_launch(
            x.data_ptr(), runs.data_ptr(), runs.shape[0], len(offsets),
            slots, out.data_ptr(), h, w, ry, rx,
            ("tma", "async").index(plan.route), plan.tile[0], plan.pad,
            plan.pitch, plan.rows, plan.box[0], plan.box[1],
            plan.shared_bytes, plan.grid, register_class(plan),
            _cuda.stream_of(x.device))
    if err < 0:
        raise RuntimeError(f"focal_halo_staged: cuTensorMapEncodeTiled failed "
                           f"with CUresult {-err} for a {h}x{w} float32 "
                           f"raster, box {plan.box}")
    _cuda.check(err, f"focal_halo_staged ({plan.route})")


def focal_stats_cuda(data: torch.Tensor, offsets, stats,
                     route: str | None = None) -> torch.Tensor:
    """(S, H, W) float32 focal statistics, stacked in `stats` order, on the
    staged route ``halo_plan`` names ("tma" or "async": each tile's whole
    window staged once); `route` "simple" takes the first port,
    ``focal_kernel``, by name, which reads every neighbour from device
    memory with bounds checks.  The routes give the same bits."""
    global LAUNCHES, TMA_LAUNCHES, ASYNC_LAUNCHES, SIMPLE_LAUNCHES
    x, offsets, offs, slots, out = focal_args(data, offsets, stats,
                                              "focal_stats_cuda")
    h, w = x.shape
    if route == "simple":
        lib = _cuda.library()
        with torch.cuda.device(x.device):
            err = lib.focal_launch(x.data_ptr(), offs.data_ptr(),
                                   len(offsets), slots, out.data_ptr(), h, w,
                                   _cuda.stream_of(x.device))
        _cuda.check(err, "focal_kernel")
        SIMPLE_LAUNCHES += 1
    else:
        plan = halo_plan(h, w, offsets, x.data_ptr())
        if plan.route == "ring":
            raise ValueError(f"focal_stats_cuda: no staged window of this "
                             f"footprint fits a block (plan {plan}); "
                             f"focal_stats_halo_cuda takes it")
        if route not in (None, plan.route):
            raise ValueError(f"focal_stats_cuda: route {route!r} is not the "
                             f"plan's ({plan.route!r}) or 'simple'")
        if h * w:
            _staged(x, offsets, offs, slots, out, plan)
        if plan.route == "tma":
            TMA_LAUNCHES += 1
        else:
            ASYNC_LAUNCHES += 1
    LAUNCHES += 1
    return out


def focal_stats_halo_cuda(data: torch.Tensor, offsets, stats,
                          route: str | None = None) -> torch.Tensor:
    """(S, H, W) float32 focal statistics, stacked in `stats` order, for
    footprints of large radius, on the route ``halo_plan`` names; `route`
    "ring" takes the ring kernel by name (any other route must be the
    plan's).  The routes give the same bits."""
    global HALO_LAUNCHES, HALO_TMA_LAUNCHES, HALO_ASYNC_LAUNCHES
    global HALO_RING_LAUNCHES
    x, offsets, offs, slots, out = focal_args(data, offsets, stats,
                                              "focal_stats_halo_cuda")
    h, w = x.shape
    plan = halo_plan(h, w, offsets, x.data_ptr())
    route = route or plan.route
    if route not in ("ring", plan.route):
        raise ValueError(f"focal_stats_halo_cuda: route {route!r} is not "
                         f"the plan's ({plan.route!r}) or 'ring'")
    if h * w == 0:
        return out
    if route == "ring":
        rx = max(abs(dx) for _, dx in offsets)
        lib = _cuda.library()
        with torch.cuda.device(x.device):
            err = lib.focal_halo_launch(x.data_ptr(), offs.data_ptr(),
                                        len(offsets), slots, out.data_ptr(),
                                        h, w, rx, _cuda.stream_of(x.device))
        _cuda.check(err, "focal_halo (ring)")
    else:
        _staged(x, offsets, offs, slots, out, plan)
    HALO_LAUNCHES += 1
    if route == "tma":
        HALO_TMA_LAUNCHES += 1
    elif route == "async":
        HALO_ASYNC_LAUNCHES += 1
    else:
        HALO_RING_LAUNCHES += 1
    return out
