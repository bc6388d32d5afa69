"""Wrapper of the XDraw scan kernel X1 (``csrc/xdraw.cu``).

``xdraw_scan_cuda`` runs the four half-plane scans of the XDraw viewshed
in one launch, the running max slope of every cell written into one
(H, W) float32 field, each cell by the scan of its own octant.  It
replaces no Pallas kernel: the JAX package runs the scan as a
``lax.scan`` of XLA (``xrspatial_tpu/kernels/viewshed.py::
_halfplane_scan4``).  Its plain version is ``kernels/viewshed.py::
xdraw_scan_twin``, which both routes equal bit for bit:

- "banded" (the default): ``xdraw_banded_kernel``, the half-planes cut
  into bands of lanes, one block a band, on the plan
  ``viewshed.xdraw_plan`` names (or a `band` and `chunk` given), one
  cooperative launch whose window is the whole raster and all its steps;
- "simple": the first port, ``xdraw_scan_kernel``, one block a
  half-plane, by name.

On a mesh, ``xdraw_strip_cuda`` is the strip route of the same kernel:
one cooperative launch runs a window of steps on one strip's four
half-planes (east and west on its strip of rows, south
and north on its strip of columns), starting from a carry-in row and
writing a carry-out row; ``kernels/viewshed.py::xdraw_mesh_max_slope``
drives it window by window and exchanges the halo carries.  Its plain
version is ``viewshed.xdraw_strip_twin``.

The wrapper takes a contiguous float32 slope field on the card and
allocates the output: for the banded route the chunks' carry slots and
the bands' progress flags (zeroed), for the first port the slope's
transpose (its east and west scans read contiguous lines) and, above
what a block's shared memory holds (more than 29,056 cells a side), the
carry's scratch.  It launches on PyTorch's current stream and raises if
the launch fails (the banded launch is cooperative, so it fails if its
blocks cannot all be resident at once); it never falls back from one
route to the other, or to the twin.
"""

from __future__ import annotations

import torch

from . import _cuda
from .viewshed import xdraw_plan

__all__ = ["xdraw_scan_cuda", "xdraw_strip_cuda", "strip_scratch", "ROUTES",
           "XDRAW_LAUNCHES", "XDRAW_SIMPLE_LAUNCHES", "XDRAW_STRIP_LAUNCHES",
           "MAX_EDGE"]

ROUTES = ("banded", "simple")

# launches in this process, for checks that a path ran on the kernel: on
# every route, and the first port's among them
XDRAW_LAUNCHES = 0
XDRAW_SIMPLE_LAUNCHES = 0
# launches of the strip route (a mesh's windows), counted apart
XDRAW_STRIP_LAUNCHES = 0
# the longest raster side the kernels take (the first port's 1024
# threads x 64 lanes)
MAX_EDGE = 65536


def xdraw_scan_cuda(slope: torch.Tensor, vp_row: int, vp_col: int,
                    route=None, band=None, chunk=None) -> torch.Tensor:
    """The XDraw running max slope of `slope` (H, W) seen from (vp_row,
    vp_col): a new (H, W) float32 tensor on the card.  `route` None or
    "banded" takes the redesigned kernel (`band` and `chunk` override its
    plan), "simple" the first port."""
    global XDRAW_LAUNCHES, XDRAW_SIMPLE_LAUNCHES
    route = route or "banded"
    if route not in ROUTES:
        raise ValueError(f"xdraw_scan_cuda: route {route!r} is not one of "
                         f"{ROUTES}")
    if slope.device.type != "cuda":
        raise ValueError(f"xdraw_scan_cuda takes a CUDA tensor, got one on "
                         f"{slope.device}")
    if slope.dtype != torch.float32 or slope.dim() != 2 \
            or not slope.is_contiguous():
        raise ValueError(f"xdraw_scan_cuda takes a contiguous 2-D float32 "
                         f"tensor, got {slope.dtype} {tuple(slope.shape)}, "
                         f"contiguous={slope.is_contiguous()}")
    h, w = slope.shape
    if not (0 < h <= MAX_EDGE and 0 < w <= MAX_EDGE):
        raise ValueError(f"xdraw_scan_cuda takes rasters of 1 to {MAX_EDGE} "
                         f"cells a side, got {h}x{w}")
    if not (0 <= vp_row < h and 0 <= vp_col < w):
        raise ValueError(f"xdraw_scan_cuda: viewpoint ({vp_row}, {vp_col}) "
                         f"outside the {h}x{w} raster")
    if route == "simple" and (band is not None or chunk is not None):
        raise ValueError("xdraw_scan_cuda: band and chunk belong to the "
                         "banded route")
    lib = _cuda.library()
    dev = slope.device
    out = torch.empty_like(slope)
    if route == "banded":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = xdraw_plan(h, w, sms, band, chunk)
        carry = torch.empty(4 * plan.slots * max(h, w), dtype=torch.float32,
                            device=dev)
        progress = torch.zeros(plan.blocks, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            err = lib.xdraw_banded_launch(
                slope.data_ptr(), out.data_ptr(), h, w, vp_row, vp_col,
                plan.band, plan.chunk, plan.slots, carry.data_ptr(),
                progress.data_ptr(), _cuda.stream_of(dev))
        _cuda.check(err, "xdraw_banded_kernel")
        XDRAW_LAUNCHES += 1
        return out

    slope_t = slope.t().contiguous()
    nbytes = lib.xdraw_scratch_bytes(h, w)
    scratch = (torch.empty(nbytes // 4, dtype=torch.float32, device=dev)
               if nbytes else None)
    with torch.cuda.device(dev):
        err = lib.xdraw_scan_launch(
            slope.data_ptr(), slope_t.data_ptr(), out.data_ptr(), h, w,
            vp_row, vp_col, scratch.data_ptr() if nbytes else None,
            _cuda.stream_of(dev))
    _cuda.check(err, "xdraw_scan_kernel")
    XDRAW_LAUNCHES += 1
    XDRAW_SIMPLE_LAUNCHES += 1
    return out


def strip_scratch(rows: torch.Tensor, cols: torch.Tensor, plan) -> tuple:
    """(slots, progress) of one strip's launches on its card: the four
    half-planes' chunk-end slots for `plan` (a ``viewshed.
    XDrawStripPlan``) and one zeroed flag a block of the strip's widest
    launch."""
    lanes = 2 * (rows.shape[0] + cols.shape[1])
    slots = torch.empty(plan.slots * lanes, dtype=torch.float32,
                        device=rows.device)
    blocks = 2 * (-(-rows.shape[0] // plan.band)
                  + -(-cols.shape[1] // plan.band))
    return slots, torch.zeros(blocks, dtype=torch.int32, device=rows.device)


def _side(half, x_major):
    """The launch's arguments of one StripHalf (rows or columns), or of an
    orientation without lanes."""
    if half is None:
        return [None, None, None, None, 0, 0, 0, 0]
    for t in (half.src, half.out, half.carry_in, half.carry_out):
        if t.device.type != "cuda" or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("xdraw_strip_cuda takes contiguous float32 "
                             "tensors on the card")
    if half.out.shape != half.src.shape:
        raise ValueError("xdraw_strip_cuda: a field differs from its slope")
    lanes = half.src.shape[0] if x_major else half.src.shape[1]
    if tuple(half.carry_in.shape) != (2, lanes) \
            or tuple(half.carry_out.shape) != (2, lanes):
        raise ValueError(f"xdraw_strip_cuda: carries must be (2, {lanes})")
    return [half.src.data_ptr(), half.out.data_ptr(),
            half.carry_in.data_ptr(), half.carry_out.data_ptr(),
            half.src.stride(0), half.buf_lo, half.lane_hi, lanes]


def xdraw_strip_cuda(rows, cols, h: int, w: int, vp_row: int, vp_col: int,
                     s0: int, plan, slots: torch.Tensor,
                     progress: torch.Tensor, pbase: int) -> None:
    """One window of the strip route: steps [s0, s0 + plan.steps) of one
    strip's four half-planes of the (h, w) raster seen from (vp_row,
    vp_col), in one cooperative launch of ``xdraw_banded_kernel`` on the
    strip's card.  `rows` and `cols` are ``viewshed.StripHalf`` s (None:
    no lanes on that side); the fields and the carry-out rows are written
    in place.  `slots` and `progress` come from ``strip_scratch``;
    `pbase` grows by ``plan.slots`` a window.  Raises if the launch
    fails; never falls back to the twin."""
    global XDRAW_STRIP_LAUNCHES
    if not (0 <= vp_row < h and 0 <= vp_col < w):
        raise ValueError(f"xdraw_strip_cuda: viewpoint ({vp_row}, {vp_col}) "
                         f"outside the {h}x{w} raster")
    dev = (rows or cols).src.device
    if slots.device != dev or progress.device != dev:
        raise ValueError("xdraw_strip_cuda: scratch on another device")
    lib = _cuda.library()
    with torch.cuda.device(dev):
        err = lib.xdraw_strip_launch(
            *_side(rows, True), *_side(cols, False), slots.data_ptr(),
            progress.data_ptr(), h, w, vp_row, vp_col, plan.band,
            plan.chunk, s0, plan.steps, plan.slots, pbase,
            _cuda.stream_of(dev))
    _cuda.check(err, "xdraw_banded_kernel (strip window)")
    XDRAW_STRIP_LAUNCHES += 1
