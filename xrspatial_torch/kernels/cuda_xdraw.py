"""Wrapper of the XDraw scan kernel (``csrc/xdraw.cu``).

``xdraw_scan_cuda`` runs ``xdraw_scan_kernel``: the four half-plane scans
of the XDraw viewshed in one launch, the running max slope of every cell
written into one (H, W) float32 field, each cell by the scan of its own
octant.  It replaces no Pallas kernel: the JAX package runs the scan as a
``lax.scan`` of XLA (``xrspatial_tpu/kernels/viewshed.py::
_halfplane_scan4``).  Its plain version is ``kernels/viewshed.py::
xdraw_scan_twin``, which it equals bit for bit.

The wrapper takes a contiguous float32 slope field on the card, makes its
transpose (one torch copy: the east and west scans then read contiguous
lines), allocates the output and, above what a block's shared memory
holds (more than 29,056 cells a side), the carry's scratch; it launches on
PyTorch's current stream and raises if the launch fails.  It never falls
back to the twin.
"""

from __future__ import annotations

import torch

from . import _cuda

__all__ = ["xdraw_scan_cuda", "XDRAW_LAUNCHES", "MAX_EDGE"]

# launches in this process, for checks that a path ran on the kernel
XDRAW_LAUNCHES = 0
# the longest raster side the kernel takes (1024 threads x 64 lanes)
MAX_EDGE = 65536


def xdraw_scan_cuda(slope: torch.Tensor, vp_row: int,
                    vp_col: int) -> torch.Tensor:
    """The XDraw running max slope of `slope` (H, W) seen from (vp_row,
    vp_col): a new (H, W) float32 tensor on the card."""
    global XDRAW_LAUNCHES
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
    lib = _cuda.library()
    slope_t = slope.t().contiguous()
    out = torch.empty_like(slope)
    nbytes = lib.xdraw_scratch_bytes(h, w)
    scratch = (torch.empty(nbytes // 4, dtype=torch.float32,
                           device=slope.device) if nbytes else None)
    with torch.cuda.device(slope.device):
        err = lib.xdraw_scan_launch(
            slope.data_ptr(), slope_t.data_ptr(), out.data_ptr(), h, w,
            vp_row, vp_col, scratch.data_ptr() if nbytes else None,
            _cuda.stream_of(slope.device))
    _cuda.check(err, "xdraw_scan_kernel")
    XDRAW_LAUNCHES += 1
    return out
