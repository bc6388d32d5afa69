"""Wrappers of XDraw's two per-cell kernels (``csrc/xdraw_cells.cu``).

``xdraw_fields_cuda`` computes each cell's slope from the viewpoint, the
input of the scan X1 (``cuda_xdraw.xdraw_scan_cuda``);
``xdraw_epilogue_cuda`` reads X1's field at each cell's primary and
secondary inward neighbours and writes the cell's vertical angle, or
INVISIBLE.  They replace no Pallas kernel: the JAX package leaves these
passes to XLA (``xrspatial_tpu/kernels/viewshed.py::_xdraw_fields``,
``_xdraw_epilogue``).  Their plain versions are the torch-op passes of
``kernels/viewshed.py::_xdraw_fields`` and ``_xdraw_epilogue``, which the
kernels equal bit for bit on the card.

Every scalar goes to the kernel as an argument, rounded to float32 as the
torch passes round it (``_f32``), and the viewpoint's elevation is read
on the card from `vp_cell`, so neither call waits on the card.  A raster
may be a block of a larger one (a mesh's), whose cell (0, 0) is the
raster's `origin`; the epilogue then reads X1's field with a one-cell
halo (`halo` 1), else the field is the raster's own (`halo` 0).

Each wrapper takes float32 tensors on the card whose rows are contiguous
(any row stride), allocates its output and launches on PyTorch's current
stream; it raises on what the kernel does not take or if the launch
fails, and never falls back to the torch passes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import _cuda

__all__ = ["xdraw_fields_cuda", "xdraw_epilogue_cuda", "FIELDS_LAUNCHES",
           "EPILOGUE_LAUNCHES"]

# launches in this process, for checks that a path ran on the kernels
FIELDS_LAUNCHES = 0
EPILOGUE_LAUNCHES = 0

TINY = 1e-12            # the distance's floor, as the torch passes clamp it


def _f32(x) -> float:
    """`x` rounded to float32 (as ``torch.tensor(x, dtype=float32)``)."""
    return float(np.float32(x))


# torch's true division of a float32 tensor by a scalar from the host
# multiplies by the scalar's float32 reciprocal on the card
INV_PI = float(np.float32(1.0) / np.float32(math.pi))


def _plane(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda" or t.dtype != torch.float32 or t.dim() != 2 \
            or t.stride(1) != 1:
        raise ValueError(f"{name} must be a 2-D float32 tensor on the card "
                         f"with contiguous rows, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}, strides "
                         f"{t.stride()}")


def _args(data, vp_row, vp_col, origin, vp_cell):
    """The checked viewpoint cell and the launch's common arguments."""
    _plane(data, "data")
    h, w = data.shape
    if h == 0 or w == 0:
        raise ValueError("the XDraw cell kernels take a non-empty raster")
    y0, x0 = origin
    if vp_cell is None:
        if not (0 <= vp_row - y0 < h and 0 <= vp_col - x0 < w):
            raise ValueError(f"viewpoint ({vp_row}, {vp_col}) outside the "
                             f"{h}x{w} raster at {origin}: give vp_cell")
        vp_cell = data[vp_row - y0, vp_col - x0]
    if vp_cell.device != data.device or vp_cell.dtype != torch.float32 \
            or vp_cell.numel() != 1:
        raise ValueError("vp_cell must be one float32 value on data's card")
    return vp_cell, [h, w, int(y0), int(x0), int(vp_row), int(vp_col),
                     vp_cell.data_ptr()]


def xdraw_fields_cuda(data: torch.Tensor, vp_row: int, vp_col: int,
                      observer_elev: float, ew_res: float, ns_res: float,
                      origin=(0, 0), vp_cell=None) -> torch.Tensor:
    """The slope of each cell of `data` (H, W) from the viewpoint (vp_row,
    vp_col) of the raster at the height of `vp_cell` (the viewpoint's
    terrain on `data`'s card; by default data's own cell) plus
    `observer_elev`: a new contiguous (H, W) float32 tensor, -inf at the
    viewpoint.  ``_xdraw_fields(...)[3]`` bit for bit."""
    global FIELDS_LAUNCHES
    vp_cell, geo = _args(data, vp_row, vp_col, origin, vp_cell)
    out = torch.empty(data.shape, dtype=torch.float32, device=data.device)
    dev = data.device
    lib = _cuda.library()
    with torch.cuda.device(dev):
        err = lib.xdraw_fields_launch(
            data.data_ptr(), data.stride(0), out.data_ptr(), *geo,
            _f32(observer_elev), _f32(ew_res), _f32(ns_res), _f32(TINY),
            _cuda.stream_of(dev))
    _cuda.check(err, "xdraw_fields_kernel")
    FIELDS_LAUNCHES += 1
    return out


def xdraw_epilogue_cuda(m: torch.Tensor, data: torch.Tensor, vp_row: int,
                        vp_col: int, observer_elev: float,
                        target_elev: float, ew_res: float, ns_res: float,
                        origin=(0, 0), vp_cell=None,
                        halo: int = 0) -> torch.Tensor:
    """The vertical angle of each cell of `data` (H, W) from X1's field
    `m`, (H + 2 * halo, W + 2 * halo) with data's cell (r, c) at m's
    (r + halo, c + halo): a new contiguous (H, W) float32 tensor, 0 to
    180 degrees where visible, INVISIBLE (-1) where hidden or where the
    DEM is NaN, 180 at the viewpoint.  The geometry as
    ``xdraw_fields_cuda``'s.  ``_xdraw_epilogue`` bit for bit."""
    global EPILOGUE_LAUNCHES
    vp_cell, geo = _args(data, vp_row, vp_col, origin, vp_cell)
    _plane(m, "m")
    h, w = data.shape
    if halo not in (0, 1) or tuple(m.shape) != (h + 2 * halo, w + 2 * halo) \
            or m.device != data.device:
        raise ValueError(f"m must be ({h} + 2 * halo, {w} + 2 * halo) on "
                         f"data's card with halo 0 or 1, got "
                         f"{tuple(m.shape)} on {m.device}, halo {halo}")
    out = torch.empty(data.shape, dtype=torch.float32, device=data.device)
    dev = data.device
    lib = _cuda.library()
    with torch.cuda.device(dev):
        err = lib.xdraw_epilogue_launch(
            m.data_ptr(), m.stride(0), m.shape[0], m.shape[1], halo,
            data.data_ptr(), data.stride(0), out.data_ptr(), *geo,
            _f32(observer_elev), _f32(target_elev), _f32(ew_res),
            _f32(ns_res), _f32(TINY), INV_PI, _cuda.stream_of(dev))
    _cuda.check(err, "xdraw_epilogue_kernel")
    EPILOGUE_LAUNCHES += 1
    return out
