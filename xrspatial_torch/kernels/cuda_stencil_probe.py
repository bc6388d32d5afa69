"""Wrapper of the CUDA stencil-probe template (``csrc/stencil_probe.cu``).

``stencil_probe_cuda`` launches one instantiation of the template, the
port of the TPU probes ``tools/exp_stencil2.py::pipe_stencil``,
``tools/exp_separable_horn.py::run``, ``tools/exp_padfree_stencil.py::
slope_2d`` and ``tools/exp_seam_cost.py::run`` (``kernels/stencil_probe.py``
names which instantiation ports which); its plain version is
``kernels/stencil_probe.py::stencil_twin``.  It takes only a 2D float32
tensor on the card: it builds the kernel library at the first call,
allocates the output, launches on PyTorch's current stream and raises if
the launch fails.  With edges "bare" the cells outside ``bare_extent``
are left as ``torch.empty`` gave them.  The staged form runs as
``staged_plan`` plans it, and so does form separable_staged (B8d's
redesign, the separable arithmetic on the same windows); the launcher
checks the plan's route and its walk's tiles against its own, and a
failed tensor-map encode raises.  The staged form with edges interior
(B8e's redesign) is two launches: the interior walk, then
``edge_bands_cuda`` on the cells outside ``staged_interior_extent``; with
edges bare (B8f's) the interior walk alone, and where the raster has no
interior, no launch.
"""

from __future__ import annotations

import torch

from . import _cuda
from .stencil_probe import (EDGES, FORMS, MODES, STAGED_FORMS,
                            check_variant, interior_extent, shapes_of,
                            staged_interior_extent, staged_plan)

__all__ = ["stencil_probe_cuda", "edge_bands_cuda", "LAUNCHES",
           "EDGE_LAUNCHES", "TMA_LAUNCHES", "ASYNC_LAUNCHES",
           "SEP_TMA_LAUNCHES", "SEP_ASYNC_LAUNCHES",
           "INTERIOR_TMA_LAUNCHES", "INTERIOR_ASYNC_LAUNCHES",
           "RING_TMA_LAUNCHES", "RING_ASYNC_LAUNCHES"]

# launches in this process, for checks that a path ran on the kernels
LAUNCHES = 0          # the template's main kernel (ring, separable, interior)
EDGE_LAUNCHES = 0     # the edge-band kernel of edges "interior"
TMA_LAUNCHES = 0      # the staged kernel (B8c), windows staged by TMA
ASYNC_LAUNCHES = 0    # the staged kernel (B8c), windows staged by cp.async
SEP_TMA_LAUNCHES = 0    # form separable_staged (B8d), by TMA
SEP_ASYNC_LAUNCHES = 0  # form separable_staged (B8d), by cp.async
INTERIOR_TMA_LAUNCHES = 0    # the staged interior walk (B8e, B8f), by TMA
INTERIOR_ASYNC_LAUNCHES = 0  # the staged interior walk, by cp.async
RING_TMA_LAUNCHES = 0    # staged ring_branch (B8f), by TMA
RING_ASYNC_LAUNCHES = 0  # staged ring_branch, by cp.async


def _staged(x: torch.Tensor, out: torch.Tensor, mode, form, edges,
            tile) -> None:
    global TMA_LAUNCHES, ASYNC_LAUNCHES, SEP_TMA_LAUNCHES, SEP_ASYNC_LAUNCHES
    global INTERIOR_TMA_LAUNCHES, INTERIOR_ASYNC_LAUNCHES
    global RING_TMA_LAUNCHES, RING_ASYNC_LAUNCHES
    h, w = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    walk = "interior" if edges in ("interior", "bare") else "full"
    plan = staged_plan(h, w, tile, x.data_ptr(), sms, walk=walk)
    if plan.tiles:
        with torch.cuda.device(x.device):
            err = _cuda.library().stencil_staged_launch(
                x.data_ptr(), out.data_ptr(), h, w, MODES.index(mode),
                STAGED_FORMS.index(form), EDGES.index(edges), tile[0],
                tile[1], ("tma", "async").index(plan.route), plan.stages,
                plan.grid, plan.shared_bytes, plan.tiles, 1.0, 1.0,
                _cuda.stream_of(x.device))
        if err < 0:
            raise RuntimeError(f"stencil_staged: cuTensorMapEncodeTiled "
                               f"failed with CUresult {-err} for a {h}x{w} "
                               f"float32 raster, box {plan.box}")
        _cuda.check(err, f"stencil_staged ({form}, {edges})")
        tma = plan.route == "tma"
        if form == "separable_staged":
            SEP_TMA_LAUNCHES += tma
            SEP_ASYNC_LAUNCHES += not tma
        elif edges == "ring":
            TMA_LAUNCHES += tma
            ASYNC_LAUNCHES += not tma
        elif edges == "ring_branch":
            RING_TMA_LAUNCHES += tma
            RING_ASYNC_LAUNCHES += not tma
        else:                           # interior and bare: the interior walk
            INTERIOR_TMA_LAUNCHES += tma
            INTERIOR_ASYNC_LAUNCHES += not tma
    if edges == "interior":
        edge_bands_cuda(x, out, staged_interior_extent(h, w, tile))


def edge_bands_cuda(x: torch.Tensor, out: torch.Tensor, extent) -> None:
    """Write into `out` the slope (B1's expression, NaN ring) of every
    cell of `x` outside `extent` = (r0, r1, c0, c1), with one launch of the
    edge-band kernel (none where no cell lies outside).  Both tensors are
    contiguous (H, W) float32 on the card."""
    global EDGE_LAUNCHES
    for name, t in (("x", x), ("out", out)):
        if t.device.type != "cuda" or t.dtype != torch.float32 or \
                t.ndim != 2 or not t.is_contiguous():
            raise ValueError(f"edge_bands_cuda takes contiguous 2D float32 "
                             f"CUDA tensors; {name} is {t.ndim}D {t.dtype} "
                             f"on {t.device}")
    if out.shape != x.shape or out.device != x.device:
        raise ValueError(f"edge_bands_cuda: out {tuple(out.shape)} on "
                         f"{out.device}, x {tuple(x.shape)} on {x.device}")
    h, w = x.shape
    r0, r1, c0, c1 = extent
    if h * w == (r1 - r0) * (c1 - c0):
        return
    with torch.cuda.device(x.device):
        err = _cuda.library().stencil_edge_launch(
            x.data_ptr(), out.data_ptr(), h, w, r0, r1, c0, c1, 1.0, 1.0,
            _cuda.stream_of(x.device))
    _cuda.check(err, "stencil_edge")
    EDGE_LAUNCHES += 1


def stencil_probe_cuda(x: torch.Tensor, mode="slope", form="nine",
                       edges="ring", block=None) -> torch.Tensor:
    """A new (H, W) float32 tensor: the instantiation (mode, form, edges,
    block) on `x`; `block` defaults to the form's first shape."""
    global LAUNCHES, EDGE_LAUNCHES
    block = block or shapes_of(form)[0]
    check_variant(mode, form, edges, block)
    if x.device.type != "cuda":
        raise ValueError(f"stencil_probe_cuda takes a CUDA tensor, got one "
                         f"on {x.device}")
    if x.ndim != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"stencil_probe_cuda takes a contiguous 2D float32 "
                         f"tensor, got {x.ndim}D {x.dtype}, contiguous="
                         f"{x.is_contiguous()}")
    h, w = x.shape
    out = torch.empty_like(x)
    if form in STAGED_FORMS:
        if h * w:
            _staged(x, out, mode, form, edges, block)
        return out
    r0, r1, c0, c1 = interior_extent(h, w, block)
    with torch.cuda.device(x.device):
        err = _cuda.library().stencil_probe_launch(
            x.data_ptr(), out.data_ptr(), h, w, MODES.index(mode),
            FORMS.index(form), EDGES.index(edges), block[0], block[1], r0, r1,
            c0, c1, 1.0, 1.0, 0, _cuda.stream_of(x.device))
    _cuda.check(err, "stencil_probe")
    if h * w == 0:
        return out
    if edges == "ring" or (r1 > r0 and c1 > c0):
        LAUNCHES += 1
    if edges == "interior" and (r1 - r0) * (c1 - c0) < h * w:
        EDGE_LAUNCHES += 1
    return out
