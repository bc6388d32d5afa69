"""Wrapper of the CUDA stencil-probe template (``csrc/stencil_probe.cu``).

``stencil_probe_cuda`` launches one instantiation of the template, the
port of the TPU probes ``tools/exp_stencil2.py::pipe_stencil``,
``tools/exp_separable_horn.py::run``, ``tools/exp_padfree_stencil.py::
slope_2d`` and ``tools/exp_seam_cost.py::run`` (``kernels/stencil_probe.py``
names which instantiation ports which); its plain version is
``kernels/stencil_probe.py::stencil_twin``.  It takes only a 2D float32
tensor on the card: it builds the kernel library at the first call,
allocates the output, launches on PyTorch's current stream and raises if
the launch fails.  With edges "bare" the cells outside the interior blocks
are left as ``torch.empty`` gave them.  The staged form runs as
``staged_plan`` plans it, and so does form separable_staged (B8d's
redesign, the separable arithmetic on the same windows); the launcher
checks the plan's route against its own rule, and a failed tensor-map
encode raises.
"""

from __future__ import annotations

import torch

from . import _cuda
from .stencil_probe import (EDGES, FORMS, MODES, STAGED_FORMS,
                            check_variant, interior_extent, shapes_of,
                            staged_plan)

__all__ = ["stencil_probe_cuda", "LAUNCHES", "EDGE_LAUNCHES", "TMA_LAUNCHES",
           "ASYNC_LAUNCHES", "SEP_TMA_LAUNCHES", "SEP_ASYNC_LAUNCHES"]

# launches in this process, for checks that a path ran on the kernels
LAUNCHES = 0          # the template's main kernel (ring, separable, interior)
EDGE_LAUNCHES = 0     # the edge-band kernel of edges "interior"
TMA_LAUNCHES = 0      # the staged kernel (B8c), windows staged by TMA
ASYNC_LAUNCHES = 0    # the staged kernel (B8c), windows staged by cp.async
SEP_TMA_LAUNCHES = 0    # form separable_staged (B8d), by TMA
SEP_ASYNC_LAUNCHES = 0  # form separable_staged (B8d), by cp.async


def _staged(x: torch.Tensor, out: torch.Tensor, mode, form, tile) -> None:
    global TMA_LAUNCHES, ASYNC_LAUNCHES, SEP_TMA_LAUNCHES, SEP_ASYNC_LAUNCHES
    h, w = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = staged_plan(h, w, tile, x.data_ptr(), sms)
    with torch.cuda.device(x.device):
        err = _cuda.library().stencil_staged_launch(
            x.data_ptr(), out.data_ptr(), h, w, MODES.index(mode),
            STAGED_FORMS.index(form), tile[0], tile[1],
            ("tma", "async").index(plan.route), plan.stages, plan.grid,
            plan.shared_bytes, 1.0, 1.0, _cuda.stream_of(x.device))
    if err < 0:
        raise RuntimeError(f"stencil_staged: cuTensorMapEncodeTiled failed "
                           f"with CUresult {-err} for a {h}x{w} float32 "
                           f"raster, box {plan.box}")
    _cuda.check(err, f"stencil_staged ({form})")
    tma = plan.route == "tma"
    if form == "staged":
        TMA_LAUNCHES += tma
        ASYNC_LAUNCHES += not tma
    else:
        SEP_TMA_LAUNCHES += tma
        SEP_ASYNC_LAUNCHES += not tma


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
            _staged(x, out, mode, form, block)
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
