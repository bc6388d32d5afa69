"""Wrappers of the CUDA stream probes (``csrc/stream.cu``).

``stream_copy_cuda`` (``stream_copy_kernel``) and ``stream_add_cuda``
(``stream_add_kernel``) replace the TPU probes
``tools/measure_stream.py::pallas_copy`` and ``pallas_add``; their plain
versions are ``kernels/stream.py::stream_copy`` and ``stream_add``.  Each
wrapper takes only contiguous float32 tensors on the card, allocates the
output (or is given one), launches on PyTorch's current stream and raises
if the launch fails.  Each splits its buffers as ``kernels/stream.py::
copy_plan`` or ``add_plan`` says: a scalar head and tail around a
16-byte-aligned body, which the copy moves with bulk copies and the add
with 16-byte loads and stores.
"""

from __future__ import annotations

import torch

from . import _cuda
from .stream import add_plan, copy_plan

__all__ = ["stream_copy_cuda", "stream_add_cuda", "COPY_LAUNCHES",
           "ADD_LAUNCHES"]

# launches of each kernel in this process, for checks that a path ran on it
COPY_LAUNCHES = 0
ADD_LAUNCHES = 0


def _check(who: str, *tensors: torch.Tensor) -> None:
    x = tensors[0]
    for t in tensors:
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{who} takes CUDA tensors on one card, got one "
                             f"on {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{who} takes contiguous float32 tensors, got "
                             f"{t.dtype}, contiguous={t.is_contiguous()}")
        if t.shape != x.shape:
            raise ValueError(f"{who}: shapes {tuple(x.shape)} and "
                             f"{tuple(t.shape)} differ")


def stream_copy_cuda(x: torch.Tensor, out: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """`x` copied into `out`, a new tensor by default (1 read + 1 write)."""
    global COPY_LAUNCHES
    if out is None:
        out = torch.empty_like(x)
    _check("stream_copy_cuda", x, out)
    head, body, _ = copy_plan(x.numel(), x.data_ptr(), out.data_ptr())
    with torch.cuda.device(x.device):
        err = _cuda.library().stream_copy_launch(
            x.data_ptr(), out.data_ptr(), x.numel(), head, body,
            _cuda.stream_of(x.device))
    _cuda.check(err, "stream_copy_kernel")
    COPY_LAUNCHES += 1
    return out


def stream_add_cuda(x: torch.Tensor, y: torch.Tensor,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """`x` + `y` into `out`, a new tensor by default (2 reads + 1 write)."""
    global ADD_LAUNCHES
    if out is None:
        out = torch.empty_like(x)
    _check("stream_add_cuda", x, y, out)
    head, body, _ = add_plan(x.numel(), x.data_ptr(), y.data_ptr(),
                             out.data_ptr())
    with torch.cuda.device(x.device):
        err = _cuda.library().stream_add_launch(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(), head,
            body, _cuda.stream_of(x.device))
    _cuda.check(err, "stream_add_kernel")
    ADD_LAUNCHES += 1
    return out
