"""Device-memory stream probes: float32 copy and add.

Counterpart of the TPU probes ``tools/measure_stream.py::pallas_copy`` and
``pallas_add``.  The functions here are the torch twins, the plain
versions of the CUDA kernels in ``cuda_stream.py``; ``copy`` and ``add``
dispatch: a tensor on the CPU goes to the twin, a tensor on the card to
the kernel.  ``xrspatial_torch.tools.measure_stream`` times them.
"""

from __future__ import annotations

import torch

__all__ = ["stream_copy", "stream_add", "copy", "add"]


def stream_copy(x: torch.Tensor) -> torch.Tensor:
    """A new tensor equal to `x`."""
    return x.clone()


def stream_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """`x` + `y`, a new tensor."""
    return x + y


def copy(x: torch.Tensor) -> torch.Tensor:
    """A copy of the float32 tensor `x`, on its device."""
    if x.device.type == "cpu":
        return stream_copy(x)
    from .cuda_stream import stream_copy_cuda
    return stream_copy_cuda(x)


def add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """`x` + `y` for float32 tensors of one shape, on their device."""
    if x.device.type == "cpu":
        return stream_add(x, y)
    from .cuda_stream import stream_add_cuda
    return stream_add_cuda(x, y)
