"""Device-memory stream probes: float32 copy and add.

Counterpart of the TPU probes ``tools/measure_stream.py::pallas_copy`` and
``pallas_add``.  The functions here are the torch twins, the plain
versions of the CUDA kernels in ``cuda_stream.py``; ``copy`` and ``add``
dispatch: a tensor on the CPU goes to the twin, a tensor on the card to
the kernel.  ``copy_plan`` and ``add_plan`` are the kernels' split of a
buffer into a scalar head, a 16-byte-aligned body (bulk copies for the
copy, 16-byte loads and stores for the add) and a scalar tail.
``xrspatial_torch.tools.measure_stream`` times them.
"""

from __future__ import annotations

import torch

__all__ = ["stream_copy", "stream_add", "copy", "add", "copy_plan",
           "add_plan"]


def copy_plan(n: int, x_ptr: int, y_ptr: int) -> tuple:
    """(head, body, tail): how the copy kernel splits `n` float32 values
    from address `x_ptr` to `y_ptr`.

    The bulk copies move 16-byte groups between 16-byte-aligned
    addresses.  When both pointers are 4-byte aligned and alike mod 16,
    `head` scalars bring x (and so y) to its next 16-byte boundary, `body`
    (a multiple of 4) goes in bulk and the `tail` (fewer than 4) is
    scalar.  Otherwise no body can be aligned in both: every value is
    scalar, ``(0, 0, n)``.  The launcher in ``csrc/stream.cu`` checks the
    same rule.
    """
    return add_plan(n, x_ptr, y_ptr, y_ptr)


def add_plan(n: int, x_ptr: int, y_ptr: int, z_ptr: int) -> tuple:
    """(head, body, tail): how the add kernel splits `n` float32 values of
    x + y at addresses `x_ptr`, `y_ptr` into z at `z_ptr`: the copy's rule
    (``copy_plan``) with all three pointers alike mod 16."""
    if not x_ptr % 16 == y_ptr % 16 == z_ptr % 16 or x_ptr % 4:
        return 0, 0, n
    head = min(n, (16 - x_ptr % 16) % 16 // 4)
    body = (n - head) // 4 * 4
    return head, body, n - head - body


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
