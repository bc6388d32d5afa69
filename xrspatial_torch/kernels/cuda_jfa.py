"""Wrapper of the CUDA jump-flood round kernel (``csrc/jfa.cu``).

Replaces ``xrspatial_tpu/kernels/pallas_jfa.py``: the small-stride round
``_multi_round_small``, the tile-jump round ``_large_round`` and their
callers ``jfa_rounds_pallas`` / ``jfa_rounds_packed`` become one round
kernel with the stride as a runtime argument, in two state forms.  Each
wrapper takes only tensors on the card: it builds the kernel library at the
first call, allocates the round's outputs (the kernel reads the round-start
state and writes new buffers, never in place), launches on PyTorch's
current stream and raises if the launch fails.  Their plain versions are
``jfa_rounds.round_packed`` and ``jfa_rounds.round_coords``.
"""

from __future__ import annotations

import torch

from . import _cuda
from .jfa_rounds import EUCLIDEAN, GREAT_CIRCLE, MANHATTAN

__all__ = ["round_packed_cuda", "round_coords_cuda", "LAUNCHES"]

# launches of the kernel in this process, for checks that a path ran on it
LAUNCHES = 0


def _check(name, t, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got one on {t.device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} takes contiguous tensors")


def _ptr(t):
    return None if t is None else t.data_ptr()


def round_packed_cuda(state, value, k: int, metric: int, steps,
                      emit_best=False):
    """One round over the packed int32 state on the card.

    Returns ``(state, value, best)`` like ``jfa_rounds.round_packed``;
    `value` is None when none was given, `best` (float32) only with
    `emit_best`, else None.
    """
    global LAUNCHES
    if metric not in (EUCLIDEAN, MANHATTAN):
        raise ValueError(f"the packed state takes EUCLIDEAN or MANHATTAN, "
                         f"got metric {metric}")
    if state.ndim != 2:
        raise ValueError(f"round_packed_cuda takes a 2D state, got "
                         f"{state.ndim}D")
    _check("round_packed_cuda", state, torch.int32, state.shape)
    if value is not None:
        _check("round_packed_cuda", value, torch.float32, state.shape)
    h, w = state.shape
    s_out = torch.empty_like(state)
    v_out = None if value is None else torch.empty_like(value)
    best = (torch.empty((h, w), dtype=torch.float32, device=state.device)
            if emit_best else None)
    lib = _cuda.library()
    with torch.cuda.device(state.device):
        err = lib.jfa_round_packed(
            state.data_ptr(), _ptr(value), s_out.data_ptr(), _ptr(v_out),
            _ptr(best), h, w, int(k), float(steps[0]), float(steps[1]),
            int(metric), _cuda.stream_of(state.device))
    _cuda.check(err, "jfa_round_packed")
    LAUNCHES += 1
    return s_out, v_out, best


def round_coords_cuda(tx, ty, value, xs, ys, k: int, metric: int):
    """One round over the float32 coordinate state on the card.

    Returns ``(tx, ty, value)`` like ``jfa_rounds.round_coords``.
    """
    global LAUNCHES
    if metric not in (EUCLIDEAN, GREAT_CIRCLE, MANHATTAN):
        raise ValueError(f"unknown metric {metric}")
    if tx.ndim != 2:
        raise ValueError(f"round_coords_cuda takes a 2D state, got "
                         f"{tx.ndim}D")
    h, w = tx.shape
    _check("round_coords_cuda", tx, torch.float32, (h, w))
    _check("round_coords_cuda", ty, torch.float32, (h, w))
    if value is not None:
        _check("round_coords_cuda", value, torch.float32, (h, w))
    _check("round_coords_cuda", xs, torch.float32, (w,))
    _check("round_coords_cuda", ys, torch.float32, (h,))
    tx_out = torch.empty_like(tx)
    ty_out = torch.empty_like(ty)
    v_out = None if value is None else torch.empty_like(value)
    lib = _cuda.library()
    with torch.cuda.device(tx.device):
        err = lib.jfa_round_coords(
            tx.data_ptr(), ty.data_ptr(), _ptr(value), tx_out.data_ptr(),
            ty_out.data_ptr(), _ptr(v_out), xs.data_ptr(), ys.data_ptr(),
            h, w, int(k), int(metric), _cuda.stream_of(tx.device))
    _cuda.check(err, "jfa_round_coords")
    LAUNCHES += 1
    return tx_out, ty_out, v_out
