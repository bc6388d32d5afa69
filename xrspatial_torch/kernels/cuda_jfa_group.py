"""Wrapper of the fused jump-flood group kernel (``csrc/jfa_group.cu``).

Replaces the TPU probe ``tools/exp_jfa_fixed.py::multi_round_fixed``; the
plain versions are ``jfa_group.group_packed_twin`` and
``group_coords_twin``.  Each wrapper takes only contiguous tensors on the
card, takes the tile edge T from ``jfa_group.window_plan`` (which raises
``ValueError`` for a group whose window does not fit in a block's shared
memory), builds the kernel library at the first call, allocates the
output, launches on PyTorch's current stream and raises if the launch
fails.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .cuda_jfa import _check
from .jfa_group import _check_metric, window_plan

__all__ = ["group_packed_cuda", "group_coords_cuda", "LAUNCHES"]

# launches of the kernel in this process, for checks that a path ran on it
LAUNCHES = 0


def _strides(ks):
    ks = [int(k) for k in ks]
    return (ctypes.c_int * len(ks))(*ks), len(ks)


def _grid_fits(h, t):
    if -(-h // t) > 65535:
        raise ValueError(f"jfa_group: {h} rows make more than 65535 tiles "
                         f"of {t}")


def group_packed_cuda(state, ks, metric: int, steps):
    """The group `ks` over the packed int32 state (h, w) on the card;
    returns the new state, equal to ``round_packed_cuda`` applied at each
    stride in turn."""
    global LAUNCHES
    t, _, nbytes = window_plan(ks, "packed")
    _check_metric("packed", metric)
    if state.ndim != 2:
        raise ValueError(f"group_packed_cuda takes a 2D state, got "
                         f"{state.ndim}D")
    _check("group_packed_cuda", state, torch.int32, state.shape)
    h, w = state.shape
    _grid_fits(h, t)
    out = torch.empty_like(state)
    arr, n = _strides(ks)
    with torch.cuda.device(state.device):
        err = _cuda.library().jfa_group_packed(
            state.data_ptr(), out.data_ptr(), h, w, arr, n, t, nbytes,
            float(steps[0]), float(steps[1]), int(metric),
            _cuda.stream_of(state.device))
    _cuda.check(err, "jfa_group_packed")
    LAUNCHES += 1
    return out


def group_coords_cuda(tx, ty, xs, ys, ks, metric: int):
    """The group `ks` over the float32 coordinate state on the card;
    returns (tx, ty), equal to ``round_coords_cuda`` applied at each stride
    in turn."""
    global LAUNCHES
    t, _, nbytes = window_plan(ks, "coords")
    _check_metric("coords", metric)
    if tx.ndim != 2:
        raise ValueError(f"group_coords_cuda takes a 2D state, got "
                         f"{tx.ndim}D")
    h, w = tx.shape
    for name, a, shape in (("tx", tx, (h, w)), ("ty", ty, (h, w)),
                           ("xs", xs, (w,)), ("ys", ys, (h,))):
        _check(f"group_coords_cuda {name}", a, torch.float32, shape)
    _grid_fits(h, t)
    tx_out, ty_out = torch.empty_like(tx), torch.empty_like(ty)
    arr, n = _strides(ks)
    with torch.cuda.device(tx.device):
        err = _cuda.library().jfa_group_coords(
            tx.data_ptr(), ty.data_ptr(), tx_out.data_ptr(),
            ty_out.data_ptr(), xs.data_ptr(), ys.data_ptr(), h, w, arr, n, t,
            nbytes, int(metric), _cuda.stream_of(tx.device))
    _cuda.check(err, "jfa_group_coords")
    LAUNCHES += 1
    return tx_out, ty_out
