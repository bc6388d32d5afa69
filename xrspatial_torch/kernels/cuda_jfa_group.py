"""Wrapper of the fused jump-flood group kernel (``csrc/jfa_group.cu``).

Replaces the TPU probe ``tools/exp_jfa_fixed.py::multi_round_fixed``; the
plain versions are ``jfa_group.group_packed_twin`` and
``group_coords_twin``.  Each wrapper takes only contiguous tensors on the
card, takes its plan from ``jfa_group.window_plan`` (route "single", the
default, or "double", the first port, by name; the plan raises
``ValueError`` for a group whose window does not fit), builds the kernel
library at the first call, allocates the output, launches on PyTorch's
current stream and raises if the launch fails.
"""

from __future__ import annotations

import ctypes
import functools
import operator

import torch

from . import _cuda
from .cuda_jfa import _check
from .jfa_group import _check_metric, window_plan

__all__ = ["group_packed_cuda", "group_coords_cuda", "LAUNCHES",
           "SINGLE_LAUNCHES", "DOUBLE_LAUNCHES"]

# launches of the kernel in this process, for checks that a path ran on it
LAUNCHES = 0            # every route
SINGLE_LAUNCHES = 0     # ... one buffer, staged by TMA or cp.async
DOUBLE_LAUNCHES = 0     # ... the first port


def _strides(ks):
    ks = [int(k) for k in ks]
    return (ctypes.c_int * len(ks))(*ks), len(ks)


def _grid_fits(h, t):
    if -(-h // t) > 65535:
        raise ValueError(f"jfa_group: {h} rows make more than 65535 tiles "
                         f"of {t}")


def _count(route):
    global LAUNCHES, SINGLE_LAUNCHES, DOUBLE_LAUNCHES
    LAUNCHES += 1
    if route == "single":
        SINGLE_LAUNCHES += 1
    else:
        DOUBLE_LAUNCHES += 1


def _plan(form, ks, planes, route):
    w = planes[0].shape[1]
    ptr = functools.reduce(operator.or_, [t.data_ptr() for t in planes], 0)
    plan = window_plan(ks, form, route, w, ptr)
    _grid_fits(planes[0].shape[0], plan.tile)
    return plan


def _single(form, plan, ins, outs, xs, ys, ks, metric, steps):
    h, w = ins[0].shape
    arr = ctypes.c_void_p * 2
    strides, n = _strides(ks)
    with torch.cuda.device(ins[0].device):
        err = _cuda.library().jfa_group_single(
            0 if form == "packed" else 1, arr(*[t.data_ptr() for t in ins]),
            arr(*[t.data_ptr() for t in outs]),
            None if xs is None else xs.data_ptr(),
            None if ys is None else ys.data_ptr(), h, w, strides, n,
            plan.tile, plan.cells, plan.pad, plan.pitch,
            plan.rows, 0 if plan.stage == "tma" else 1, plan.shared_bytes,
            float(steps[0]), float(steps[1]), int(metric),
            _cuda.stream_of(ins[0].device))
    if err < 0:
        raise RuntimeError(f"jfa_group: cuTensorMapEncodeTiled failed with "
                           f"CUresult {-err} for a {h}x{w} plane, box "
                           f"{plan.pitch}x{plan.rows}")
    _cuda.check(err, "jfa_group_single")


def group_packed_cuda(state, ks, metric: int, steps, route="single"):
    """The group `ks` over the packed int32 state (h, w) on the card;
    returns the new state, equal to ``round_packed_cuda`` applied at each
    stride in turn."""
    _check_metric("packed", metric)
    if state.ndim != 2:
        raise ValueError(f"group_packed_cuda takes a 2D state, got "
                         f"{state.ndim}D")
    _check("group_packed_cuda", state, torch.int32, state.shape)
    h, w = state.shape
    out = torch.empty_like(state)
    plan = _plan("packed", ks, [state, out], route)
    if plan.route == "single":
        _single("packed", plan, [state], [out], None, None, ks, metric,
                steps)
    else:
        arr, n = _strides(ks)
        with torch.cuda.device(state.device):
            err = _cuda.library().jfa_group_packed(
                state.data_ptr(), out.data_ptr(), h, w, arr, n, plan.tile,
                plan.shared_bytes, float(steps[0]), float(steps[1]),
                int(metric), _cuda.stream_of(state.device))
        _cuda.check(err, "jfa_group_packed")
    _count(plan.route)
    return out


def group_coords_cuda(tx, ty, xs, ys, ks, metric: int, route="single"):
    """The group `ks` over the float32 coordinate state on the card;
    returns (tx, ty), equal to ``round_coords_cuda`` applied at each stride
    in turn."""
    _check_metric("coords", metric)
    if tx.ndim != 2:
        raise ValueError(f"group_coords_cuda takes a 2D state, got "
                         f"{tx.ndim}D")
    h, w = tx.shape
    for name, a, shape in (("tx", tx, (h, w)), ("ty", ty, (h, w)),
                           ("xs", xs, (w,)), ("ys", ys, (h,))):
        _check(f"group_coords_cuda {name}", a, torch.float32, shape)
    tx_out, ty_out = torch.empty_like(tx), torch.empty_like(ty)
    plan = _plan("coords", ks, [tx, ty, tx_out, ty_out], route)
    if plan.route == "single":
        _single("coords", plan, [tx, ty], [tx_out, ty_out], xs, ys, ks,
                metric, (1.0, 1.0))
    else:
        arr, n = _strides(ks)
        with torch.cuda.device(tx.device):
            err = _cuda.library().jfa_group_coords(
                tx.data_ptr(), ty.data_ptr(), tx_out.data_ptr(),
                ty_out.data_ptr(), xs.data_ptr(), ys.data_ptr(), h, w, arr,
                n, plan.tile, plan.shared_bytes, int(metric),
                _cuda.stream_of(tx.device))
        _cuda.check(err, "jfa_group_coords")
    _count(plan.route)
    return tx_out, ty_out
