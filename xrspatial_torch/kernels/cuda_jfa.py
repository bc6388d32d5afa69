"""Wrapper of the CUDA jump-flood round kernel (``csrc/jfa.cu``).

Replaces ``xrspatial_tpu/kernels/pallas_jfa.py``: the small-stride round
``_multi_round_small``, the tile-jump round ``_large_round`` and their
callers ``jfa_rounds_pallas`` / ``jfa_rounds_packed`` become one round
kernel with the stride as a runtime argument, in two state forms.  Each
round runs on the route ``jfa_plan.round_plan`` names for it ("staged",
"vector" or "simple"; a `route` by name must be one that can run).  Each
wrapper takes only tensors on the card: it builds the kernel library at the
first call, allocates the round's outputs (the kernel reads the round-start
state and writes new buffers, never in place), launches on PyTorch's
current stream and raises if the launch fails.  Their plain versions are
``jfa_rounds.round_packed`` and ``jfa_rounds.round_coords``.
"""

from __future__ import annotations

import ctypes
import functools
import operator

import torch

from . import _cuda
from .jfa_plan import round_plan, state_planes
from .jfa_rounds import EUCLIDEAN, GREAT_CIRCLE, MANHATTAN

__all__ = ["round_packed_cuda", "round_coords_cuda", "LAUNCHES",
           "STAGED_LAUNCHES", "VECTOR_LAUNCHES", "SIMPLE_LAUNCHES"]

# launches of the kernel in this process, for checks that a path ran on it
LAUNCHES = 0             # every route
STAGED_LAUNCHES = 0      # ... the window staged in shared memory
VECTOR_LAUNCHES = 0      # ... 16-byte loads at the 9 positions
SIMPLE_LAUNCHES = 0      # ... the first port

_ROUTE_CODES = {"staged": 0, "vector": 1}
_STAGE_CODES = {"tma": 0, "async": 1, "": 0}


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


def _count(route):
    global LAUNCHES, STAGED_LAUNCHES, VECTOR_LAUNCHES, SIMPLE_LAUNCHES
    LAUNCHES += 1
    if route == "staged":
        STAGED_LAUNCHES += 1
    elif route == "vector":
        VECTOR_LAUNCHES += 1
    else:
        SIMPLE_LAUNCHES += 1


def _plan(form, ins, outs, best, k, route, phased):
    """round_plan for the planes `ins` and `outs` (and `best`)."""
    h, w = ins[0].shape
    ptr = functools.reduce(operator.or_, [
        t.data_ptr() for t in (*ins, *outs, best) if t is not None], 0)
    return round_plan(h, w, k, form, len(ins) > state_planes(form), ptr, route,
                      phased)


def _launch_routed(form, plan, ins, outs, best, xs, ys, k, metric, steps,
                   origin=(0, 0)):
    """One round of `plan` (staged or vector) through jfa_round_routed."""
    h, w = ins[0].shape
    arr = ctypes.c_void_p * 3
    in_ptrs = arr(*[t.data_ptr() for t in ins])
    out_ptrs = arr(*[t.data_ptr() for t in outs])
    lib = _cuda.library()
    with torch.cuda.device(ins[0].device):
        err = lib.jfa_round_routed(
            0 if form == "packed" else 1, in_ptrs, out_ptrs, _ptr(best),
            _ptr(xs), _ptr(ys), h, w, int(k), float(steps[0]),
            float(steps[1]), int(metric), int(len(ins) > state_planes(form)),
            _ROUTE_CODES[plan.route], _STAGE_CODES[plan.stage], plan.tile[0],
            plan.pad, plan.pitch, plan.rows, plan.shared_bytes,
            int(plan.phased), plan.grid, int(origin[0]), int(origin[1]),
            _cuda.stream_of(ins[0].device))
    if err < 0:
        raise RuntimeError(f"jfa_round ({plan.route}): cuTensorMapEncodeTiled "
                           f"failed with CUresult {-err} for a {h}x{w} plane, "
                           f"box {plan.pitch}x{plan.rows}")
    _cuda.check(err, f"jfa_round ({plan.route})")


def round_packed_cuda(state, value, k: int, metric: int, steps,
                      emit_best=False, route=None, phased=None,
                      origin=(0, 0)):
    """One round over the packed int32 state on the card, on the route
    ``round_plan`` names (or `route` by name; `phased` forces the vector
    route's row order).  `origin` is the (row, column) in the whole raster
    of the state's cell (0, 0): a block of a mesh, extended by its halo,
    has its own (``parallel/jfa_sharded.py``); every route takes it.

    Returns ``(state, value, best)`` like ``jfa_rounds.round_packed``;
    `value` is None when none was given, `best` (float32) only with
    `emit_best`, else None.
    """
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
    ins = [state] + ([value] if value is not None else [])
    outs = [s_out] + ([v_out] if v_out is not None else [])
    plan = _plan("packed", ins, outs, best, k, route, phased)
    if plan.route == "simple":
        with torch.cuda.device(state.device):
            err = _cuda.library().jfa_round_packed(
                state.data_ptr(), _ptr(value), s_out.data_ptr(), _ptr(v_out),
                _ptr(best), h, w, int(k), float(steps[0]), float(steps[1]),
                int(metric), int(origin[0]), int(origin[1]),
                _cuda.stream_of(state.device))
        _cuda.check(err, "jfa_round_packed")
    else:
        _launch_routed("packed", plan, ins, outs, best, None, None, k,
                       metric, steps, origin)
    _count(plan.route)
    return s_out, v_out, best


def round_coords_cuda(tx, ty, value, xs, ys, k: int, metric: int,
                      route=None, phased=None):
    """One round over the float32 coordinate state on the card, on the
    route ``round_plan`` names (or `route` by name).

    Returns ``(tx, ty, value)`` like ``jfa_rounds.round_coords``.
    """
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
    ins = [tx, ty] + ([value] if value is not None else [])
    outs = [tx_out, ty_out] + ([v_out] if v_out is not None else [])
    plan = _plan("coords", ins, outs, None, k, route, phased)
    if plan.route == "simple":
        with torch.cuda.device(tx.device):
            err = _cuda.library().jfa_round_coords(
                tx.data_ptr(), ty.data_ptr(), _ptr(value), tx_out.data_ptr(),
                ty_out.data_ptr(), _ptr(v_out), xs.data_ptr(), ys.data_ptr(),
                h, w, int(k), int(metric), _cuda.stream_of(tx.device))
        _cuda.check(err, "jfa_round_coords")
    else:
        _launch_routed("coords", plan, ins, outs, None, xs, ys, k, metric,
                       (1.0, 1.0))
    _count(plan.route)
    return tx_out, ty_out, v_out
