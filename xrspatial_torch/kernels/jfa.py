"""Jump-flood nearest-target transform (proximity / allocation / direction).

Counterpart of ``xrspatial_tpu/kernels/jfa.py``.  Each round every cell
looks at 8 neighbours at the current power-of-two stride and adopts their
nearest target when it is closer under the chosen metric; two extra
stride-2/1 rounds (JFA+2) clean up the classic jump-flood corner cases.
MANHATTAN on monotone axes instead takes the exact separable scan
transform (``manhattan_transform``), in plain torch ops, as the JAX
package leaves it to XLA.

Dispatch (``jump_flood``): a CUDA tensor runs every round on the CUDA
round kernel (``cuda_jfa.py``, ``csrc/jfa.cu``), a CPU tensor on its torch
twins (``jfa_rounds.py``); both take the packed int32 state when
``packed_state_plan`` proves it bit-equal to the coordinate state, and the
coordinate state otherwise.  The JAX package's TPU size gates and its T=256
pad-and-relay tiling have no counterpart: the kernel reads its neighbours
with bounds checks at every size.

On a mesh (`target_mask` a ``ShardedRaster``) the rounds run per block
behind halo exchanges (``parallel/jfa_sharded.py``), the round kernel
taking each block's origin, and MANHATTAN's scans carry across the
blocks.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..tracing import count, span
from . import jfa_rounds
from .jfa_rounds import (EUCLIDEAN, GREAT_CIRCLE, MANHATTAN, PACK_BITS,
                         PACK_MASK, coords_key, metric_key)

__all__ = ["jump_flood", "metric_distance", "manhattan_transform",
           "packed_state_plan", "manhattan_scan_plan", "EUCLIDEAN",
           "GREAT_CIRCLE", "MANHATTAN"]

EARTH_DIAMETER = 6378137.0 * 2.0  # the reference's R = 6378137 m


def metric_distance(x1, x2, y1, y2, metric: int) -> torch.Tensor:
    """Distance between coordinate pairs under the reference's metrics."""
    return _metric_finalize(metric_key(x1, x2, y1, y2, metric), metric)


def _metric_finalize(key, metric: int) -> torch.Tensor:
    """True distance from the comparison key of ``metric_key``."""
    if metric == GREAT_CIRCLE:
        return EARTH_DIAMETER * torch.asin(torch.sqrt(key))
    if metric == MANHATTAN:
        return key
    return torch.sqrt(key)


def _stride_schedule(max_dim: int) -> np.ndarray:
    """Powers of two from below `max_dim` down to 1, then JFA+2's [2, 1]."""
    strides = []
    k = 1
    while k < max_dim:
        k *= 2
    k //= 2
    while k >= 1:
        strides.append(k)
        k //= 2
    strides += [2, 1]
    return np.asarray(strides, dtype=np.int32)


def packed_state_plan(xs_np, ys_np, metric):
    """Host gate for the packed int32 ``iy << 15 | ix`` state.

    The packed keys equal the coordinate keys bit for bit when:
    - each axis is exactly affine as reals: ``coords[i] == c0 + i*step``
      in float64 with the step representable in float32, so one float32
      subtraction of coordinates and one float32 product ``(i-j)*step``
      round the same real;
    - world coordinates reconstruct bitwise in the epilogue:
      ``f32(c0 + f32(i*step)) == coords[i]`` for every i;
    - both dims fit the 15-bit packing, and exceed 1.
    Returns ``((step_y, step_x), (y0, x0))``, or None to keep the
    coordinate state.  GREAT_CIRCLE always returns None: its key needs
    trig of the coordinates, not their deltas.
    """
    if metric == GREAT_CIRCLE:
        return None
    xs_np = np.asarray(xs_np, dtype=np.float32)
    ys_np = np.asarray(ys_np, dtype=np.float32)
    h, w = ys_np.size, xs_np.size
    if not (1 < h <= 32768 and 1 < w <= 32768):
        return None

    def axis_plan(cs):
        n = cs.size
        s64 = (np.float64(cs[-1]) - np.float64(cs[0])) / (n - 1)
        s32 = np.float32(s64)
        if np.float64(s32) != s64 or s64 == 0.0 or not np.isfinite(s64):
            return None
        idx = np.arange(n, dtype=np.float64)
        if not np.array_equal(np.float64(cs),
                              np.float64(cs[0]) + idx * s64):
            return None
        rec = (np.float32(cs[0])
               + (idx.astype(np.float32) * s32)).astype(np.float32)
        if not np.array_equal(rec, cs):
            return None
        return float(s32), float(cs[0])

    py = axis_plan(ys_np)
    px = axis_plan(xs_np)
    if py is None or px is None:
        return None
    return ((py[0], px[0]), (py[1], px[1]))


def manhattan_scan_plan(xs_np, ys_np):
    """Whether the exact Manhattan scan transform applies: it needs
    monotone coordinate axes.  Returns flip_x (True when a descending
    x-axis must be reversed so the min-plus prefix/suffix split sees
    ascending coordinates), or None for a non-monotone axis.  The JAX
    package's TPU-only size gate (a compile-time limit of XLA:TPU) has no
    counterpart here."""
    xs_np = np.asarray(xs_np)
    ys_np = np.asarray(ys_np)
    dxs = np.diff(xs_np)
    dys = np.diff(ys_np)
    mono = ((dxs >= 0).all() or (dxs <= 0).all()) and \
           ((dys >= 0).all() or (dys <= 0).all())
    if not mono:
        return None
    return bool(dxs.size) and bool(dxs[0] < 0)


def _last_valid(valid, reverse: bool):
    """Index along dim 0 of the nearest valid row at or before each row
    (at or after, with `reverse`), clamped into range: the JAX package's
    ``last_valid`` scan, whose value where no row is valid is that of the
    first (last) row, which is not valid either."""
    h = valid.shape[0]
    rows = torch.arange(h, device=valid.device)[:, None]
    if not reverse:
        idx = torch.where(valid, rows, -1)
        return torch.cummax(idx, dim=0).values.clamp(min=0)
    idx = torch.where(valid, rows, h).flip(0)
    return torch.cummin(idx, dim=0).values.flip(0).clamp(max=h - 1)


def _argmin_scan(key, reverse: bool):
    """Prefix (suffix, with `reverse`) minimum of `key` along dim 1 and
    the index that holds it.  Ties go to the index nearest the scan's
    position, as the JAX package's combiner ``b[0] <= a[0]`` decides:
    ``torch.cummin`` keeps the last of equal minima."""
    if not reverse:
        vals, idx = torch.cummin(key, dim=1)
        return vals, idx
    w = key.shape[1]
    vals, idx = torch.cummin(key.flip(1), dim=1)
    return vals.flip(1), (w - 1) - idx.flip(1)


def manhattan_transform(target_mask, xs, ys, values=None, need_coords=True):
    """Exact separable Manhattan nearest-target transform: 4 scans, no
    jump flood.

    |dx| + |dy| decomposes: phase 1 finds each column's nearest target in
    y (the last valid row above and below; the nearer wins, ``<=`` for the
    one above), phase 2 solves ``D(x) = min_j g(j) + |x - x_j|`` as a
    prefix/suffix min-plus: ``left = x + cummin(g - x_j)``, ``right = -x +
    revcummin(g + x_j)``; the left one wins ties.  Needs ascending x
    (``_manhattan_flipped`` reverses a descending axis).  Returns
    ``(dist, tx, ty, tval)`` with inf coordinates where no target exists.
    """
    h, w = target_mask.shape
    xs = xs.to(torch.float32)
    ys = ys.to(torch.float32)
    inf = math.inf
    ty0 = torch.where(target_mask, ys[:, None], inf)
    pay0 = None
    if values is not None:
        pay0 = torch.where(target_mask, values.to(torch.float32), 0.0)

    valid = torch.isfinite(ty0)
    dn_i = _last_valid(valid, reverse=False)
    up_i = _last_valid(valid, reverse=True)
    dn = torch.gather(ty0, 0, dn_i)
    up = torch.gather(ty0, 0, up_i)
    py = ys[:, None]
    gd = torch.where(torch.isfinite(dn), (py - dn).abs(), inf)
    gu = torch.where(torch.isfinite(up), (py - up).abs(), inf)
    use_d = gd <= gu
    g = torch.minimum(gd, gu)
    col_ty = torch.where(use_d, dn, up)
    col_val = None
    if pay0 is not None:
        col_val = torch.where(use_d, torch.gather(pay0, 0, dn_i),
                              torch.gather(pay0, 0, up_i))

    xrow = xs[None, :].expand(h, w)
    kl = torch.where(torch.isfinite(g), g - xrow, inf)
    kr = torch.where(torch.isfinite(g), g + xrow, inf)
    lv, li = _argmin_scan(kl, reverse=False)
    rv, ri = _argmin_scan(kr, reverse=True)
    dl = lv + xrow
    dr = rv - xrow
    lwins = dl <= dr
    dist = torch.where(lwins, dl, dr)
    fin = torch.isfinite(dist)
    if not need_coords and values is None:
        none_tx = torch.where(fin, 0.0, inf)
        return dist, none_tx, none_tx, None

    def pick(plane):
        """The payload `plane` at each cell's winning column."""
        return torch.where(lwins, torch.gather(plane, 1, li),
                           torch.gather(plane, 1, ri))

    if need_coords:
        tx = torch.where(fin, pick(xrow.contiguous()), inf)
        ty = torch.where(fin, pick(col_ty), inf)
    else:
        tx = ty = torch.where(fin, 0.0, inf)
    tval = None
    if values is not None:
        tval = torch.where(fin, pick(col_val), 0.0)
    return dist, tx, ty, tval


def _manhattan_flipped(target_mask, xs, ys, values, need_coords, flip_x):
    """``manhattan_transform`` with a descending x-axis reversed first so
    the min-plus split sees ascending coordinates, and the results
    reversed back."""
    if flip_x:
        target_mask = target_mask.flip(1)
        xs = xs.flip(0)
        if values is not None:
            values = values.flip(1)
    dist, tx, ty, tval = manhattan_transform(
        target_mask, xs, ys, values=values, need_coords=need_coords)
    if flip_x:
        dist, tx, ty = dist.flip(1), tx.flip(1), ty.flip(1)
        tval = None if tval is None else tval.flip(1)
    return dist, tx, ty, tval


def _round_packed(state, value, k, metric, steps, emit_best,
                  origin=(0, 0)):
    if state.device.type == "cpu":
        s, v, best = jfa_rounds.round_packed(state, value, k, metric, steps,
                                             origin)
        return s, v, best if emit_best else None
    from .cuda_jfa import round_packed_cuda
    return round_packed_cuda(state, value, k, metric, steps,
                             emit_best=emit_best, origin=origin)


def _round_coords(tx, ty, value, xs, ys, k, metric):
    if tx.device.type == "cpu":
        return jfa_rounds.round_coords(tx, ty, value, xs, ys, k, metric)
    from .cuda_jfa import round_coords_cuda
    return round_coords_cuda(tx, ty, value, xs, ys, k, metric)


def _jfa_packed(target_mask, values, strides, metric, plan):
    """The stride schedule over the packed state; the full ``jump_flood``
    result.  The last round emits the best key, so no whole-raster key
    recompute follows."""
    steps, (y0, x0) = plan
    h, w = target_mask.shape
    dev = target_mask.device
    with span("torchops.proximity_mask"):
        iy = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
        ix = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
        state = torch.where(target_mask, (iy << PACK_BITS) | ix, -1)
        value = None
        if values is not None:
            value = torch.where(target_mask, values.to(torch.float32), 0.0)
    best = None
    with span("dispatch.jfa"):
        for n, k in enumerate(strides):
            state, value, best = _round_packed(
                state, value, int(k), metric, steps,
                emit_best=n == len(strides) - 1)
    with span("torchops.proximity_epilogue"):
        valid = state >= 0
        tiy = (state >> PACK_BITS).to(torch.float32)
        tix = (state & PACK_MASK).to(torch.float32)
        # bitwise-verified reconstruction (packed_state_plan, condition 2)
        t_x = torch.where(valid, x0 + tix * steps[1], math.inf)
        t_y = torch.where(valid, y0 + tiy * steps[0], math.inf)
        return _metric_finalize(best, metric), t_x, t_y, value


def _jfa_coords(target_mask, values, xs, ys, strides, metric):
    """The stride schedule over the coordinate state; the full
    ``jump_flood`` result."""
    px = xs[None, :]
    py = ys[:, None]
    with span("torchops.proximity_mask"):
        tx = torch.where(target_mask, px, math.inf)
        ty = torch.where(target_mask, py, math.inf)
        value = None
        if values is not None:
            value = torch.where(target_mask, values.to(torch.float32), 0.0)
    with span("dispatch.jfa"):
        for k in strides:
            tx, ty, value = _round_coords(tx, ty, value, xs, ys, int(k),
                                          metric)
    with span("torchops.proximity_epilogue"):
        best = coords_key(px, py, tx, ty, metric)
        return _metric_finalize(best, metric), tx, ty, value


def jump_flood(target_mask, xs, ys, metric: int, values=None,
               need_coords=True, manhattan_plan="auto", packed_plan="auto",
               mesh=None):
    """(distance, target_x, target_y, target_value) per cell.

    `target_mask` is an (h, w) bool tensor, `xs` (w,) and `ys` (h,) the
    cells' coordinates (tensors, or arrays placed on the mask's device).
    target_x/y are the world coordinates of the nearest target (inf where
    no target exists); target_value is `values` at that target (float32,
    None without `values`).  `need_coords=False` lets the Manhattan scan
    path skip its coordinate payload.  `manhattan_plan` / `packed_plan`
    are ``manhattan_scan_plan`` / ``packed_state_plan`` results, or "auto"
    to decide here.

    With a `mesh` (a ``parallel.RasterMesh``; `target_mask` and `values`
    are placed on it unless they are ``ShardedRaster`` s already) the
    rounds run per block (``parallel/jfa_sharded.py``) and the four
    results are ``ShardedRaster`` s over the mesh, equal to the unsharded
    ones.
    """
    if mesh is not None:
        return _jump_flood_mesh(target_mask, xs, ys, metric, values,
                                need_coords, manhattan_plan, packed_plan,
                                mesh)
    h, w = target_mask.shape
    dev = target_mask.device
    xs = torch.as_tensor(xs, device=dev).to(torch.float32)
    ys = torch.as_tensor(ys, device=dev).to(torch.float32)

    if metric == MANHATTAN:
        plan = manhattan_plan
        if plan == "auto":
            count("host.syncs", 2)      # two reads back to the host
            plan = manhattan_scan_plan(xs.cpu().numpy(), ys.cpu().numpy())
        if plan is not None:
            return _manhattan_flipped(target_mask, xs, ys, values,
                                      need_coords, plan)

    strides = _stride_schedule(max(h, w))
    pplan = packed_plan
    if pplan == "auto":
        count("host.syncs", 2)          # two reads back to the host
        pplan = packed_state_plan(xs.cpu().numpy(), ys.cpu().numpy(),
                                  metric)
    if pplan is not None:
        return _jfa_packed(target_mask, values, strides, metric, pplan)
    return _jfa_coords(target_mask, values, xs, ys, strides, metric)


def _host_axis(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        count("host.syncs")             # a read back to the host
        v = v.detach().cpu().numpy()
    return np.ascontiguousarray(v, dtype=np.float32)


def _jump_flood_mesh(target_mask, xs, ys, metric, values, need_coords,
                     manhattan_plan, packed_plan, mesh):
    """``jump_flood``'s mesh branch."""
    from ..parallel.halo import ShardedRaster, distribute
    from ..parallel.jfa_sharded import jump_flood_sharded
    if not isinstance(target_mask, ShardedRaster):
        target_mask = distribute(target_mask, mesh)
    if values is not None and not isinstance(values, ShardedRaster):
        values = distribute(values, mesh)
    h, w = target_mask.shape
    xs_np, ys_np = _host_axis(xs), _host_axis(ys)
    mplan = None
    if metric == MANHATTAN:
        mplan = manhattan_plan
        if mplan == "auto":
            mplan = manhattan_scan_plan(xs_np, ys_np)
    pplan = packed_plan
    if pplan == "auto":
        pplan = packed_state_plan(xs_np, ys_np, metric)
    return jump_flood_sharded(target_mask, values, xs_np, ys_np, metric,
                              _stride_schedule(max(h, w)), pplan, mplan,
                              need_coords)
