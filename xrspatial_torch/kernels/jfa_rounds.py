"""One jump-flood round: the torch twins of the CUDA round kernel.

Counterpart of the round semantics of ``xrspatial_tpu/kernels/jfa.py::
_jfa_rounds`` (the XLA rounds the JAX package runs off the TPU) and of the
packed key of ``xrspatial_tpu/kernels/pallas_jfa.py::_key_packed``.  These
are the plain versions of ``csrc/jfa.cu`` (wrapper ``cuda_jfa.py``); the
tests and ``chip_smoke.py`` call them by name, and ``jfa.jump_flood`` calls
them for a tensor on the CPU only.

A round at stride ``k``:
- every cell starts from its own round-start target and that target's key;
- it then visits the 8 candidates at ``(i + sy*k, j + sx*k)`` in ``(sy,
  sx)`` row-major order over ``{-1, 0, 1}^2``, skipping the centre, and
  adopts a candidate whose key is strictly smaller (``<``) than the best so
  far.  That order decides every tie;
- candidates are read from the round-start state, never from cells already
  updated in the same round;
- an out-of-bounds candidate is infinitely far (the JAX package's
  inf-filled shifts), so it is never adopted.

Two state forms:
- packed: int32 ``iy << 15 | ix`` of the target (-1 for none), for exactly
  affine coordinate axes (``jfa.packed_state_plan``); the key is built from
  index deltas times the axis steps, bit-equal to the coordinate key;
- coordinates: float32 target ``tx``, ``ty`` (inf for none) with 1-D ``xs``
  (w,) and ``ys`` (h,), for any axes and for great-circle distance.
Either carries an optional float32 value channel (allocation).
"""

from __future__ import annotations

import math

import torch

__all__ = ["key_packed", "metric_key", "coords_key", "shifted",
           "round_packed", "round_coords", "PACK_BITS", "PACK_MASK",
           "CANDIDATES"]

EUCLIDEAN, GREAT_CIRCLE, MANHATTAN = 0, 1, 2

PACK_BITS = 15            # iy << 15 | ix; dims <= 32768 (packed_state_plan)
PACK_MASK = (1 << PACK_BITS) - 1
DEG2RAD = math.pi / 180.0  # rounded to float32 where it meets a tensor

# the 8 candidate offsets in the order that decides ties
CANDIDATES = tuple((sy, sx) for sy in (-1, 0, 1) for sx in (-1, 0, 1)
                   if (sy, sx) != (0, 0))


def metric_key(x1, x2, y1, y2, metric: int) -> torch.Tensor:
    """Monotone float32 comparison key of the distance between (x1, y1)
    and (x2, y2), the JAX package's ``jfa._metric_key``: squared distance
    for EUCLIDEAN, the haversine term for GREAT_CIRCLE, the distance
    itself for MANHATTAN."""
    if metric == GREAT_CIRCLE:
        # subtract in degrees, then convert (see jfa.metric_distance)
        dlat_h = (y2 - y1) * DEG2RAD * 0.5
        dlon_h = (x2 - x1) * DEG2RAD * 0.5
        slat = torch.sin(dlat_h)
        slon = torch.sin(dlon_h)
        a = (slat * slat + torch.cos(y1 * DEG2RAD) * torch.cos(y2 * DEG2RAD)
             * (slon * slon))
        same = (x1 == x2) & (y1 == y2)
        return torch.where(same, 0.0, a)
    dx = x1 - x2
    dy = y1 - y2
    if metric == MANHATTAN:
        return dx.abs() + dy.abs()
    return dx * dx + dy * dy


def key_packed(piy, pix, cand, metric: int, steps) -> torch.Tensor:
    """Key of the packed candidate `cand` (int32 ``iy << 15 | ix``, or -1)
    seen from the cells at int32 indices (`piy`, `pix`); `steps` is
    (step_y, step_x).  inf for the -1 sentinel."""
    sy, sx = steps
    ciy = cand >> PACK_BITS          # arithmetic shift: -1 stays -1
    cix = cand & PACK_MASK
    dy = (piy - ciy).to(torch.float32) * sy
    dx = (pix - cix).to(torch.float32) * sx
    if metric == MANHATTAN:
        d = dx.abs() + dy.abs()
    else:
        d = dx * dx + dy * dy
    return torch.where(cand >= 0, d, math.inf)


def coords_key(px, py, tx, ty, metric: int) -> torch.Tensor:
    """Key of the target (`tx`, `ty`) seen from (`px`, `py`); inf where
    `tx` is not finite (no target, or out of bounds)."""
    d = metric_key(px, tx, py, ty, metric)
    return torch.where(torch.isfinite(tx), d, math.inf)


def shifted(a: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """``out[i, j] = a[i + dy, j + dx]``, and `fill` outside `a`."""
    h, w = a.shape
    out = torch.full_like(a, fill)
    if abs(dy) < h and abs(dx) < w:
        out[max(-dy, 0):h - max(dy, 0), max(-dx, 0):w - max(dx, 0)] = \
            a[max(dy, 0):h - max(-dy, 0), max(dx, 0):w - max(-dx, 0)]
    return out


def round_packed(state, value, k: int, metric: int, steps, origin=(0, 0)):
    """One round over the packed state.

    `state` is (h, w) int32, `value` (h, w) float32 or None, `steps`
    (step_y, step_x), `origin` the (row, column) in the whole raster of
    the state's cell (0, 0) (a block of a mesh has its own).  Returns
    ``(state, value, best)``: the new state and value and the float32 key
    of each cell's new target.
    """
    h, w = state.shape
    iy = origin[0] + torch.arange(h, dtype=torch.int32,
                                  device=state.device)[:, None]
    ix = origin[1] + torch.arange(w, dtype=torch.int32,
                                  device=state.device)[None, :]
    best = key_packed(iy, ix, state, metric, steps)
    s_out, v_out = state, value
    for sy, sx in CANDIDATES:
        cand = shifted(state, sy * k, sx * k, -1)
        nd = key_packed(iy, ix, cand, metric, steps)
        better = nd < best
        s_out = torch.where(better, cand, s_out)
        if value is not None:
            v_out = torch.where(better, shifted(value, sy * k, sx * k, 0.0),
                                v_out)
        best = torch.where(better, nd, best)
    return s_out, v_out, best


def round_coords(tx, ty, value, xs, ys, k: int, metric: int):
    """One round over the coordinate state.

    `tx`, `ty` are (h, w) float32 target coordinates (inf for none),
    `value` (h, w) float32 or None, `xs` (w,) and `ys` (h,) the float32
    coordinates of the cells.  Returns ``(tx, ty, value)``.
    """
    px = xs[None, :]
    py = ys[:, None]
    best = coords_key(px, py, tx, ty, metric)
    tx_out, ty_out, v_out = tx, ty, value
    for sy, sx in CANDIDATES:
        ctx = shifted(tx, sy * k, sx * k, math.inf)
        cty = shifted(ty, sy * k, sx * k, math.inf)
        nd = coords_key(px, py, ctx, cty, metric)
        better = nd < best
        tx_out = torch.where(better, ctx, tx_out)
        ty_out = torch.where(better, cty, ty_out)
        if value is not None:
            v_out = torch.where(better, shifted(value, sy * k, sx * k, 0.0),
                                v_out)
        best = torch.where(better, nd, best)
    return tx_out, ty_out, v_out
