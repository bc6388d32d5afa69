"""Masked window reductions: focal statistics.

Counterpart of ``xrspatial_tpu/kernels/window.py``.  ``window_stats`` is
the torch twin of the unrolled shifted-reads pass
(``_window_stats_unrolled``): every footprint cell is one shifted read of
the NaN-padded input, and all requested statistics share the pass.  It is
the plain version of the CUDA kernel in ``cuda_window.py``, which runs
whenever the input lies on the card.

Semantics mirrored:
- window cells where kernel != 1 or out of bounds are excluded; every
  output cell is computed (focal ops have no NaN border);
- NaNs are excluded by count; min/max use +-inf sentinels and an extreme
  that stays +-inf becomes NaN (genuine +-inf data too);
- std/var are population (ddof=0) and two-pass.

Footprints of more than ``UNROLL_MAX_OFFSETS`` cells, the convolution and
``_focal_mean_one_pass`` and ``hotspots_classify`` wait for ROADMAP A3.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["window_stats", "kernel_offsets", "UNROLL_MAX_OFFSETS"]

UNROLL_MAX_OFFSETS = 1024


def kernel_offsets(kernel: np.ndarray) -> Tuple[Tuple[int, int], ...]:
    """(dy, dx) offsets (relative to center) of the kernel's 1-cells."""
    kh, kw = kernel.shape
    cy, cx = kh // 2, kw // 2
    offs = [(int(y - cy), int(x - cx))
            for y, x in zip(*np.nonzero(kernel == 1))]
    return tuple(offs)


def _offsets_mask(offsets):
    ry = max(abs(dy) for dy, _ in offsets)
    rx = max(abs(dx) for _, dx in offsets)
    mask = np.zeros((2 * ry + 1, 2 * rx + 1), np.float32)
    for dy, dx in offsets:
        mask[dy + ry, dx + rx] = 1.0
    return mask, ry, rx


def check_offsets(offsets) -> None:
    """Raise for footprints the port does not handle yet."""
    if len(offsets) > UNROLL_MAX_OFFSETS:
        raise NotImplementedError(
            f"focal footprints of more than {UNROLL_MAX_OFFSETS} cells "
            f"(got {len(offsets)}) are not ported to xrspatial_torch yet "
            f"(ROADMAP A3)")


def window_stats(data: torch.Tensor, offsets: Tuple[Tuple[int, int], ...],
                 stats: Tuple[str, ...]) -> dict:
    """Focal statistics over a masked window in one pass of shifted reads.

    Returns a dict of float32 (H, W) tensors, one per requested stat in
    {mean, max, min, range, std, var, sum}.
    """
    check_offsets(offsets)
    data = data.to(torch.float32)
    h, w = data.shape
    _, ry, rx = _offsets_mask(offsets)
    padded = F.pad(data, (rx, rx, ry, ry), value=math.nan)

    def each_shift():
        for dy, dx in offsets:
            yield padded[ry + dy:ry + dy + h, rx + dx:rx + dx + w]

    need_sum = any(s in stats for s in ("sum", "mean", "std", "var"))
    need_minmax = any(s in stats for s in ("min", "max", "range"))

    def full(value):
        return torch.full((h, w), value, dtype=torch.float32,
                          device=data.device)

    if need_sum:
        cnt = full(0.0)
        ssum = full(0.0)
        for s in each_shift():
            ok = ~torch.isnan(s)
            cnt = cnt + ok
            ssum = ssum + torch.where(ok, s, 0.0)
    if need_minmax:
        smin = full(math.inf)
        smax = full(-math.inf)
        for s in each_shift():
            nan_s = torch.isnan(s)
            smin = torch.minimum(smin, torch.where(nan_s, math.inf, s))
            smax = torch.maximum(smax, torch.where(nan_s, -math.inf, s))
        smin = torch.where(torch.isinf(smin), math.nan, smin)
        smax = torch.where(torch.isinf(smax), math.nan, smax)

    out = {}
    if need_sum:
        mean = torch.where(cnt > 0, ssum / torch.clamp(cnt, min=1.0),
                           math.nan)
    if "mean" in stats:
        out["mean"] = mean
    if "sum" in stats:
        # np.nansum of an all-NaN window is 0.0
        out["sum"] = ssum
    if "max" in stats:
        out["max"] = smax
    if "min" in stats:
        out["min"] = smin
    if "range" in stats:
        out["range"] = smax - smin
    if "std" in stats or "var" in stats:
        # two-pass (deviations from the window mean), matching np.nanstd
        dev2 = full(0.0)
        for s in each_shift():
            d = s - mean
            dev2 = dev2 + torch.where(torch.isnan(s), 0.0, d * d)
        var = torch.where(cnt > 0, dev2 / torch.clamp(cnt, min=1.0),
                          math.nan)
        if "var" in stats:
            out["var"] = var
        if "std" in stats:
            out["std"] = torch.sqrt(var)
    return out
