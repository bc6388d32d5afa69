"""Masked window reductions: focal statistics, convolution, hotspots.

Counterpart of ``xrspatial_tpu/kernels/window.py``.  ``window_stats`` is
the torch twin of the unrolled shifted-reads pass
(``_window_stats_unrolled``): every footprint cell is one shifted read of
the NaN-padded input, and all requested statistics share the pass.  It is
the plain version of the CUDA kernels in ``cuda_window.py``, which run
whenever the input lies on the card.  Footprints of more than
``UNROLL_MAX_OFFSETS`` cells take ``_window_stats_conv`` instead, on any
device: the JAX package computes that path, the convolution, the 3x3 mean
filter and the hotspot classes in XLA, not Pallas, so here they are plain
torch ops.

Semantics mirrored:
- window cells where kernel != 1 or out of bounds are excluded; every
  output cell is computed (focal ops have no NaN border);
- NaNs are excluded by count; min/max use +-inf sentinels and an extreme
  that stays +-inf becomes NaN (genuine +-inf data too);
- std/var are population (ddof=0) and two-pass;
- convolution has a NaN border of the kernel radius and does not skip NaNs
  inside.

cuDNN convolutions run in full float32 (``_conv2d``), whatever PyTorch's
global TF32 flags say: the JAX package pins ``Precision.HIGHEST`` for the
same reason.
"""

from __future__ import annotations

import contextlib
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["window_stats", "kernel_offsets", "UNROLL_MAX_OFFSETS",
           "tiled_radius_supported", "convolve2d", "focal_mean_pass",
           "hotspots_classify"]

# beyond this many footprint cells the JAX package leaves the unrolled
# shift chain for the conv / reduce-window formulation
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


def tiled_radius_supported(ry: int, rx: int) -> bool:
    """The footprint radii the JAX package sends to its tiled focal kernel
    (``pallas_window2.py::tiled_radius_supported``); beyond them it takes
    the halo-window kernel."""
    return 0 < max(ry, 1) <= 32 and 0 < max(rx, 1) <= 256


@contextlib.contextmanager
def _cudnn_full_fp32():
    """cuDNN convolutions in IEEE float32, no TF32, inside the block; the
    previous setting comes back after it.  Where PyTorch has the per-op
    precision flag, only the convolution flag is set."""
    cudnn = torch.backends.cudnn
    if hasattr(cudnn, "conv") and hasattr(cudnn.conv, "fp32_precision"):
        saved = cudnn.conv.fp32_precision
        cudnn.conv.fp32_precision = "ieee"
        try:
            yield
        finally:
            cudnn.conv.fp32_precision = saved
    else:
        saved = cudnn.allow_tf32
        cudnn.allow_tf32 = False
        try:
            yield
        finally:
            cudnn.allow_tf32 = saved


def _conv2d(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Valid cross-correlation of an (H, W) float32 plane with a (kh, kw)
    weight, as ``lax.conv_general_dilated`` with Precision.HIGHEST."""
    with _cudnn_full_fp32():
        return F.conv2d(x[None, None], weight[None, None])[0, 0]


def _window_stats_conv(data: torch.Tensor, offsets, stats) -> dict:
    """Large-footprint focal statistics without per-offset unrolling.

    sum, count and sum of squares are one convolution each; min/max split
    the footprint mask into contiguous runs of each row, each served by
    one max pool of width L.  std/var use the centred sum of squares
    around the GLOBAL mean ``c`` (``nanmean`` of the raster), as the JAX
    package does: accurate while a window's mean is not far from ``c``.
    """
    data = data.to(torch.float32)
    h, w = data.shape
    mask, ry, rx = _offsets_mask(offsets)
    kf = torch.from_numpy(mask).to(data.device)
    ok = ~torch.isnan(data)   # as the unrolled path: inf participates
    c = torch.nanmean(data)
    v0 = torch.where(ok, data - c, 0.0)

    def conv(x):
        return _conv2d(F.pad(x, (rx, rx, ry, ry)), kf)

    need_sum = any(s in stats for s in ("sum", "mean", "std", "var"))
    need_minmax = any(s in stats for s in ("min", "max", "range"))

    out = {}
    if need_sum:
        cnt = torch.round(conv(ok.to(torch.float32)))  # exact below 2^24
        ssum_c = conv(v0)
        safe = torch.clamp(cnt, min=1.0)
        if "mean" in stats:
            out["mean"] = torch.where(cnt > 0, ssum_c / safe + c, math.nan)
        if "sum" in stats:
            # np.nansum of an all-NaN window is 0.0; cnt*c would be 0*NaN
            out["sum"] = torch.where(cnt > 0, ssum_c + cnt * c, 0.0)
        if "std" in stats or "var" in stats:
            ssq_c = conv(v0 * v0)
            css = torch.clamp(ssq_c - ssum_c * ssum_c / safe, min=0.0)
            var = torch.where(cnt > 0, css / safe, math.nan)
            if "var" in stats:
                out["var"] = var
            if "std" in stats:
                out["std"] = torch.sqrt(var)
    if need_minmax:
        pad = (rx, rx, ry, ry)
        # the min is the negated max of the negated plane (exact)
        pmax = F.pad(torch.where(ok, data, -math.inf), pad, value=-math.inf)
        pneg = F.pad(torch.where(ok, -data, -math.inf), pad, value=-math.inf)
        smax = torch.full((h, w), -math.inf, dtype=torch.float32,
                          device=data.device)
        sneg = torch.full_like(smax, -math.inf)
        for r in range(mask.shape[0]):
            row = mask[r]
            j = 0
            while j < row.shape[0]:
                if row[j] != 1.0:
                    j += 1
                    continue
                j0 = j
                while j < row.shape[0] and row[j] == 1.0:
                    j += 1
                for acc, plane in ((smax, pmax), (sneg, pneg)):
                    run = F.max_pool2d(plane[None, None], (1, j - j0),
                                       stride=1)[0, 0]
                    torch.maximum(acc, run[r:r + h, j0:j0 + w], out=acc)
        smin = -sneg
        smin = torch.where(torch.isinf(smin), math.nan, smin)
        smax = torch.where(torch.isinf(smax), math.nan, smax)
        if "max" in stats:
            out["max"] = smax
        if "min" in stats:
            out["min"] = smin
        if "range" in stats:
            out["range"] = smax - smin
    return out


def _window_stats_unrolled(data: torch.Tensor, offsets, stats) -> dict:
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


def window_stats(data: torch.Tensor, offsets: Tuple[Tuple[int, int], ...],
                 stats: Tuple[str, ...]) -> dict:
    """Focal statistics over a masked window.

    Returns a dict of float32 (H, W) tensors, one per requested stat in
    {mean, max, min, range, std, var, sum}.  Footprints of more than
    ``UNROLL_MAX_OFFSETS`` cells take the convolution / max-pool
    formulation; smaller ones the unrolled shifted-reads pass.
    """
    if len(offsets) > UNROLL_MAX_OFFSETS:
        return _window_stats_conv(data, tuple(offsets), tuple(stats))
    return _window_stats_unrolled(data, tuple(offsets), tuple(stats))


def convolve2d(data: torch.Tensor, kernel) -> torch.Tensor:
    """Cross-correlation (un-flipped kernel) over the full input, with a
    NaN ring of the kernel radius; NaNs inside are not skipped.

    A raster with fewer rows or columns than the kernel has no cell
    inside the ring: the result is all NaN, of the input's shape.  (The
    JAX package pads its empty VALID convolution by the radius, so below
    k - 1 cells a side its result is larger than its input.)
    """
    data = data.to(torch.float32)
    kernel = torch.as_tensor(np.asarray(kernel), dtype=torch.float32,
                             device=data.device)
    if data.shape[0] < kernel.shape[0] or data.shape[1] < kernel.shape[1]:
        return torch.full_like(data, math.nan)
    ry = (kernel.shape[0] - 1) // 2
    rx = (kernel.shape[1] - 1) // 2
    return F.pad(_conv2d(data, kernel), (rx, rx, ry, ry), value=math.nan)


def focal_mean_pass(data: torch.Tensor, excludes) -> torch.Tensor:
    """One pass of the NaN-excluding 3x3 mean, in `data`'s dtype.

    Cells equal to any exclude (NaN-aware equality) keep their value;
    all others become the nanmean of the clipped 3x3 window.
    """
    h, w = data.shape
    padded = F.pad(data, (1, 1, 1, 1), value=math.nan)
    cnt = torch.zeros_like(data)
    ssum = torch.zeros_like(data)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            s = padded[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            ok = ~torch.isnan(s)
            cnt = cnt + ok
            ssum = ssum + torch.where(ok, s, 0.0)
    mean = torch.where(cnt > 0, ssum / torch.clamp(cnt, min=1.0), math.nan)
    excluded = torch.zeros((h, w), dtype=torch.bool, device=data.device)
    for ex in np.asarray(excludes, dtype=np.float64):
        excluded |= torch.isnan(data) if np.isnan(ex) else data == float(ex)
    return torch.where(excluded, data, mean)


def hotspots_classify(z: torch.Tensor) -> torch.Tensor:
    """z-scores -> signed confidence levels {0, +-90, +-95, +-99}, int8."""
    az = z.abs()
    conf = torch.where(az > 2.58, 99,
                       torch.where(az > 1.96, 95,
                                   torch.where(az > 1.65, 90, 0)))
    sign = torch.where(z > 0, 1, torch.where(z < 0, -1, 0))
    return (conf * sign).to(torch.int8)
