"""Classification: binary, reclassify, quantile, natural_breaks (Jenks),
equal_interval, std_mean, head_tail_breaks, percentiles, maximum_breaks,
box_plot.

Counterpart of ``xrspatial_tpu/classify.py``.  Binning and the global
statistics (percentiles, mean, std, min, max) are torch ops on the
raster's device; the break arithmetic, ``maximum_breaks``' unique values
and ``natural_breaks``' fixed-seed sampler (``RandomState(1234567890)``)
are host numpy, copied from the JAX package.  The Jenks dynamic program
runs on the raster's device as a loop over the sorted sample whose step
updates all classes at once: a class's candidates read only rows below
the current one, so the JAX package's sequential loop over classes has
independent iterations.  Its variances are float32 prefix sums, whose
summation order differs from XLA's, so a near-tie may pick another break
than the JAX package's.
"""

from __future__ import annotations

import math
import warnings
from typing import List, Optional

import numpy as np
import torch

from .dataset_support import supports_dataset
from .kernels.selection import nanpercentile, nanpercentile_sharded
from .parallel.halo import get_raster_mesh, tiles
from .tracing import span
from .utils import (blockwise, host_copy, per_block, raster_payload,
                    wrap_like)
from .xr_compat import _to_numpy, nanmax, nanmin, nanvar

__all__ = ["binary", "reclassify", "quantile", "natural_breaks",
           "equal_interval", "std_mean", "head_tail_breaks", "percentiles",
           "maximum_breaks", "box_plot"]


# ---------------------------------------------------------------------------
# core bin
# ---------------------------------------------------------------------------

def _bin(data: torch.Tensor, bins, new_values) -> torch.Tensor:
    """val <= bins[0] -> class 0; bins[i-1] < val <= bins[i] -> class i;
    val > bins[-1] or non-finite -> NaN.

    The class index is the count of bins below the value (the JAX
    package's ``searchsorted(method="compare_all")``), found by a search
    of the bins sorted on the host; bins and values are float32.
    """
    data = data.to(torch.float32)
    bins = np.asarray(bins).astype(np.float32)
    new_values = np.asarray(new_values).astype(np.float32)
    nb = bins.shape[0]
    idx = torch.searchsorted(torch.from_numpy(np.sort(bins)).to(data.device),
                             data, side="left", out_int32=True)
    valid = torch.isfinite(data) & (idx < nb)
    gathered = torch.from_numpy(new_values).to(data.device)[
        idx.clamp_max(nb - 1)]
    return torch.where(valid, gathered, math.nan)


def _finite_or_nan(data: torch.Tensor) -> torch.Tensor:
    data = data.to(torch.float32)
    return torch.where(torch.isinf(data), math.nan, data)


def _nan_raster(data: torch.Tensor) -> torch.Tensor:
    return torch.full(data.shape, math.nan, dtype=torch.float32,
                      device=data.device)


# ---------------------------------------------------------------------------
# binary / reclassify
# ---------------------------------------------------------------------------

@supports_dataset
def binary(agg, values, name='binary'):
    """1 where the cell value is in `values`, 0 otherwise; NaN/inf -> NaN."""
    with span("api.binary"):
        with span("api.args"):
            vals = [float(v) for v in
                    np.asarray(values, dtype=np.float32).ravel()]

        def classes(data):
            with span("torchops.binary"):
                member = torch.zeros(data.shape, dtype=torch.bool,
                                     device=data.device)
                for v in vals:
                    member = member | (data == v)
                return torch.where(torch.isfinite(data),
                                   member.to(torch.float32), math.nan)
        out = per_block(classes, agg)
        with span("api.dataset"):
            return wrap_like(agg, out, name)


@supports_dataset
def reclassify(agg, bins, new_values, name: Optional[str] = 'reclassify'):
    """Classify into `new_values` by user-defined upper-bound `bins`."""
    if len(bins) != len(new_values):
        raise ValueError(
            'bins and new_values mismatch. Should have same length.')
    out = per_block(lambda data: _bin(data, bins, new_values), agg)
    return wrap_like(agg, out, name)


# ---------------------------------------------------------------------------
# quantile / percentiles / equal_interval / std_mean / box_plot
# ---------------------------------------------------------------------------

def _nanpercentile(data: torch.Tensor, p) -> np.ndarray:
    """The percentiles `p` of the finite cells, read to the host; on a
    mesh from per-block sorts and summed counts, no block gathered."""
    p = np.asarray(p, dtype=np.float32)
    if get_raster_mesh(data) is not None:
        return _to_numpy(nanpercentile_sharded(
            [_finite_or_nan(b).reshape(-1) for row in tiles(data).blocks
             for b in row], p))
    return _to_numpy(nanpercentile(_finite_or_nan(data).reshape(-1), p))


def _blocks(data) -> list:
    """The non-empty blocks of a raster split over a mesh, or [data]."""
    if get_raster_mesh(data) is None:
        return [data]
    return [b for row in tiles(data).blocks for b in row if b.numel()]


def _nanmax_finite(data) -> float:
    """The largest finite cell (NaN if none); on a mesh the largest of the
    blocks'."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # all NaN
        return float(np.nanmax([float(nanmax(_finite_or_nan(b)))
                                for b in _blocks(data)]))


def _nanmin_finite(data) -> float:
    """The least finite cell (NaN if none), as ``_nanmax_finite``."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return float(np.nanmin([float(nanmin(_finite_or_nan(b)))
                                for b in _blocks(data)]))


def _mesh_moments(data, mask=None):
    """(count, float64 sum) of the finite cells of a raster split over a
    mesh (those where `mask`, a raster of its tiles, is set), from each
    block's float64 partial sums."""
    cnt, total = 0, 0.0
    for k, b in enumerate(_blocks(data)):
        b = _finite_or_nan(b)
        keep = ~torch.isnan(b) if mask is None else mask[k]
        cnt += int(keep.sum())
        total += float(torch.where(keep, b.double(), 0.0).sum())
    return cnt, total


def _quantile_bins(data, k: int) -> np.ndarray:
    w = 100.0 / k
    p = np.arange(w, 100 + w, w)
    if p[-1] > 100.0:
        p[-1] = 100.0
    return np.unique(_nanpercentile(data, p))


@supports_dataset
def quantile(agg, k: int = 4, name: Optional[str] = 'quantile'):
    """Classify into `k` quantile classes (equal counts per class)."""
    data = raster_payload(agg)
    q = _quantile_bins(data, k)
    if q.shape[0] < k:
        print("Quantile Warning: Not enough unique values "
              "for k classes (using {} bins)".format(q.shape[0]))
        k = q.shape[0]
    out = blockwise(lambda b: _bin(b, q, np.arange(k)), data)
    return wrap_like(agg, out, name)


@supports_dataset
def percentiles(agg, pct: Optional[List] = None,
                name: Optional[str] = 'percentiles'):
    """Classify by explicit percentile breakpoints (default [25,50,75,100])."""
    if pct is None:
        pct = [25, 50, 75, 100]
    for p in pct:
        if not 0 < p <= 100:
            raise ValueError("percentiles must be in (0, 100]")
    data = raster_payload(agg)
    q = np.unique(_nanpercentile(data, np.asarray(pct, dtype=float)))
    out = blockwise(lambda b: _bin(b, q, np.arange(len(q))), data)
    return wrap_like(agg, out, name)


@supports_dataset
def equal_interval(agg, k: int = 5,
                   name: Optional[str] = 'equal_interval'):
    """Classify into `k` classes of equal value-range width (on a mesh
    from the blocks' minima and maxima)."""
    data = raster_payload(agg)
    min_data, max_data = _nanmin_finite(data), _nanmax_finite(data)
    width = (max_data - min_data) / k
    if width == 0 or not np.isfinite(width):
        # constant raster: one class
        cuts = np.array([max_data])
    else:
        cuts = np.arange(min_data + width, max_data + width, width)
        if cuts.shape[0] > k:
            cuts = cuts[0:k]
        cuts[-1] = max_data
    out = blockwise(lambda b: _bin(b, cuts, np.arange(cuts.shape[0])), data)
    return wrap_like(agg, out, name)


@supports_dataset
def std_mean(agg, name: Optional[str] = 'std_mean'):
    """Classify by standard deviations from the mean
    (breaks at mean ± 1σ, ± 2σ, max).  On a mesh the mean and the
    variance come from the blocks' float64 partial sums (two passes)."""
    data = raster_payload(agg)
    if get_raster_mesh(data) is None:
        clean = _finite_or_nan(data)
        m = float(torch.nanmean(clean))
        s = float(torch.sqrt(nanvar(clean)))
    else:
        n, total = _mesh_moments(data)
        m = total / n if n else math.nan
        dev2 = sum(float(torch.where(torch.isnan(c), 0.0,
                                     (c.double() - m) ** 2).sum())
                   for c in map(_finite_or_nan, _blocks(data)))
        s = math.sqrt(dev2 / n) if n else math.nan
    mx = _nanmax_finite(data)
    bins = np.sort(np.unique([m - 2 * s, m - s, m + s, m + 2 * s, mx]))
    out = blockwise(lambda b: _bin(b, bins, np.arange(len(bins))), data)
    return wrap_like(agg, out, name)


@supports_dataset
def box_plot(agg, hinge: float = 1.5, name: Optional[str] = 'box_plot'):
    """Classify by box-plot fences: q1-h*iqr, q1, q2, q3, q3+h*iqr, max."""
    data = raster_payload(agg)
    q1, q2, q3 = (float(v) for v in _nanpercentile(data, [25.0, 50.0, 75.0]))
    if not np.isfinite([q1, q2, q3]).all():
        # all-NaN input: the fences are undefined; all-NaN output
        return wrap_like(agg, blockwise(_nan_raster, data), name)
    max_v = _nanmax_finite(data)
    iqr = q3 - q1
    raw = [q1 - hinge * iqr, q1, q2, q3, q3 + hinge * iqr, max_v]
    bins = np.sort(np.unique(raw))
    bins = bins[bins <= max_v]
    if bins[-1] < max_v:
        bins = np.append(bins, max_v)
    out = blockwise(lambda b: _bin(b, bins, np.arange(len(bins))), data)
    return wrap_like(agg, out, name)


# ---------------------------------------------------------------------------
# head/tail breaks
# ---------------------------------------------------------------------------

@supports_dataset
def head_tail_breaks(agg, name: Optional[str] = 'head_tail_breaks'):
    """Head/Tail Breaks: iteratively split at the mean while the head
    holds <= 40% of the data (heavy-tailed distributions).  On a mesh each
    mean comes from the blocks' float64 partial sums."""
    raw = raster_payload(agg)
    if get_raster_mesh(raw) is not None:
        return wrap_like(agg, _head_tail_mesh(raw), name)
    data = _finite_or_nan(raw)
    mask = torch.isfinite(data)
    bins = []
    total = int(mask.sum())
    while total > 1:
        cnt = mask.sum()
        mean_f = float(torch.where(mask, data, 0.0).sum()
                       / cnt.clamp_min(1))
        bins.append(mean_f)
        new_mask = mask & (data > mean_f)
        head = int(new_mask.sum())
        if head == 0 or head / total > 0.40:
            break
        mask = new_mask
        total = head
    if not bins:
        bins = [float(torch.nanmean(data))]
    bins.append(float(nanmax(data)))
    out = _bin(data, np.array(bins), np.arange(len(bins)))
    return wrap_like(agg, out, name)


def _head_tail_mesh(raw):
    blocks = [_finite_or_nan(b) for b in _blocks(raw)]
    masks = [torch.isfinite(b) for b in blocks]
    bins = []
    total = sum(int(m.sum()) for m in masks)
    while total > 1:
        cnt, ssum = _mesh_moments(raw, masks)
        mean_f = ssum / max(cnt, 1)
        bins.append(mean_f)
        new = [m & (b > mean_f) for m, b in zip(masks, blocks)]
        head = sum(int(m.sum()) for m in new)
        if head == 0 or head / total > 0.40:
            break
        masks, total = new, head
    if not bins:
        cnt, ssum = _mesh_moments(raw)
        bins = [ssum / cnt if cnt else math.nan]
    bins.append(_nanmax_finite(raw))
    return blockwise(lambda b: _bin(_finite_or_nan(b), np.array(bins),
                                    np.arange(len(bins))), raw)


# ---------------------------------------------------------------------------
# maximum breaks
# ---------------------------------------------------------------------------

@supports_dataset
def maximum_breaks(agg, k: int = 5, name: Optional[str] = 'maximum_breaks'):
    """Break at the k-1 largest gaps between sorted unique values (found
    on the host: a raster split over a mesh is gathered, with a warning;
    the classes are binned on its blocks)."""
    data = raster_payload(agg)
    values = host_copy(data, "maximum_breaks").ravel()
    values = values[np.isfinite(values)]
    uv = np.unique(values)
    if uv.size == 0:
        # all-NaN input: all-NaN output
        return wrap_like(agg, blockwise(_nan_raster, data), name)
    if len(uv) < k:
        bins = uv
    else:
        diffs = np.diff(uv)
        n_gaps = min(k - 1, len(diffs))
        top = np.argsort(diffs, kind='stable')[-n_gaps:]
        top.sort()
        bins = np.array([(uv[i] + uv[i + 1]) / 2.0 for i in top])
        bins = np.append(bins, float(uv[-1]))
    out = blockwise(lambda b: _bin(b, bins, np.arange(len(bins))), data)
    return wrap_like(agg, out, name)


# ---------------------------------------------------------------------------
# natural breaks (Jenks)
# ---------------------------------------------------------------------------

def jenks_matrix(data: torch.Tensor, n_classes: int) -> torch.Tensor:
    """Lower-class-limit matrix of the Jenks dynamic program, on `data`'s
    device.

    ``data`` is sorted ascending, float32, length n.  Step l (2..n) takes
    the variance of every window ``data[i:l]`` from float32 prefix sums of
    ``data[l-1], data[l-2], ...`` (the JAX package's reversed cumulative
    sums) and, for every class j >= 2 at once, the row i in [1, l-1] that
    minimises ``var_comb[i, j-1] + variance(data[i:l])``; ``min`` takes the
    first minimum, the smallest i, which is the JAX package's tie to the
    larger m = l-1-i.  Row l of ``var_comb`` is +inf until step l writes
    it, so the JAX package's ``best <= var_comb[l, j]`` always holds (the
    data are finite) and the step writes ``best`` and ``l - m = i + 1``
    unconditionally: 12 launches a step.
    """
    n = data.shape[0]
    kk = n_classes + 1
    dev = data.device
    lcl = torch.zeros((n + 1, kk), dtype=torch.float32, device=dev)
    lcl[1:, 1] = 1.0
    lcl[1, 2:] = 1.0
    var_comb = torch.zeros((n + 1, kk), dtype=torch.float32, device=dev)
    var_comb[2:, 1:] = math.inf
    row = torch.zeros((n + 1, max(kk - 2, 0)), dtype=torch.int64,
                      device=dev)           # i - 1 of step l's best row i
    rev = data.flip(0)
    w = torch.arange(1, n + 1, dtype=torch.float32, device=dev)
    for l in range(2, n + 1):
        t = rev[n - l:]                      # data[l-1], ..., data[0]
        csum = torch.cumsum(t, 0)
        csumsq = torch.cumsum(t * t, 0)
        # variance[m]: the window of the last m+1 values, data[l-1-m:l]
        variance = csumsq - csum * csum / w[:l]
        if kk > 2:
            cand = var_comb[1:l, 1:kk - 1] + variance[:l - 1].flip(0)[:, None]
            torch.min(cand, dim=0, out=(var_comb[l, 2:], row[l]))
        var_comb[l, 1] = variance[l - 1]
    lcl[2:, 2:] = (row[2:] + 2).to(torch.float32)
    return lcl


def _run_jenks(sample_data: np.ndarray, n_classes: int,
               device) -> np.ndarray:
    data = np.sort(sample_data).astype(np.float32)
    lcl = _to_numpy(jenks_matrix(torch.from_numpy(data).to(device),
                                 n_classes))
    k = data.shape[0]
    kclass = np.zeros(n_classes + 1, dtype=np.float32)
    kclass[0] = data[0]
    kclass[-1] = data[-1]
    count_num = n_classes
    while count_num > 1:
        elt = int(lcl[k][count_num] - 2)
        kclass[count_num - 1] = data[elt]
        k = int(lcl[k][count_num] - 1)
        count_num -= 1
    return kclass


def _sample_index(num_data: int, num_sample: Optional[int]):
    """The flat indices of the cells natural_breaks fits on (None: all):
    the reference's fixed-seed linspace + shuffle sampling."""
    if num_sample is None or num_sample >= num_data:
        return None
    generator = np.random.RandomState(1234567890)
    idx = np.linspace(0, num_data, num_data, endpoint=False,
                      dtype=np.uint32)
    generator.shuffle(idx)
    return idx[:num_sample]


def _mesh_sample(data, idx) -> np.ndarray:
    """The cells at flat indices `idx` (None: every cell) of a raster split
    over a mesh, read from their blocks (no block gathered but for the
    cells it holds), as float32 in `idx`'s order."""
    data = tiles(data)
    h, w = data.shape
    if idx is None:
        return np.concatenate([_to_numpy(b.to(torch.float32)).ravel()
                               for b in _blocks(data)])
    rows, cols = idx.astype(np.int64) // w, idx.astype(np.int64) % w
    out = np.empty(idx.shape[0], dtype=np.float32)
    for i, row in enumerate(data.blocks):
        y0, y1 = data.extent(0, i)
        for j, b in enumerate(row):
            x0, x1 = data.extent(1, j)
            at = np.nonzero((rows >= y0) & (rows < y1) & (cols >= x0)
                            & (cols < x1))[0]
            if at.size:
                flat = torch.from_numpy((rows[at] - y0) * (x1 - x0)
                                        + cols[at] - x0).to(b.device)
                out[at] = _to_numpy(b.reshape(-1)[flat].to(torch.float32))
    return out


def _natural_break_bins(sample_data: np.ndarray, k: int, max_data: float,
                        device):
    sample_data = np.asarray(sample_data)
    sample_data = sample_data[np.isfinite(sample_data)]
    uv = np.unique(sample_data)
    uvk = len(uv)

    if uvk < k:
        with warnings.catch_warnings():
            warnings.simplefilter('default')
            warnings.warn('natural_breaks Warning: Not enough unique values '
                          'in data array for {} classes. '
                          'n_samples={} should be >= n_clusters={}. '
                          'Using k={} instead.'.format(k, uvk, k, uvk),
                          Warning)
        uv.sort()
        bins = uv
    else:
        centroids = _run_jenks(sample_data, k, device)
        bins = np.array(centroids[1:])
        bins[-1] = max_data
    return bins, uvk


@supports_dataset
def natural_breaks(agg, num_sample: Optional[int] = 20000,
                   name: Optional[str] = 'natural_breaks', k: int = 5):
    """Jenks natural-breaks classification into `k` classes.

    Fits on a fixed-seed sample of `num_sample` points (the DP is
    O(n^2 k)); the sample is drawn on the host, the DP runs on the
    raster's device (on a mesh: only the sampled cells are read from
    their blocks, the DP runs on the first block's device).
    """
    data = raster_payload(agg)
    max_data = _nanmax_finite(data)
    if not np.isfinite(max_data):
        # no finite values to fit on: every cell is NaN
        return wrap_like(agg, blockwise(_nan_raster, data), name)
    idx = _sample_index(int(np.prod(data.shape)), num_sample)
    if get_raster_mesh(data) is None:
        values = _to_numpy(data).ravel()
        sample = values if idx is None else values[idx]
    else:
        sample = _mesh_sample(data, idx)
    bins, uvk = _natural_break_bins(sample, k, max_data,
                                    _blocks(data)[0].device)
    out = blockwise(lambda b: _bin(b, bins, np.arange(uvk)), data)
    return wrap_like(agg, out, name)
