"""Percentiles of a raster's finite values, as ``jnp.nanpercentile``.

Counterpart of ``xrspatial_tpu/kernels/selection.py``.  The JAX module
finds the order statistics by a radix select, because a device sort was
slow on the TPU; this one sorts with ``torch.sort`` (``torch.quantile``
and ``torch.nanquantile`` refuse inputs above 2^24 elements, and a 16384^2
raster has 2^28).

The interpolation is ``jnp.nanpercentile``'s as XLA evaluates it, which
is not quite its source: XLA turns ``(q / 100) * (counts - 1)`` into
``q * ((counts - 1) * 0.01)``, with 0.01 rounded to float32, and fuses
``low * low_weight + high * high_weight`` into one multiply-add,
``fma(high, high_weight, low * low_weight)``.  Both are copied here (the
multiply-add in float64, rounded once to float32), so the percentiles
equal the JAX package's bit for bit.  The count of finite values is exact
in int64 and converted once to float32, and the ranks are clamped to
``n_finite - 1`` in integers, the JAX module's clamp, so q = 100 selects
the largest finite value above 2^24 elements too, where the float32
``counts - 1`` rounds up.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["nanpercentile"]

_ONE_HUNDREDTH = float(np.float32(0.01))


def nanpercentile(v: torch.Tensor, q100) -> torch.Tensor:
    """``jnp.nanpercentile(v, q100)`` for a flat float32 tensor `v` whose
    non-finite values are NaN, at the (P,) percentiles `q100` (numpy,
    float32); a (P,) float32 tensor on `v`'s device."""
    counts_i = torch.isfinite(v).sum()
    counts = counts_i.to(torch.float32)
    q = torch.from_numpy(np.asarray(q100, dtype=np.float32)).to(v.device)
    t = q * ((counts - 1.0) * _ONE_HUNDREDTH)
    low = torch.floor(t)
    high = torch.ceil(t)
    high_weight = t - low
    low_weight = 1.0 - high_weight
    low = torch.clamp_min(torch.minimum(low, counts - 1.0), 0.0)
    high = torch.clamp_min(torch.minimum(high, counts - 1.0), 0.0)
    ranks = torch.cat([low, high]).to(torch.int64)
    ranks = torch.minimum(ranks, (counts_i - 1).clamp_min(0))
    # NaN sorts last: the first counts_i values are the finite ones
    values = torch.sort(v).values[ranks]
    p = q.shape[0]
    low_term = (values[:p] * low_weight).double()
    res = (values[p:].double() * high_weight.double() + low_term).float()
    return torch.where(counts > 0, res, math.nan)
