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

__all__ = ["nanpercentile", "nanpercentile_sharded"]

_ONE_HUNDREDTH = float(np.float32(0.01))


def nanpercentile(v: torch.Tensor, q100) -> torch.Tensor:
    """``jnp.nanpercentile(v, q100)`` for a flat float32 tensor `v` whose
    non-finite values are NaN, at the (P,) percentiles `q100` (numpy,
    float32); a (P,) float32 tensor on `v`'s device."""
    # NaN sorts last: the first counts_i values are the finite ones
    return _interpolate(torch.isfinite(v).sum(), q100,
                        lambda ranks: torch.sort(v).values[ranks])


def _key_to_float(key: torch.Tensor) -> torch.Tensor:
    """float32 values of int32 order-preserving keys (the map is its own
    inverse: negative floats have their magnitude bits flipped)."""
    key = key.to(torch.int32)
    return (key ^ ((key >> 31) & 0x7FFFFFFF)).view(torch.float32)


# keys of -inf and +inf: every non-NaN float32 lies between them
_KEY_LO, _KEY_HI = -2139095041, 2139095040


def nanpercentile_sharded(blocks, q100) -> torch.Tensor:
    """``nanpercentile`` of the values of `blocks`, flat float32 tensors
    whose non-finite values are NaN, each on its own device, with no block
    gathered; a (P,) float32 tensor on the first block's device.

    Each block is sorted where it lies (NaN as +inf, at the end).  The
    exact finite count and, for each rank, the counts at or below a
    candidate value are summed over the blocks: a binary search over the
    order-preserving int32 keys of float32 (32 steps, no host sync) finds
    the smallest value whose count passes the rank, which is the order
    statistic itself.  The interpolation is ``nanpercentile``'s, so the
    result equals it on the gathered values bit for bit (but for the sign
    of a zero).
    """
    dev = blocks[0].device
    counts_i = sum(torch.isfinite(b).sum().to(dev) for b in blocks)
    ordered = [torch.sort(torch.nan_to_num(b, nan=math.inf)).values
               for b in blocks]

    def select(ranks):
        need = ranks + 1
        lo = torch.full_like(ranks, _KEY_LO)
        hi = torch.full_like(ranks, _KEY_HI)
        for _ in range(32):          # the key range is below 2^32
            mid = (lo + hi) // 2
            probe = _key_to_float(mid)
            below = sum(torch.searchsorted(o, probe.to(o.device),
                                           right=True).to(dev)
                        for o in ordered)
            take = below >= need
            hi = torch.where(take, mid, hi)
            lo = torch.where(take, lo, mid)
        return _key_to_float(hi)

    return _interpolate(counts_i, q100, select)


def _interpolate(counts_i, q100, select) -> torch.Tensor:
    """``jnp.nanpercentile``'s interpolation as XLA evaluates it, from the
    exact finite count `counts_i` and ``select(ranks)``, the order
    statistics at the int64 `ranks`."""
    counts = counts_i.to(torch.float32)
    q = torch.from_numpy(np.asarray(q100, dtype=np.float32)).to(
        counts_i.device)
    t = q * ((counts - 1.0) * _ONE_HUNDREDTH)
    low = torch.floor(t)
    high = torch.ceil(t)
    high_weight = t - low
    low_weight = 1.0 - high_weight
    low = torch.clamp_min(torch.minimum(low, counts - 1.0), 0.0)
    high = torch.clamp_min(torch.minimum(high, counts - 1.0), 0.0)
    ranks = torch.cat([low, high]).to(torch.int64)
    ranks = torch.minimum(ranks, (counts_i - 1).clamp_min(0))
    values = select(ranks)
    p = q.shape[0]
    low_term = (values[:p] * low_weight).double()
    res = (values[p:].double() * high_weight.double() + low_term).float()
    return torch.where(counts > 0, res, math.nan)
