"""Statistics of a run's host records."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile of all `values`: the smallest
    value with at least q% of the values at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


def mean(values) -> float:
    xs = list(values)
    return sum(xs) / len(xs)
