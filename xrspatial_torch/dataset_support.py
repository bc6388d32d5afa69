"""Decorator for transparent Dataset support on DataArray functions.

Counterpart of ``xrspatial_tpu/dataset_support.py``.  The band-alias
decorator ``supports_dataset_bands`` waits for the multispectral port
(ROADMAP A5).
"""

from __future__ import annotations

import functools
import inspect

from .xrlib import Dataset

__all__ = ["supports_dataset"]


def supports_dataset(func):
    """Let a single-DataArray function transparently accept a Dataset.

    When a Dataset is the first argument, the function is applied to each
    data variable (with ``name=<variable>`` if the function accepts ``name``)
    and the results are collected into a new Dataset carrying the input's
    attrs.
    """
    accepts_name = "name" in inspect.signature(func).parameters

    @functools.wraps(func)
    def wrapper(agg, *args, **kwargs):
        if isinstance(agg, Dataset):
            out = {}
            for var in agg.data_vars:
                kw = dict(kwargs)
                if accepts_name:
                    kw["name"] = var
                out[var] = func(agg[var], *args, **kw)
            return Dataset(out, attrs=dict(agg.attrs))
        return func(agg, *args, **kwargs)

    return wrapper
