"""Decorators for transparent Dataset support on DataArray functions.

Counterpart of ``xrspatial_tpu/dataset_support.py``: ``supports_dataset``
maps a function over a Dataset's variables, ``supports_dataset_bands``
maps band-alias keywords to Dataset variables
(``ndvi(ds, nir='B8', red='B4')``).
"""

from __future__ import annotations

import functools
import inspect

from .xrlib import Dataset

__all__ = ["supports_dataset", "supports_dataset_bands"]


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


def supports_dataset_bands(**band_param_map):
    """Let a multi-band function accept one Dataset plus band-alias kwargs.

    ``@supports_dataset_bands(nir='nir_agg', red='red_agg')`` enables
    ``ndvi(ds, nir='band_8', red='band_4')`` in place of
    ``ndvi(ds['band_8'], ds['band_4'])``.
    """

    def decorator(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            if args and isinstance(args[0], Dataset):
                ds = args[0]
                call_kwargs = {}
                for alias, param in band_param_map.items():
                    if alias not in kwargs:
                        raise TypeError(
                            f"'{alias}' keyword required when passing a "
                            f"Dataset")
                    var = kwargs[alias]
                    if var not in ds.data_vars:
                        raise ValueError(
                            f"'{var}' not in Dataset. "
                            f"Available: {list(ds.data_vars)}")
                    call_kwargs[param] = ds[var]
                for k, v in kwargs.items():
                    if k not in band_param_map:
                        call_kwargs[k] = v
                return func(**call_kwargs)
            return func(*args, **kwargs)

        return wrapper

    return decorator
