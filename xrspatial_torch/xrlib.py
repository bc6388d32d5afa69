"""Canonical DataArray/Dataset implementation used across the package.

Counterpart of ``xrspatial_tpu/xrlib.py``, which prefers real xarray when
it is importable.  Here the torch-backed shim in
:mod:`xrspatial_torch.xr_compat` is used unconditionally: real xarray
cannot hold a CUDA tensor without copying it to the host.
"""

from .xr_compat import DataArray, Dataset, concat

__all__ = ["DataArray", "Dataset", "concat"]
