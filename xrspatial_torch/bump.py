"""Bump map synthesis (random land-feature bumps).

Counterpart of ``xrspatial_tpu/bump.py``.  The bump locations come from
the same legacy NumPy RNG calls (``np.random.choice`` for the columns,
then for the rows), so a seeded run places the JAX package's bumps.  The
sequential accumulation, where each bump's spread reads the centre as the
earlier bumps left it, runs in one launch of the CUDA kernel X2
(``csrc/bump.cu``) on the card and in the torch twin on the CPU
(``kernels/bump.py``), in float64, equal to the JAX package bit for bit.
The map is made on the default device (``default_device()``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .kernels.bump import bump_scan
from .utils import _payload_device
from .xrlib import DataArray

__all__ = ["bump"]


def bump(width: int,
         height: int,
         count: Optional[int] = None,
         height_func=None,
         spread: int = 1) -> DataArray:
    """Generate a simple bump map simulating land features.

    Parameters
    ----------
    width, height : int
        Output size in pixels.
    count : int, optional
        Number of bumps (default ``width * height // 10``).
    height_func : callable, optional
        Maps an (N, 2) array of bump locations to heights.
    spread : int, default=1
        Spread radius in pixels.
    """
    if count is None:
        count = width * height // 10
    if height_func is None:
        height_func = lambda bumps: np.ones(len(bumps))  # noqa: E731

    locs = np.empty((count, 2), dtype=np.uint16)
    locs[:, 0] = np.random.choice(range(width), count)
    locs[:, 1] = np.random.choice(range(height), count)
    heights = np.asarray(height_func(locs), dtype=np.float64)

    dev = _payload_device(None)
    out = torch.zeros((height, width), dtype=torch.float64, device=dev)
    bump_scan(out, torch.from_numpy(locs.astype(np.int32)).to(dev),
              torch.from_numpy(heights).to(dev), max(int(spread), 0))
    return DataArray(out, dims=['y', 'x'], attrs=dict(res=1))
