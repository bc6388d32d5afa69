"""Local (cell-by-cell, across-variables) toolset over Datasets.

Counterpart of ``xrspatial_tpu/local.py``: every function reduces a
stacked (V, H, W) float32 cube along the variable axis with torch ops on
the variables' device; ``combine`` stays host numpy, as in the JAX
package.  Semantics kept, quirks included: NaN in any data variable makes
the output cell NaN, but a NaN in the reference variable of the frequency
tools counts nothing; positions are 1-indexed with first-occurrence ties;
``popularity`` indexes the sorted unique values and is NaN where all
values are distinct; negative reference indices wrap; outputs are bare
DataArrays without coords.

Where torch's defaults differ from jnp's, the jnp semantics are spelled
out: ``median`` averages the two middle values of an even count
(``torch.median`` takes the lower), ``std`` is the population std
(``torch.std`` is unbiased), a mean is a sum divided by the count (as
XLA's, on every device), and the reference variable converts to int32 as
XLA converts (NaN to 0, out-of-range values saturated).
"""

from __future__ import annotations

import numpy as np
import torch

from .utils import host_copy, payload_mesh, per_block, raster_device, \
    to_torch
from .xrlib import DataArray, Dataset

__all__ = ["cell_stats", "combine", "lesser_frequency", "equal_frequency",
           "greater_frequency", "lowest_position", "highest_position",
           "popularity", "rank"]

_FUNCS = ("max", "mean", "median", "min", "std", "sum")
_INT32_MIN, _INT32_MAX = -2 ** 31, 2 ** 31 - 1


def _validate(raster, data_vars, ref_var=None):
    if not isinstance(raster, Dataset):
        raise TypeError(
            "Expected raster to be a 'xarray.Dataset'. "
            f"Received '{type(raster).__name__}' instead.")
    if ref_var is not None:
        if not isinstance(ref_var, str):
            raise TypeError(
                "Expected ref_var to be a 'str'. "
                f"Received '{type(ref_var).__name__}' instead.")
        if ref_var not in list(raster.data_vars):
            raise ValueError('raster must contain ref_var.')
    if data_vars:
        if (not isinstance(data_vars, list)
                or not all(isinstance(v, str) for v in data_vars)):
            raise TypeError('Expected data_vars to be a list of string.')
        if not set(data_vars).issubset(set(raster.data_vars)):
            raise ValueError(
                "raster must contain all the variables of data_vars. "
                f"The variables available are '{list(raster.data_vars)}'.")
        if ref_var is not None and ref_var in data_vars:
            raise ValueError('ref_var must not be an element of data_vars.')
    else:
        data_vars = list(raster.data_vars)
        if ref_var is not None:
            data_vars.remove(ref_var)
    return data_vars


def _per_cell(raster, data_vars, body, ref_var=None):
    """``body(cube)`` of the (V, H, W) stack of `data_vars`, or ``body(cube,
    ref)`` with the `ref_var` raster: on one device, or on each block
    where the variables are split over a mesh (every variable on that
    mesh; a raster of the tiles)."""
    names = list(data_vars) + ([ref_var] if ref_var is not None else [])

    def cell(*bs):
        cube = torch.stack(bs[:len(data_vars)], dim=0)
        if ref_var is None:
            return body(cube)
        return body(cube, bs[-1].to(cube.device))
    return per_block(cell, *(raster[v] for v in names))


def _nan_any(cube):
    return torch.isnan(cube).any(dim=0)


def _median(cube):
    """jnp.median along axis 0: the mean of the two middle values
    ((lo + hi) * 0.5), NaN where the column holds a NaN."""
    v = cube.shape[0]
    s = torch.sort(cube, dim=0).values
    mid = (s[(v - 1) // 2] + s[v // 2]) * 0.5
    return torch.where(_nan_any(cube), torch.nan, mid)


def _sum0(cube):
    """The sum along axis 0, the variables added one after another: the
    same bits for a block as for the whole raster (a reduction kernel on
    the card may order its adds by the tensor's shape)."""
    acc = cube[0]
    for k in range(1, cube.shape[0]):
        acc = acc + cube[k]
    return acc


def _std(cube):
    """jnp.std along axis 0 (ddof 0): the root of the mean squared
    deviation from the mean."""
    v = cube.shape[0]
    d = cube - _sum0(cube) / v
    return torch.sqrt(_sum0(d * d) / v)


def cell_stats(raster: Dataset, data_vars=None, func: str = 'sum'):
    """Per-cell statistic across Dataset variables
    (max/mean/median/min/std/sum)."""
    if not isinstance(raster, Dataset):
        raise TypeError(
            "Expected raster to be a 'xarray.Dataset'. "
            f"Received '{type(raster).__name__}' instead.")
    if func not in _FUNCS:
        raise ValueError(
            f'{func} is not supported. '
            f"The supported types are '{list(_FUNCS)}'.")
    data_vars = _validate(raster, data_vars)
    out = _per_cell(raster, data_vars, {
        'max': lambda c: torch.amax(c, dim=0),
        'mean': lambda c: _sum0(c) / c.shape[0],
        'median': _median,
        'min': lambda c: torch.amin(c, dim=0),
        'std': _std,
        'sum': _sum0,
    }[func])
    return DataArray(out)


def combine(raster: Dataset, data_vars=None):
    """Assign one output id per unique combination of variable values.

    Ids are 1..n in first-occurrence scan order; any-NaN cells are NaN.
    The id -> combination mapping is stored in ``attrs['key']``.  The ids
    are found on the host with ``np.unique``, as in the JAX package (a
    Dataset split over a mesh is gathered to the host, with a warning);
    the float64 result goes to the first variable's device (its first
    block's).
    """
    data_vars = _validate(raster, data_vars)
    mesh = payload_mesh(*(raster[v] for v in data_vars))
    cube = np.stack([host_copy(raster[v], "combine") for v in data_vars],
                    axis=0)
    v, h, w = cube.shape
    rows = cube.reshape(v, -1).T  # (H*W, V)
    nan_mask = np.isnan(rows).any(axis=1)

    out = np.full(rows.shape[0], np.nan)
    unique_values = {}
    clean = rows[~nan_mask]
    if clean.shape[0]:
        _, first_idx, inverse = np.unique(clean, axis=0, return_index=True,
                                          return_inverse=True)
        # renumber so ids follow first-occurrence order
        order = np.argsort(np.argsort(first_idx))
        out[~nan_mask] = order[inverse.ravel()] + 1
        for i, row in enumerate(clean[np.sort(first_idx)]):
            unique_values[i + 1] = tuple(row.tolist())
    first = raster[data_vars[0]].data
    device = (raster_device(first) if mesh is not None
              or isinstance(first, torch.Tensor) else None)
    final = DataArray(to_torch(out.reshape(h, w), dtype=torch.float64,
                               device=device))
    final.attrs['key'] = unique_values
    return final


def _frequency(raster, ref_var, data_vars, op):
    data_vars = _validate(raster, data_vars, ref_var)

    def body(cube, ref):
        count = op(ref[None], cube).sum(dim=0).to(cube.dtype)
        return torch.where(_nan_any(cube), torch.nan, count)
    return DataArray(_per_cell(raster, data_vars, body, ref_var))


def lesser_frequency(raster: Dataset, ref_var: str, data_vars=None):
    """Count of variables whose value is less than the reference."""
    return _frequency(raster, ref_var, data_vars, lambda r, c: r > c)


def equal_frequency(raster: Dataset, ref_var: str, data_vars=None):
    """Count of variables whose value equals the reference."""
    return _frequency(raster, ref_var, data_vars, lambda r, c: r == c)


def greater_frequency(raster: Dataset, ref_var: str, data_vars=None):
    """Count of variables whose value is greater than the reference."""
    return _frequency(raster, ref_var, data_vars, lambda r, c: r < c)


def _position(raster, data_vars, arg_fn):
    data_vars = _validate(raster, data_vars)

    def body(cube):
        pos = (arg_fn(cube, dim=0) + 1).to(cube.dtype)
        return torch.where(_nan_any(cube), torch.nan, pos)
    return DataArray(_per_cell(raster, data_vars, body))


def lowest_position(raster: Dataset, data_vars=None):
    """1-indexed variable position of the per-cell minimum (first tie)."""
    return _position(raster, data_vars, torch.argmin)


def highest_position(raster: Dataset, data_vars=None):
    """1-indexed variable position of the per-cell maximum (first tie)."""
    return _position(raster, data_vars, torch.argmax)


def _reference_index(ref):
    """``ref.astype(int32) - 1`` as XLA computes it on the float32
    reference: NaN converts to 0, values beyond int32 saturate, and
    INT32_MIN - 1 wraps to INT32_MAX; held in int64."""
    ref = ref.double()
    idx = torch.nan_to_num(ref, nan=0.0).clamp(_INT32_MIN, _INT32_MAX)
    idx = idx.to(torch.int64) - 1
    return torch.where(idx < _INT32_MIN, _INT32_MAX, idx)


def popularity(raster: Dataset, ref_var: str, data_vars=None):
    """Value selected from each cell's sorted unique values by the
    reference index; NaN when all values are distinct."""
    data_vars = _validate(raster, data_vars, ref_var)
    return DataArray(_per_cell(raster, data_vars, _popularity, ref_var))


def _popularity(cube, ref):
    v = cube.shape[0]
    ref_idx = _reference_index(ref)

    s = torch.sort(cube, dim=0).values
    is_new = torch.cat([torch.ones_like(s[:1], dtype=torch.bool),
                        s[1:] != s[:-1]], dim=0)
    distinct_rank = torch.cumsum(is_new, dim=0) - 1  # (V, H, W)
    n_unique = is_new.sum(dim=0)

    # negative reference indices wrap (python list indexing)
    eff_idx = torch.where(ref_idx < 0, n_unique + ref_idx, ref_idx)
    pick = is_new & (distinct_rank == eff_idx[None])
    picked = _sum0(torch.where(pick, s, 0.0))

    out = torch.where(n_unique == 1, s[0], picked)
    out = torch.where((ref_idx >= n_unique) & (n_unique != 1), torch.nan,
                      out)
    return torch.where(_nan_any(cube) | (n_unique >= v), torch.nan, out)


def rank(raster: Dataset, ref_var: str, data_vars=None):
    """Per-cell value at the reference's rank in ascending sorted order."""
    data_vars = _validate(raster, data_vars, ref_var)
    return DataArray(_per_cell(raster, data_vars, _rank, ref_var))


def _rank(cube, ref):
    v = cube.shape[0]
    ref_idx = _reference_index(ref)
    s = torch.sort(cube, dim=0).values
    # negative ranks wrap, like python list indexing
    eff_idx = torch.where(ref_idx < 0, v + ref_idx, ref_idx)
    gathered = torch.gather(s, 0, eff_idx.clamp(0, v - 1)[None])[0]
    return torch.where(_nan_any(cube) | (ref_idx >= v) | (eff_idx < 0),
                       torch.nan, gathered)
