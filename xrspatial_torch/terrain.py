"""Pseudo-random terrain synthesis (16-octave perlin fBm).

Counterpart of ``xrspatial_tpu/terrain.py``: the octave loop, the water
cutoff and the zfactor scaling, with the datashader Canvas pixel-centre
coordinates.  Each octave's hash lattice is built on the host
(``perlin.octave_tables``); the 16 octaves' tables, indices and fractions
travel as three flat arrays (``pack_octaves``), kept resident on the
device per (seed, shape, ranges, device), and each octave is expanded and
accumulated as torch ops on the raster's device (``perlin.octave_eval``).

Bits: as in ``perlin.py``, the port copies what XLA on the CPU computes;
here also ``acc / 1.97``, which XLA evaluates as ``acc * float32(1 /
1.97)``.  The cube is ``d * d * d`` and the normalisation a true
division, as written.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from .perlin import normalize, octave_eval, octave_tables
from .utils import raster_device
from .xrlib import DataArray

__all__ = ["generate_terrain"]

# sum of the first 6 octave weights, as hard-coded by the reference:
# 1.00+0.50+0.25+0.13+0.06+0.03
_OCTAVE_NORM = 1.97
_INV_OCTAVE_NORM = float(np.float32(1.0 / _OCTAVE_NORM))
_N_OCTAVES = 16


def _scale(value, old_range, new_range):
    d = (value - old_range[0]) / (old_range[1] - old_range[0])
    return d * (new_range[1] - new_range[0]) + new_range[0]


def pack_octaves(octaves):
    """Concatenate per-octave (packed, ix, iy, xf, yf) tuples into three
    flat arrays (uint8 tables, int32 indices, float32 fractions) plus a
    carve plan of static ints, one entry an octave."""
    tables, idx, frac, plan = [], [], [], []
    t_off = i_off = f_off = 0
    for packed, ix, iy, xf, yf in octaves:
        nyi, nxi = packed.shape
        h, w = iy.shape[0], ix.shape[0]
        plan.append((t_off, nyi, nxi, i_off, w, h, f_off))
        tables.append(packed.ravel())
        idx.append(ix)
        idx.append(iy)
        frac.append(xf)
        frac.append(yf)
        t_off += nyi * nxi
        i_off += w + h
        f_off += w + h
    return (np.concatenate(tables), np.concatenate(idx),
            np.concatenate(frac), tuple(plan))


def carve_octave(tables, idx, frac, entry):
    """Slice one octave's fields out of the packed arrays (views)."""
    t_off, nyi, nxi, i_off, w, h, f_off = entry
    packed = tables[t_off:t_off + nyi * nxi].reshape(nyi, nxi)
    ix = idx[i_off:i_off + w]
    iy = idx[i_off + w:i_off + w + h]
    xf = frac[f_off:f_off + w]
    yf = frac[f_off + w:f_off + w + h]
    return packed, ix, iy, xf, yf


def terrain_tables(seed, height, width, x_scaled, y_scaled):
    """The 16 octaves' host-hashed lattices, packed (numpy).

    float32 linspace then float64 promotion, as the JAX package: x * freq
    is exact in float64 (freq is a power of two)."""
    linx = np.linspace(x_scaled[0], x_scaled[1], width, endpoint=False,
                       dtype=np.float32).astype(np.float64)
    liny = np.linspace(y_scaled[0], y_scaled[1], height, endpoint=False,
                       dtype=np.float32).astype(np.float64)
    octaves = []
    for i in range(_N_OCTAVES):
        freq = float(2 ** i)
        octaves.append(octave_tables(seed + i, linx * freq, liny * freq))
    return pack_octaves(octaves)


@lru_cache(maxsize=4)
def _transport(seed, height, width, x_scaled, y_scaled, device):
    """The packed tables resident on `device`, memoised per (seed, shape,
    scaled ranges, device): synthesis is deterministic in these, and a
    repeated call skips the host hashing and the upload."""
    tables, idx, frac, plan = terrain_tables(seed, height, width, x_scaled,
                                             y_scaled)
    return (torch.from_numpy(tables).to(device),
            torch.from_numpy(idx).to(device),
            torch.from_numpy(frac).to(device), plan)


def generate_terrain(agg: DataArray,
                     x_range: tuple = (0, 500),
                     y_range: tuple = (0, 500),
                     seed: int = 10,
                     zfactor: int = 4000,
                     full_extent: Optional[Union[Tuple, List]] = None,
                     name: str = 'terrain') -> DataArray:
    """Generate pseudo-random terrain (helpful for testing raster functions).

    Parameters
    ----------
    agg : DataArray
        2D array whose shape determines the output size; the output lies
        on its tensor's device (a numpy payload: the default device).
    x_range, y_range : tuple
        Coordinate ranges of the output.
    seed : int, default=10
    zfactor : int, default=4000
        Multiplier for elevation values.
    full_extent : (xmin, ymin, xmax, ymax), optional
        Full extent of the coordinate system; noise-space coordinates are
        scaled relative to it.
    """
    height, width = agg.shape

    if full_extent is None:
        full_extent = (x_range[0], y_range[0], x_range[1], y_range[1])
    elif not isinstance(full_extent, (list, tuple)) or len(full_extent) != 4:
        raise TypeError('full_extent must be tuple(4)')

    full_xrange = (full_extent[0], full_extent[2])
    full_yrange = (full_extent[1], full_extent[3])
    x_scaled = (_scale(x_range[0], full_xrange, (0.0, 1.0)),
                _scale(x_range[1], full_xrange, (0.0, 1.0)))
    y_scaled = (_scale(y_range[0], full_yrange, (0.0, 1.0)),
                _scale(y_range[1], full_yrange, (0.0, 1.0)))

    tables, idx, frac, plan = _transport(
        seed, height, width, (float(x_scaled[0]), float(x_scaled[1])),
        (float(y_scaled[0]), float(y_scaled[1])), raster_device(agg))
    acc = None
    for i, entry in enumerate(plan):
        val = octave_eval(*carve_octave(tables, idx, frac, entry))
        val.mul_(1.0 / float(2 ** i))
        acc = val if acc is None else acc.add_(val)
        del val
    data = acc.mul_(_INV_OCTAVE_NORM)
    data = normalize(data * data * data)
    data = torch.where(data < 0.3, 0.0, data)  # water cutoff
    out = data.mul_(float(np.float32(zfactor)))

    # datashader Canvas pixel-center coordinate convention
    dx = (x_range[1] - x_range[0]) / width
    dy = (y_range[1] - y_range[0]) / height
    xs = x_range[0] + dx * (np.arange(width) + 0.5)
    ys = y_range[0] + dy * (np.arange(height) + 0.5)

    return DataArray(out, name=name, dims=['y', 'x'],
                     coords={'y': ys, 'x': xs},
                     attrs={'res': (dx, dy)})
