"""Multispectral band indices and true-color compositing.

Counterpart of ``xrspatial_tpu/multispectral.py``, where each index is one
jitted jnp expression that XLA fuses; here each is a short run of torch
ops on the bands' device.  Semantics kept: float32 compute, NaN where the
denominator is exactly 0, coords/attrs from the same source band as the
JAX package.  Each operation is a separate torch op (no ``alpha=`` forms,
no ``addcmul``), so every product and sum is rounded to float32 apart, on
the card as on the CPU; the float constants are rounded to float32 on the
host first, as the JAX package's ``jnp.float32`` arguments are.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .dataset_support import supports_dataset_bands
from .parallel.halo import ShardedRaster, zip_blocks
from .utils import (mesh_shards, payload_mesh, per_block, to_torch,
                    validate_arrays, wrap_like)
from .xr_compat import nanmax, nanmin
from .xrlib import DataArray

__all__ = ["arvi", "evi", "gci", "nbr", "nbr2", "ndvi", "ndmi", "savi",
           "sipi", "ebbi", "true_color"]


def _f32(value) -> float:
    """`value` rounded to float32 (a Python float holding that value)."""
    return float(np.float32(value))


def _guard(den: torch.Tensor, num: torch.Tensor) -> torch.Tensor:
    """``num / den``, NaN where the denominator is exactly 0."""
    zero = den == 0.0
    return torch.where(zero, math.nan, num / torch.where(zero, 1.0, den))


def _normalized_ratio(a, b):
    return _guard(a + b, a - b)


@supports_dataset_bands(nir='nir_agg', red='red_agg', blue='blue_agg')
def arvi(nir_agg, red_agg, blue_agg, name='arvi') -> DataArray:
    """Atmospherically Resistant Vegetation Index:
    ``(nir - 2*red + blue) / (nir + 2*red + blue)``."""
    validate_arrays(red_agg, nir_agg, blue_agg)

    def index(nir, red, blue):
        red2 = 2.0 * red
        return _guard(nir + red2 + blue, nir - red2 + blue)
    out = per_block(index, nir_agg, red_agg, blue_agg)
    return wrap_like(nir_agg, out, name)


@supports_dataset_bands(nir='nir_agg', red='red_agg', blue='blue_agg')
def evi(nir_agg, red_agg, blue_agg, c1=6.0, c2=7.5, soil_factor=1.0,
        gain=2.5, name='evi') -> DataArray:
    """Enhanced Vegetation Index:
    ``gain * (nir - red) / (nir + c1*red - c2*blue + soil_factor)``."""
    if not isinstance(c1, (float, int)):
        raise ValueError("c1 must be numeric")
    if not isinstance(c2, (float, int)):
        raise ValueError("c2 must be numeric")
    if soil_factor > 1.0 or soil_factor < -1.0:
        raise ValueError("soil factor must be between [-1.0, 1.0]")
    if gain < 0:
        raise ValueError("gain must be greater than 0")
    validate_arrays(nir_agg, red_agg, blue_agg)

    def index(nir, red, blue):
        den = nir + _f32(c1) * red - _f32(c2) * blue + _f32(soil_factor)
        return _f32(gain) * _guard(den, nir - red)
    out = per_block(index, nir_agg, red_agg, blue_agg)
    return wrap_like(nir_agg, out, name)


@supports_dataset_bands(nir='nir_agg', green='green_agg')
def gci(nir_agg, green_agg, name='gci') -> DataArray:
    """Green Chlorophyll Index: ``nir / green - 1``."""
    validate_arrays(nir_agg, green_agg)

    def index(nir, green):
        zero = green == 0.0
        return torch.where(zero, math.nan,
                           nir / torch.where(zero, 1.0, green) - 1.0)
    out = per_block(index, nir_agg, green_agg)
    return wrap_like(nir_agg, out, name)


@supports_dataset_bands(nir='nir_agg', swir2='swir2_agg')
def nbr(nir_agg, swir2_agg, name='nbr') -> DataArray:
    """Normalized Burn Ratio: ``(nir - swir2) / (nir + swir2)``."""
    validate_arrays(nir_agg, swir2_agg)
    out = per_block(_normalized_ratio, nir_agg, swir2_agg)
    return wrap_like(nir_agg, out, name)


@supports_dataset_bands(swir1='swir1_agg', swir2='swir2_agg')
def nbr2(swir1_agg, swir2_agg, name='nbr2') -> DataArray:
    """Normalized Burn Ratio 2: ``(swir1 - swir2) / (swir1 + swir2)``."""
    validate_arrays(swir1_agg, swir2_agg)
    out = per_block(_normalized_ratio, swir1_agg, swir2_agg)
    return wrap_like(swir1_agg, out, name)


@supports_dataset_bands(nir='nir_agg', red='red_agg')
def ndvi(nir_agg, red_agg, name='ndvi') -> DataArray:
    """Normalized Difference Vegetation Index:
    ``(nir - red) / (nir + red)``."""
    validate_arrays(nir_agg, red_agg)
    out = per_block(_normalized_ratio, nir_agg, red_agg)
    return wrap_like(nir_agg, out, name)


@supports_dataset_bands(nir='nir_agg', swir1='swir1_agg')
def ndmi(nir_agg, swir1_agg, name='ndmi') -> DataArray:
    """Normalized Difference Moisture Index:
    ``(nir - swir1) / (nir + swir1)``."""
    validate_arrays(nir_agg, swir1_agg)
    out = per_block(_normalized_ratio, nir_agg, swir1_agg)
    return wrap_like(nir_agg, out, name)


@supports_dataset_bands(nir='nir_agg', red='red_agg')
def savi(nir_agg, red_agg, soil_factor=1.0, name='savi') -> DataArray:
    """Soil Adjusted Vegetation Index:
    ``(nir - red) / ((nir + red + sf) * (1 + sf))``."""
    validate_arrays(red_agg, nir_agg)
    if not -1.0 <= soil_factor <= 1.0:
        raise ValueError("soil factor must be between [-1.0, 1.0]")
    sf = np.float32(soil_factor)

    def index(nir, red):
        den = (nir + red + float(sf)) * float(np.float32(1.0) + sf)
        return _guard(den, nir - red)
    out = per_block(index, nir_agg, red_agg)
    return wrap_like(nir_agg, out, name)


@supports_dataset_bands(nir='nir_agg', red='red_agg', blue='blue_agg')
def sipi(nir_agg, red_agg, blue_agg, name='sipi') -> DataArray:
    """Structure Insensitive Pigment Index:
    ``(nir - blue) / (nir - red)``."""
    validate_arrays(red_agg, nir_agg, blue_agg)
    out = per_block(lambda nir, red, blue: _guard(nir - red, nir - blue),
                    nir_agg, red_agg, blue_agg)
    return wrap_like(nir_agg, out, name)


@supports_dataset_bands(red='red_agg', swir='swir_agg', tir='tir_agg')
def ebbi(red_agg, swir_agg, tir_agg, name='ebbi') -> DataArray:
    """Enhanced Built-Up and Bareness Index:
    ``(swir - red) / (10 * sqrt(swir + tir))``."""
    validate_arrays(red_agg, swir_agg, tir_agg)
    out = per_block(lambda red, swir, tir: _guard(
        10.0 * torch.sqrt(swir + tir), swir - red), red_agg, swir_agg, tir_agg)
    return wrap_like(red_agg, out, name)


def _normalize_sigmoid(data, pixel_max, c, th, extremes=None):
    """Global min-max normalisation, then sigmoid contrast enhancement; a
    band whose values are all equal is all NaN.  `extremes` (min, max)
    are the band's when `data` is one block of it."""
    min_val, max_val = extremes or (nanmin(data), nanmax(data))
    rng = max_val - min_val
    flat = rng == 0.0
    norm = (data - min_val) / torch.where(flat, 1.0, rng)
    norm = 1.0 / (1.0 + torch.exp(c * (th - norm)))
    return torch.where(flat, math.nan, norm * pixel_max)


def _saturate_uint8(x: torch.Tensor) -> torch.Tensor:
    """float -> uint8 as XLA converts: NaN to 0, out-of-range values
    clamped to 0 or 255, the rest truncated (``Tensor.to`` wraps, and
    leaves NaN undefined on the card)."""
    return torch.nan_to_num(x, nan=0.0).clamp(0.0, 255.0).to(torch.uint8)


def true_color(r, g, b, nodata=1, c=10.0, th=0.125,
               name='true_color') -> DataArray:
    """RGBA true-color composite with sigmoid contrast enhancement.

    ``normalized = 1 / (1 + exp(c * (th - normalized)))``; output is a
    (y, x, band) uint8 DataArray; alpha = 0 on nodata/NaN cells.  Bands
    split over a mesh give a (y, x, band) raster of the same blocks, each
    band normalised by its min and max over the blocks.
    """
    def composite(red, green, blue, extremes=(None, None, None)):
        channels = [_saturate_uint8(_normalize_sigmoid(
            band, 255.0, _f32(c), _f32(th), ext))
            for band, ext in zip((red, green, blue), extremes)]
        alpha = torch.where(torch.isnan(red) | (red <= _f32(nodata)), 0,
                            255)
        return torch.stack(channels + [alpha.to(torch.uint8)], dim=-1)

    coords = {'band': [0, 1, 2, 3]}
    for d in ('y', 'x'):
        if d in r.coords:
            coords[d] = r[d]
    mesh = payload_mesh(r, g, b)
    if mesh is None:
        out = composite(to_torch(r), to_torch(g), to_torch(b))
    else:
        bands = mesh_shards(mesh, r, g, b)
        extremes = [_extremes(x) for x in bands]
        out = zip_blocks(
            lambda i, j, *bs: composite(*bs, [tuple(
                t.to(bs[0].device) for t in e) for e in extremes]),
            *bands, trail=1)
    return DataArray(out, name=name, dims=['y', 'x', 'band'], coords=coords,
                     attrs=dict(r.attrs))


def _extremes(x: ShardedRaster):
    """(nanmin, nanmax) of a raster split over a mesh: the least and the
    greatest of its blocks' (NaN where every cell is NaN), on its first
    block's device."""
    dev = x.blocks[0][0].device
    parts = [(nanmin(b), nanmax(b)) for row in x.blocks for b in row
             if b.numel()]
    lo = torch.stack([p[0].to(dev) for p in parts])
    hi = torch.stack([p[1].to(dev) for p in parts])
    return nanmin(lo), nanmax(hi)
