"""Perlin noise: host-hashed lattices, expanded on the raster's device.

Counterpart of ``xrspatial_tpu/perlin.py``.  The permutation table comes
from the same legacy NumPy RNG calls (``np.random.seed(seed)`` then
``np.random.permutation(2**20)``, a global side effect kept on purpose),
so the hashes equal the JAX package's.  Each octave's hash lattice is
computed on the host over the unique (xi, yi) values only (``xi`` depends
on the column, ``yi`` on the row): ``octave_tables`` packs the four
corner hashes of every lattice cell, 2 bits each, into one uint8 table,
copied from the JAX module.  ``octave_eval`` expands it to pixels with two
whole-axis ``index_select`` calls and runs the fade, gradient and lerp
arithmetic in float32 as torch ops on the table's device.

Bits.  XLA on the CPU does not evaluate the JAX sources' arithmetic as
written; the port copies what it computes, so that both give the same
bits:

- ``6 t^5 - 15 t^4 + 10 t^3`` is ``fma(10, t3, fma(6, t5, -(15 t4)))``
  with ``t2 = t t``, ``t3 = t2 t``, ``t4 = t2 t2``, ``t5 = t4 t``;
- each lerp ``a + s (b - a)`` is ``fma(s, b - a, a)``.

A multiply-add is evaluated exactly in float64 (the product of two
float32 values is exact there) and rounded once to float32, as
``kernels/selection.py`` does for ``nanpercentile``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from .utils import raster_device
from .xrlib import DataArray

__all__ = ["perlin"]


@lru_cache(maxsize=32)
def _permutation_table(seed: int) -> np.ndarray:
    """Legacy-RNG permutation of 2**20, doubled."""
    np.random.seed(seed)
    p = np.random.permutation(np.arange(2 ** 20, dtype=np.int32))
    return np.concatenate([p, p]).astype(np.int32)


@lru_cache(maxsize=32)
def _mod4_table(seed: int) -> np.ndarray:
    """``p % 4`` as uint8: the only part of the hash the gradient needs."""
    return (_permutation_table(seed) & 3).astype(np.uint8)


def fma32(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (float32 operands; the float64
    product is exact)."""
    a, b, c = (v.double() if isinstance(v, torch.Tensor) else float(v)
               for v in (a, b, c))
    return (a * b + c).float()


def _fade(t: torch.Tensor) -> torch.Tensor:
    t2 = t * t
    t3 = t2 * t
    t4 = t2 * t2
    t5 = t4 * t
    return fma32(10.0, t3, fma32(6.0, t5, -(15.0 * t4)))


def _lerp(s, a, b) -> torch.Tensor:
    return fma32(s, b - a, a)


def _gradient(h, x, y) -> torch.Tensor:
    """Dot product with one of 4 axis gradients chosen by ``h % 4``
    (``[[0, 1], [0, -1], [1, 0], [-1, 0]]``): exact in float32."""
    f = torch.remainder(h, 4)
    gx = torch.where(f == 2, 1.0, torch.where(f == 3, -1.0, 0.0))
    gy = torch.where(f == 0, 1.0, torch.where(f == 1, -1.0, 0.0))
    return gx.to(x.dtype) * x + gy.to(y.dtype) * y


def perlin_noise(p: torch.Tensor, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    """Raw (not normalised) perlin values for coordinate grids x, y
    (float64), gathering from the permutation table `p` on the device.

    The JAX package's legacy form, kept as the oracle of the lattice path
    (``octave_tables`` + ``octave_eval``), which it equals bit for bit.
    """
    xi = x.to(torch.int64)
    yi = y.to(torch.int64)
    xf = (x - xi).to(torch.float32)
    yf = (y - yi).to(torch.float32)
    u = _fade(xf)
    v = _fade(yf)
    n = p.shape[0]

    def hash_(a, b):
        # out-of-range indices clamp, as jnp gathers do
        return p[(p[a.clamp(0, n - 1)] + b).clamp(0, n - 1)]

    n00 = _gradient(hash_(xi, yi), xf, yf)
    n01 = _gradient(hash_(xi, yi + 1), xf, yf - 1)
    n11 = _gradient(hash_(xi + 1, yi + 1), xf - 1, yf - 1)
    n10 = _gradient(hash_(xi + 1, yi), xf - 1, yf)
    x1 = _lerp(u, n00, n10)
    x2 = _lerp(u, n01, n11)
    return _lerp(v, x1, x2)


def _split_axis(v: np.ndarray):
    """Integer/fraction split of a 1-D coordinate axis on the host:
    truncating ``astype(int32)`` and ``v - vi`` in the input precision
    rounded to float32."""
    vi = v.astype(np.int32)
    vf = (v - vi.astype(v.dtype)).astype(np.float32)
    viu, inv = np.unique(vi, return_inverse=True)
    return vf, viu, inv.astype(np.int32).ravel()


def octave_tables(seed: int, x_col: np.ndarray, y_row: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                             np.ndarray, np.ndarray]:
    """Hash one octave's lattice on the host.

    ``x_col``/``y_row`` are the per-column and per-row noise-space
    coordinates.  Returns ``packed`` (n_unique_yi, n_unique_xi) uint8, the
    four corner hashes ``p[p[xi+dx]+yi+dy] % 4`` packed 2 bits each as
    ``h00 | h01<<2 | h10<<4 | h11<<6``; ``ix`` (W,) and ``iy`` (H,), the
    int32 lattice column and row of each pixel; ``xf`` (W,) and ``yf``
    (H,), the float32 fractions.  Out-of-range lattice indices clamp.
    """
    p = _permutation_table(seed)
    p4 = _mod4_table(seed)
    n = p.shape[0]
    half = n // 2  # p holds a doubled permutation: values are < n//2
    xf, xiu, ix = _split_axis(x_col)
    yf, yiu, iy = _split_axis(y_row)

    in_bounds = (xiu[0] >= 0 and xiu[-1] <= n - 2
                 and yiu[0] >= 0 and yiu[-1] + 1 <= n - half)
    if in_bounds:
        # int32 indices, the two outer-sum planes shared by both dy
        # corners (p4[b + 1] == p4[1:][b], a view)
        px0 = p[xiu]
        px1 = p[xiu + 1]
        y0 = yiu[:, None]
        p4s = p4[1:]
        b = px0[None, :] + y0
        packed = p4[b]
        packed |= p4s[b] << 2
        b = px1[None, :] + y0
        packed |= p4[b] << 4
        packed |= p4s[b] << 6
        return packed, ix, iy, xf, yf

    px0 = p[np.clip(xiu, 0, n - 1)].astype(np.int64)
    px1 = p[np.clip(xiu + 1, 0, n - 1)].astype(np.int64)
    y0 = yiu.astype(np.int64)[:, None]
    y1 = y0 + 1

    def tab(px, yv):
        return p4[np.clip(px[None, :] + yv, 0, n - 1)].astype(np.int16)

    packed = (tab(px0, y0) | (tab(px0, y1) << 2)
              | (tab(px1, y0) << 4) | (tab(px1, y1) << 6))
    return packed.astype(np.uint8), ix, iy, xf, yf


def octave_eval(packed: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor,
                xf: torch.Tensor, yf: torch.Tensor) -> torch.Tensor:
    """One octave's (H, W) float32 values from its hashed lattice, on the
    tensors' device: two whole-axis gathers, then per element the same
    float sequence as ``perlin_noise``."""
    t = packed.index_select(0, iy).index_select(1, ix)
    h00 = t & 3
    h01 = (t >> 2) & 3
    h10 = (t >> 4) & 3
    h11 = (t >> 6) & 3
    del t
    xf2 = xf[None, :]
    yf2 = yf[:, None]
    u = _fade(xf)[None, :]
    v = _fade(yf)[:, None]
    n00 = _gradient(h00, xf2, yf2)
    n01 = _gradient(h01, xf2, yf2 - 1)
    n11 = _gradient(h11, xf2 - 1, yf2 - 1)
    n10 = _gradient(h10, xf2 - 1, yf2)
    del h00, h01, h10, h11
    x1 = _lerp(u, n00, n10)
    del n00, n10
    x2 = _lerp(u, n01, n11)
    del n01, n11
    return _lerp(v, x1, x2)


def tables_to(device, packed, ix, iy, xf, yf):
    """One octave's host tables as tensors on `device`."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (packed, ix, iy, xf, yf))


def normalize(out: torch.Tensor) -> torch.Tensor:
    """``(out - min) / (max - min)``, a true division."""
    lo = out.min()
    return (out - lo) / (out.max() - lo)


def perlin(agg: DataArray,
           freq: tuple = (1, 1),
           seed: int = 5,
           name: str = 'perlin') -> DataArray:
    """Generate a perlin noise aggregate, normalized to [0, 1].

    Parameters
    ----------
    agg : DataArray
        2D array whose shape determines the output size; the output lies
        on its tensor's device (a numpy payload: the default device).
    freq : tuple, default=(1, 1)
        (x, y) frequency multipliers.
    seed : int, default=5
        RNG seed for the permutation table.
    """
    height, width = agg.shape
    linx = np.linspace(0, freq[0], width, endpoint=False, dtype=np.float32)
    liny = np.linspace(0, freq[1], height, endpoint=False, dtype=np.float32)
    fields = tables_to(raster_device(agg),
                       *octave_tables(seed, linx, liny))
    out = normalize(octave_eval(*fields)).to(torch.float32)
    return DataArray(out, dims=agg.dims, attrs=agg.attrs, name=name)
