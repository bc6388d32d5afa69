"""The bump map's sequential accumulation: the twin of kernel X2.

Counterpart of ``xrspatial_tpu/bump.py::_scan_bumps`` (a ``lax.scan`` over
the bumps with masked scatter-adds) and ``_scan_bumps_nospread`` (one
scatter-add of the centres).  Bump by bump, in order: the height is added
to the centre cell; then the new centre value times ``k = d2 / s`` is
added to every cell of the half-open square ``[y - spread, y + spread) x
[x - spread, x + spread)`` whose squared distance ``d2`` is at most ``s =
spread^2`` and that lies inside the raster, offset (0, 0) included (its k
is 0).  The order matters: a later bump reads the centre as the earlier
ones left it.  In float64, every product and sum rounded apart, as the
JAX package computes it on the CPU (XLA's scatter adds duplicates in index
order).

``bump_scan`` sends a tensor on the card to the CUDA kernel
(``cuda_bump.bump_scan_cuda``, ``csrc/bump.cu``) and one on the CPU to
``bump_scan_twin``, a per-bump loop of torch ops.  On the card the bumps
run in rounds of bumps whose footprints do not overlap, then a walk of
the rest in order; ``rounds_threshold`` is the plan that ends the rounds.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["ring_offsets", "ring_table", "rounds_threshold",
           "bump_scan_twin", "bump_scan"]

# The rounds' plan, from the H100 (PERF.md): the first port's walk takes
# about 0.89 us a bump, and a round costs about 10 us at its smallest
# (three grid-wide barriers and three passes over a short list)
WALK_US_PER_BUMP = 0.89
ROUND_US = 10.0


def ring_offsets(spread: int):
    """(oy, ox, k) of the ring cells, numpy, in the JAX package's order
    (oy slowest): the offsets with ``ox^2 + oy^2 <= spread^2`` of the
    half-open square, and ``k = d2 / spread^2`` in float64."""
    oy, ox, d2 = _square(spread)
    s = spread * spread
    ring = d2 <= s
    return oy[ring], ox[ring], d2[ring] / s


def _square(spread: int):
    offs = np.arange(-spread, spread)
    oy, ox = np.meshgrid(offs, offs, indexing="ij")
    oy, ox = oy.ravel(), ox.ravel()
    return oy, ox, (ox * ox + oy * oy).astype(np.float64)


def ring_table(spread: int) -> np.ndarray:
    """``d2 / spread^2`` (float64) at every offset of the half-open square,
    oy slowest: the kernel's table (it tests the ring itself)."""
    _, _, d2 = _square(spread)
    return d2 / (spread * spread)


def rounds_threshold() -> int:
    """The fewest bumps a round must make ready for the next round to
    run: below it, walking the rest one by one costs less than a round."""
    return math.ceil(ROUND_US / WALK_US_PER_BUMP)


def bump_scan_twin(out: torch.Tensor, locs: torch.Tensor,
                   heights: torch.Tensor, spread: int) -> torch.Tensor:
    """Add the bumps to `out` in place, one after another, as torch ops.

    `out` (H, W) float64, `locs` (N, 2) integer columns (x, y) and
    `heights` (N,) float64, all on one device; returns `out`.  A bump's
    ring goes through ``index_add_`` on a flat buffer with one spare cell
    at its end, where the ring's cells outside the raster add their
    (unused) contribution: the indices of one bump are distinct, so each
    cell gets one rounded product and one rounded sum.
    """
    h, w = out.shape
    dev = out.device
    n = locs.shape[0]
    xs = locs[:, 0].cpu().numpy().astype(np.int64)
    ys = locs[:, 1].cpu().numpy().astype(np.int64)
    centre = (ys * w + xs).tolist()
    zs = heights.tolist()
    buf = torch.zeros(h * w + 1, dtype=torch.float64, device=dev)
    buf[:h * w] = out.reshape(-1)
    if spread > 0:
        oy, ox, k = ring_offsets(spread)
        ny = ys[:, None] + oy[None, :]
        nx = xs[:, None] + ox[None, :]
        inside = (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)
        ring = torch.from_numpy(np.where(inside, ny * w + nx, h * w)).to(dev)
        k_t = torch.from_numpy(k).to(dev)
    for i in range(n):
        c = centre[i]
        buf[c:c + 1].add_(zs[i])
        if spread > 0:
            buf.index_add_(0, ring[i], buf[c] * k_t)
    out.copy_(buf[:h * w].view(h, w))
    return out


def bump_scan(out: torch.Tensor, locs: torch.Tensor, heights: torch.Tensor,
              spread: int) -> torch.Tensor:
    """The bumps added to `out` in order: X2 for a tensor on the card (its
    wrapper raises on one elsewhere), the twin on the CPU."""
    if out.device.type == "cpu":
        return bump_scan_twin(out, locs, heights, spread)
    from .cuda_bump import bump_scan_cuda
    return bump_scan_cuda(out, locs, heights, spread)
