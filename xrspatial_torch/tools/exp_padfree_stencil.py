"""Slope on an interior walk whose windows never leave the raster, the edge
bands apart.

    python -m xrspatial_torch.tools.exp_padfree_stencil [N]   (N = 16384)

Counterpart of ``tools/exp_padfree_stencil.py``, whose TPU kernel
``slope_2d`` (B8e) clamps its interior tiles so that none reaches outside
the raster and writes the thin edge bands in a second pass.  Its port is
the ``stencil_probe`` template (``csrc/stencil_probe.cu``) in form staged,
edges interior: B8c's staged window ring on the interior walk (output rows
[1, h - 1), columns [4, w - 4), the last tiles pulled back inside), with
no NaN-filled window, no bounds test and no ragged tile, then the edge
bands by a second, small launch.  Its first port, form nine with edges
interior (the blocks wholly inside the ring by nine global reads, the
rest by the edge kernel), stays by name.  The TPU probe's point was to
drop the NaN pad copy; on the card the question is what B1's border
machinery costs on the staged ring.  On an (N, N) float32
``gaussian_bump`` and on uniform noise it checks every kernel leg against
the surface kernel B1 (bit for bit) and the twin, then times in turns,
from CUDA events, "interior staged TxW" at every tile, the edge-band
launch alone, the first port "interior 32x8", B1 and the stacked kernel
B0 (slope only: the production kernels the TPU probe compared with) and
the twin.  Without a card it exits 1.
"""

from __future__ import annotations

import sys

import torch

from ..kernels import cuda_stencil_probe, cuda_surface
from ..kernels.stencil_probe import (TILES, staged_interior_extent, stencil,
                                     stencil_twin)
from . import _stencil
from ._probe import SURFACE_TOL

__all__ = ["measure"]

FIRST_PORT = (32, 8)
EDGE_TILE = (64, 128)   # the edge launch timed alone: B1's tile's bands


def _legs_of(x):
    """{label: kernel call} of the kernel legs, each checked against B1."""
    out = {f"interior staged {t[0]}x{t[1]}": (
        lambda t=t: stencil(x, "slope", "staged", "interior", t))
        for t in TILES}
    out[f"interior {FIRST_PORT[0]}x{FIRST_PORT[1]}"] = (
        lambda: stencil(x, "slope", edges="interior", block=FIRST_PORT))
    return out


def checks(x):
    out = []
    for label, got in _legs_of(x).items():
        out += [(f"{label} = surface_kernel", got,
                 lambda: cuda_surface.surface_cuda(x, ("slope",))[0],
                 _stencil.EXACT, None),
                (f"{label} vs twin", got, lambda: stencil_twin(x),
                 SURFACE_TOL, None)]
    return out


def legs(x, reps=20):
    plane = x.numel() * x.element_size()
    out = {label: (fn, reps, 2 * plane) for label, fn in _legs_of(x).items()}
    h, w = x.shape
    r0, r1, c0, c1 = extent = staged_interior_extent(h, w, EDGE_TILE)
    band = h * w - (r1 - r0) * (c1 - c0)
    scratch = torch.empty_like(x)
    # each band cell's nine neighbours read, the cell written
    out[f"edge bands alone ({EDGE_TILE[0]}x{EDGE_TILE[1]})"] = (
        lambda: cuda_stencil_probe.edge_bands_cuda(x, scratch, extent), reps,
        10 * band * x.element_size())
    out["surface_kernel slope"] = (
        lambda: cuda_surface.surface_cuda(x, ("slope",)), reps, 2 * plane)
    out["surface_stacked_kernel slope"] = (
        lambda: cuda_surface.surface_stacked_cuda(x, ("slope",),
                                                  squeeze=True), reps,
        2 * plane)
    out["twin"] = (lambda: stencil_twin(x, edges="interior"), 2, 2 * plane)
    return out


def measure(n: int = 16384, out=sys.stdout) -> dict:
    """Check and time every leg at (n, n); see ``_stencil.run``."""
    return _stencil.run("exp_padfree_stencil", n, checks, legs, out)


if __name__ == "__main__":
    sys.exit(_stencil.main("exp_padfree_stencil", measure, sys.argv[1:]))
