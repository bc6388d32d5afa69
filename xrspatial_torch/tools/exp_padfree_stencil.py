"""Slope on interior blocks with no bounds test, the edge bands apart.

    python -m xrspatial_torch.tools.exp_padfree_stencil [N]   (N = 16384)

Counterpart of ``tools/exp_padfree_stencil.py``, whose TPU kernel
``slope_2d`` (B8e) is the ``stencil_probe`` template with edges interior
(``csrc/stencil_probe.cu``): the main launch covers only the blocks that
lie wholly inside the 1-cell ring and tests no bound, a second, small
launch writes the edge bands and the ring.  The TPU probe's point was to
drop the NaN pad copy; the card's version drops B1's per-cell bounds
tests.  On an (N, N) float32 ``gaussian_bump`` and on uniform noise it
checks the result against the surface kernel B1 (bit for bit) and the
twin, then times in turns, from CUDA events, the interior variant at
blocks 32x8, 32x16 and 64x4, B1 and the stacked kernel B0 (slope only:
the production kernels the TPU probe compared with) and the twin.
Without a card it exits 1.
"""

from __future__ import annotations

import sys

from ..kernels import cuda_surface
from ..kernels.stencil_probe import BLOCKS, stencil, stencil_twin
from . import _stencil
from ._probe import SURFACE_TOL

__all__ = ["measure"]


def checks(x):
    out = []
    for b in BLOCKS:
        t = f"{b[0]}x{b[1]}"
        got = lambda b=b: stencil(x, "slope", edges="interior",  # noqa: E731
                                  block=b)
        out += [(f"interior {t} = surface_kernel", got,
                 lambda: cuda_surface.surface_cuda(x, ("slope",))[0],
                 _stencil.EXACT, None),
                (f"interior {t} vs twin", got, lambda: stencil_twin(x),
                 SURFACE_TOL, None)]
    return out


def legs(x, reps=20):
    plane = x.numel() * x.element_size()
    out = {f"interior {b[0]}x{b[1]}": (
        lambda b=b: stencil(x, "slope", edges="interior", block=b), reps,
        2 * plane) for b in BLOCKS}
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
