"""What B1's border handling costs on the card.

    python -m xrspatial_torch.tools.exp_seam_cost [N]     (N = 16384)

Counterpart of ``tools/exp_seam_cost.py``, whose TPU kernel ``run`` (B8f)
times ``surface_tiled``'s seam machinery in four variants.  The port has
no seam passes: B1's only border machinery is its per-cell ring branch.
So the variants become, on B1's 32x8 blocks:

- prod: the surface kernel B1, slope only, called by name;
- ring_branch: the ``stencil_probe`` template with B1's per-cell ring
  test (edges ring);
- bare: the template on the interior blocks only, the ring and the edge
  bands left unwritten (edges bare).

On an (N, N) float32 ``gaussian_bump`` and on uniform noise it checks
ring_branch against B1 at every cell and bare on the cells it writes (bit
for bit), then times the variants and the twin in turns, from CUDA
events.  Without a card it exits 1.
"""

from __future__ import annotations

import sys

from ..kernels import cuda_surface
from ..kernels.stencil_probe import interior_extent, stencil, stencil_twin
from . import _stencil
from ._probe import SURFACE_TOL

__all__ = ["measure"]

BLOCK = (32, 8)     # B1's block


def _prod(x):
    return cuda_surface.surface_cuda(x, ("slope",))[0]


def checks(x):
    r0, r1, c0, c1 = interior_extent(*x.shape, BLOCK)
    inner = (slice(r0, r1), slice(c0, c1))
    ring = lambda: stencil(x, "slope", block=BLOCK)  # noqa: E731
    bare = lambda: stencil(x, "slope", edges="bare",  # noqa: E731
                           block=BLOCK)
    return [("ring_branch = prod", ring, lambda: _prod(x), _stencil.EXACT,
             None),
            ("ring_branch vs twin", ring, lambda: stencil_twin(x),
             SURFACE_TOL, None),
            ("bare = prod on the interior blocks", bare, lambda: _prod(x),
             _stencil.EXACT, inner),
            ("bare vs twin", bare, lambda: stencil_twin(
                x, edges="bare", block=BLOCK), SURFACE_TOL, inner)]


def legs(x, reps=20):
    plane = x.numel() * x.element_size()
    return {"prod (surface_kernel slope)": (lambda: _prod(x), reps,
                                            2 * plane),
            "ring_branch": (lambda: stencil(x, "slope", block=BLOCK), reps,
                            2 * plane),
            "bare": (lambda: stencil(x, "slope", edges="bare", block=BLOCK),
                     reps, 2 * plane),
            "twin": (lambda: stencil_twin(x, edges="bare", block=BLOCK), 2,
                     2 * plane)}


def measure(n: int = 16384, out=sys.stdout) -> dict:
    """Check and time every leg at (n, n); see ``_stencil.run``."""
    return _stencil.run("exp_seam_cost", n, checks, legs, out)


if __name__ == "__main__":
    sys.exit(_stencil.main("exp_seam_cost", measure, sys.argv[1:]))
