"""What B1's border machinery costs on the card.

    python -m xrspatial_torch.tools.exp_seam_cost [N]     (N = 16384)

Counterpart of ``tools/exp_seam_cost.py``, whose TPU kernel ``run`` (B8f)
times ``surface_tiled``'s seam machinery in four variants.  The port has
no seam passes: B1's border machinery is its staged ring's NaN-filled edge
windows, the bounds test on every quad and the ragged last tiles.  So the
variants become the ``stencil_probe`` template in form staged, at B1's
tile 64x128:

- prod: the surface kernel B1, slope only, called by name;
- bare: the interior walk alone (output rows [1, h - 1), columns
  [4, w - 4), the last tiles pulled back inside: no window leaves the
  raster, no bounds test), the cells outside left unwritten;
- ring_branch: B8c's full walk with B1's first port's per-cell ring test
  in place of relying on the NaN fill;

beside B8c's staged slope at 64x128 (the full walk, the ring from the NaN
fill) and the first ports, form nine on blocks 32x8: "ring_branch" (edges
ring, B1's per-cell test) and "bare" (the interior blocks alone).  prod -
bare is the cost of B1's border machinery on Hopper, ring_branch - staged
that of an explicit ring test.

On an (N, N) float32 ``gaussian_bump`` and on uniform noise it checks
every leg against B1 bit for bit (bare on the cells it writes) and the
twin, then times the legs and the twin in turns, from CUDA events.
Without a card it exits 1.
"""

from __future__ import annotations

import sys

from ..kernels import cuda_surface
from ..kernels.stencil_probe import bare_extent, stencil, stencil_twin
from . import _stencil
from ._probe import SURFACE_TOL

__all__ = ["measure"]

TILE = (64, 128)    # B1's tile
BLOCK = (32, 8)     # the first ports' block


def _prod(x):
    return cuda_surface.surface_cuda(x, ("slope",))[0]


def _legs_of(x):
    """{label: (kernel call, form, edges, block)} of the kernel legs."""
    t = f"{TILE[0]}x{TILE[1]}"
    return {
        f"bare staged {t}": (
            lambda: stencil(x, "slope", "staged", "bare", TILE), "staged",
            "bare", TILE),
        f"ring_branch staged {t}": (
            lambda: stencil(x, "slope", "staged", "ring_branch", TILE),
            "staged", "ring_branch", TILE),
        f"staged {t}": (lambda: stencil(x, "slope", "staged", block=TILE),
                        "staged", "ring", TILE),
        "ring_branch": (lambda: stencil(x, "slope", block=BLOCK), "nine",
                        "ring", BLOCK),
        "bare": (lambda: stencil(x, "slope", edges="bare", block=BLOCK),
                 "nine", "bare", BLOCK)}


def checks(x):
    out = []
    for label, (got, form, edges, block) in _legs_of(x).items():
        region = None
        if edges == "bare":
            r0, r1, c0, c1 = bare_extent(*x.shape, form, block)
            region = (slice(r0, r1), slice(c0, c1))
        out += [(f"{label} = prod", got, lambda: _prod(x), _stencil.EXACT,
                 region),
                (f"{label} vs twin", got,
                 lambda f=form, e=edges, b=block: stencil_twin(x, "slope", f,
                                                               e, b),
                 SURFACE_TOL, region)]
    return out


def legs(x, reps=20):
    plane = x.numel() * x.element_size()
    out = {"prod (surface_kernel slope)": (lambda: _prod(x), reps,
                                           2 * plane)}
    out.update({label: (fn, reps, 2 * plane)
                for label, (fn, *_) in _legs_of(x).items()})
    out["twin"] = (lambda: stencil_twin(x, "slope", "staged", "bare", TILE),
                   2, 2 * plane)
    return out


def measure(n: int = 16384, out=sys.stdout) -> dict:
    """Check and time every leg at (n, n); see ``_stencil.run``."""
    return _stencil.run("exp_seam_cost", n, checks, legs, out)


if __name__ == "__main__":
    sys.exit(_stencil.main("exp_seam_cost", measure, sys.argv[1:]))
