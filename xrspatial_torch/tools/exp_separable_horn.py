"""The 9-window Horn slope against its separable form on the card.

    python -m xrspatial_torch.tools.exp_separable_horn [N]     (N = 16384)

Counterpart of ``tools/exp_separable_horn.py``, whose TPU kernel ``run``
(B8d) is the ``stencil_probe`` template (``csrc/stencil_probe.cu``) in
form separable_staged, B8d's redesign: the TPU probe's separable
arithmetic (each column's vertical smooth and difference formed once,
then neighbouring columns combined) on the staged window ring of B8c, at
its tiles 32x128, 64x128 and 32x248; its first port, form separable (a
shared-memory row tile per warp, blocks 32x8, 32x16, 64x4); and form
nine.  Unlike the TPU probe, every form writes the whole raster with its
1-cell NaN ring.  On an (N, N) float32 ``gaussian_bump`` and on uniform
noise it checks nine against the surface kernel (bit for bit), the staged
separable form against the first port (bit for bit) and each form against
its twin (surface tolerance), prints how far the forms lie from each
other and from a float64 slope, then times in turns, from CUDA events,
the staged separable form and B8c's staged slope (nine-read arithmetic,
same windows) at each tile, nine and separable at each block, the surface
kernel B1 (slope only, the production path) and the twins.  Staged
separable against staged slope is the probe's question with the window in
shared memory: does forming the vertical sums once a column buy anything?
Without a card it exits 1.

The forms are not held to each other: they round dzdy differently, and
on a DEM a kilometre high, where each Sobel sum is about 4|z|, they may
part by more than the surface tolerance; the float64 slope shows which
form keeps more bits.
"""

from __future__ import annotations

import sys

import torch

from ..kernels import cuda_surface
from ..kernels.stencil_probe import BLOCKS, TILES, stencil, stencil_twin
from ..kernels.surface import _nan_border, neighborhood, slope_from_neighbors
from . import _stencil
from ._probe import SURFACE_TOL

__all__ = ["measure"]


def slope64(x):
    """B1's slope in float64, the yardstick of both forms' rounding."""
    one = torch.tensor(1.0, dtype=torch.float64, device=x.device)
    return _nan_border(slope_from_neighbors(neighborhood(x.double()), one,
                                            one))


def checks(x):
    out = [("nine vs float64", lambda: stencil(x, "slope", "nine"),
            lambda: slope64(x), None, None),
           ("separable vs float64", lambda: stencil(x, "slope", "separable"),
            lambda: slope64(x), None, None)]
    for b in BLOCKS:
        t = f"{b[0]}x{b[1]}"
        nine = lambda b=b: stencil(x, "slope", "nine", block=b)  # noqa: E731
        sep = lambda b=b: stencil(x, "slope", "separable",   # noqa: E731
                                  block=b)
        out += [(f"nine {t} = surface_kernel", nine,
                 lambda: cuda_surface.surface_cuda(x, ("slope",))[0],
                 _stencil.EXACT, None),
                (f"nine {t} vs twin", nine, lambda: stencil_twin(x),
                 SURFACE_TOL, None),
                (f"separable {t} vs twin", sep,
                 lambda: stencil_twin(x, form="separable"), SURFACE_TOL,
                 None),
                (f"separable {t} vs nine", sep, nine, None, None)]
    first = lambda: stencil(x, "slope", "separable")  # noqa: E731
    for tile in TILES:
        t = f"{tile[0]}x{tile[1]}"
        staged = lambda b=tile: stencil(  # noqa: E731
            x, "slope", "separable_staged", block=b)
        out += [(f"separable_staged {t} = separable 32x8", staged, first,
                 _stencil.EXACT, None),
                (f"separable_staged {t} vs twin", staged,
                 lambda: stencil_twin(x, form="separable"), SURFACE_TOL,
                 None)]
    return out


def legs(x, reps=20):
    plane = x.numel() * x.element_size()
    out = {}
    for form in ("separable_staged", "staged"):
        for b in TILES:
            out[f"{form} {b[0]}x{b[1]}"] = (
                lambda f=form, b=b: stencil(x, "slope", f, block=b), reps,
                2 * plane)
    for form in ("nine", "separable"):
        for b in BLOCKS:
            out[f"{form} {b[0]}x{b[1]}"] = (
                lambda f=form, b=b: stencil(x, "slope", f, block=b), reps,
                2 * plane)
    out["surface_kernel slope (prod)"] = (
        lambda: cuda_surface.surface_cuda(x, ("slope",)), reps, 2 * plane)
    out["twin nine"] = (lambda: stencil_twin(x), 2, 2 * plane)
    out["twin separable"] = (lambda: stencil_twin(x, form="separable"), 2,
                             2 * plane)
    return out


def measure(n: int = 16384, out=sys.stdout) -> dict:
    """Check and time every leg at (n, n); see ``_stencil.run``."""
    return _stencil.run("exp_separable_horn", n, checks, legs, out)


if __name__ == "__main__":
    sys.exit(_stencil.main("exp_separable_horn", measure, sys.argv[1:]))
