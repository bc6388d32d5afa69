"""What limits the surface stencil on the card: B1's 3x3 windows with and
without their arithmetic.

    python -m xrspatial_torch.tools.exp_stencil2 [N]     (N = 16384)

Counterpart of ``tools/exp_stencil2.py``, whose TPU kernel ``pipe_stencil``
(B8c) is the ``stencil_probe`` template in modes copy, grad and slope
(``csrc/stencil_probe.cu``): form staged, each tile's window staged in
shared memory by TMA as the TPU probe stages it in VMEM, at tiles 32x128,
64x128 and 32x248; and form nine, nine global reads a cell, at blocks
32x8, 32x16 and 64x4.  On an (N, N) float32 ``gaussian_bump`` and on
uniform noise it checks each kernel against its twin (copy equal to the
input, grad and slope within the surface tolerance, slope equal to the
surface kernel bit for bit), then times in turns, from CUDA events:

- A ``torch.add(x, 1)`` and ``Tensor.copy_``: the stream yardsticks;
- B the surface kernel B1 and the stacked kernel B0, slope only;
- C copy, E grad and slope: "staged TxW" at each tile, "nine BxB" at
  each block;
- D slope from cuDNN's ``conv2d`` Sobel pair in full float32;
- G the torch-op twins of slope and copy.

GB/s counts one read and one write of the plane.  The yardsticks and D are
no part of the port.  Without a card it exits 1.
"""

from __future__ import annotations

import math
import sys

import torch
import torch.nn.functional as F

from ..kernels import cuda_surface
from ..kernels.stencil_probe import BLOCKS, TILES, stencil, stencil_twin
from ..kernels.surface import DEG
from ..kernels.window import _cudnn_full_fp32
from . import _stencil
from ._probe import SURFACE_TOL

__all__ = ["measure", "conv_slope"]


def conv_slope(x: torch.Tensor) -> torch.Tensor:
    """Slope from cuDNN's float32 Sobel convolutions, NaN ring (the TPU
    probe's leg D)."""
    kx = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]],
                      dtype=torch.float32, device=x.device)
    k = torch.stack([kx, kx.T])[:, None]
    with _cudnn_full_fp32():
        g = F.conv2d(x[None, None], k, padding=1)[0]
    out = torch.atan(torch.sqrt(g[0] * g[0] + g[1] * g[1]) * 0.125) * DEG
    out[0, :] = out[-1, :] = out[:, 0] = out[:, -1] = math.nan
    return out


# (form, its shapes): every instantiation of the TPU probe's modes
SHAPES = (("staged", TILES), ("nine", BLOCKS))


def _tag(form, block):
    return f"{form} {block[0]}x{block[1]}"


def checks(x):
    b1 = lambda: cuda_surface.surface_cuda(x, ("slope",))[0]  # noqa: E731
    out = []
    for form, shapes in SHAPES:
        for block in shapes:
            t = _tag(form, block)
            out.append((f"copy {t} = input", lambda f=form, b=block: stencil(
                x, "copy", f, block=b), lambda: x, _stencil.EXACT, None))
            for mode in ("grad", "slope"):
                out.append((f"{mode} {t} vs twin",
                            lambda f=form, b=block, m=mode: stencil(
                                x, m, f, block=b),
                            lambda m=mode: stencil_twin(x, m), SURFACE_TOL,
                            None))
            out.append((f"slope {t} = surface_kernel",
                        lambda f=form, b=block: stencil(x, "slope", f,
                                                        block=b),
                        b1, _stencil.EXACT, None))
    out.append(("D conv2d Sobel slope vs surface_kernel", lambda: conv_slope(x),
                b1, None, None))
    return out


def legs(x, reps=20):
    plane = x.numel() * x.element_size()
    z = torch.empty_like(x)
    out = {"A torch.add(x, 1)": (lambda: torch.add(x, 1.0), reps, 2 * plane),
           "A Tensor.copy_": (lambda: z.copy_(x), reps, 2 * plane),
           "B surface_kernel slope": (
               lambda: cuda_surface.surface_cuda(x, ("slope",)), reps,
               2 * plane),
           "B surface_stacked_kernel slope": (
               lambda: cuda_surface.surface_stacked_cuda(
                   x, ("slope",), squeeze=True), reps, 2 * plane)}
    for mode, leg in (("copy", "C"), ("grad", "E"), ("slope", "E")):
        for form, shapes in SHAPES:
            for block in shapes:
                out[f"{leg} {mode} {_tag(form, block)}"] = (
                    lambda m=mode, f=form, b=block: stencil(x, m, f,
                                                            block=b),
                    reps, 2 * plane)
    out["D conv2d Sobel slope"] = (lambda: conv_slope(x), 3, 2 * plane)
    out["G twin slope"] = (lambda: stencil_twin(x, "slope"), 2, 2 * plane)
    out["G twin copy"] = (lambda: stencil_twin(x, "copy"), reps, 2 * plane)
    return out


def measure(n: int = 16384, out=sys.stdout) -> dict:
    """Check and time every leg at (n, n); see ``_stencil.run``."""
    return _stencil.run("exp_stencil2", n, checks, legs, out)


if __name__ == "__main__":
    sys.exit(_stencil.main("exp_stencil2", measure, sys.argv[1:]))
