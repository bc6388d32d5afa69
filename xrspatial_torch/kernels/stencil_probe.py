"""The stencil probes of the surface kernel: one float32 3x3 slope stencil
in several instantiations.

Counterpart of four TPU probes of ``xrspatial_tpu``'s surface kernel B1
(``pallas_surface2.py::surface_tiled``), each an instantiation of the
CUDA template ``csrc/stencil_probe.cu`` (wrapper ``cuda_stencil_probe.py``):

===  ======================================  ===============================
B8c  ``tools/exp_stencil2.py::pipe_stencil``  mode copy, grad or slope; form
                                              staged; edges ring; tiles
                                              32x128, 64x128, 32x248 (the
                                              TPU probe's tile shapes)
B8d  ``tools/exp_separable_horn.py::run``     mode slope; form
                                              separable_staged (tiles as
                                              B8c's), its first port
                                              separable, or nine; edges
                                              ring
B8e  ``tools/exp_padfree_stencil.py::         mode slope; form staged (tiles
     slope_2d``                               as B8c's), its first port
                                              nine; edges interior
B8f  ``tools/exp_seam_cost.py::run``          prod = B1 by name; bare =
                                              form staged, edges bare;
                                              ring_branch = form staged,
                                              edges ring_branch; their
                                              first ports form nine, edges
                                              bare and ring
===  ======================================  ===============================

The staged form stages each tile's window in shared memory, as the TPU
probe does in VMEM: ``staged_plan`` (``kernels/staged.py``, the plan of
the window ring B1's staged kernel shares) says how (the TMA box, the
ring's stages and shared bytes, the route, the persistent grid), and
refuses a tile that breaks a rule of the box or of shared memory, naming
it.  Edges
interior and bare walk the interior (``staged_plan(..., walk="interior")``:
output rows [1, h - 1) and columns [4, w - 4), the last tiles pulled back
inside, so no window leaves the raster and no tile tests a bound);
interior then writes the edge bands outside ``staged_interior_extent``
with a second, small launch, and bare leaves them unwritten.  Edges
ring_branch walks the whole raster as B8c does, with B1's first port's
per-cell ring test.  Form nine at blocks 32x8, 32x16 and 64x4, B8c's
first port (nine global reads a cell, B1's access pattern), stays by
name, with edges interior and bare (B8e's and B8f's first ports: the
blocks wholly inside the ring, ``interior_extent``).  Form
separable_staged, B8d's redesign, is the separable arithmetic on the same
staged windows and plan, at the same tiles; its first port, form
separable at the blocks, stays by name.

``stencil_twin`` is the plain version of every instantiation:

- copy: the input;
- grad: ``sqrt(dzdx^2 + dzdy^2)`` with B1's ``dzdx = sx / (8*csx)`` at
  cellsize 1, NaN ring;
- slope: ``atan(grad) * 57.29578``, the surface twin's slope (B1's), NaN
  ring;
- staged: the nine-read twin, the same bits (its NaN pad gives the NaN
  ring);
- separable and separable_staged: the vertical smooth and difference
  first, then the horizontal combination, so dzdy rounds as
  ``(g-a) + 2(hh-b) + (ii-c)``;
- edges interior and ring_branch equal ring; edges bare leaves every cell
  outside its rectangle unwritten, which the twin marks NaN (compare only
  ``bare_extent``'s rectangle: ``interior_extent``'s blocks in form nine,
  ``staged_interior_extent`` in form staged).

``stencil`` dispatches: a tensor on the CPU goes to the twin, a tensor on
the card to the kernel.  The ``xrspatial_torch.tools.exp_*`` probes time
them.
"""

from __future__ import annotations

import math

import torch

from .staged import MAX_STAGES, StagedPlan, staged_plan  # noqa: F401
from .surface import DEG, _nan_border, neighborhood, slope_from_neighbors

__all__ = ["MODES", "FORMS", "STAGED_FORMS", "EDGES", "BLOCKS", "TILES",
           "VARIANTS",
           "shapes_of", "check_variant", "interior_extent",
           "staged_interior_extent", "bare_extent", "StagedPlan",
           "staged_plan", "stencil_twin", "stencil"]

MODES = ("copy", "grad", "slope")
FORMS = ("nine", "separable", "staged", "separable_staged")
STAGED_FORMS = ("staged", "separable_staged")  # at TILES, on staged_plan
EDGES = ("ring", "interior", "bare", "ring_branch")  # ring_branch: staged
BLOCKS = ((32, 8), (32, 16), (64, 4))     # (threads in x, threads in y)
TILES = ((32, 128), (64, 128), (32, 248))  # staged: (rows, columns) a tile

# the instantiations csrc/stencil_probe.cu compiles: (mode, form, edges)
# at every shape of the form (shapes_of)
VARIANTS = (tuple((m, "nine", "ring") for m in MODES)
            + (("slope", "separable", "ring"), ("slope", "nine", "interior"),
               ("slope", "nine", "bare"))
            + tuple((m, "staged", "ring") for m in MODES)
            + (("slope", "separable_staged", "ring"),
               ("slope", "staged", "interior"), ("slope", "staged", "bare"),
               ("slope", "staged", "ring_branch")))


def shapes_of(form) -> tuple:
    """The block shapes (nine, separable) or tiles (staged,
    separable_staged) of a form."""
    return TILES if form in STAGED_FORMS else BLOCKS


def check_variant(mode, form, edges, block) -> None:
    """Raise ValueError unless the template has this instantiation."""
    if (mode, form, edges) not in VARIANTS or \
            tuple(block) not in shapes_of(form):
        raise ValueError(
            f"no stencil_probe instantiation mode={mode!r} form={form!r} "
            f"edges={edges!r} block={tuple(block)}; the template has "
            f"(mode, form, edges) in {VARIANTS} at blocks {BLOCKS}, and "
            f"forms {STAGED_FORMS} at tiles {TILES}")


def interior_extent(h: int, w: int, block=(32, 8)) -> tuple:
    """(r0, r1, c0, c1): the rows and columns of the blocks that lie wholly
    inside the 1-cell ring, on the block grid anchored at (0, 0).  Empty
    (r0 == r1 or c0 == c1) when no block fits."""
    bx, by = block
    r0 = min(by, h)
    r1 = max(r0, by * ((h - 1) // by))
    c0 = min(bx, w)
    c1 = max(c0, bx * ((w - 1) // bx))
    return r0, r1, c0, c1


def staged_interior_extent(h: int, w: int, tile=(64, 128)) -> tuple:
    """(r0, r1, c0, c1): the cells the staged form's interior walk at
    `tile` writes, (1, h - 1, 4, w - 4); empty (r0 == r1 and c0 == c1,
    every cell in the edge bands) where h - 2 < TH or w - 8 < TW."""
    th, tw = tile
    if h - 2 < th or w - 8 < tw:
        return min(1, h), min(1, h), min(4, w), min(4, w)
    return 1, h - 1, 4, w - 4


def bare_extent(h: int, w: int, form="nine", block=None) -> tuple:
    """(r0, r1, c0, c1): the cells edges bare writes in `form` at
    `block`: ``interior_extent`` in form nine, ``staged_interior_extent``
    in form staged."""
    block = block or shapes_of(form)[0]
    if form in STAGED_FORMS:
        return staged_interior_extent(h, w, block)
    return interior_extent(h, w, block)


def _grad_from_neighbors(nb, cs):
    a, b, c, d, e, f, g, h, i = nb
    dz_dx = ((c + 2.0 * f + i) - (a + 2.0 * d + g)) / (8.0 * cs)
    dz_dy = ((g + 2.0 * h + i) - (a + 2.0 * b + c)) / (8.0 * cs)
    return torch.sqrt(dz_dx * dz_dx + dz_dy * dz_dy)


def _separable_slope(x, cs):
    p = torch.nn.functional.pad(x, (1, 1, 1, 1), value=math.nan)
    smooth = p[:-2, :] + 2.0 * p[1:-1, :] + p[2:, :]    # vertical smooth
    diff = p[2:, :] - p[:-2, :]                          # vertical difference
    dz_dx = (smooth[:, 2:] - smooth[:, :-2]) / (8.0 * cs)
    dz_dy = (diff[:, :-2] + 2.0 * diff[:, 1:-1] + diff[:, 2:]) / (8.0 * cs)
    p = torch.sqrt(dz_dx * dz_dx + dz_dy * dz_dy)
    return torch.atan(p) * DEG


def stencil_twin(x: torch.Tensor, mode="slope", form="nine", edges="ring",
                 block=None) -> torch.Tensor:
    """The plain version of the instantiation (mode, form, edges, block) on
    the 2D float32 tensor `x`: a new (H, W) float32 tensor.  `block`
    defaults to the form's first shape."""
    block = block or shapes_of(form)[0]
    check_variant(mode, form, edges, block)
    if x.ndim != 2:
        raise ValueError(f"stencil_twin takes a 2D tensor, got {x.ndim}D")
    x = x.to(torch.float32)
    if mode == "copy":
        return x.clone()
    cs = torch.tensor(1.0, dtype=torch.float32, device=x.device)
    if form in ("separable", "separable_staged"):
        out = _separable_slope(x, cs)
    elif mode == "grad":
        out = _grad_from_neighbors(neighborhood(x), cs)
    else:
        out = slope_from_neighbors(neighborhood(x), cs, cs)
    out = _nan_border(out)
    if edges == "bare":
        r0, r1, c0, c1 = bare_extent(*x.shape, form, block)
        bare = torch.full_like(out, math.nan)
        bare[r0:r1, c0:c1] = out[r0:r1, c0:c1]
        out = bare
    return out


def stencil(x: torch.Tensor, mode="slope", form="nine", edges="ring",
            block=None) -> torch.Tensor:
    """The instantiation on `x`'s device: the twin on the CPU, the kernel
    on the card."""
    if x.device.type == "cpu":
        return stencil_twin(x, mode, form, edges, block)
    from .cuda_stencil_probe import stencil_probe_cuda
    return stencil_probe_cuda(x, mode, form, edges, block)
