"""Wrapper of the bump kernel X2 (``csrc/bump.cu``).

``bump_scan_cuda`` runs ``bump_scan_kernel``: every bump of a bump map
added in order in one launch, in float64.  It replaces no Pallas kernel:
the JAX package runs the walk as a ``lax.scan`` of XLA
(``xrspatial_tpu/bump.py::_scan_bumps``) and, at spread 0, one scatter-add
(``_scan_bumps_nospread``).  Its plain version is ``kernels/bump.py::
bump_scan_twin``, which it equals bit for bit.

The wrapper takes a contiguous (H, W) float64 map on the card, the
bumps' (N, 2) integer locations (x, y) and (N,) heights; it checks that
every location lies inside the map, uploads the ring's table ``d2 /
spread^2`` (float64, computed on the host), launches on PyTorch's current
stream and raises if the launch fails.  It never falls back to the twin.
"""

from __future__ import annotations

import torch

from . import _cuda
from .bump import ring_table

__all__ = ["bump_scan_cuda", "BUMP_LAUNCHES"]

# launches in this process, for checks that a path ran on the kernel
BUMP_LAUNCHES = 0


def bump_scan_cuda(out: torch.Tensor, locs: torch.Tensor,
                   heights: torch.Tensor, spread: int) -> torch.Tensor:
    """Add the bumps to `out` in place, in order; returns `out`."""
    global BUMP_LAUNCHES
    if out.device.type != "cuda":
        raise ValueError(f"bump_scan_cuda takes a CUDA tensor, got one on "
                         f"{out.device}")
    if out.dtype != torch.float64 or out.dim() != 2 \
            or not out.is_contiguous():
        raise ValueError(f"bump_scan_cuda takes a contiguous 2-D float64 "
                         f"map, got {out.dtype} {tuple(out.shape)}, "
                         f"contiguous={out.is_contiguous()}")
    n = locs.shape[0]
    if locs.dim() != 2 or locs.shape[1] != 2 or heights.shape != (n,):
        raise ValueError(f"bump_scan_cuda takes (N, 2) locations and (N,) "
                         f"heights, got {tuple(locs.shape)} and "
                         f"{tuple(heights.shape)}")
    if spread < 0:
        raise ValueError(f"bump_scan_cuda: spread {spread} < 0")
    h, w = out.shape
    locs = locs.to(device=out.device, dtype=torch.int32).contiguous()
    heights = heights.to(device=out.device, dtype=torch.float64).contiguous()
    if n == 0:
        return out
    lo = locs.amin(dim=0).tolist()
    hi = locs.amax(dim=0).tolist()
    if min(lo) < 0 or hi[0] >= w or hi[1] >= h:
        raise ValueError(f"bump_scan_cuda: locations outside the {h}x{w} "
                         f"map (x in [{lo[0]}, {hi[0]}], y in [{lo[1]}, "
                         f"{hi[1]}])")
    k = (torch.from_numpy(ring_table(spread)).to(out.device) if spread
         else None)
    lib = _cuda.library()
    with torch.cuda.device(out.device):
        err = lib.bump_scan_launch(
            out.data_ptr(), locs.data_ptr(), heights.data_ptr(), n, h, w,
            spread, k.data_ptr() if spread else None,
            _cuda.stream_of(out.device))
    _cuda.check(err, "bump_scan_kernel")
    BUMP_LAUNCHES += 1
    return out
