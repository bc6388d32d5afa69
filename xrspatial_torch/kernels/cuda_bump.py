"""Wrapper of the bump kernel X2 (``csrc/bump.cu``).

``bump_scan_cuda`` adds every bump of a bump map in order, in float64, in
one launch.  It replaces no Pallas kernel: the JAX package runs the walk
as a ``lax.scan`` of XLA (``xrspatial_tpu/bump.py::_scan_bumps``) and, at
spread 0, one scatter-add (``_scan_bumps_nospread``).  Its plain version
is ``kernels/bump.py::bump_scan_twin``, which both routes equal bit for
bit:

- "rounds" (the default): ``bump_rounds_kernel``, one cooperative launch
  that runs rounds of bumps whose footprints do not overlap across the
  card while a round makes at least ``rounds_threshold()`` bumps ready,
  then walks the rest in order in one block;
- "simple": the first port, ``bump_scan_kernel``, one block walking every
  bump, by name.

The wrapper takes a contiguous (H, W) float64 map on the card, the
bumps' (N, 2) integer locations (x, y) and (N,) heights; it checks that
every location lies inside the map, uploads the ring's table ``d2 /
spread^2`` (float64, computed on the host), allocates the rounds' owner
map (8 bytes a cell) and lists, launches on PyTorch's current stream and
raises if the launch fails.  It never falls back from one route to the
other, or to the twin.  On the rounds route it then reads the kernel's
counts back (one synchronisation) into the counters below.
"""

from __future__ import annotations

import torch

from . import _cuda
from .bump import ring_table, rounds_threshold

__all__ = ["bump_scan_cuda", "ROUTES", "BUMP_LAUNCHES",
           "BUMP_SIMPLE_LAUNCHES", "BUMP_ROUNDS", "BUMP_ROUND_BUMPS",
           "BUMP_TAIL_BUMPS"]

ROUTES = ("rounds", "simple")

# in this process, for checks that a path ran on the kernel: launches on
# every route, the first port's among them, and on the rounds route the
# rounds, the bumps done in them and the bumps the walk took after them
BUMP_LAUNCHES = 0
BUMP_SIMPLE_LAUNCHES = 0
BUMP_ROUNDS = 0
BUMP_ROUND_BUMPS = 0
BUMP_TAIL_BUMPS = 0

_INT_MAX = 2 ** 31 - 1


def bump_scan_cuda(out: torch.Tensor, locs: torch.Tensor,
                   heights: torch.Tensor, spread: int, route=None,
                   threshold=None) -> torch.Tensor:
    """Add the bumps to `out` in place, in order; returns `out`.

    `route` None or "rounds" takes the redesigned kernel, "simple" the
    first port.  `threshold` (rounds only) overrides the plan's: 0 runs
    rounds until every bump is done, ``math.inf`` leaves every bump to
    the walk.
    """
    global BUMP_LAUNCHES, BUMP_SIMPLE_LAUNCHES, BUMP_ROUNDS
    global BUMP_ROUND_BUMPS, BUMP_TAIL_BUMPS
    route = route or "rounds"
    if route not in ROUTES:
        raise ValueError(f"bump_scan_cuda: route {route!r} is not one of "
                         f"{ROUTES}")
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
    if route == "rounds" and (h * w > _INT_MAX or n > _INT_MAX):
        raise ValueError(f"bump_scan_cuda: the rounds take fewer than 2^31 "
                         f"cells and bumps, got {h}x{w} and {n}")
    if threshold is not None and (route != "rounds" or threshold < 0):
        raise ValueError(f"bump_scan_cuda: threshold {threshold} needs the "
                         f"rounds route and a count >= 0")
    locs = locs.to(device=out.device, dtype=torch.int32).contiguous()
    heights = heights.to(device=out.device, dtype=torch.float64).contiguous()
    if n == 0:
        return out
    lo, hi = (v.tolist() for v in torch.stack(
        torch.aminmax(locs, dim=0)).cpu())      # one round trip
    if min(lo) < 0 or hi[0] >= w or hi[1] >= h:
        raise ValueError(f"bump_scan_cuda: locations outside the {h}x{w} "
                         f"map (x in [{lo[0]}, {hi[0]}], y in [{lo[1]}, "
                         f"{hi[1]}])")
    k = (torch.from_numpy(ring_table(spread)).to(out.device) if spread
         else None)
    k_ptr = k.data_ptr() if spread else None
    lib = _cuda.library()
    stream = _cuda.stream_of(out.device)
    if route == "simple":
        with torch.cuda.device(out.device):
            err = lib.bump_scan_launch(
                out.data_ptr(), locs.data_ptr(), heights.data_ptr(), n, h, w,
                spread, k_ptr, stream)
        _cuda.check(err, "bump_scan_kernel")
        BUMP_LAUNCHES += 1
        BUMP_SIMPLE_LAUNCHES += 1
        return out

    if threshold is None:
        threshold = rounds_threshold()
    threshold = int(min(threshold, _INT_MAX))
    dev = out.device
    with torch.cuda.device(dev):
        grid = lib.bump_rounds_grid(n)
        if grid < 1:
            raise RuntimeError("bump_scan_cuda: the device takes no "
                               "cooperative launch of bump_rounds_kernel")
        owner = torch.empty(h * w, dtype=torch.int64, device=dev)
        lists = torch.empty(2 * n, dtype=torch.int32, device=dev)
        counts = torch.empty(grid, dtype=torch.int32, device=dev)
        counted = torch.zeros(3, dtype=torch.int64, device=dev)
        err = lib.bump_rounds_launch(
            out.data_ptr(), owner.data_ptr(), lists.data_ptr(),
            lists[n:].data_ptr(), counts.data_ptr(), counted.data_ptr(),
            locs.data_ptr(), heights.data_ptr(), n, h, w, spread, k_ptr,
            threshold, grid, stream)
    _cuda.check(err, "bump_rounds_kernel")
    BUMP_LAUNCHES += 1
    rounds, round_bumps, tail = counted.tolist()
    BUMP_ROUNDS += rounds
    BUMP_ROUND_BUMPS += round_bumps
    BUMP_TAIL_BUMPS += tail
    return out
