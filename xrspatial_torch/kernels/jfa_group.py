"""A group of small-stride jump-flood rounds in one kernel launch.

Counterpart of the TPU probe ``tools/exp_jfa_fixed.py::multi_round_fixed``:
the strides ``ks`` (H = sum(ks)) run over one window of (T+2H)^2 cells a
block, whose T x T centre is the output (``csrc/jfa_group.cu``, wrapper
``cuda_jfa_group.py``).  The result equals the round kernel applied round
by round over the same strides, bit for bit, so the plain versions here
loop the round twins of ``jfa_rounds``.  Both state forms of the round
kernel, every metric of each, and no value plane (as in the TPU probe).

Two routes, which ``window_plan`` plans:

- "single" (the default): the window is staged once by TMA (``stage``
  "tma"; 4-byte cp.async where TMA refuses the pitch or a base, ``stage``
  "async") and held once: each round every thread computes its cells'
  new states into registers, then a barrier, the stores, a barrier.  A
  round's region is one flat index over its side^2 cells, so every lane
  has a cell.  A thread holds at most ``REG_WORDS`` 32-bit words of new
  state (its cells of the first, largest region times the planes); the
  plan refuses a tile that needs more.
- "double": the first port, the window held twice (the round-start values
  and the round's output), kept by name for the A/B and the bit check.

Shared memory is what limits a group: a block may use 227 KB
(``SHARED_BYTES``), and a TMA box is at most 256 cells a side.
``window_plan`` takes the largest tile whose window fits and raises ``ValueError``, naming the bytes, for a group whose window
fits at none: the TPU probe's group (64, 32, 16, 8, 4, 2, 1, 2, 1), H =
130, is one.  Proximity's 16384^2 schedule ends with ``TAIL`` (H = 34),
which fits single-buffered at T = 128 packed, T = 64 coordinates.

``group_packed`` and ``group_coords`` dispatch: a tensor on the CPU goes
to the twin, a tensor on the card to the kernel; both refuse a group that
the kernel cannot take.
"""

from __future__ import annotations

from typing import NamedTuple

from .jfa_rounds import EUCLIDEAN, GREAT_CIRCLE, MANHATTAN
from .jfa_rounds import round_coords, round_packed

__all__ = ["TILES", "SINGLE_THREADS", "SHARED_BYTES", "MAX_ROUNDS", "TAIL",
           "REG_WORDS", "GroupPlan", "window_plan", "group_packed_twin",
           "group_coords_twin", "group_packed", "group_coords"]

TILES = (128, 64, 32, 16, 8)     # tile edges T, largest first
SINGLE_THREADS = 1024            # threads a block of the single route
SHARED_BYTES = 232448            # shared memory a block may opt in to
ALIGN_SLACK = 128                # room to align the barrier and window
BARRIER_BYTES = 128              # the window's mbarrier
TMA_BOX_MAX = 256                # cells in each dimension of a TMA box
REG_WORDS = 32                   # new-state words a thread holds a round
CELL_CLASSES = (16, 28)          # cells a thread the kernel is built for
MAX_ROUNDS = 16                  # strides a launch takes (csrc/jfa_group.cu)
# the last 7 rounds of proximity's schedule at 16384^2
TAIL = (16, 8, 4, 2, 1, 2, 1)


class GroupPlan(NamedTuple):
    route: str          # "single" or "double"
    stage: str          # single: "tma" or "async"; double: ""
    tile: int           # T: the output tile's edge
    halo: int           # H = sum(ks)
    pad: int            # single: window columns left of the halo's first
                        # (H rounded up to 4, so a box starts 16-byte
                        # aligned); double: H
    pitch: int          # cells a window row
    rows: int           # window rows (T + 2H)
    cells: int          # single: the cells a thread the kernel is built
                        # for (CELL_CLASSES); double: 0
    shared_bytes: int   # dynamic shared memory a block asks for


def _up(a, b):
    return -(-a // b) * b


def _single(ks, planes, t, stage):
    h = sum(ks)
    pad = _up(h, 4)
    rows, pitch = t + 2 * h, t + 2 * pad
    nbytes = ALIGN_SLACK + BARRIER_BYTES + planes * _up(rows * pitch * 4, 128)
    side0 = t + 2 * (h - ks[0])
    per_thread = -(-side0 * side0 // SINGLE_THREADS)
    cells = next((c for c in CELL_CLASSES if per_thread <= c
                  and c * planes <= REG_WORDS), 0)
    ok = (rows <= TMA_BOX_MAX and pitch <= TMA_BOX_MAX
          and nbytes <= SHARED_BYTES and cells > 0)
    return GroupPlan("single", stage, t, h, pad, pitch, rows, cells,
                     nbytes), ok


def _double(ks, planes, t):
    h = sum(ks)
    side = t + 2 * h
    nbytes = 2 * planes * 4 * side ** 2
    return GroupPlan("double", "", t, h, h, side, side, 0,
                     nbytes), nbytes <= SHARED_BYTES


def window_plan(ks, form: str, route: str = "single", w: int = 0,
                ptr: int = 0, tile: int | None = None) -> GroupPlan:
    """The plan of the group `ks` in `form` ("packed": one int32 plane,
    "coords": two float32 planes) on `route`, for a raster `w` wide whose
    planes lie at addresses whose bitwise OR is `ptr` (the single route
    stages by TMA where ``w % 4 == 0`` and ``ptr % 16 == 0``, by cp.async
    elsewhere).  The first tile of ``TILES`` that fits, or `tile`.
    Raises ValueError for a bad group, or one whose window fits at no tile
    tried."""
    ks = tuple(int(k) for k in ks)
    if not ks or len(ks) > MAX_ROUNDS or min(ks) < 1:
        raise ValueError(f"a group is 1 to {MAX_ROUNDS} strides >= 1, got "
                         f"{ks}")
    if form not in ("packed", "coords"):
        raise ValueError(f"form is 'packed' or 'coords', got {form!r}")
    if route not in ("single", "double"):
        raise ValueError(f"route is 'single' or 'double', got {route!r}")
    planes = 1 if form == "packed" else 2
    stage = "tma" if w % 4 == 0 and ptr % 16 == 0 else "async"
    tries = [_single(ks, planes, t, stage) if route == "single"
             else _double(ks, planes, t)
             for t in TILES if tile is None or t == tile]
    for plan, ok in tries:
        if ok:
            return plan
    if not tries:
        raise ValueError(f"tile is one of {TILES}, got {tile}")
    last = tries[-1][0]
    raise ValueError(
        f"the {form} window of group {ks} (H = {sum(ks)}) on the {route} "
        f"route needs {last.shared_bytes} bytes of shared memory at T = "
        f"{last.tile} (a {last.rows} x {last.pitch} window), or fits none "
        f"of: the {SHARED_BYTES} bytes a block may use, a TMA box of "
        f"{TMA_BOX_MAX} a side, {REG_WORDS} words of new state a thread")


def group_packed_twin(state, ks, metric: int, steps):
    """The rounds `ks` over the packed int32 state, one round twin at a
    time; returns the new state."""
    for k in ks:
        state, _, _ = round_packed(state, None, int(k), metric, steps)
    return state


def group_coords_twin(tx, ty, xs, ys, ks, metric: int):
    """The rounds `ks` over the float32 coordinate state; returns (tx,
    ty)."""
    for k in ks:
        tx, ty, _ = round_coords(tx, ty, None, xs, ys, int(k), metric)
    return tx, ty


def _check_metric(form, metric):
    allowed = (EUCLIDEAN, MANHATTAN) if form == "packed" else (
        EUCLIDEAN, GREAT_CIRCLE, MANHATTAN)
    if metric not in allowed:
        raise ValueError(f"the {form} state takes metrics {allowed}, got "
                         f"{metric}")


def group_packed(state, ks, metric: int, steps, route: str = "single"):
    """The group `ks` over the packed state on its device (on the card, on
    `route`)."""
    window_plan(ks, "packed", route)
    _check_metric("packed", metric)
    if state.device.type == "cpu":
        return group_packed_twin(state, ks, metric, steps)
    from .cuda_jfa_group import group_packed_cuda
    return group_packed_cuda(state, ks, metric, steps, route)


def group_coords(tx, ty, xs, ys, ks, metric: int, route: str = "single"):
    """The group `ks` over the coordinate state on its device (on the card,
    on `route`)."""
    window_plan(ks, "coords", route)
    _check_metric("coords", metric)
    if tx.device.type == "cpu":
        return group_coords_twin(tx, ty, xs, ys, ks, metric)
    from .cuda_jfa_group import group_coords_cuda
    return group_coords_cuda(tx, ty, xs, ys, ks, metric, route)
