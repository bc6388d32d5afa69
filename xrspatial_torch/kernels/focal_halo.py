"""The large-footprint focal kernel's plan: routes, tiles, windows, runs.

``csrc/focal_halo.cu`` ports ``xrspatial_tpu/kernels/pallas_window.py::
focal_stats_pallas`` (wrapper ``cuda_window.focal_stats_halo_cuda``) in
three routes, which ``halo_plan`` chooses between:

- "tma": each block stages its output tile's whole halo window in shared
  memory once, with TMA boxes whose out-of-bounds fill is NaN, then walks
  the footprint as row runs, four cells along x a thread, and stores each
  plane 4 cells at a time;
- "async": the same kernel, the window staged by 4-byte ``cp.async``
  copies (NaN stores outside the raster), for a pitch or base TMA refuses
  (``w % 4 != 0`` or a base that is not 16-byte aligned);
- "ring": the first port, input rows staged one footprint row at a time
  in a ring of 8 rows, only where no tile's window fits in a block's
  shared memory (a sparse footprint of radius 500, say).

The same staged template serves the footprints within the tiled radii
(``focal_stats_cuda``, the port of ``pallas_window2.py::
focal_stats_tiled``) and beyond them (``focal_stats_halo_cuda``): every
footprint of at most 1024 offsets with ry <= 32 and rx <= 256 fits a
staged window.  The choice of tile and blocks an SM is ``halo_plan``'s
and ``register_class``'s alone, pinned by the CPU tests; the launcher checks only what keeps a launch safe (the
route rule, box sizes, a window that covers the tile and its halo, shared
bytes that hold it, a grid of one block a tile) and refuses a plan that
fails.
``footprint_runs`` and ``run_table`` give the kernel its footprint: runs
of consecutive ``dx`` in one footprint row, in offsets order, each as the
window address of lane 0's first value.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

__all__ = ["TILE_COLS", "TILE_ROWS", "CELLS", "HaloPlan", "footprint_runs",
           "halo_plan", "register_class", "run_table"]

TILE_COLS = 128            # a warp's 32 lanes x CELLS cells along x
CELLS = 4                  # cells along x a thread
TILE_ROWS = (32, 16, 8)    # tried in this order; 8 warps share the rows
TMA_BOX_MAX = 256          # elements in each dimension of a TMA box
SMEM_PER_BLOCK = 232448    # shared memory a block can use on an H100
SMEM_PER_SM = 233472       # an SM's 228 KB, of which 1 KB a block is reserved
ALIGN_SLACK = 128          # room to align the barrier and window to 128 bytes
BARRIER_BYTES = 128        # the window's mbarrier
READ_SLACK = 64            # a run's 16-byte loads read up to 8 floats past
                           # the window's last row
RING_TILE = (8, 32)        # the ring kernel's output tile
REGISTER_CLASSES = (3, 2)  # blocks an SM the staged kernel is compiled for
RING_MAX_RX = 511          # the ring's widest staged row radius


class HaloPlan(NamedTuple):
    route: str          # "tma", "async" or "ring"
    tile: tuple         # (rows, columns) of an output tile
    pad: int            # window columns on each side of a tile (ring: rxs)
    pitch: int          # floats a window row (a multiple of 32)
    rows: int           # window rows staged (whole boxes)
    box: tuple          # (columns, rows) of a TMA box; (0, 0) on the ring
    boxes: int          # TMA boxes a window
    shared_bytes: int   # the dynamic shared memory a block asks for
    blocks_per_sm: int  # blocks an SM holds at that shared memory
    grid: int           # blocks: one a tile (the ring: its 2D grid's size)


def footprint_runs(offsets) -> Tuple[Tuple[int, int, int], ...]:
    """(dy, dx0, length) runs of the (dy, dx) offsets, in their order:
    consecutive offsets with equal dy and dx one more than the last join
    one run.  Expanding the runs gives the offsets back in order."""
    runs = []
    for dy, dx in offsets:
        if runs and runs[-1][0] == dy and runs[-1][1] + runs[-1][2] == dx:
            runs[-1][2] += 1
        else:
            runs.append([int(dy), int(dx), 1])
    return tuple(map(tuple, runs))


def _radii(offsets, min_radius: int = 0) -> tuple:
    return (max(max(abs(dy) for dy, _ in offsets), min_radius),
            max(max(abs(dx) for _, dx in offsets), min_radius))


def _window(rx: int) -> tuple:
    """(pad, pitch, box columns, boxes a row) of a window around a tile of
    TILE_COLS columns for a footprint of radius rx along x.

    The window starts `pad` columns (rx rounded up to 4) left of the tile,
    so its first column is 16-byte aligned, as TMA needs of a box's
    innermost coordinate.  A row is one box wide when it fits in 256
    columns, else as many boxes of equal width as it needs, one row each;
    box widths and the pitch are multiples of 32 floats, so that every
    box lands on a 128-byte boundary.
    """
    def up(a, b):
        return -(-a // b) * b

    pad = up(rx, 4)
    width = up(TILE_COLS + 2 * pad, 32)
    per_row = -(-width // TMA_BOX_MAX)
    box_cols = up(-(-width // per_row), 32)
    return pad, per_row * box_cols, box_cols, per_row


def _ring_plan(h: int, w: int, n: int, rx: int) -> HaloPlan:
    rxs = min(rx, RING_MAX_RX)
    th, tw = RING_TILE
    shared = 2 * n * 4 + th * (tw + 2 * rxs) * 4
    grid = -(-w // tw) * min(-(-h // th), 65535)
    return HaloPlan("ring", RING_TILE, rxs, tw + 2 * rxs, th, (0, 0), 0,
                    shared, min(8, SMEM_PER_SM // (shared + 1024)), grid)


def halo_plan(h: int, w: int, offsets, ptr: int = 0,
              min_radius: int = 0) -> HaloPlan:
    """How the large-footprint focal kernel runs an (h, w) float32 raster
    at input address `ptr` over `offsets`, its window's radii at least
    `min_radius` (the fused pipeline's surface half needs 1).

    A block stages the window of one tile (TILE_ROWS rows x 128 columns,
    with ry rows and `pad` columns of halo on each side) and the run
    table.  The tile keeps 32 rows where two such blocks fit an SM (one
    block's staging then hides under the other's arithmetic), else 16,
    else 8; then the same with one block an SM; the ring route only where
    no window fits a block.  The window's rows come in whole boxes of at
    most 256 rows when a row is one box wide, else one box a row and
    column group.  TMA stages it where the row pitch and the base are
    16-byte aligned (``w % 4 == 0``, ``ptr % 16 == 0``), cp.async
    elsewhere.
    """
    offsets = tuple(offsets)
    ry, rx = _radii(offsets, min_radius)
    pad, pitch, box_cols, per_row = _window(rx)
    table = -(-len(footprint_runs(offsets)) * 8 // 128) * 128
    route = "tma" if w % 4 == 0 and ptr % 16 == 0 else "async"
    tiles_x = -(-w // TILE_COLS)
    for per_sm in (2, 1):
        limit = min(SMEM_PER_BLOCK, SMEM_PER_SM // per_sm - 1024)
        for th in TILE_ROWS:
            rows = th + 2 * ry
            if per_row == 1:
                chunks = -(-rows // TMA_BOX_MAX)
                box_rows = -(-rows // chunks)
                rows, boxes = chunks * box_rows, chunks
            else:
                box_rows, boxes = 1, rows * per_row
            shared = (ALIGN_SLACK + BARRIER_BYTES + table
                      + rows * pitch * 4 + READ_SLACK)
            if shared <= limit:
                return HaloPlan(route, (th, TILE_COLS), pad, pitch, rows,
                                (box_cols, box_rows), boxes, shared, per_sm,
                                -(-h // th) * tiles_x)
    return _ring_plan(h, w, len(offsets), rx)


def register_class(plan: HaloPlan) -> int:
    """The blocks an SM the staged kernel is compiled for on `plan` (its
    ``__launch_bounds__``, so its register cap: 80 registers a thread at 3,
    128 at 2): 3 where three of the plan's windows fit an SM's shared
    memory, else 2.  A third block hides more of the window's staging and
    the stores; four blocks (64 registers a thread) spill."""
    if plan.route == "ring":
        raise ValueError("the ring route is not the staged kernel")
    for blocks in REGISTER_CLASSES:
        if blocks * (plan.shared_bytes + 1024) <= SMEM_PER_SM:
            return blocks
    return REGISTER_CLASSES[-1]


def run_table(offsets, plan: HaloPlan,
              min_radius: int = 0) -> Tuple[Tuple[int, int], ...]:
    """The staged kernel's footprint: for each run of ``footprint_runs``,
    ``(quad, code)``: ``quad`` is the 16-byte group of the window (row
    dy + ry, column pad + dx0) that lane 0's first cell reads first,
    rounded down, and ``code`` is ``(pad + dx0) % 4 + 4 * length``; ry
    is the window's row radius, at least `min_radius` as in the plan."""
    if plan.route == "ring":
        raise ValueError("the ring route takes the offsets, not runs")
    ry, _ = _radii(offsets, min_radius)
    table = []
    for dy, dx0, length in footprint_runs(offsets):
        col = plan.pad + dx0
        table.append(((dy + ry) * (plan.pitch // 4) + col // 4,
                      col % 4 + 4 * length))
    return tuple(table)
