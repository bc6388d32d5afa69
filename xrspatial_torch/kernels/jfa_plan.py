"""The jump-flood round kernel's plan: one route a round, chosen by stride.

``csrc/jfa.cu`` (wrapper ``cuda_jfa.py``) runs one round of the jump flood
(``jfa_rounds.round_packed`` / ``round_coords``) on one of three routes,
which ``round_plan`` chooses for each round from the raster's shape, the
stride, the state form, the value plane and the planes' addresses:

- "staged": each block of 256 threads stages the window of its tile
  (32 rows x 128 columns, with k rows above and below and ``pad`` = k
  rounded up to 4 columns on each side) of every plane in shared memory,
  by TMA (``stage`` "tma", one box a plane) or, where TMA refuses the
  pitch or a base (``w % 4 != 0``, an address that is not 16-byte
  aligned), by 4-byte cp.async (``stage`` "async"); cells outside the
  raster hold the no-target sentinel.  Each thread then evaluates 4 cells
  along x from 16-byte shared loads, with no bounds test.  It takes k = 1,
  2 (where 16-byte loads at c +- k would be misaligned) and any k that is
  a multiple of 4 whose window fits a 256-wide box (k <= 64).
- "vector": each thread owns 4 consecutive cells of one row and makes 9
  unconditional 16-byte loads, one a candidate position, from device
  memory; a position outside the raster gets a clamped address and the
  sentinel.  It needs ``w % 4 == 0``, k a multiple of 4, 16-byte aligned
  planes and ``h * w < 2**31`` (32-bit offsets).  Where 2k rows of state
  pass half of the L2 cache, blocks take the rows in k-phase order
  (r, r + k, r + 2k, ...), so that each row band comes from device memory
  about once a round (``phased``).
- "simple": the first port, one thread a cell in 32x8 blocks with bounds
  tests, where neither new route can run; also callable by name.

Where the routes hand over was set from the per-stride table of
``chip_smoke.py``'s phase 8 on an H100 (PERF.md §6): the staged
route beat the vector route at every k <= 32 whose window let two blocks
share an SM (``STAGED_MAX_K``, ``STAGED_MAX_BYTES``) and lost by 2.5x at
k = 64 (164 KB, one block an SM); k-phase order beat row order from k =
256 on a sparse state and lost at k = 128, so it starts where 2k rows of
state pass half of L2 (``PHASE_FRACTION``).  The plan is pure Python and
the CPU tests pin it; the launcher checks only the rules that keep a
launch safe and refuses a plan that breaks one.
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["ROUTES", "RoundPlan", "round_plan", "STAGED_MAX_K",
           "STAGED_MAX_BYTES", "PHASE_FRACTION",
           "TILE_COLS", "CELLS", "THREADS", "TMA_BOX_MAX", "L2_BYTES",
           "phase_rows", "state_planes"]

ROUTES = ("staged", "vector", "simple")
THREADS = 256              # threads a block, staged and vector routes
CELLS = 4                  # cells along x a thread
TILE_COLS = THREADS // 8 * CELLS   # a warp's 32 lanes x 4 cells: 128
STAGED_ROWS = 32           # rows of a staged tile; 8 warps share them
STAGED_MAX_K = 32          # the largest stride the plan sends to "staged"
STAGED_MAX_BYTES = 233472 // 2 - 1024   # ... at two blocks an SM
PHASE_FRACTION = 2         # k-phase order where 2k rows pass L2 / this
TMA_BOX_MAX = 256          # elements in each dimension of a TMA box
SMEM_PER_BLOCK = 232448    # shared memory a block can use on an H100
ALIGN_SLACK = 128          # room to align the barrier and windows to 128 B
BARRIER_BYTES = 128        # the window's mbarrier
L2_BYTES = 50 * 2 ** 20    # an H100's L2 cache
SIMPLE_TILE = (8, 32)      # the first port's block: 8 rows x 32 columns
MAX_GRID_Y = 65535


class RoundPlan(NamedTuple):
    route: str          # "staged", "vector" or "simple"
    stage: str          # staged: "tma" or "async"; else ""
    tile: tuple         # (rows, columns) of cells a block
    pad: int            # staged: window columns left of the tile
    pitch: int          # staged: cells a window row (the TMA box's width)
    rows: int           # staged: window rows (the TMA box's height)
    planes: int         # planes a round reads (state planes + value)
    shared_bytes: int   # dynamic shared memory a block asks for
    phased: bool        # vector: rows in k-phase order
    grid: int           # blocks


def state_planes(form: str) -> int:
    """32-bit planes of the state: 1 packed, 2 coordinates (tx, ty)."""
    if form not in ("packed", "coords"):
        raise ValueError(f"form is 'packed' or 'coords', got {form!r}")
    return 1 if form == "packed" else 2


def _up(a: int, b: int) -> int:
    return -(-a // b) * b


def _staged(h, w, k, planes, aligned) -> RoundPlan | None:
    if not (k in (1, 2) or k % 4 == 0):
        return None
    pad = _up(k, 4)
    pitch = TILE_COLS + 2 * pad
    if pitch > TMA_BOX_MAX:
        return None
    rows = STAGED_ROWS + 2 * k
    shared = ALIGN_SLACK + BARRIER_BYTES + planes * _up(rows * pitch * 4, 128)
    if rows > TMA_BOX_MAX or shared > SMEM_PER_BLOCK:
        return None
    return RoundPlan("staged", "tma" if aligned else "async",
                     (STAGED_ROWS, TILE_COLS), pad, pitch, rows, planes,
                     shared, False, -(-h // STAGED_ROWS) * -(-w // TILE_COLS))


def _vector(h, w, k, planes, state, aligned, phased) -> RoundPlan | None:
    if not (aligned and w % 4 == 0 and k % 4 == 0 and h * w < 2 ** 31):
        return None
    if phased is None:
        phased = 2 * k * w * 4 * state > L2_BYTES // PHASE_FRACTION
    per_row = -(-(w // CELLS) // THREADS)
    return RoundPlan("vector", "", (1, THREADS * CELLS), 0, 0, 0, planes, 0,
                     bool(phased), h * per_row)


def _simple(h, w, planes) -> RoundPlan:
    th, tw = SIMPLE_TILE
    grid = -(-w // tw) * min(-(-h // th), MAX_GRID_Y)
    return RoundPlan("simple", "", SIMPLE_TILE, 0, 0, 0, planes, 0, False,
                     grid)


def round_plan(h: int, w: int, k: int, form: str, with_val: bool,
               ptr: int = 0, route: str | None = None,
               phased: bool | None = None) -> RoundPlan:
    """How one round at stride `k` runs on an (h, w) state of `form`
    ("packed" or "coords"), with or without a value plane, whose planes
    (inputs and outputs) lie at addresses whose bitwise OR is `ptr`.

    With `route` None the plan takes the staged route for k <=
    STAGED_MAX_K where its window lets two blocks share an SM (always at
    k = 1, 2, which the vector route cannot take), else the vector route,
    and the simple route where the one it takes cannot run.  A `route`
    by name must be able to run (ValueError otherwise).  `phased` forces
    the vector route's row order.
    """
    state = state_planes(form)
    planes = state + (1 if with_val else 0)
    k, h, w = int(k), int(h), int(w)
    if k < 1 or h < 1 or w < 1:
        raise ValueError(f"round_plan: k, h, w must be >= 1, got {k}, {h}, "
                         f"{w}")
    aligned = ptr % 16 == 0 and w % 4 == 0
    plans = {"staged": _staged(h, w, k, planes, aligned),
             "vector": _vector(h, w, k, planes, state, aligned, phased),
             "simple": _simple(h, w, planes)}
    if route is not None:
        if route not in ROUTES:
            raise ValueError(f"route is one of {ROUTES}, got {route!r}")
        if plans[route] is None:
            raise ValueError(f"the {route} route cannot take a {form} round "
                             f"at k = {k} on {h}x{w} (w % 4 = {w % 4}, "
                             f"ptr % 16 = {ptr % 16})")
        return plans[route]
    staged = plans["staged"]
    if staged is not None and k <= STAGED_MAX_K and (
            staged.shared_bytes <= STAGED_MAX_BYTES or k % 4 != 0):
        return staged
    return plans["vector"] or plans["simple"]


def phase_rows(h: int, k: int) -> list:
    """The rows in the vector route's k-phase order: p, p + k, p + 2k, ...
    for p = 0 .. k - 1; the kernel maps its row slot t to row
    ``phase_rows(h, k)[t]`` with the same arithmetic."""
    q, rem = divmod(h, k)
    rows = []
    for t in range(h):
        if t < rem * (q + 1):
            p, j = divmod(t, q + 1)
        else:
            p, j = divmod(t - rem * (q + 1), q)
            p += rem
        rows.append(p + j * k)
    return rows
