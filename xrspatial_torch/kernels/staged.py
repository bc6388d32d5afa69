"""The plan of the persistent, TMA-staged window ring of the 3x3 stencil
kernels (``csrc/staged_window.cuh``): the surface kernel B1
(``csrc/surface.cu::surface_staged_kernel``, planned by
``kernels/surface.py::surface_plan``), the stacked surface kernel B0
(planned by ``kernels/surface.py::stacked_plan``) and the stencil probes
B8c and B8d (``csrc/stencil_probe.cu::stencil_staged_kernel``).

``staged_plan`` says how a tile's window is staged (the TMA box, the
ring's stages and shared bytes, the route, the walk's tiles, the
persistent grid) and refuses a tile that breaks a rule of the box or of
shared memory, naming it.  The launchers check the same numbers.
``tile_origin`` is the walk's first row and column of a tile, as the
ring's ``tile_origin`` computes it: walk "full" (every kernel's) tiles
the raster from (0, 0); walk "interior" (the stencil probes B8e, B8f)
tiles output rows [1, h - 1) and columns [4, w - 4) with the last row
and column of tiles pulled back inside, so that no window leaves the
raster.
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["SMEM_PER_BLOCK", "SMEM_PER_SM", "BARRIER_BYTES", "ALIGN_SLACK",
           "MAX_STAGES", "BLOCKS_PER_SM", "TMA_BOX_MAX", "WALKS", "StagedPlan",
           "walk_tiles", "tile_origin", "staged_plan"]

SMEM_PER_BLOCK = 232448    # shared memory a block can use on an H100
SMEM_PER_SM = 233472       # an SM's 228 KB, of which 1 KB a block is reserved
BARRIER_BYTES = 128        # the stages' mbarriers
ALIGN_SLACK = 128          # room to align the ring to 128 bytes
MAX_STAGES = 4
BLOCKS_PER_SM = 2
TMA_BOX_MAX = 256          # elements in each dimension of a TMA box
WALKS = ("full", "interior")


class StagedPlan(NamedTuple):
    box: tuple          # (columns, rows) of a tile's window: the TMA box
    stages: int         # windows in the shared-memory ring
    stage_bytes: int    # one window, rounded up to 128 bytes
    shared_bytes: int   # the dynamic shared memory a block asks for
    route: str          # "tma" or "async" (4-byte cp.async copies)
    tiles: int          # output tiles of the walk
    grid: int           # persistent blocks, at most BLOCKS_PER_SM an SM


def walk_tiles(h: int, w: int, tile, walk: str = "full") -> tuple:
    """(rows, columns) of tiles of `walk` over an (h, w) raster at `tile`:
    "interior" covers (h - 2) x (w - 8) cells, and has no tile where
    h - 2 < TH or w - 8 < TW."""
    th, tw = tile
    if walk == "full":
        return -(-h // th), -(-w // tw)
    if walk != "interior":
        raise ValueError(f"walk {walk!r}: the ring has walks {WALKS}")
    if h - 2 < th or w - 8 < tw:
        return 0, 0
    return -(-(h - 2) // th), -(-(w - 8) // tw)


def tile_origin(t: int, h: int, w: int, tile, walk: str = "full") -> tuple:
    """(r0, c0), the first row and column of tile `t` (row-major) of
    `walk`: ``csrc/staged_window.cuh::tile_origin``."""
    th, tw = tile
    tx = walk_tiles(h, w, tile, walk)[1]
    ty, t_x = divmod(t, tx)
    if walk == "full":
        return ty * th, t_x * tw
    return 1 + min(ty * th, h - 2 - th), 4 + min(t_x * tw, w - 8 - tw)


def staged_plan(h: int, w: int, tile, ptr: int = 0, sms: int = 132,
                blocks_per_sm: int = BLOCKS_PER_SM, row_pad: int = 0,
                stages: int | None = None, walk: str = "full") -> StagedPlan:
    """How a staged kernel runs an (h, w) raster at `tile` = (rows,
    columns), from input address `ptr` (the outputs are allocated 16-byte
    aligned), on `sms` SMs.

    A tile's window is its rows with a 1-row halo and its columns with a
    4-column halo on each side: TMA refuses an innermost start coordinate
    that is not a multiple of 16 bytes, so the window starts at column
    c0 - 4.  Rules, each refused by name: the width a multiple of 4 (each
    thread stores 16 bytes, and c0 - 4 is 16-byte aligned); each box
    dimension at most 256; the stages within a block's shared memory.  The
    ring takes `stages` windows (2 .. MAX_STAGES), by default as many as
    let `blocks_per_sm` blocks share an SM, up to 4, and never fewer than
    2.  A window row holds the box's columns and `row_pad` floats more
    (the stacked surface kernel's phased route: 4).  The route is TMA when
    the row pitch and the base are 16-byte aligned (``w % 4 == 0``,
    ``ptr % 16 == 0``), else cp.async.  `walk` says which tiles the
    blocks walk (``walk_tiles``); an interior walk with no tile has grid 0
    and is not launched.
    """
    th, tw = tile
    if th < 1 or tw < 4 or tw % 4:
        raise ValueError(f"staged tile {th}x{tw}: the width must be a "
                         f"positive multiple of 4 (each thread stores 16 "
                         f"bytes)")
    box = (tw + 8, th + 2)
    if max(box) > TMA_BOX_MAX:
        raise ValueError(f"staged tile {th}x{tw}: its window is a {box[0]}x"
                         f"{box[1]} TMA box, and a box dimension is at most "
                         f"{TMA_BOX_MAX}")
    stage_bytes = -(-((box[0] + row_pad) * box[1] * 4) // 128) * 128
    fixed = BARRIER_BYTES + ALIGN_SLACK
    if stages is None:
        shared_of_one = SMEM_PER_SM // blocks_per_sm - 1024
        stages = max(2, min(MAX_STAGES,
                            (shared_of_one - fixed) // stage_bytes))
    elif not 2 <= stages <= MAX_STAGES:
        raise ValueError(f"staged tile {th}x{tw}: {stages} stages; the ring "
                         f"takes 2 to {MAX_STAGES}")
    shared = fixed + stages * stage_bytes
    if shared > SMEM_PER_BLOCK:
        raise ValueError(f"staged tile {th}x{tw}: {stages} stages of its "
                         f"window need {shared} bytes of shared memory, more "
                         f"than the {SMEM_PER_BLOCK} a block can use")
    route = "tma" if w % 4 == 0 and ptr % 16 == 0 else "async"
    ty, tx = walk_tiles(h, w, tile, walk)
    tiles = ty * tx
    per_sm = min(blocks_per_sm, SMEM_PER_SM // (shared + 1024))
    return StagedPlan(box, stages, stage_bytes, shared, route, tiles,
                      min(tiles, per_sm * sms))
