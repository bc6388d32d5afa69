"""The large-footprint focal kernel's plan and algorithm, on the CPU.

``kernels/focal_halo.py`` plans ``csrc/focal_halo.cu``: the route (TMA,
cp.async or the ring), the tile, the window's pad, pitch, rows and TMA
boxes, the shared bytes and the grid.  Its launcher checks only that a
plan is safe to launch (the rules of
``test_halo_plan_keeps_the_box_and_shared_memory_rules``), so the choice
of tile and blocks an SM is pinned here.  ``footprint_runs`` and
``run_table`` give the staged kernel its footprint.
``kernels/emulate.py::emulate_staged`` is a torch emulation of the staged kernel's algorithm: each tile's window
with its NaN fill, the run table's addresses, four cells along x a lane,
offsets order in every cell, and the NaN-free branch that takes the count
from the number of offsets.  It must equal ``window_stats``, the kernel's
plain version, bit for bit (the same float32 operations in the same
order), and ``window_stats`` must match the JAX package's twin
(``tests/test_torch_focal.py``).
"""

import numpy as np
import pytest
import torch

from xrspatial_torch import focal
from xrspatial_torch.convolution import annulus_kernel, circle_kernel
from xrspatial_torch.kernels import focal_halo as fh
from xrspatial_torch.kernels.emulate import (emulate_staged, halo_case,
                                             same_bits)
from xrspatial_torch.kernels.window import (_window_stats_unrolled,
                                            kernel_offsets, window_stats)

ALL_STATS = ("mean", "max", "min", "range", "std", "var", "sum")


@pytest.fixture(autouse=True)
def one_thread():
    """The emulation is many small torch ops: one thread each, so that
    parallel test workers do not contend for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sparse_1001():
    """A sparse footprint of radius 500: its window fits no block."""
    k = np.zeros((1001, 1001))
    k[[0, 0, 500, 1000, 1000], [0, 1000, 500, 0, 1000]] = 1
    return k


def irregular():
    rng = np.random.default_rng(5)
    k = (rng.random((81, 61)) < 0.15).astype(float)
    k[0, 7] = 1
    return k


def ends_1x1025():
    k = np.zeros((1, 1025))
    k[0, [0, 300, 512, 1024]] = 1
    return k


# the footprints the card sends to the large-footprint kernel (focal._route
# "halo"), and the 1x2001 row the kernel takes by name
FOOTPRINTS = {
    "annulus_40_38": annulus_kernel(1, 1, 40, 38),
    "row_601": np.ones((1, 601)),
    "col_67": np.ones((67, 1)),
    "irregular": irregular(),
    "ends_1x1025": ends_1x1025(),
    "sparse_1001": sparse_1001(),
    "row_2001": np.ones((1, 2001)),
}


@pytest.mark.parametrize("name", list(FOOTPRINTS))
def test_runs_expand_to_the_offsets_in_order(name):
    offsets = kernel_offsets(FOOTPRINTS[name])
    runs = fh.footprint_runs(offsets)
    back = tuple((dy, dx0 + m) for dy, dx0, n in runs for m in range(n))
    assert back == offsets
    # maximal: no two neighbouring runs could have joined
    for (dy, dx0, n), (dy1, dx1, _) in zip(runs, runs[1:]):
        assert dy != dy1 or dx0 + n != dx1
    if name != "row_2001":
        assert focal._route(offsets) == "halo"


def test_annulus_runs():
    runs = fh.footprint_runs(kernel_offsets(FOOTPRINTS["annulus_40_38"]))
    assert len(runs) == 158
    assert len({dy for dy, _, _ in runs}) == 81
    assert max(n for *_, n in runs) == 17
    assert sum(n for *_, n in runs) == 512


PLANS = {
    # the main path's annulus at 16384^2: a 112 x 224 window, one box
    ("annulus_40_38", (16384, 16384), 1 << 20): fh.HaloPlan(
        "tma", (32, 128), 40, 224, 112, (224, 112), 1, 101952, 2, 65536),
    ("annulus_40_38", (16384, 16384), (1 << 20) + 4): fh.HaloPlan(
        "async", (32, 128), 40, 224, 112, (224, 112), 1, 101952, 2, 65536),
    ("annulus_40_38", (300, 70), 0): fh.HaloPlan(
        "async", (32, 128), 40, 224, 112, (224, 112), 1, 101952, 2, 10),
    # rows wider than a box: one box a row and column group
    ("row_601", (1025, 2048), 0): fh.HaloPlan(
        "tma", (32, 128), 300, 768, 32, (256, 1), 96, 98752, 2, 528),
    ("col_67", (2048, 2048), 0): fh.HaloPlan(
        "tma", (32, 128), 0, 128, 98, (128, 98), 1, 51136, 2, 1024),
    # the tile shrinks to 8 rows before two blocks an SM fail
    ("row_2001", (9, 2500), 0): fh.HaloPlan(
        "tma", (8, 128), 1000, 2304, 8, (256, 1), 72, 74176, 2, 40),
    ("ends_1x1025", (2, 5), 0): fh.HaloPlan(
        "async", (16, 128), 512, 1280, 16, (256, 1), 80, 82368, 2, 1),
    # no window fits a block: the ring of input rows
    ("sparse_1001", (2048, 2048), 0): fh.HaloPlan(
        "ring", (8, 32), 500, 1032, 8, (0, 0), 0, 33064, 6, 16384),
}


@pytest.mark.parametrize("key", list(PLANS), ids=lambda k: f"{k[0]}-{k[1]}")
def test_halo_plan(key):
    name, shape, ptr = key
    assert fh.halo_plan(*shape, kernel_offsets(FOOTPRINTS[name]),
                        ptr) == PLANS[key]


@pytest.mark.parametrize("shape", [(16384, 16384), (300, 70), (2, 5),
                                   (1025, 2049), (9, 2500)])
@pytest.mark.parametrize("name", list(FOOTPRINTS))
def test_halo_plan_keeps_the_box_and_shared_memory_rules(name, shape):
    offsets = kernel_offsets(FOOTPRINTS[name])
    ry = max(abs(dy) for dy, _ in offsets)
    rx = max(abs(dx) for _, dx in offsets)
    p = fh.halo_plan(*shape, offsets)
    if p.route == "ring":
        # only where no tile of 8 rows fits a block
        width = -(-(fh.TILE_COLS + 2 * (-(-rx // 4) * 4)) // 32) * 32
        assert (8 + 2 * ry) * width * 4 > fh.SMEM_PER_BLOCK
        return
    assert p.route == ("tma" if shape[1] % 4 == 0 else "async")
    th, tw = p.tile
    assert th in fh.TILE_ROWS and tw == fh.TILE_COLS == 32 * fh.CELLS
    # the window holds every offset of every cell of the tile, and its
    # first column is 16-byte aligned
    assert p.pad % 4 == 0 and p.pad >= rx and p.rows >= th + 2 * ry
    assert p.pitch % 32 == 0 and p.pitch >= tw + 2 * p.pad
    # the boxes tile the window exactly
    bc, br = p.box
    assert max(bc, br) <= fh.TMA_BOX_MAX and bc % 32 == 0
    assert p.boxes * bc * br == p.rows * p.pitch
    assert (p.pitch == bc) or br == 1
    # shared memory: the window, the run table, the barrier, the slack
    table = -(-len(fh.footprint_runs(offsets)) * 8 // 128) * 128
    assert p.shared_bytes == (fh.ALIGN_SLACK + fh.BARRIER_BYTES + table
                              + 4 * p.rows * p.pitch + fh.READ_SLACK)
    assert p.blocks_per_sm * (p.shared_bytes + 1024) <= fh.SMEM_PER_SM
    assert p.shared_bytes <= fh.SMEM_PER_BLOCK
    assert p.grid == -(-shape[0] // th) * -(-shape[1] // tw)


def test_run_table_addresses_each_runs_first_value():
    offsets = kernel_offsets(FOOTPRINTS["annulus_40_38"])
    plan = fh.halo_plan(16384, 16384, offsets)
    table = fh.run_table(offsets, plan)
    for (dy, dx0, n), (quad, code) in zip(fh.footprint_runs(offsets), table):
        assert code >> 2 == n
        # lane 0's cell 0 at tile row 0 reads window (dy + 40, 40 + dx0)
        assert 4 * quad + (code & 3) == (dy + 40) * plan.pitch + 40 + dx0
    with pytest.raises(ValueError, match="ring"):
        fh.run_table(kernel_offsets(sparse_1001()),
                     fh.halo_plan(64, 64, kernel_offsets(sparse_1001())))


# -- a torch emulation of the staged kernel's algorithm -------------------------

@pytest.mark.parametrize("name,shape,free_tiles", [
    ("annulus_40_38", (200, 340), True),
    ("annulus_40_38", (70, 301), False),
    ("col_67", (150, 262), True),
    ("irregular", (90, 130), False),
    ("row_601", (5, 700), False),
    ("ends_1x1025", (3, 40), False),
    ("row_2001", (17, 2500), True),
    ("circle_r2", (70, 300), True),
])
def test_emulated_staged_kernel_equals_window_stats(name, shape, free_tiles):
    """Bit for bit, NaN and +-inf cells included, on tiles with and
    without NaN in their window."""
    kernel = circle_kernel(1, 1, 2.5) if name == "circle_r2" \
        else FOOTPRINTS[name]
    offsets = kernel_offsets(kernel)
    x = halo_case(shape, seed=len(offsets))
    got, nan_free = emulate_staged(x, offsets)
    assert bool(nan_free.any()) == free_tiles and not bool(nan_free.all())
    ref = (_window_stats_unrolled if len(offsets) > 1024 else window_stats)(
        x, offsets, ALL_STATS)
    for s in ALL_STATS:
        assert same_bits(got[s], ref[s]), s
