"""The work table: bytes and operations of a terrain job, whole and on
the 2x2 grid's blocks, and the least time the roofline reader takes."""

import torch

from gpubench import peaks
from gpubench.spec import Bench
from conftest import REPO

ARGS = {"surface": ["slope", "hillshade"],
        "stats_funcs": ["mean", "max", "min", "std"],
        "kernel": torch.tensor([[0, 1, 0], [1, 1, 1], [0, 1, 0]])}


def work(shape, args=ARGS):
    return Bench(REPO).work("terrain_pipeline").work(shape, args)


def test_work_at_16384_squared():
    cells = 16384 ** 2
    nbytes, ops = work((16384, 16384))
    # the DEM read once, slope, hillshade and 4 stats written once
    assert nbytes == 28 * cells == 7_516_192_768
    # 14 Sobel + 10 slope + 17 hillshade; 9 x 5 offsets + 9 for the stats
    assert ops == 95 * cells
    least = max(nbytes / peaks.HBM_BYTES_S, ops / peaks.F32_FLOP_S)
    assert abs(least * 1e3 - 2.2437) < 1e-3     # bound by the bytes


def test_work_of_the_mesh_is_its_blocks_work():
    whole = work((65536, 65536))
    block = work((32768, 32768))
    assert whole == (4 * block[0], 4 * block[1])
    assert block[0] == 28 * 32768 ** 2
    # over four cards the least time is one block's on one card
    least = max(whole[0] / (peaks.HBM_BYTES_S * 4),
                whole[1] / (peaks.F32_FLOP_S * 4))
    assert abs(least * 1e3 - 8.975) < 1e-2


def test_work_follows_the_products_and_the_footprint():
    three = torch.ones((3, 3))
    nbytes, ops = work((100, 10), {"surface": ["slope"],
                                   "stats_funcs": ["mean", "max", "min",
                                                   "std"],
                                   "kernel": three})
    assert nbytes == 4 * 1000 * 6 and ops == (14 + 10 + 9 * 9 + 9) * 1000
