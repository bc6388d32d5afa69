"""The DEM recipe: a mesh's blocks, each made on its own, equal the
whole recipe's slices; the seed alone decides it, any whole seed."""

import pytest
import torch
from conftest import CPU

from gpubench import dem

CONFIG = {"shape": [70, 101], "mesh": [2, 3],
          "dem": {"height_m": 1000.0, "ripple_m": 20.0,
                  "noise_sigma_m": 2.0}}


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, 2 ** 70 + 5, -3])
def test_blocks_equal_the_whole_recipes_slices(seed):
    whole = dem.make_whole(CONFIG, seed, CPU)
    blocks = dem.make_blocks(CONFIG, seed, [CPU] * 6)
    for i, row in enumerate(blocks):
        for j, b in enumerate(row):
            (y0, y1), (x0, x1) = dem.block_extents(CONFIG, i, j)
            assert torch.equal(b, whole[y0:y1, x0:x1])
    assert sum(b.numel() for row in blocks for b in row) == 70 * 101


def test_the_seed_decides_the_dem():
    a = dem.make_whole(CONFIG, 5, CPU)
    assert torch.equal(a, dem.make_whole(CONFIG, 5, CPU))
    assert not torch.equal(a, dem.make_whole(CONFIG, 6, CPU))
    noise = a - dem.hill(CONFIG, (0, 70), (0, 101), CPU)
    assert 1.8 < float(noise.std()) < 2.2


def test_block_seeds_are_distinct_and_fit_a_generator():
    seeds = {dem.block_seed(s, i, j) for s in (0, 1, 2 ** 64, -1)
             for i in range(3) for j in range(3)}
    assert len(seeds) == 36
    assert all(0 <= s < 2 ** 63 for s in seeds)
    torch.Generator().manual_seed(max(seeds))


def test_one_card_holds_the_whole_raster():
    one = dict(CONFIG, mesh=None)
    (b,), = dem.make_blocks(one, 9, [CPU])
    assert torch.equal(b, dem.make_whole(one, 9, CPU))
