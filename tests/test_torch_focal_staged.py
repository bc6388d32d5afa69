"""B2 on the staged template: its plan and window, on the CPU.

``cuda_window.focal_stats_cuda`` (the port of ``xrspatial_tpu/kernels/
pallas_window2.py::focal_stats_tiled``, for the footprints with ry <= 32
and rx <= 256 that ``focal._route`` calls "tiled") runs the staged
template of ``csrc/focal_halo.cu`` on the route ``focal_halo.halo_plan``
names, compiled for ``focal_halo.register_class`` blocks an SM; its first
port ``csrc/focal.cu::focal_kernel`` stays by name as route "simple".
Pinned here without a card:

- the plan (route, tile, shared bytes, register class) of the 5-cell plus,
  3x3, 1x513 (rx = 256) and 65x1 (ry = 32) footprints, at w % 4 == 0
  (TMA) and w % 4 != 0 (cp.async);
- no footprint within the tiled radii is left without a staged window;
- ``kernels/emulate.py::emulate_staged`` (each tile's window
  with its NaN fill, the run table, 4 cells a lane, offsets order, the
  NaN-free branch) equals ``window_stats`` bit for bit on these
  footprints;
- every focal kernel rounds the second pass's square and sum apart
  (``focal_cell.cuh::focal_dev2_add``), so the staged route, the first
  port and the fused pipeline kernel give the same bits.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from xrspatial_torch import focal
from xrspatial_torch.convolution import circle_kernel
from xrspatial_torch.kernels import cuda_window
from xrspatial_torch.kernels import focal_halo as fh
from xrspatial_torch.kernels.emulate import (emulate_staged, halo_case,
                                             same_bits)
from xrspatial_torch.kernels.window import kernel_offsets, window_stats

ALL_STATS = ("mean", "max", "min", "range", "std", "var", "sum")
CSRC = Path(fh.__file__).resolve().parent.parent / "csrc"

FOOTPRINTS = {
    "plus": circle_kernel(1, 1, 1.5),
    "3x3": np.ones((3, 3)),
    "1x513": np.ones((1, 513)),
    "65x1": np.ones((65, 1)),
}


@pytest.fixture(autouse=True)
def one_thread():
    """The emulation is many small torch ops: one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def offsets_of(name):
    return kernel_offsets(FOOTPRINTS[name])


# (footprint, w % 4 == 0) -> (tile, pad, pitch, rows, box, shared bytes,
# register class), at 16384 rows and w = 16384 or 16382
PLANS = {
    "plus": ((32, 128), 4, 160, 34, (160, 34), 22208, 3),
    "3x3": ((32, 128), 4, 160, 34, (160, 34), 22208, 3),
    "1x513": ((32, 128), 256, 672, 32, (224, 1), 86464, 2),
    "65x1": ((32, 128), 0, 128, 96, (128, 96), 50112, 3),
}


@pytest.mark.parametrize("w", [16384, 16382])
@pytest.mark.parametrize("name", list(FOOTPRINTS))
def test_tiled_footprint_plan(name, w):
    offsets = offsets_of(name)
    assert focal._route(offsets) == "tiled"
    p = fh.halo_plan(16384, w, offsets)
    tile, pad, pitch, rows, box, shared, blocks = PLANS[name]
    assert p.route == ("tma" if w % 4 == 0 else "async")
    assert (p.tile, p.pad, p.pitch, p.rows, p.box, p.shared_bytes) == (
        tile, pad, pitch, rows, box, shared)
    assert fh.register_class(p) == blocks
    assert blocks * (p.shared_bytes + 1024) <= fh.SMEM_PER_SM
    assert p.grid == 16384 // 32 * -(-w // 128)
    # an unaligned base takes cp.async too
    assert fh.halo_plan(16384, w, offsets, 4).route == "async"


def test_register_class_refuses_the_ring():
    k = np.zeros((1001, 1001))
    k[[0, 1000], [0, 1000]] = 1
    plan = fh.halo_plan(2048, 2048, kernel_offsets(k))
    assert plan.route == "ring"
    with pytest.raises(ValueError, match="ring"):
        fh.register_class(plan)


def widest_footprints():
    """Footprints at the tiled radii's extremes: full rectangles, and the
    sparsest (one run an offset, 1024 offsets) at ry = 32, rx = 256."""
    for ry in (0, 1, 2, 8, 31, 32):
        for rx in (0, 1, 2, 5, 127, 255, 256):
            if (2 * ry + 1) * (2 * rx + 1) <= 1024:
                yield f"rect_{ry}_{rx}", tuple(
                    (dy, dx) for dy in range(-ry, ry + 1)
                    for dx in range(-rx, rx + 1))
            else:
                # a cross through the centre: rows and columns of the
                # radii
                yield f"cross_{ry}_{rx}", tuple(sorted(
                    {(0, dx) for dx in range(-rx, rx + 1)}
                    | {(dy, 0) for dy in range(-ry, ry + 1)}))
    sparse = [(dy, dx) for dy in range(-32, 33)
              for dx in range(-256, 257, 2)][:1024]
    sparse[-1] = (32, 256)
    yield "sparse_1024", tuple(sparse)


@pytest.mark.parametrize("w", [16384, 517, 5])
def test_every_tiled_footprint_fits_a_staged_window(w):
    for label, offsets in widest_footprints():
        assert len(offsets) <= 1024 and focal._route(offsets) == "tiled"
        p = fh.halo_plan(16384, w, offsets)
        assert p.route in ("tma", "async"), label
        assert p.shared_bytes <= fh.SMEM_PER_BLOCK, label
        assert fh.register_class(p) in fh.REGISTER_CLASSES, label
    # the largest window and run table, ry = 32, rx = 256 with 1024 runs:
    # 80 rows of 3 boxes of 224 floats at a tile of 16 rows, one block an SM
    p = fh.halo_plan(16384, w, dict(widest_footprints())["sparse_1024"])
    assert (p.tile, p.rows, p.pitch, p.box, p.blocks_per_sm) == (
        (16, 128), 80, 672, (224, 1), 1)
    assert p.shared_bytes == 128 + 128 + 1024 * 8 + 80 * 672 * 4 + 64


@pytest.mark.parametrize("shape", [(140, 300), (140, 701), (3, 40)])
@pytest.mark.parametrize("name", list(FOOTPRINTS))
def test_emulated_staged_kernel_equals_window_stats(name, shape):
    """Bit for bit on B2's footprints, NaN and +-inf cells included, at
    w % 4 == 0 and != 0, on tiles with and without NaN in their window
    (an interior tile's window holds none where the raster is high and,
    for the 1x513 row's 640 columns, wide enough)."""
    offsets = offsets_of(name)
    x = halo_case(shape, seed=len(offsets) + shape[1])
    got, nan_free = emulate_staged(x, offsets)
    free = shape[0] == 140 and (name != "1x513" or shape[1] == 701)
    assert bool(nan_free.any()) == free and not bool(nan_free.all())
    ref = window_stats(x, offsets, ALL_STATS)
    for s in ALL_STATS:
        assert same_bits(got[s], ref[s]), s


def test_every_focal_kernel_rounds_the_second_pass_apart():
    """focal_dev2_add rounds the square and the sum apart, with no switch
    to an fma, and every focal kernel calls it without one."""
    cell = (CSRC / "focal_cell.cuh").read_text()
    body = cell[cell.index("void focal_dev2_add("):]
    body = body[:body.index("\n}\n")]
    assert "__fadd_rn(dev2, __fmul_rn(dv, dv))" in body
    assert "kRounded" not in cell
    for src in ("focal_cell.cuh", "focal_halo.cu", "focal.cu", "pipeline.cu"):
        text = (CSRC / src).read_text()
        assert not re.search(r"focal_dev2_add<\s*(true|false)\s*,", text), src
        assert "focal_dev2_add<false>" not in text, src


def test_rounding_apart_is_what_the_twin_does():
    """The twin's second pass, one torch op a step, equals a running
    float32 sum of separately rounded squares; an fma of the same values
    differs on some cells, so the rounding is not a detail."""
    rng = np.random.default_rng(3)
    vals = (rng.random((6, 4096)) * 1000.0).astype(np.float32)
    mean = vals.mean(axis=0, dtype=np.float32)
    dev2 = np.zeros(4096, np.float32)
    fused = np.zeros(4096, np.float32)
    for v in vals:
        dv = v - mean
        dev2 = (dev2 + dv * dv).astype(np.float32)
        exact = fused.astype(np.float64) + dv.astype(np.float64) ** 2
        fused = exact.astype(np.float32)
    x = torch.from_numpy(vals.reshape(6, 4096))
    t = torch.zeros(4096)
    tm = torch.from_numpy(mean)
    for row in x:
        d = row - tm
        t = t + torch.where(torch.isnan(row), 0.0, d * d)
    assert np.array_equal(t.numpy(), dev2)
    assert not np.array_equal(fused, dev2)


def test_focal_stats_cuda_refuses_a_cpu_tensor_and_an_unknown_route():
    offsets = offsets_of("plus")
    before = (cuda_window.LAUNCHES, cuda_window.TMA_LAUNCHES,
              cuda_window.ASYNC_LAUNCHES, cuda_window.SIMPLE_LAUNCHES)
    for route in (None, "simple", "tma", "async"):
        with pytest.raises(ValueError, match="CUDA tensor"):
            cuda_window.focal_stats_cuda(torch.ones((4, 8)), offsets,
                                         ("mean",), route=route)
    assert (cuda_window.LAUNCHES, cuda_window.TMA_LAUNCHES,
            cuda_window.ASYNC_LAUNCHES, cuda_window.SIMPLE_LAUNCHES) == before
