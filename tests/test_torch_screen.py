"""The exact viewshed's interval screen: the culled route's design on the CPU.

``csrc/screen.cu::screen_culled_kernel`` (route "culled") rests on three
facts about the expanded tables and its loop order, which these tests pin
without a card, on the inputs ``viewshed_exact.screen_inputs`` builds (the
shapes of ``chip_smoke.py``'s phase 13 that fit a CPU test: NaN cells, a
viewpoint at a corner, the crossing east-ray cells), at both levels:

- ``sure`` implies ``maybe``: a0n >= a0w, a2n <= a2w, kt_lo <= kt_hi;
- the chunk bounds (``screen.chunk_bounds``, the pre-pass's twin) are
  sound: no pair of a culled (warp, chunk) passes ``maybe`` or ``sure``;
- a torch emulation of the kernel's loop (``emulate.emulate_culled``: 4
  warps of 128 targets a block, 4 targets a thread, 128-candidate chunks
  culled by the block and by the warp, every kept pair held to the wide
  cover and kt_hi first) equals the twin ``screen.screen_hilo`` bit for
  bit.

Nothing here needs the card; ``tests/test_torch_cuda.py`` holds the
kernel itself to the twin and to the first port on the card.
"""

import numpy as np
import pytest
import torch

from xrspatial_torch.kernels import cuda_screen
from xrspatial_torch.kernels.emulate import (SCREEN_WARP, blocks_of,
                                             emulate_culled)
from xrspatial_torch.kernels import screen as TS
from xrspatial_torch.kernels import viewshed_exact as TE

F = {k: i for i, k in enumerate(TS.F13)}


@pytest.fixture(autouse=True)
def one_thread():
    """Many small torch ops: one thread each, so that parallel test
    workers do not contend for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ridge(shape, seed, n_nan):
    """chip_smoke.py's screen-check raster: a ridge and NaN cells."""
    rng = np.random.default_rng(seed)
    data = rng.random(shape) * 60.0
    data[shape[0] // 3, :] += 100.0
    data[np.unravel_index(rng.integers(0, data.size, n_nan), shape)] = np.nan
    return data


# label -> (raster, (row, col), observer_elev, target_elev, ew, ns)
CASES = {
    "48x64": (lambda: ridge((48, 64), 601, 20), (10, 10), 3.0, 0.5, 1.5,
              -1.0),
    "64x48_corner": (lambda: ridge((64, 48), 602, 20), (0, 0), 3.0, 0.5,
                     1.5, -1.0),
    "96x112_nan_cells": (lambda: ridge((96, 112), 603, 200), (50, 30), 3.0,
                         0.5, 1.0, -1.0),
    "300x70": (lambda: ridge((300, 70), 604, 20), (200, 60), 2.0, 0.0, 1.0,
               -1.0),
}


def inputs(case, level):
    make, (vr, vc), oe, te, ew, ns = CASES[case]
    return TE.screen_inputs(make(), vr, vc, oe, te, ew, ns, level=level)


def all_tables(args):
    glob, stacks = args[0], args[1]
    yield glob[0]
    for stk, _ in stacks:
        yield stk.transpose(0, 1).reshape(len(TS.F13), -1)


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_sure_implies_maybe_on_the_expanded_tables(case, level):
    args = inputs(case, level)
    for tab in all_tables(args):
        a0w, a0n, a2w, a2n = (tab[F[k]] for k in ("a0w", "a0n", "a2w",
                                                  "a2n"))
        assert torch.equal(torch.isnan(a0w), torch.isnan(a0n))
        assert torch.equal(torch.isnan(a2w), torch.isnan(a2n))
        assert bool(((a0n >= a0w) | torch.isnan(a0w)).all())
        assert bool(((a2n <= a2w) | torch.isnan(a2w)).all())
        # an invalid candidate fails both covers at once
        assert torch.equal(a0w == torch.inf, a0n == torch.inf)
    klo, khi = args[3], args[4]
    assert not bool(torch.isnan(klo).any() | torch.isnan(khi).any())
    assert bool((klo <= khi).all()) and bool((klo >= 0).all())


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_chunk_bounds_are_the_covers_extremes(case, level):
    """Each chunk's (lo, hi), in the kernel's order, from its definition."""
    args = inputs(case, level)
    got = TS.chunk_bounds(args[0], args[1]).reshape(-1, 2)
    want = []
    for tab in all_tables(args):
        for c in range(0, tab.shape[1], TS.CHUNK):
            w0 = tab[F["a0w"], c:c + TS.CHUNK].tolist()
            w2 = tab[F["a2w"], c:c + TS.CHUNK].tolist()
            can = [(x, y) for x, y in zip(w0, w2) if x < y]
            want.append((min((x for x, _ in can), default=np.inf),
                         max((y for _, y in can), default=-np.inf)))
    assert got.dtype == args[2].dtype
    np.testing.assert_array_equal(got.numpy(), np.array(want))


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_no_pair_of_a_culled_chunk_passes(case, level):
    """Every pair of a (warp, chunk) the kernel culls fails both maybe and
    sure, as screen_pairs writes them; and the culling is not empty."""
    args = inputs(case, level)
    klo, khi, it = args[3], args[4], args[5]
    culled = total = 0
    for g, sl, a, kept, fields, idx in blocks_of(args):
        n = sl.stop - sl.start
        cut = ~kept.repeat_interleave(SCREEN_WARP, 0).repeat_interleave(
            TS.CHUNK, 1)[:n]
        f = {k: fields[i][None] for k, i in F.items()}
        t = a[:n, None]
        other = idx[None] != it[sl][:, None]
        maybe = ((t > f["a0w"]) & (t < f["a2w"])
                 & (f["key"] < khi[sl][:, None]) & other)
        sure = ((t > f["a0n"]) & (t < f["a2n"])
                & (f["key"] < klo[sl][:, None]) & other)
        assert not bool(((maybe | sure) & cut).any())
        culled += int((~kept).sum())
        total += kept.numel()
    assert 0 < culled < total


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_culled_loop_order_equals_the_twin(case, level):
    args = inputs(case, level)
    hi, lo = emulate_culled(args)
    ref_hi, ref_lo = TS.screen_hilo(*args)
    assert hi.dtype == ref_hi.dtype
    assert torch.equal(hi, ref_hi) and torch.equal(lo, ref_lo)


def test_wrapper_refuses_an_unknown_route_and_cpu_tensors():
    args = inputs("48x64", 1)
    before = (cuda_screen.LAUNCHES, cuda_screen.CULLED_LAUNCHES,
              cuda_screen.SIMPLE_LAUNCHES, cuda_screen.BOUNDS_LAUNCHES)
    with pytest.raises(ValueError, match="route"):
        cuda_screen.screen_hilo_cuda(*args, route="fast")
    for route in cuda_screen.ROUTES:
        with pytest.raises(ValueError, match="CUDA"):
            cuda_screen.screen_hilo_cuda(*args, route=route)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_screen.chunk_bounds_cuda(args[0], args[1])
    assert (cuda_screen.LAUNCHES, cuda_screen.CULLED_LAUNCHES,
            cuda_screen.SIMPLE_LAUNCHES, cuda_screen.BOUNDS_LAUNCHES) == before
