"""The schedules of the two scan kernels' redesigns, on the CPU.

A CUDA kernel cannot run without a card, so its schedule is emulated in
torch ops with the kernel's own rounds, bands, chunks and hand-offs
(``xrspatial_torch/kernels/emulate.py``) and held to the kernels' plain
versions bit for bit; the kernels themselves are held to the same twins
on the card in ``tests/test_torch_cuda.py``.

- X2, ``csrc/bump.cu::bump_rounds_kernel``: ``emulate_bump_rounds`` (the
  claim, test and apply rounds on a retagged 64-bit owner map, then the
  walk of the rest in order) against ``bump_scan_twin``, at the plan's
  threshold on the 600-bump 23x17 case (which reaches the walk), on a
  sparse 256^2 case (whose rounds finish every bump), at threshold 0
  (rounds only) and infinity (the walk only); once against the JAX
  package's ``_scan_bumps``.
- X1, ``csrc/xdraw.cu::xdraw_banded_kernel``: ``emulate_xdraw_banded``
  (bands, K-step chunks, the one-sided halo, carries exchanged only at
  chunk ends) against ``xdraw_scan_twin`` at the card tests' small shapes,
  the viewpoint at every corner and inside, on the plan's band and chunk
  and on tiny ones (8 and 4, 4 and 8: many bands and chunks, a halo wider
  than a band); once, with the interpolation evaluated as XLA's FMA,
  against the JAX package's ``_halfplane_scan4``.
- The plans: ``rounds_threshold`` and ``xdraw_plan``.

Every comparison is bit for bit: NaN where NaN, the same infinities.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrspatial_torch.kernels import bump as KB
from xrspatial_torch.kernels import viewshed as TV
from xrspatial_torch.kernels.emulate import (emulate_bump_rounds,
                                             emulate_xdraw_banded, same_bits)
from xrspatial_tpu.kernels import viewshed as JV
from xrspatial_tpu.utils import x64

JB = importlib.import_module("xrspatial_tpu.bump")


def bits(t):
    return t.view(torch.int64)


# -- X2: the bump rounds -------------------------------------------------------

def bump_case(spread, seed):
    """(shape, (N, 2) int32 locations (x, y), (N,) float64 heights): 600
    bumps on 23x17, duplicates forced, a bump on every corner and edge,
    non-integer and negative heights (the card tests' case)."""
    rng = np.random.default_rng(seed)
    h, w = 17, 23
    locs = np.stack([rng.integers(0, w, 600), rng.integers(0, h, 600)], 1)
    locs[:10] = [[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1], [5, 0],
                 [0, 7], [w - 1, 9], [11, h - 1], [5, 0], [5, 0]]
    heights = rng.random(600) * 7.3 - 1.1
    return ((h, w), torch.from_numpy(locs.astype(np.int32)),
            torch.from_numpy(heights))


def sparse_case(spread):
    """3000 (spread 1) or 2000 (spread 2) bumps on 256^2."""
    count = {1: 3000, 2: 2000}[spread]
    rng = np.random.default_rng(5)
    locs = np.stack([rng.integers(0, 256, count),
                     rng.integers(0, 256, count)], 1)
    return ((256, 256), torch.from_numpy(locs.astype(np.int32)),
            torch.from_numpy(rng.random(count) * 3))


def rounds_and_twin(case, spread, threshold=None):
    shape, locs, heights = case
    got = torch.zeros(shape, dtype=torch.float64)
    counts = emulate_bump_rounds(got, locs, heights, spread, threshold)
    ref = KB.bump_scan_twin(torch.zeros(shape, dtype=torch.float64), locs,
                            heights, spread)
    return got, ref, counts


@pytest.mark.parametrize("spread", [0, 1, 3])
def test_bump_rounds_reach_the_walk_on_a_crowded_map(spread):
    """600 bumps on 391 cells: the rounds shrink below the plan's
    threshold and the walk takes the rest, in order."""
    got, ref, (rounds, done, tail) = rounds_and_twin(
        bump_case(spread, spread), spread)
    assert torch.equal(bits(got), bits(ref))
    assert rounds >= 1 and tail > 0 and done + tail == 600


@pytest.mark.parametrize("spread", [1, 2])
def test_bump_rounds_finish_a_sparse_map(spread):
    got, ref, (rounds, done, tail) = rounds_and_twin(sparse_case(spread),
                                                     spread)
    assert torch.equal(bits(got), bits(ref))
    assert rounds >= 2 and tail == 0 and done == len(sparse_case(spread)[1])


@pytest.mark.parametrize("spread", [0, 1, 3])
def test_bump_threshold_zero_runs_rounds_only(spread):
    got, ref, (rounds, done, tail) = rounds_and_twin(
        bump_case(spread, 10 + spread), spread, threshold=0)
    assert torch.equal(bits(got), bits(ref))
    assert tail == 0 and done == 600 and rounds > 1


@pytest.mark.parametrize("spread", [0, 1, 3])
def test_bump_threshold_infinity_walks_every_bump(spread):
    got, ref, counts = rounds_and_twin(bump_case(spread, 20 + spread),
                                       spread, threshold=math.inf)
    assert torch.equal(bits(got), bits(ref))
    assert counts == (0, 0, 600)


def test_bump_rounds_on_a_non_finite_centre():
    """An infinite height makes a centre infinite; its (0, 0) term
    centre * 0 is then NaN there, in the rounds as in the walk."""
    shape, locs, heights = bump_case(1, 4)
    heights[[3, 200]] = torch.tensor([math.inf, -math.inf],
                                     dtype=torch.float64)
    got, ref, _ = rounds_and_twin((shape, locs, heights), 1, threshold=0)
    assert bool(torch.isnan(ref).any())
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert torch.equal(bits(torch.nan_to_num(got)),
                       bits(torch.nan_to_num(ref)))


def test_bump_rounds_match_the_jax_scan():
    """The rounds and the walk, handed off at the plan's threshold, give
    the JAX package's lax.scan bit for bit."""
    shape, locs, heights = bump_case(1, 1)
    got = torch.zeros(shape, dtype=torch.float64)
    _, _, tail = emulate_bump_rounds(got, locs, heights, 1)
    with x64():
        ref = np.asarray(JB._scan_bumps(shape, jnp.asarray(locs.numpy()),
                                        jnp.asarray(heights.numpy()), 1))
    assert tail > 0 and ref.dtype == np.float64
    assert np.array_equal(got.numpy().view(np.int64), ref.view(np.int64))


def test_rounds_threshold_is_a_round_over_a_walked_bump():
    assert KB.rounds_threshold() == math.ceil(KB.ROUND_US
                                              / KB.WALK_US_PER_BUMP) == 12


# -- X1: the banded XDraw scan -------------------------------------------------

def terrain(shape, seed, nan=3):
    """Random float32 terrain with a mesa and `nan` NaN cells."""
    rng = np.random.default_rng(seed)
    h, w = shape
    data = (rng.random(shape) * 50).astype(np.float32)
    data[h // 3:h // 3 + max(1, h // 10), w // 2:w // 2 + max(1, w // 10)] \
        += 150.0
    if nan:
        data[rng.integers(0, h, nan), rng.integers(0, w, nan)] = np.nan
    return data


def slope_of(shape, vp, seed, nan=3):
    return TV._xdraw_fields(torch.from_numpy(terrain(shape, seed, nan)),
                            *vp, 2.0, 0.0, 1.0, -1.0)[3]


def viewpoints(shape):
    h, w = shape
    return ((0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1), (h // 3, w // 2))


# the card tests' small shapes (tests/test_torch_cuda.py XDRAW_SHAPES)
SMALL_SHAPES = ((17, 1), (1, 23), (300, 70), (70, 300), (263, 516))
# (band, chunk): the plan's, many bands and chunks, a halo wider than a band
BANDS = {"plan": (None, None), "b8_k4": (8, 4), "b4_k8": (4, 8)}


@pytest.mark.parametrize("bands", list(BANDS))
@pytest.mark.parametrize("shape", SMALL_SHAPES)
def test_banded_emulation_equals_the_twin(shape, bands):
    """NaN-free, so every cell must be written; then with NaN cells."""
    for nan in (0, 4):
        for vp in viewpoints(shape):
            slope = slope_of(shape, vp, sum(shape) + nan, nan)
            got = emulate_xdraw_banded(slope, *vp, *BANDS[bands])
            assert same_bits(got, TV.xdraw_scan_twin(slope, *vp)), vp
            if not nan:
                assert not bool(torch.isnan(got).any()), vp


def fma_interp(prim, sec, wsec):
    """fma(prim, 1 - wsec, sec * wsec), the expression XLA emits: the
    product and sum in float64 (exact product), rounded once to float32."""
    return (prim.double() * (1.0 - wsec).double()
            + (sec * wsec).double()).float()


def test_banded_emulation_matches_the_jax_scan(monkeypatch):
    """With the interpolation evaluated as XLA's FMA, the banded schedule
    gives the JAX package's _halfplane_scan4 and its combine bit for bit;
    as it is, within the twin's rtol (tests/test_torch_xdraw.py)."""
    shape, vp = (40, 64), (30, 5)
    data = terrain(shape, 104)
    h, w = shape
    dy, dx, _, slope, _, dy_vec, dx_vec, _ = JV._xdraw_fields(
        jnp.asarray(data), jnp.int32(vp[0]), jnp.int32(vp[1]),
        jnp.float32(2.0), jnp.float32(0.0), jnp.float32(1.0),
        jnp.float32(-1.0), (h, w))
    m_e, m_w, m_s, m_n = JV._halfplane_scan4(
        slope, dy_vec, dx_vec, jnp.int32(vp[0]), jnp.int32(vp[1]), (h, w))
    x_dom = jnp.abs(dx) >= jnp.abs(dy)
    ref = torch.from_numpy(np.array(jnp.where(
        x_dom, jnp.where(dx >= 0, m_e, m_w), jnp.where(dy >= 0, m_s, m_n))))
    slope = torch.from_numpy(np.array(slope))
    got = emulate_xdraw_banded(slope, *vp, 8, 4)
    fin = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(got), fin)
    torch.testing.assert_close(got[fin], ref[fin], rtol=1e-5, atol=0)
    monkeypatch.setattr(TV, "_xdraw_interp", fma_interp)
    assert same_bits(emulate_xdraw_banded(slope, *vp, 8, 4), ref)


@pytest.mark.parametrize("shape,band,chunk,blocks", [
    ((16384, 16384), 64, 32, 1024), ((4096, 4096), 32, 32, 512),
    ((1024, 1024), 32, 32, 128), ((30000, 2), 64, 32, 940),
    ((16384, 100), 32, 32, 1032), ((65536, 65536), 2048, 8, 128)])
def test_xdraw_plan(shape, band, chunk, blocks):
    """The longest chunk, and for it the smallest band, whose blocks can
    all be resident on 132 SMs."""
    p = TV.xdraw_plan(*shape)
    assert (p.band, p.chunk, p.blocks) == (band, chunk, blocks)
    threads = min(1024, -(-(band + chunk) // 32) * 32)
    shared = 4 * (2 * (band + chunk + 2) + 2 * chunk * (band + chunk))
    assert (p.threads, p.shared_bytes) == (threads, shared)
    assert p.slots == -(-(max(shape) - 1) // chunk) + 1
    assert p.per_sm == min(32, 2048 // threads, 65536 // (threads * 64),
                           233472 // (shared + 1024))
    assert p.blocks <= 132 * p.per_sm
    if band > 32:
        assert not fits(shape, band // 2, chunk)
    if chunk < 32:
        assert not any(fits(shape, b, 2 * chunk) for b in TV.XDRAW_BANDS)


def fits(shape, band, chunk):
    """Whether bands of `band` and chunks of `chunk` fit a block's shared
    memory and keep every block resident on 132 SMs."""
    try:
        p = TV.xdraw_plan(*shape, band=band, chunk=chunk)
    except ValueError:
        return False
    return p.blocks <= 132 * p.per_sm


def test_xdraw_plan_takes_a_given_band_and_chunk():
    p = TV.xdraw_plan(263, 516, band=8, chunk=4)
    assert (p.band, p.chunk, p.threads, p.blocks) == (8, 4, 32, 196)
    assert TV.xdraw_plan(263, 516, band=128).band == 128
    assert TV.xdraw_plan(16384, 16384, chunk=16).band == 32
    with pytest.raises(ValueError, match="shared memory"):
        TV.xdraw_plan(64, 64, band=4096, chunk=32)
