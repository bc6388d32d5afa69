"""Parity of the torch port's synthesis (A9) with the JAX package (CPU).

The same seeds and shapes go through ``xrspatial_tpu`` and
``xrspatial_torch``: ``octave_eval``, ``perlin``, ``generate_terrain``,
``make_terrain`` and ``bump``, and ``canvas_like``.  Every comparison is
bit for bit (no tolerance): the port copies the arithmetic XLA runs on the
CPU (``fma`` forms of the fade and the lerps, ``acc * float32(1 /
1.97)``), and its bump walk rounds every float64 product and sum apart,
as the JAX scan does.  The JAX package's own goldens (the reference's
docstring values) are checked on the port's output at the JAX suite's
tolerances (atol 1e-6, rtol 1e-5).

The JAX programs compile once a shape, so the JAX results come from
module-scoped fixtures shared by the tests.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

import xrspatial_torch as xt
from xrspatial_torch import utils as TU
from xrspatial_torch.kernels import bump as KB
from xrspatial_tpu import utils as JU
from xrspatial_tpu.xrlib import DataArray as JaxDataArray

TP = importlib.import_module("xrspatial_torch.perlin")
TT = importlib.import_module("xrspatial_torch.terrain")
TB = importlib.import_module("xrspatial_torch.bump")
TD = importlib.import_module("xrspatial_torch.datasets")
JP = importlib.import_module("xrspatial_tpu.perlin")
JT = importlib.import_module("xrspatial_tpu.terrain")
JB = importlib.import_module("xrspatial_tpu.bump")
JD = importlib.import_module("xrspatial_tpu.datasets")


@pytest.fixture(autouse=True)
def numpy_rasters_on_the_cpu():
    """These tests give numpy rasters and compare on the CPU."""
    saved = xt.default_device()
    xt.set_default_device("cpu")
    yield
    xt.set_default_device(saved)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The octave loop is ~45 small torch ops an octave: beside the other
    test workers, torch's thread pool spends far more time waiting than
    working on them (a 256² terrain took 40-60 s instead of 0.1 s), so
    this module runs them on one thread."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def blank(shape, jax_side=False):
    data = np.zeros(shape, dtype=np.float32)
    if jax_side:
        return JaxDataArray(data, dims=["y", "x"])
    return xt.DataArray(data, dims=["y", "x"])


def assert_bits(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.array_equal(got.view(np.uint8), ref.view(np.uint8)), \
        f"{int((got != ref).sum())} cells differ, max " \
        f"{np.nanmax(np.abs(got - ref))}"


# -- perlin ---------------------------------------------------------------------

def octave_inputs(octave, h=257, w=301):
    linx = np.linspace(0.0, 1.0, w, endpoint=False,
                       dtype=np.float32).astype(np.float64)
    liny = np.linspace(0.0, 1.0, h, endpoint=False,
                       dtype=np.float32).astype(np.float64)
    freq = float(2 ** octave)
    return 10 + octave, linx * freq, liny * freq


@pytest.mark.parametrize("octave", [0, 3, 11, 15])
def test_octave_eval_matches_jax(octave):
    """The port's octave_eval against the JAX package's as it runs it,
    under jit (eagerly, op by op, XLA would compute the sources'
    arithmetic, which no JAX entry point does)."""
    tables = JP.octave_tables(*octave_inputs(octave))
    for a, b in zip(tables, TP.octave_tables(*octave_inputs(octave))):
        assert_bits(b, a)
    ref = jax.jit(JP.octave_eval)(*map(jax.numpy.asarray, tables))
    assert_bits(TP.octave_eval(*TP.tables_to("cpu", *tables)), ref)


@pytest.mark.parametrize("octave", [0, 3, 11, 15])
def test_lattice_path_equals_the_gather_form(octave):
    """octave_tables + octave_eval equal the legacy gather form
    perlin_noise bit for bit, as the JAX suite pins for the JAX package."""
    h, w = 37, 53
    seed, x, y = octave_inputs(octave, h, w)
    new = TP.octave_eval(*TP.tables_to("cpu", *TP.octave_tables(seed, x, y)))
    p = torch.from_numpy(TP._permutation_table(seed))
    gx, gy = np.meshgrid(x, y)
    old = TP.perlin_noise(p, torch.from_numpy(gx), torch.from_numpy(gy))
    assert_bits(new, old.numpy())


def test_fma_forms_are_what_xla_computes():
    """The fade as written in the sources (op by op) differs from XLA's
    fused evaluation in many cells; the port's fma form does not."""
    t = np.random.default_rng(0).random(200_000).astype(np.float32)
    ref = np.asarray(jax.jit(JP._fade)(t))
    assert_bits(TP._fade(torch.from_numpy(t)), ref)
    plain = 6 * t ** 5 - 15 * t ** 4 + 10 * t ** 3
    assert (plain != ref).mean() > 0.01


PERLIN_CASES = (((3, 4), (1, 1), 5), ((64, 80), (4, 3), 11),
                ((300, 257), (1, 1), 5), ((40, 50), (4, 3), 12))


@pytest.fixture(scope="module")
def jax_perlin():
    return {case: np.asarray(JP.perlin(blank(case[0], True), freq=case[1],
                                       seed=case[2]).data)
            for case in PERLIN_CASES}


@pytest.mark.parametrize("case", PERLIN_CASES)
def test_perlin_matches_jax(jax_perlin, case):
    shape, freq, seed = case
    out = TP.perlin(blank(shape), freq=freq, seed=seed)
    assert out.name == "perlin" and out.dims == ("y", "x")
    assert out.data.dtype == torch.float32
    assert_bits(out.data, jax_perlin[case])


def test_perlin_reference_golden():
    out = xt.perlin(blank((3, 4))).data.numpy()
    expected = np.array([
        [0.39268944, 0.27577767, 0.01621884, 0.05518942],
        [1.0, 0.8229485, 0.2935367, 0.0],
        [1.0, 0.8715414, 0.41902685, 0.02916668]], dtype=np.float32)
    np.testing.assert_allclose(out, expected, atol=1e-6)


def test_perlin_follows_the_raster_device(jax_perlin):
    """A tensor payload keeps its device; the default device is only for
    numpy payloads."""
    agg = xt.DataArray(torch.zeros((64, 80)), dims=["y", "x"])
    xt.set_default_device("meta")
    out = xt.perlin(agg, freq=(4, 3), seed=11)
    assert out.data.device.type == "cpu"
    assert_bits(out.data, jax_perlin[((64, 80), (4, 3), 11)])


# -- generate_terrain ---------------------------------------------------------

TERRAIN_CASES = {
    "golden_300x500": ((300, 500), dict(x_range=(-20e6, 20e6),
                                        y_range=(-20e6, 20e6))),
    "defaults_256": ((256, 256), {}),
    "extent_97x131": ((97, 131), dict(x_range=(100, 300), y_range=(0, 50),
                                      seed=3, zfactor=1000,
                                      full_extent=(0, -50, 400, 250))),
}


@pytest.fixture(scope="module")
def jax_terrain():
    return {k: JT.generate_terrain(blank(shape, True), **kw)
            for k, (shape, kw) in TERRAIN_CASES.items()}


@pytest.mark.parametrize("case", sorted(TERRAIN_CASES))
def test_generate_terrain_matches_jax(jax_terrain, case):
    shape, kw = TERRAIN_CASES[case]
    ref = jax_terrain[case]
    out = xt.generate_terrain(blank(shape), **kw)
    assert_bits(out.data, ref.data)
    assert out.name == ref.name == "terrain"
    assert out.dims == ("y", "x")
    assert out.attrs == ref.attrs
    for c in ("x", "y"):
        assert_bits(out[c].values, np.asarray(ref[c].data))


def test_terrain_reference_golden():
    """The reference's docstring slice (W=500 H=300, extent +-20e6)."""
    t = xt.generate_terrain(blank((300, 500)), x_range=(-20e6, 20e6),
                            y_range=(-20e6, 20e6))
    sl = t.data.numpy()[200:203, 200:202]
    expected = np.array([[1264.02296597, 1261.947921],
                         [1285.37105519, 1282.48079719],
                         [1306.02339636, 1303.4069579]])
    np.testing.assert_allclose(sl, expected, rtol=1e-5)
    assert t.attrs["res"] == (80000.0, 400e5 / 300)
    np.testing.assert_allclose(t["x"].values[:2], [-19.96e6, -19.88e6])


def test_terrain_water_cutoff_and_range():
    t = xt.generate_terrain(blank((256, 256)), zfactor=4000).data
    assert bool((t >= 0).all()) and bool((t == 0).any())
    assert bool((t > 0).any()) and float(t.max()) <= 4000.0


def test_terrain_transport_is_memoised_per_device():
    TT._transport.cache_clear()
    xt.generate_terrain(blank((64, 64)))
    xt.generate_terrain(blank((64, 64)))
    info = TT._transport.cache_info()
    assert (info.hits, info.misses) == (1, 1)
    tables, idx, frac, plan = TT._transport(
        10, 64, 64, (0.0, 1.0), (0.0, 1.0), torch.device("cpu"))
    assert tables.dtype == torch.uint8 and idx.dtype == torch.int32
    assert frac.dtype == torch.float32 and len(plan) == 16


def test_terrain_full_extent_must_be_a_4_tuple():
    with pytest.raises(TypeError, match="tuple"):
        xt.generate_terrain(blank((8, 8)), full_extent=(0, 1, 2))


# -- make_terrain (datasets) ------------------------------------------------------

MAKE_TERRAIN_CASES = {
    "small": dict(shape=(64, 80), scale=20.0, octaves=3),
    "200x300": dict(shape=(200, 300)),
    # a weight that is no power of two: rounded in float32, as the JAX
    # package's weak-typed product
    "persistence_0.37": dict(shape=(50, 70), scale=13.0, octaves=5,
                             persistence=0.37, lacunarity=1.7),
}


@pytest.fixture(scope="module")
def jax_make_terrain():
    return {k: JD.make_terrain(**kw) for k, kw in MAKE_TERRAIN_CASES.items()}


@pytest.mark.parametrize("case", sorted(MAKE_TERRAIN_CASES))
def test_make_terrain_matches_jax(jax_make_terrain, case):
    ref = jax_make_terrain[case]
    out = TD.make_terrain(**MAKE_TERRAIN_CASES[case])
    assert_bits(out.data, ref.data)
    assert out.name == "terrain" and out.attrs == {"res": 1}
    for c in ("x", "y"):
        assert_bits(out[c].values, np.asarray(ref[c].data))


# -- bump ---------------------------------------------------------------------------

def odd_heights(bumps):
    """Non-integer heights, so that every rounding shows."""
    return np.random.default_rng(len(bumps)).random(len(bumps)) * 7.3 + 0.01


BUMP_CASES = [(0, 40, 30, None), (1, 40, 30, None), (3, 40, 30, None),
              (1, 23, 17, 500), (3, 9, 7, 200), (2, 1, 13, 40)]


@pytest.mark.parametrize("spread,width,height,count", BUMP_CASES)
def test_bump_matches_jax(spread, width, height, count):
    """The same legacy-RNG locations, non-integer heights, bit for bit;
    500 bumps on 23x17 and 200 on 9x7 force duplicate locations and bumps
    on every edge and corner."""
    np.random.seed(100 + spread)
    ref = JB.bump(width, height, count=count, spread=spread,
                  height_func=odd_heights)
    np.random.seed(100 + spread)
    out = xt.bump(width, height, count=count, spread=spread,
                  height_func=odd_heights)
    assert_bits(out.data, ref.data)
    assert out.dims == ("y", "x") and out.attrs == {"res": 1}


def test_bump_defaults_and_rng_state():
    """Default count and heights; the global RNG is left where the JAX
    package leaves it."""
    np.random.seed(7)
    ref = JB.bump(31, 19)
    after_jax = np.random.random()
    np.random.seed(7)
    out = xt.bump(31, 19)
    assert np.random.random() == after_jax
    assert_bits(out.data, ref.data)
    assert float(out.data.sum()) > 31 * 19 // 10


def sequential_oracle(shape, locs, heights, spread):
    """The walk in plain Python float64, one rounding an operation."""
    out = np.zeros(shape)
    h, w = shape
    for (x, y), z in zip(locs, heights):
        out[y, x] += z
        c = out[y, x]
        for oy in range(-spread, spread):
            for ox in range(-spread, spread):
                ny, nx = y + oy, x + ox
                if ox * ox + oy * oy <= spread * spread \
                        and 0 <= ny < h and 0 <= nx < w:
                    out[ny, nx] += c * ((ox * ox + oy * oy)
                                        / (spread * spread))
    return out


@pytest.mark.parametrize("spread", [0, 1, 2, 3])
def test_bump_twin_equals_the_sequential_walk(spread):
    rng = np.random.default_rng(spread)
    shape = (11, 14)
    locs = np.stack([rng.integers(0, 14, 150), rng.integers(0, 11, 150)], 1)
    locs[:8] = [[0, 0], [13, 0], [0, 10], [13, 10], [0, 0], [6, 5],
                [6, 5], [13, 4]]
    heights = rng.random(150) * 3 - 0.5
    got = KB.bump_scan(torch.zeros(shape, dtype=torch.float64),
                       torch.from_numpy(locs), torch.from_numpy(heights),
                       spread)
    assert_bits(got, sequential_oracle(shape, locs, heights, spread))


def test_ring_offsets_are_the_jax_packages():
    oy, ox, k = KB.ring_offsets(3)
    offs = np.arange(-3, 3)
    gy, gx = np.meshgrid(offs, offs, indexing="ij")
    d2 = (gx * gx + gy * gy).ravel().astype(np.float64)
    ring = d2 <= 9
    assert np.array_equal(oy, gy.ravel()[ring])
    assert np.array_equal(ox, gx.ravel()[ring])
    assert_bits(k, d2[ring] / 9)
    assert_bits(KB.ring_table(3), d2 / 9)
    assert KB.ring_table(1).tolist() == [2.0, 1.0, 1.0, 0.0]


# -- canvas_like ----------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(width=17), dict(width=40, height=9),
                                dict(width=12, x_range=(2.0, 30.0),
                                     y_range=(5.0, 20.0))])
def test_canvas_like_matches_jax(kw):
    rng = np.random.default_rng(4)
    data = rng.random((23, 31)).astype(np.float32)
    coords = {"y": np.linspace(20.0, 0.0, 23), "x": np.linspace(0, 30, 31)}
    ref = JU.canvas_like(JaxDataArray(data, dims=("y", "x"), coords=coords,
                                      name="r", attrs={"u": 1}), **kw)
    out = TU.canvas_like(xt.DataArray(data, dims=("y", "x"), coords=coords,
                                      name="r", attrs={"u": 1}), **kw)
    assert_bits(out.data, ref.data)
    assert out.name == "r" and out.attrs == ref.attrs
    for c in ("x", "y"):
        assert_bits(out[c].values, np.asarray(ref[c].data))


def test_canvas_like_keeps_a_tensor_on_its_device_and_layer():
    data = torch.arange(2 * 6 * 8, dtype=torch.float64).reshape(2, 6, 8)
    agg = xt.DataArray(data, dims=("band", "y", "x"),
                       coords={"band": np.array([1, 2]),
                               "y": np.arange(6.0), "x": np.arange(8.0)})
    out = TU.canvas_like(agg, width=4, height=3, layer=2)
    assert out.data.device.type == "cpu" and tuple(out.shape) == (3, 4)
    ref = JU.canvas_like(JaxDataArray(data.numpy(), dims=("band", "y", "x"),
                                      coords={"band": np.array([1, 2]),
                                              "y": np.arange(6.0),
                                              "x": np.arange(8.0)}),
                         width=4, height=3, layer=2)
    # the JAX package holds float64 as float32 (x64 is off); the port
    # keeps the payload's dtype
    assert out.data.dtype == torch.float64
    assert_bits(out.data.float(), ref.data)
