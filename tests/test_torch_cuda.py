"""The port's CUDA kernels against their torch twins, on the card.

Tests marked ``gpu`` skip where ``torch.cuda.is_available()`` is false;
the decision is taken inside a fixture, so every pytest worker collects
the same tests.  On a machine with a card and without jax, run them with

    python -m pytest --noconftest tests/test_torch_cuda.py -m gpu -q

(``--noconftest`` skips ``tests/conftest.py``, which imports jax).  This
file imports neither jax nor the JAX package.

Tolerances: surface products rtol 1e-4 / atol 5e-5, focal stats
rtol 1e-5 / atol 1e-5, NaN masks equal.
"""

import numpy as np
import pytest
import torch

import xrspatial_torch as xt
from xrspatial_torch.convolution import circle_kernel
from xrspatial_torch.kernels import cuda_surface, cuda_window
from xrspatial_torch.kernels.surface import PRODUCTS, surface_multi
from xrspatial_torch.kernels.window import kernel_offsets, window_stats

SURFACE_TOL = dict(rtol=1e-4, atol=5e-5)
FOCAL_TOL = dict(rtol=1e-5, atol=1e-5)
ALL_STATS = ("mean", "max", "min", "range", "std", "var", "sum")
KERNELS = {
    "circle_r1": circle_kernel(1, 1, 1.5),
    "circle_r2": circle_kernel(1, 1, 2.5),
    "custom_3x5": np.array([[1, 0, 1, 1, 0],
                            [0, 1, 1, 0, 1],
                            [1, 1, 0, 0, 0]], dtype=float),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "false")
    return torch.device("cuda", 0)


def surface_case(name):
    """(raster, (cellsize_x, cellsize_y)), as in test_torch_surface.py."""
    if name == "elevation_8x6":
        rng = np.random.default_rng(7)
        data = (rng.random((8, 6)) * 1000).astype(np.float32)
        data[0, :] = np.nan
        return data, (1.0, 1.0)
    rng = np.random.default_rng(5)
    if name == "patches_70x300":
        data = rng.random((70, 300)).astype(np.float32) * 100
        data[20:23, 120:140] = np.nan
        data[31:33, 40] = np.nan
        return data, (2.0, 3.0)
    shape = (1, 257) if name == "row_1x257" else (300, 2)
    return (rng.random(shape) * 100).astype(np.float32), (1.0, 1.0)


def focal_raster(with_inf):
    """The raster of test_torch_focal.py."""
    rng = np.random.default_rng(9)
    data = (rng.random((70, 300)) * 50).astype(np.float32)
    data[30:34, 120:135] = np.nan
    data[31:33, 128] = np.nan
    data[60:70, 250:260] = np.nan
    if with_inf:
        data[10, 10] = np.inf
        data[50, 200] = -np.inf
        data[0, 299] = np.inf
    return data


def assert_matches(got, ref, tol, msg=""):
    got = got.detach().cpu().numpy()
    ref = ref.detach().cpu().numpy()
    assert got.shape == ref.shape, msg
    assert np.array_equal(np.isnan(got), np.isnan(ref)), msg
    np.testing.assert_allclose(got, ref, equal_nan=True, err_msg=msg, **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["patches_70x300", "row_1x257", "col_300x2",
                                  "elevation_8x6"])
def test_surface_kernel_matches_twin(cuda, name):
    data, (csx, csy) = surface_case(name)
    x = torch.from_numpy(data).to(cuda)
    got = cuda_surface.surface_cuda(x, PRODUCTS, csx, csy, 225.0, 25.0)
    ref = surface_multi(x, csx, csy, 225.0, 25.0, PRODUCTS)
    torch.cuda.synchronize()
    for p, g in zip(PRODUCTS, got):
        assert g.device == x.device
        assert_matches(g, ref[p], SURFACE_TOL, p)


@pytest.mark.gpu
@pytest.mark.parametrize("with_inf", [False, True], ids=["nan", "nan_inf"])
@pytest.mark.parametrize("kname", list(KERNELS))
def test_focal_kernel_matches_twin(cuda, kname, with_inf):
    x = torch.from_numpy(focal_raster(with_inf)).to(cuda)
    offsets = kernel_offsets(KERNELS[kname])
    got = cuda_window.focal_stats_cuda(x, offsets, ALL_STATS)
    ref = window_stats(x, offsets, ALL_STATS)
    torch.cuda.synchronize()
    assert got.shape == (len(ALL_STATS),) + x.shape
    for i, s in enumerate(ALL_STATS):
        assert_matches(got[i], ref[s], FOCAL_TOL, s)


@pytest.mark.gpu
def test_terrain_pipeline_launches_each_kernel_once(cuda):
    data, _ = surface_case("patches_70x300")
    attrs = {"res": (2.0, 3.0)}
    on_card = xt.DataArray(torch.from_numpy(data).to(cuda), dims=("y", "x"),
                           name="dem", attrs=attrs)
    on_host = xt.DataArray(data, dims=("y", "x"), name="dem", attrs=attrs)
    before = (cuda_surface.LAUNCHES, cuda_window.LAUNCHES)
    got = xt.terrain_pipeline(on_card)
    torch.cuda.synchronize()
    assert (cuda_surface.LAUNCHES, cuda_window.LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    ref = xt.terrain_pipeline(on_host)
    assert list(got.data_vars) == list(ref.data_vars)
    for k in ("dem-slope", "dem-hillshade", "focal_stats"):
        assert got[k].data.device.type == "cuda", k
        tol = FOCAL_TOL if k == "focal_stats" else SURFACE_TOL
        assert_matches(got[k].data, ref[k].data, tol, k)


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["slope", "aspect", "curvature", "hillshade"])
def test_public_op_runs_the_kernel(cuda, op):
    data, res = surface_case("patches_70x300")
    attrs = {"res": res}
    on_card = xt.DataArray(torch.from_numpy(data).to(cuda), dims=("y", "x"),
                           attrs=attrs)
    before = cuda_surface.LAUNCHES
    got = getattr(xt, op)(on_card)
    torch.cuda.synchronize()
    assert cuda_surface.LAUNCHES == before + 1
    ref = getattr(xt, op)(xt.DataArray(data, dims=("y", "x"), attrs=attrs))
    assert_matches(got.data, ref.data, SURFACE_TOL, op)


@pytest.mark.parametrize("call", [
    lambda x: cuda_surface.surface_cuda(x, ("slope",)),
    lambda x: cuda_window.focal_stats_cuda(x, ((0, 0), (0, 1)), ("mean",)),
], ids=["surface_cuda", "focal_stats_cuda"])
def test_raw_wrappers_refuse_a_cpu_tensor(call):
    """The kernel wrappers never run the twin: a CPU tensor is refused
    before anything is built or launched."""
    before = (cuda_surface.LAUNCHES, cuda_window.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        call(torch.ones((4, 5)))
    assert (cuda_surface.LAUNCHES, cuda_window.LAUNCHES) == before
