"""Parity of the port's cast-shadow hillshade with the JAX package (CPU).

The same seeded numpy rasters go through ``xrspatial_tpu`` and
``xrspatial_torch`` with ``hillshade(..., shadows=True)``.  The lit mask
(``kernels/shadows.py::shadow_mask``) must be equal at every cell; the
shade within rtol 1e-6 / atol 1e-6 (``rsqrt`` and the normal's dot
product may differ by a float32 ulp), NaN masks equal.  The ray march's
per-step offsets, computed on the host by the port, equal the JAX
package's device values bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xrspatial_torch as xt
import xrspatial_tpu as xj
from xrspatial_torch.kernels import shadows as tshadows
from xrspatial_tpu.kernels import shadows as jshadows
from xrspatial_tpu.xrlib import DataArray as JaxDataArray


@pytest.fixture(autouse=True)
def numpy_rasters_on_the_cpu():
    """These tests give numpy rasters and compare on the CPU."""
    saved = xt.default_device()
    xt.set_default_device("cpu")
    yield
    xt.set_default_device(saved)


SHADE_TOL = dict(rtol=1e-6, atol=1e-6)
AZIMUTHS = (0, 45, 90, 180, 225, 270, 315, 359)
ALTITUDES = (10, 25, 45)


def wall():
    """tests/test_surface.py's east-west wall, res (1, 1)."""
    data = np.zeros((32, 32), dtype=np.float32)
    data[16, :] = 50.0
    return data, (1, 1)


def hills_with_nan():
    """Smooth hills on a ragged grid with a NaN patch, res (30, -30)."""
    iy, ix = np.mgrid[0:83, 0:117].astype(np.float32)
    data = (400 * np.exp(-((iy - 40) ** 2 + (ix - 60) ** 2) / 900)
            + 15 * np.sin(ix / 5) * np.cos(iy / 7)).astype(np.float32)
    data[30:36, 70:80] = np.nan
    return data, (30.0, -30.0)


def noise():
    rng = np.random.default_rng(3)
    data = (rng.random((50, 64)) * 100).astype(np.float32)
    data[10:13, 20:26] = np.nan
    return data, (2.0, 3.0)


CASES = {"wall": wall, "hills_with_nan": hills_with_nan, "noise": noise}


def both(data, res):
    dims = ("y", "x")
    return (JaxDataArray(data, dims=dims, attrs={"res": res}, name="dem"),
            xt.DataArray(data, dims=dims, attrs={"res": res}, name="dem"))


@pytest.mark.parametrize("azimuth", AZIMUTHS)
@pytest.mark.parametrize("case", list(CASES))
def test_hillshade_shadows_matches_jax(case, azimuth):
    data, res = CASES[case]()
    ja, ta = both(data, res)
    for altitude in (10, 45):
        ref = np.asarray(xj.hillshade(ja, azimuth=azimuth,
                                      angle_altitude=altitude,
                                      shadows=True).data)
        got = xt.hillshade(ta, azimuth=azimuth, angle_altitude=altitude,
                           shadows=True)
        assert isinstance(got.data, torch.Tensor)
        assert got.data.dtype == torch.float32 and got.name == "hillshade"
        out = got.values
        assert np.array_equal(np.isnan(out), np.isnan(ref))
        np.testing.assert_allclose(out, ref, equal_nan=True, **SHADE_TOL)


@pytest.mark.parametrize("altitude", ALTITUDES)
@pytest.mark.parametrize("case", list(CASES))
def test_lit_mask_equal_at_every_cell(case, altitude):
    data, (csx, csy) = CASES[case]()
    csy = abs(csy)
    for azimuth in AZIMUTHS:
        ref = np.asarray(jshadows.shadow_mask(jnp.asarray(data), azimuth,
                                              altitude, csx, csy))
        got = tshadows.shadow_mask(torch.from_numpy(data), azimuth, altitude,
                                   csx, csy)
        assert got.dtype == torch.bool
        assert np.array_equal(got.numpy(), ref), (azimuth, int(
            (got.numpy() != ref).sum()))


def test_wall_shadows_its_north_side():
    """tests/test_surface.py's check: the sun due south, low, shadows the
    cells north of the wall."""
    data, res = wall()
    _, ta = both(data, res)
    out = xt.hillshade(ta, azimuth=180, angle_altitude=10,
                       shadows=True).values
    assert np.nanmin(out) >= 0.0 and np.nanmax(out) <= 1.0
    assert out[5:15, 5:25].mean() < out[18:28, 5:25].mean()


@jax.jit
def jax_steps(azimuth, altitude, cellsize_x, cellsize_y, ks, pad):
    """The JAX package's per-step values: its `_sun_dir` and the scalar
    arithmetic of `_shadow_mask_impl`'s loop body, for steps `ks`."""
    sx, sy, sz = jshadows._sun_dir(azimuth, altitude)
    step = jnp.minimum(jnp.abs(cellsize_x), jnp.abs(cellsize_y))
    dc = sx * step / jnp.abs(cellsize_x)
    dr = -sy * step / jnp.abs(cellsize_y)
    dz = sz / jnp.maximum(jnp.sqrt(sx * sx + sy * sy), 1e-9) * step
    kf = ks.astype(jnp.float32)
    oy, ox = dr * kf, dc * kf
    oy0, ox0 = jnp.floor(oy), jnp.floor(ox)
    return ((pad + oy0).astype(jnp.int32), (pad + ox0).astype(jnp.int32),
            oy - oy0, ox - ox0, dz * kf)


@pytest.mark.parametrize("cellsize", [(1.0, 1.0), (30.0, 20.0)])
@pytest.mark.parametrize("altitude", ALTITUDES)
@pytest.mark.parametrize("azimuth", AZIMUTHS)
def test_step_offsets_equal_jax_bit_for_bit(azimuth, altitude, cellsize):
    n = 1024
    csx, csy = cellsize
    f32 = jnp.float32
    ref = jax_steps(f32(azimuth), f32(altitude), f32(csx), f32(csy),
                    jnp.arange(1, n + 1), n + 1)
    got = tshadows.step_offsets(azimuth, altitude, csx, csy, n)
    for name, g, r in zip(("ry", "rx", "fy", "fx", "dz*k"), got, ref):
        r = np.asarray(r)
        if name in ("ry", "rx"):
            assert np.array_equal(g, r.astype(np.int64)), name
        else:
            assert g.dtype == r.dtype == np.float32, name
            assert np.array_equal(g.view(np.int32), r.view(np.int32)), name


@pytest.mark.parametrize("azimuth", AZIMUTHS)
def test_sun_dir_equals_jax_bit_for_bit(azimuth):
    for altitude in ALTITUDES:
        ref = jax.jit(jshadows._sun_dir)(jnp.float32(azimuth),
                                         jnp.float32(altitude))
        got = tshadows._sun_dir(azimuth, altitude)
        for g, r in zip(got, ref):
            assert np.float32(g).view(np.int32) == \
                np.float32(r).view(np.int32), (azimuth, altitude)
