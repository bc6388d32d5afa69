"""Parity of the torch port's polygonize with the JAX package (CPU).

``polygonize`` is host numpy in both packages; the same rasters (and
masks) go through ``xrspatial_tpu.experimental`` and
``xrspatial_torch.experimental``, as numpy payloads and as tensors.  The
columns and every ring are compared exactly.
"""

import numpy as np
import pytest
import torch

import xrspatial_torch as xt
from xrspatial_torch.experimental import polygonize
from xrspatial_torch.experimental.polygonize import _signed_area
from xrspatial_tpu.experimental import polygonize as jax_polygonize
from xrspatial_tpu.xrlib import DataArray as JaxDataArray


@pytest.fixture(autouse=True)
def numpy_rasters_on_the_cpu():
    saved = xt.default_device()
    xt.set_default_device("cpu")
    yield
    xt.set_default_device(saved)


def assert_same(got, ref):
    (c_got, p_got), (c_ref, p_ref) = got, ref
    assert [type(v) for v in c_got] == [type(v) for v in c_ref]
    assert c_got == c_ref
    assert len(p_got) == len(p_ref)
    for rings_got, rings_ref in zip(p_got, p_ref):
        assert len(rings_got) == len(rings_ref)
        for a, b in zip(rings_got, rings_ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def run_both(data, mask=None, tensor=False, **kw):
    port_data = torch.from_numpy(data) if tensor else data
    port_mask = None
    jax_mask = None
    if mask is not None:
        port_mask = xt.DataArray(torch.from_numpy(mask) if tensor else mask)
        jax_mask = JaxDataArray(mask)
    got = polygonize(xt.DataArray(port_data), mask=port_mask, **kw)
    ref = jax_polygonize(JaxDataArray(data), mask=jax_mask, **kw)
    assert_same(got, ref)
    return got


def test_single_region_hole_and_values():
    column, polys = run_both(np.ones((3, 4)))
    assert column == [1.0] and len(polys[0]) == 1
    assert _signed_area(polys[0][0]) == pytest.approx(12.0)
    data = np.ones((5, 5), dtype=np.int64)
    data[2, 2] = 9
    column, polys = run_both(data)
    assert column == [1, 9] and len(polys[0]) == 2
    assert _signed_area(polys[0][1]) == pytest.approx(-1.0)


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("tensor", [False, True])
def test_classified_rasters_match_jax(connectivity, tensor):
    """A quantised random field: many regions, holes, diagonal touches,
    NaN cells excluded."""
    rng = np.random.default_rng(11)
    base = rng.random((6, 8))
    field = np.kron(base, np.ones((4, 4)))[:23, :29] + \
        rng.random((23, 29)) * 0.3
    data = np.floor(field * 3).astype(np.float32)
    data[rng.random((23, 29)) < 0.03] = np.nan
    run_both(data, connectivity=connectivity, tensor=tensor)


@pytest.mark.parametrize("tensor", [False, True])
def test_mask_and_transform_match_jax(tensor):
    rng = np.random.default_rng(2)
    data = rng.integers(0, 3, (9, 11)).astype(np.int64)
    mask = (rng.random((9, 11)) > 0.2).astype(np.int64)
    run_both(data, mask=mask, tensor=tensor)
    transform = np.array([2.0, 0.0, 10.0, 0.0, -3.0, 100.0])
    got = run_both(data, transform=transform, tensor=tensor)
    assert got[1][0][0][:, 0].min() >= 10.0


def test_connectivity_8_diagonals():
    data = np.array([[1, 0], [0, 1]], dtype=np.int64)
    c8, p8 = run_both(data, connectivity=8)
    assert sorted(c8) == [0, 0, 1, 1]
    for rings in p8:
        assert len(rings) == 1 and _signed_area(rings[0]) == 1.0


def test_validation_matches_jax():
    cases = (dict(connectivity=6), dict(transform=np.zeros(4)),
             dict(mask=np.ones((3, 3))), dict(return_type="bogus"))
    for kw in cases:
        port_kw, jax_kw = dict(kw), dict(kw)
        if "mask" in kw:
            port_kw["mask"] = xt.DataArray(kw["mask"])
            jax_kw["mask"] = JaxDataArray(kw["mask"])
        with pytest.raises(ValueError) as jax_err:
            jax_polygonize(JaxDataArray(np.ones((2, 2))), **jax_kw)
        with pytest.raises(ValueError) as err:
            polygonize(xt.DataArray(np.ones((2, 2))), **port_kw)
        assert str(err.value) == str(jax_err.value)
