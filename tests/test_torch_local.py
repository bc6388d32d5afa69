"""Parity of the port's local (across-variables) tools with the JAX package
(CPU).

The same seeded Datasets (4 variables of 24x32: small integers, so that
ties and repeated values are common, and floats; NaN patches in the data
variables and in the reference) go through ``xrspatial_tpu.local`` and
``xrspatial_torch.local``: equal at every cell with NaN equal to NaN;
mean and std within rtol 1e-6.  Each trap where torch's default differs
from jnp's is pinned: the median of an even count, std's ddof, negative
and out-of-range reference indices, first-occurrence ties.  Outputs are
bare DataArrays on the variables' device; ``combine`` ids and keys equal.
"""

import numpy as np
import pytest
import torch

import xrspatial_torch as xt
from xrspatial_torch import local as tl
from xrspatial_tpu import local as jl
from xrspatial_tpu.xrlib import DataArray as JaxDataArray
from xrspatial_tpu.xrlib import Dataset as JaxDataset

RTOL = 1e-6
SHAPE = (24, 32)
DATA = ["v0", "v1", "v2", "v3"]


@pytest.fixture(autouse=True)
def numpy_rasters_on_the_cpu():
    """These tests give numpy rasters and compare on the CPU."""
    saved = xt.default_device()
    xt.set_default_device("cpu")
    yield
    xt.set_default_device(saved)


def variables(kind, seed=9):
    rng = np.random.default_rng(seed)
    out = {}
    for k in DATA:
        if kind == "int":
            out[k] = rng.integers(0, 5, SHAPE).astype(np.float32)
        else:
            out[k] = (rng.random(SHAPE) * 100).astype(np.float32)
    out["v1"][3:6, 4:9] = np.nan
    out["v3"][20, 30] = np.nan
    ref = rng.integers(-6, 7, SHAPE).astype(np.float32)
    ref[0, :6] = [np.nan, np.inf, -np.inf, 1e10, -1e10, 2.7]
    ref[1, :3] = [-2.7, 0.5, -0.5]
    out["ref"] = ref
    return out


def both(values):
    kw = dict(dims=("y", "x"), coords={"x": np.arange(SHAPE[1]) * 1.0})
    return (JaxDataset({k: JaxDataArray(v, **kw) for k, v in values.items()}),
            xt.Dataset({k: xt.DataArray(v, **kw)
                        for k, v in values.items()}))


def assert_same(ref, got, rtol=0.0):
    r = np.asarray(ref.data)
    assert isinstance(got.data, torch.Tensor)
    assert got.dims == ref.dims and len(got.coords) == len(ref.coords) == 0
    g = got.values
    assert g.dtype == r.dtype, (g.dtype, r.dtype)
    np.testing.assert_allclose(g, r, rtol=rtol, atol=0, equal_nan=True)


FUNCS = ("max", "mean", "median", "min", "std", "sum")


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("func", FUNCS)
def test_cell_stats_matches_the_jax_package(func, kind):
    j, t = both(variables(kind))
    ref = jl.cell_stats(j, data_vars=DATA, func=func)
    got = tl.cell_stats(t, data_vars=DATA, func=func)
    assert_same(ref, got, rtol=RTOL if func in ("mean", "std") else 0.0)


def test_cell_stats_default_takes_every_variable():
    values = variables("int")
    del values["ref"]
    j, t = both(values)
    assert_same(jl.cell_stats(j), tl.cell_stats(t))


def column(values):
    """A 1x1 Dataset, one variable per value."""
    data = {f"v{i}": np.array([[v]], np.float32)
            for i, v in enumerate(values)}
    return (JaxDataset({k: JaxDataArray(v) for k, v in data.items()}),
            xt.Dataset({k: xt.DataArray(v) for k, v in data.items()}))


@pytest.mark.parametrize("values, expected", [
    ((1.0, 2.0, 5.0, 4.0), 3.0), ((1.0, 2.0, 5.0), 2.0),
    ((1.0, np.nan, 5.0, 4.0), np.nan), ((7.0, 7.0), 7.0)],
    ids=["even", "odd", "nan", "pair"])
def test_median_averages_the_two_middle_values(values, expected):
    """jnp.median averages the middle pair; torch.median takes the
    lower (2.0 on [1, 2, 5, 4])."""
    j, t = column(values)
    got = tl.cell_stats(t, func="median").values[0, 0]
    ref = np.asarray(jl.cell_stats(j, func="median").data)[0, 0]
    np.testing.assert_array_equal([got], [ref])
    np.testing.assert_array_equal([got], [expected])
    if len(values) == 4 and not np.isnan(expected):
        assert float(torch.tensor(values).median()) == 2.0


def test_std_is_the_population_std():
    """jnp.std has ddof 0 (1.5811 on [1, 2, 5, 4]); torch.std's default
    is unbiased (1.8257)."""
    values = (1.0, 2.0, 5.0, 4.0)
    j, t = column(values)
    got = tl.cell_stats(t, func="std").values[0, 0]
    ref = np.asarray(jl.cell_stats(j, func="std").data)[0, 0]
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    np.testing.assert_allclose(got, np.std(values), rtol=RTOL)
    assert abs(float(torch.tensor(values).std()) - 1.8257) < 1e-4


FREQUENCIES = ("lesser_frequency", "equal_frequency", "greater_frequency")


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("func", FREQUENCIES + ("popularity", "rank"))
def test_reference_tools_match_the_jax_package(func, kind):
    j, t = both(variables(kind))
    assert_same(getattr(jl, func)(j, "ref"), getattr(tl, func)(t, "ref"))


@pytest.mark.parametrize("func", FREQUENCIES + ("popularity", "rank"))
def test_reference_tools_on_chosen_variables(func):
    j, t = both(variables("int", seed=2))
    assert_same(getattr(jl, func)(j, "ref", data_vars=["v2", "v0", "v3"]),
                getattr(tl, func)(t, "ref", data_vars=["v2", "v0", "v3"]))


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("func", ["lowest_position", "highest_position"])
def test_positions_match_the_jax_package(func, kind):
    j, t = both(variables(kind))
    assert_same(getattr(jl, func)(j, data_vars=DATA),
                getattr(tl, func)(t, data_vars=DATA))


def test_positions_take_the_first_tie():
    j, t = column((3.0, 1.0, 1.0, 3.0))
    assert tl.lowest_position(t).values[0, 0] == 2.0
    assert tl.highest_position(t).values[0, 0] == 1.0
    assert_same(jl.lowest_position(j), tl.lowest_position(t))
    assert_same(jl.highest_position(j), tl.highest_position(t))


@pytest.mark.parametrize("ref, pop, rnk", [
    (1.0, 1.0, 1.0), (2.0, 4.0, 4.0), (3.0, 9.0, 4.0),
    (-1.0, 4.0, 4.0), (-2.0, 1.0, 4.0), (-5.0, 0.0, np.nan),
    (0.0, 9.0, 9.0), (np.nan, 9.0, 9.0), (5.0, np.nan, np.nan),
    (-np.inf, np.nan, np.nan), (np.inf, np.nan, np.nan)],
    ids=["first", "second", "past_unique", "minus1", "minus2", "below",
         "zero", "nan", "past_all", "minus_inf", "inf"])
def test_reference_indices_wrap_and_saturate(ref, pop, rnk):
    """Values (1, 4, 4, 9): sorted unique (1, 4, 9).  A reference converts
    to int32 as XLA converts (NaN to 0, infinities saturated) and indexes
    from 1; 0 and negatives wrap like a python index (popularity gives 0
    where the wrapped index is still negative); -inf saturates to
    INT32_MIN, whose index wraps to INT32_MAX."""
    data = {f"v{i}": np.array([[v]], np.float32)
            for i, v in enumerate((1.0, 4.0, 4.0, 9.0))}
    data["ref"] = np.array([[ref]], np.float32)
    j = JaxDataset({k: JaxDataArray(v) for k, v in data.items()})
    t = xt.Dataset({k: xt.DataArray(v) for k, v in data.items()})
    for func, expected in (("popularity", pop), ("rank", rnk)):
        got = getattr(tl, func)(t, "ref").values[0, 0]
        np.testing.assert_array_equal([got], [expected], err_msg=func)
        assert_same(getattr(jl, func)(j, "ref"), getattr(tl, func)(t, "ref"))


def test_popularity_is_nan_where_all_values_differ():
    data = {f"v{i}": np.array([[v]], np.float32)
            for i, v in enumerate((1.0, 2.0, 3.0))}
    data["ref"] = np.array([[1.0]], np.float32)
    t = xt.Dataset({k: xt.DataArray(v) for k, v in data.items()})
    assert np.isnan(tl.popularity(t, "ref").values[0, 0])


@pytest.mark.parametrize("kind", ["int", "float"])
def test_combine_matches_the_jax_package(kind):
    values = variables(kind)
    del values["ref"]
    j, t = both(values)
    ref, got = jl.combine(j), tl.combine(t)
    assert_same(ref, got)
    assert got.attrs["key"] == ref.attrs["key"]
    assert got.data.dtype == torch.float64


def test_outputs_stay_on_the_variables_device():
    values = variables("int")
    t = xt.Dataset({k: xt.DataArray(torch.from_numpy(v), dims=("y", "x"))
                    for k, v in values.items()})
    outs = [tl.cell_stats(t, DATA, f) for f in FUNCS]
    outs += [getattr(tl, f)(t, "ref") for f in FREQUENCIES
             + ("popularity", "rank")]
    outs += [tl.lowest_position(t, DATA), tl.combine(t, DATA)]
    for out in outs:
        assert isinstance(out.data, torch.Tensor)
        assert out.data.device.type == "cpu" and len(out.coords) == 0


@pytest.mark.parametrize("call, error", [
    (lambda m, ds: m.cell_stats(ds["v0"]), TypeError),
    (lambda m, ds: m.cell_stats(ds, func="mode"), ValueError),
    (lambda m, ds: m.rank(ds, "w"), ValueError),
    (lambda m, ds: m.rank(ds, 3), TypeError),
    (lambda m, ds: m.rank(ds, "ref", data_vars=["ref", "v0"]), ValueError),
    (lambda m, ds: m.combine(ds, data_vars="v0"), TypeError),
    (lambda m, ds: m.combine(ds, data_vars=["v9"]), ValueError),
], ids=["not_dataset", "func", "no_ref", "ref_type", "ref_in_data",
        "data_vars_type", "missing_var"])
def test_errors_match_the_jax_package(call, error):
    j, t = both(variables("int"))
    with pytest.raises(error) as ref:
        call(jl, j)
    with pytest.raises(error) as got:
        call(tl, t)
    assert str(got.value) == str(ref.value)
