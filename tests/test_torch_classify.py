"""Parity of the port's classifiers with the JAX package (CPU).

The same seeded float32 rasters (64x64 with NaN and +-inf cells; uniform
floats, and small integers whose ties leave fewer unique breaks) go
through ``xrspatial_tpu.classify`` and ``xrspatial_torch.classify``:
classes equal at every cell, NaN equal to NaN, coords, dims, attrs and
name equal.  The quantile and percentile breaks equal the JAX package's
bit for bit.

``natural_breaks``: the Jenks dynamic program sums its variances in
float32, and XLA's cumulative sum adds in another order than torch's, so
a near-tie may pick another break.  The port's breaks equal the JAX
suite's sequential loop oracle (``reference_impl.ref_jenks``) bit for bit,
and the JAX package's on the suite's fixtures (its DP draws and its three
clusters); where near-ties decide (seeded uniform data, five breaks in
three clusters) the float64 within-class variance of the two sets of
breaks agrees within rtol 1e-5.  Samples are at most 600 values.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xrspatial_torch as xt
from reference_impl import ref_jenks
from xrspatial_torch import classify as tc
from xrspatial_tpu import classify as jc
from xrspatial_tpu.xrlib import DataArray as JaxDataArray
from xrspatial_tpu.xrlib import Dataset as JaxDataset

VAR_RTOL = 1e-5
SHAPE = (64, 64)


@pytest.fixture(autouse=True)
def numpy_rasters_on_the_cpu():
    """These tests give numpy rasters and compare on the CPU."""
    saved = xt.default_device()
    xt.set_default_device("cpu")
    yield
    xt.set_default_device(saved)


def raster(kind, seed=7):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        a = (rng.random(SHAPE) * 100).astype(np.float32)
    else:
        a = rng.integers(0, 6, SHAPE).astype(np.float32)
    a[10:13, 20:30] = np.nan
    a[3, 3], a[4, 4] = np.inf, -np.inf
    return a


def both(data, name="elev"):
    kw = dict(dims=("y", "x"), name=name, attrs={"res": (10.0, 10.0)},
              coords={"y": np.arange(data.shape[0]) * -10.0,
                      "x": np.arange(data.shape[1]) * 10.0})
    return JaxDataArray(data, **kw), xt.DataArray(data, **kw)


def assert_same(ref, got):
    r = np.asarray(ref.data)
    assert isinstance(got.data, torch.Tensor)
    assert got.data.dtype == torch.float32 and r.dtype == np.float32
    np.testing.assert_array_equal(got.values, r)
    assert got.dims == ref.dims and got.name == ref.name
    assert got.attrs == dict(ref.attrs)
    for d in ("y", "x"):
        np.testing.assert_array_equal(got.coords[d].values,
                                      np.asarray(ref.coords[d].data))


CALLS = {
    "binary": lambda m, a: m.binary(a, [1, 2, 3.5]),
    "reclassify": lambda m, a: m.reclassify(a, [10, 35, 50, 100],
                                            [1, 2, 3, 4]),
    "reclassify_unsorted": lambda m, a: m.reclassify(a, [50, 10, 100, 35],
                                                     [7, 8, 9, 6]),
    "quantile": lambda m, a: m.quantile(a, k=5),
    "quantile_k4": lambda m, a: m.quantile(a),
    "percentiles": lambda m, a: m.percentiles(a),
    "percentiles_chosen": lambda m, a: m.percentiles(a, [1, 10, 33.3, 99]),
    "equal_interval": lambda m, a: m.equal_interval(a),
    "equal_interval_k3": lambda m, a: m.equal_interval(a, k=3),
    "std_mean": lambda m, a: m.std_mean(a),
    "box_plot": lambda m, a: m.box_plot(a),
    "box_plot_hinge": lambda m, a: m.box_plot(a, hinge=0.5),
    "head_tail_breaks": lambda m, a: m.head_tail_breaks(a),
    "maximum_breaks": lambda m, a: m.maximum_breaks(a),
    "maximum_breaks_k3": lambda m, a: m.maximum_breaks(a, k=3),
}


@pytest.mark.parametrize("kind", ["uniform", "ties"])
@pytest.mark.parametrize("call", list(CALLS.values()), ids=list(CALLS))
def test_classes_match_the_jax_package(call, kind):
    j, t = both(raster(kind))
    assert_same(call(jc, j), call(tc, t))


@pytest.mark.parametrize("kind", ["uniform", "ties"])
@pytest.mark.parametrize("k", [3, 5, 7])
def test_quantile_breaks_bit_for_bit(k, kind):
    data = raster(kind)
    ref = jc._quantile_bins(jnp.asarray(data), k)
    got = tc._quantile_bins(torch.from_numpy(data), k)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_percentile_breaks_bit_for_bit():
    data = raster("uniform", seed=11)
    p = np.asarray([5.0, 25.0, 50.0, 62.5, 75.0, 99.9])
    np.testing.assert_array_equal(
        tc._nanpercentile(torch.from_numpy(data), p),
        np.asarray(jc._nanpercentile(jnp.asarray(data), p)))


def test_quantile_docstring_golden():
    """The reference's quantile docstring example."""
    data = np.array([
        [np.nan, 1., 2., 3., 4.],
        [5., 6., 7., 8., 9.],
        [10., 11., 12., 13., 14.],
        [15., 16., 17., 18., 19.],
        [20., 21., 22., 23., np.inf]], dtype=np.float64)
    ref = np.asarray(jc.quantile(JaxDataArray(data), k=5).data)
    got = tc.quantile(xt.DataArray(data), k=5).values
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[1], [0, 1, 1, 1, 1])


def test_quantile_with_too_few_values_warns_like_the_jax_package(capsys):
    j, t = both(np.array([[1.0, 1.0, 2.0, 2.0]], np.float32))
    assert_same(jc.quantile(j, k=4), tc.quantile(t, k=4))
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[0] == out[1]
    assert out[0].startswith("Quantile Warning")


@pytest.mark.parametrize("name", ["box_plot", "maximum_breaks",
                                  "natural_breaks", "quantile",
                                  "equal_interval", "head_tail_breaks"])
def test_all_nan_input(name):
    j, t = both(np.full((4, 5), np.nan, np.float32))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref, got = getattr(jc, name)(j), getattr(tc, name)(t)
    assert_same(ref, got)
    assert np.isnan(got.values).all()


def test_constant_raster():
    j, t = both(np.full((4, 5), 3.0, np.float32))
    for name in ("equal_interval", "std_mean", "box_plot",
                 "head_tail_breaks", "maximum_breaks"):
        assert_same(getattr(jc, name)(j), getattr(tc, name)(t))


def test_dataset_input_maps_over_variables():
    values = {"a": raster("uniform", 1), "b": raster("ties", 2)}
    jd = JaxDataset({k: JaxDataArray(v, dims=("y", "x"))
                     for k, v in values.items()}, attrs={"crs": 4326})
    td = xt.Dataset({k: xt.DataArray(v, dims=("y", "x"))
                     for k, v in values.items()}, attrs={"crs": 4326})
    ref, got = jc.quantile(jd, k=3), tc.quantile(td, k=3)
    assert list(got) == ["a", "b"] and got.attrs == {"crs": 4326}
    for k in values:
        assert got[k].name == k
        np.testing.assert_array_equal(got[k].values, np.asarray(ref[k].data))


@pytest.mark.parametrize("call, error", [
    (lambda m, a: m.reclassify(a, [1, 2], [1]), ValueError),
    (lambda m, a: m.percentiles(a, [0, 50]), ValueError),
    (lambda m, a: m.percentiles(a, [50, 101]), ValueError),
], ids=["reclassify_lengths", "pct_zero", "pct_above_100"])
def test_errors_match_the_jax_package(call, error):
    j, t = both(raster("ties"))
    with pytest.raises(error) as ref:
        call(jc, j)
    with pytest.raises(error) as got:
        call(tc, t)
    assert str(got.value) == str(ref.value)


def test_exported_classifiers_are_the_ports():
    for name in tc.__all__:
        assert getattr(xt, name) is getattr(tc, name)


# -- natural breaks ----------------------------------------------------------------

def within_class_variance(values, bins):
    """Float64 sum over classes of the squared deviations from the class
    mean, classes by the upper-bound bins (``_bin``'s rule)."""
    values = np.sort(values.astype(np.float64))
    idx = np.searchsorted(np.asarray(bins, np.float64), values, side="left")
    total = 0.0
    for c in np.unique(idx):
        part = values[idx == c]
        total += ((part - part.mean()) ** 2).sum()
    return total


def clustered(seed=6):
    """The JAX suite's clustered fixture: three normal clusters."""
    rng = np.random.default_rng(seed)
    data = np.concatenate([rng.normal(10, 1, 200), rng.normal(50, 2, 200),
                           rng.normal(90, 1, 200)]).astype(np.float32)
    rng.shuffle(data)
    return data


@pytest.mark.parametrize("n, k", [(30, 4), (100, 5), (57, 3)])
def test_jenks_equals_the_loop_oracle(n, k):
    """The JAX suite's DP fixtures: the port's breaks equal the
    sequential loop oracle's and the JAX package's."""
    rng = np.random.default_rng(5)
    for _ in range({30: 1, 100: 2, 57: 3}[n]):   # the suite's draw order
        data = (rng.random(n) * 100).astype(np.float32)
    got = tc._run_jenks(data.copy(), k, torch.device("cpu"))
    np.testing.assert_array_equal(got, ref_jenks(data.copy(), k))
    np.testing.assert_array_equal(got, jc._run_jenks(data.copy(), k))


def test_natural_breaks_on_clusters_match_the_jax_package():
    data = clustered().reshape(20, 30)
    j, t = both(data)
    got = tc.natural_breaks(t, k=3)
    assert_same(jc.natural_breaks(j, k=3), got)
    classes = got.values
    assert set(np.unique(classes)) == {0.0, 1.0, 2.0}
    assert (classes[(data > 30) & (data < 70)] == 1.0).all()


def test_five_breaks_in_three_clusters():
    """Two breaks fall inside a cluster, among near-ties: the port's breaks
    equal the sequential loop oracle's; the JAX package's, from XLA's
    cumulative sums, reach the same within-class variance within rtol
    1e-5."""
    values = clustered()
    got = tc._run_jenks(values.copy(), 5, torch.device("cpu"))
    np.testing.assert_array_equal(got, ref_jenks(values.copy(), 5))
    ref = jc._run_jenks(values.copy(), 5)
    np.testing.assert_allclose(within_class_variance(values, got[1:]),
                               within_class_variance(values, ref[1:]),
                               rtol=VAR_RTOL)


def test_natural_breaks_sampled_matches_the_jax_package():
    """num_sample below the cell count: the fixed-seed sampler picks the
    same 400 values in both packages."""
    data = clustered(seed=8).reshape(24, 25)
    j, t = both(data)
    assert_same(jc.natural_breaks(j, num_sample=400, k=4),
                tc.natural_breaks(t, num_sample=400, k=4))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_natural_breaks_on_uniform_data(seed):
    """Near-ties are common on uniform data: the breaks may differ, the
    within-class variance they reach agrees within rtol 1e-5."""
    rng = np.random.default_rng(seed)
    values = (rng.random(500) * 100).astype(np.float32)
    k = 5
    ref = jc._run_jenks(values.copy(), k)[1:]
    got = tc._run_jenks(values.copy(), k, torch.device("cpu"))[1:]
    np.testing.assert_allclose(within_class_variance(values, got),
                               within_class_variance(values, ref),
                               rtol=VAR_RTOL)


def test_jenks_ties_go_to_the_larger_last_class():
    """[0, 1, 2] into 2 classes: {0} {1, 2} and {0, 1} {2} tie at 0.5;
    the DP keeps the larger m, the longer last class, as the JAX package
    does."""
    data = np.array([0.0, 1.0, 2.0], np.float32)
    got = tc._run_jenks(data.copy(), 2, torch.device("cpu"))
    np.testing.assert_array_equal(got, jc._run_jenks(data.copy(), 2))
    np.testing.assert_array_equal(got, [0.0, 0.0, 2.0])


def test_natural_breaks_with_too_few_unique_values_warns():
    j, t = both(np.array([[1.0, 2.0]] * 3, np.float32))
    with pytest.warns(Warning, match="Not enough unique values"):
        ref = jc.natural_breaks(j, k=5)
    with pytest.warns(Warning, match="Not enough unique values"):
        got = tc.natural_breaks(t, k=5)
    assert_same(ref, got)


def test_jenks_matrix_runs_on_the_samples_device():
    data = torch.sort(torch.rand(40)).values
    lcl = tc.jenks_matrix(data, 4)
    assert lcl.shape == (41, 5) and lcl.device == data.device
    assert lcl.dtype == torch.float32
