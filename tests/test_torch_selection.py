"""The port's percentiles against ``jnp.nanpercentile`` (CPU).

``xrspatial_torch.kernels.selection.nanpercentile`` sorts with
``torch.sort`` and copies ``jnp.nanpercentile``'s float32 interpolation as
XLA evaluates it (``q * ((counts - 1) * 0.01)``, then one multiply-add):
on the same seeded float32 data (NaN cells included) it equals
``jnp.nanpercentile`` bit for bit, where the source's own arithmetic
(``q / 100``, two products summed) does not.  The JAX package's radix
select (``nanpercentile_select``, its TPU path) selects the same order
statistics; XLA rounds its interpolation in another order, so it is held
within rtol 1e-6.  Above 2^24 finite values the float32 count rounds; the
integer rank clamp keeps q = 100 on the largest finite value there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrspatial_torch.kernels.selection import nanpercentile
from xrspatial_tpu.kernels.selection import nanpercentile_select

PCTS = {
    "quartiles": [25.0, 50.0, 75.0, 100.0],
    "quintiles": [20.0, 40.0, 60.0, 80.0, 100.0],
    "thirds": [100 / 3, 200 / 3, 100.0],
    "ends": [0.0, 100.0],
    "fine": [0.1, 1.0, 33.3, 49.99, 99.9],
}


def data(kind, n=4096, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        v = rng.random(n).astype(np.float32) * 100
    elif kind == "normal":
        v = (rng.normal(size=n) * 1e3).astype(np.float32)
    else:                                    # many ties
        v = rng.integers(0, 7, n).astype(np.float32)
    v[rng.integers(0, n, n // 10)] = np.nan
    return v


def expected(v, pct):
    return np.asarray(jnp.nanpercentile(jnp.asarray(v),
                                        jnp.asarray(np.float32(pct))))


@pytest.mark.parametrize("kind", ["uniform", "normal", "ties"])
@pytest.mark.parametrize("pct", list(PCTS.values()), ids=list(PCTS))
def test_equals_jnp_nanpercentile_bit_for_bit(pct, kind):
    v = data(kind)
    got = nanpercentile(torch.from_numpy(v), np.float32(pct))
    assert got.dtype == torch.float32 and got.shape == (len(pct),)
    np.testing.assert_array_equal(got.numpy(), expected(v, pct))


@pytest.mark.parametrize("n", [1, 2, 3, 17])
def test_short_inputs(n):
    v = data("normal", n=n, seed=n)
    v[0] = 5.0                                # at least one finite value
    got = nanpercentile(torch.from_numpy(v), np.float32(PCTS["fine"]))
    np.testing.assert_array_equal(got.numpy(), expected(v, PCTS["fine"]))


def test_all_nan_gives_nan():
    v = np.full(10, np.nan, np.float32)
    got = nanpercentile(torch.from_numpy(v), np.float32([50.0, 100.0]))
    assert torch.isnan(got).all()
    assert np.isnan(expected(v, [50.0, 100.0])).all()


def test_the_sources_arithmetic_is_not_xlas():
    """``(q / 100) * (counts - 1)`` and ``low*lw + high*hw``, rounded op
    by op, miss jnp.nanpercentile's bits on this data; XLA's evaluation
    order, which the port copies, hits them."""
    v = data("normal", seed=1)
    pct = np.float32(PCTS["fine"])
    s = np.sort(v)
    c = np.float32(np.isfinite(v).sum())
    misses = 0
    for t in ((pct / np.float32(100)) * (c - 1),
              pct * ((c - 1) * np.float32(0.01))):
        lo, hi = np.floor(t), np.ceil(t)
        hw = t - lo
        plain = s[lo.astype(int)] * (1 - hw) + s[hi.astype(int)] * hw
        misses += not np.array_equal(plain, expected(v, pct))
    assert misses == 2
    np.testing.assert_array_equal(
        nanpercentile(torch.from_numpy(v), pct).numpy(), expected(v, pct))


@pytest.mark.parametrize("pct", [PCTS["quintiles"], [0.0, 50.0, 100.0]],
                         ids=["quintiles", "integral_ranks"])
def test_the_jax_packages_radix_select_agrees(pct):
    v = data("normal", n=3000, seed=5)
    pct = np.float32(pct)
    radix = np.asarray(nanpercentile_select(jnp.asarray(v), jnp.asarray(pct),
                                            len(pct)))
    got = nanpercentile(torch.from_numpy(v), pct).numpy()
    np.testing.assert_allclose(got, radix, rtol=1e-6)


def test_rank_clamp_above_2_24():
    """2^24 + 3 finite values then NaN: the float32 count rounds to 2^24 +
    4, so without the integer clamp q = 100 would take rank 2^24 + 3, a
    NaN; with it, the largest finite value."""
    n = 2 ** 24 + 3
    v = torch.arange(n + 5, dtype=torch.float32) % 1000
    v[n:] = float("nan")
    v[n - 1] = 5000.0
    got = nanpercentile(v, np.float32([0.0, 100.0]))
    assert got.tolist() == [0.0, 5000.0]
