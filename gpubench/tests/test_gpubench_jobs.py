"""The general generator: steps call the port by name, a step takes an
earlier step's result, ``$call`` is made once, draws follow the seed."""

import torch

import xrspatial_torch as xt
from gpubench import jobs as joblib

TRAFFIC = {"steps": [
    {"op": "slope", "input": "dem", "name": "s"},
    {"op": "hillshade", "input": "s",
     "args": {"azimuth": {"$uniform": [100.0, 200.0]},
              "angle_altitude": 30.0}}]}


def dem():
    z = torch.arange(20 * 24, dtype=torch.float32).reshape(20, 24) ** 1.5
    return xt.DataArray(z, dims=("y", "x"), name="dem",
                        attrs={"res": (10.0, 10.0)})


def test_steps_chain_and_draws_follow_the_seed():
    a = joblib.Jobs(TRAFFIC, {"dem": dem()}, 7)
    b = joblib.Jobs(TRAFFIC, {"dem": dem()}, 7)
    draws = [a.draw() for _ in range(5)]
    assert draws == [b.draw() for _ in range(5)]
    az = [d[1]["azimuth"] for d in draws]
    assert len(set(az)) == 5 and all(100 <= x < 200 for x in az)
    assert draws[0][1]["angle_altitude"] == 30.0
    out = a.run(a.prepare(draws[0]))
    want = xt.hillshade(xt.slope(dem()), azimuth=az[0], angle_altitude=30.0)
    assert torch.equal(out.data.nan_to_num(-1), want.data.nan_to_num(-1))


def test_a_call_is_made_once_and_the_reference_makes_its_own(monkeypatch):
    from conftest import REPO
    from gpubench.spec import Bench
    calls = []
    import xrspatial_torch.convolution as conv
    real = conv.circle_kernel
    monkeypatch.setattr(conv, "circle_kernel",
                        lambda *a: calls.append(a) or real(*a))
    traffic = {"steps": [{"op": "focal_stats", "input": "dem",
                          "args": {"kernel": {"$call":
                                              "convolution.circle_kernel",
                                              "args": [1, 1, 1.5]}}}]}
    j = joblib.Jobs(traffic, {"dem": dem()}, 1)
    for _ in range(3):
        j.run(j.prepare(j.draw()))
    assert calls == [(1, 1, 1.5)]
    ref = joblib.reference_args(j.draw()[0], Bench(REPO))
    assert isinstance(ref["kernel"], torch.Tensor)
    assert ref["kernel"].int().tolist() == real(1, 1, 1.5).tolist()
