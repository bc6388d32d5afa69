"""The ``dem16k-sites`` deployment on the CPU: the plain references of its
three steps (``gpubench/reference/{viewshed,binary,proximity}.py``, loaded
through ``gpubench.spec.Bench``) against the port and against brute
force, on seeded DEMs of ``gpubench/dem.py`` at small sizes; and a tiny
``sites`` cell through ``gpubench.run.run`` with the real references.

Visibility flips between the port's float32 XDraw and the float64
reference are near-ties of ``inward max <= target slope``: none on these
DEMs at 97x131 and 256x256 (one of 196,608 cells at 512x384 with the
observer a third of the way in), bounded here at one in 10,000 cells.
"""

import json
import math
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import xrspatial_torch as xt

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from gpubench import dem as demlib  # noqa: E402
from gpubench import jobs as joblib  # noqa: E402
from gpubench import run  # noqa: E402
from gpubench.spec import Bench  # noqa: E402

CPU = torch.device("cpu")
EPS32 = 2.0 ** -23
FLIPS_PER_CELL = 1e-4
SEED = 2 ** 40 + 123


@pytest.fixture(autouse=True)
def on_cpu():
    before = xt.default_device()
    xt.set_default_device("cpu")
    yield
    xt.set_default_device(before)


@pytest.fixture(scope="module")
def bench():
    return Bench(REPO)


def geo(bench, shape):
    """dem16k-geo's deployment at `shape`."""
    return dict(bench.config("dem16k-geo"), shape=list(shape))


def dem_of(config, seed):
    """The configuration's DEM as the port's DataArray and the whole
    float32 raster, with its coordinates (float64 tensors)."""
    blocks = demlib.make_blocks(config, seed, [CPU])
    da = run.dem_input(xt, config, blocks, [CPU])
    coords = tuple(torch.from_numpy(c) for c in demlib.coords(config))
    return da, blocks[0][0], coords


PLACES = {"inside": (0.37, 0.55), "edge": (0.0, 0.61), "corner": (1.0, 1.0)}


@pytest.mark.parametrize("shape", [(97, 131), (256, 256)])
@pytest.mark.parametrize("place", sorted(PLACES))
def test_the_reference_viewshed_is_the_ports_xdraw(bench, shape, place):
    config = geo(bench, shape)
    da, z, coords = dem_of(config, SEED)
    ys, xs = demlib.coords(config)
    fx, fy = PLACES[place]
    args = {"x": float(xs[0] + fx * (xs[-1] - xs[0])),
            "y": float(ys[0] + fy * (ys[-1] - ys[0])),
            "observer_elev": 100.0, "target_elev": 0.0, "exact": False}
    port = xt.viewshed(da, **args).data
    ref = bench.reference("viewshed").run(z.double(), coords, args,
                                          torch.float64)["viewshed"]
    assert port.dtype == torch.float32 and ref.dtype == torch.float64
    seen_p, seen_r = port != -1, ref != -1
    flips = int((seen_p != seen_r).sum())
    assert flips <= FLIPS_PER_CELL * port.numel(), flips
    # a fair share of the raster is seen, and not all of it
    assert 0.05 * port.numel() < int(seen_r.sum()) < port.numel()
    both = seen_p & seen_r
    gap = (port.double() - ref).abs()[both]
    assert float(gap.max()) <= 8 * EPS32 * float(ref[both].abs().max())
    # the viewpoint: 180 on both sides, where the snapping put it
    r, c = (int(np.argmin(np.abs(ys - args["y"]))),
            int(np.argmin(np.abs(xs - args["x"]))))
    assert port[r, c] == 180.0 and ref[r, c] == 180.0
    assert int((ref == 180.0).sum()) == 1


def test_the_reference_viewshed_refuses_the_exact_route(bench):
    config = geo(bench, (16, 20))
    _, z, coords = dem_of(config, 1)
    with pytest.raises(NotImplementedError):
        bench.reference("viewshed").run(z.double(), coords,
                                        {"x": 50.0, "y": 50.0}, torch.float64)


def brute(hit, y, x):
    """The Euclidean distance to the nearest target over every pair, in
    float64; NaN where there is none."""
    ty, tx = torch.nonzero(hit, as_tuple=True)
    if ty.numel() == 0:
        return torch.full(hit.shape, math.nan, dtype=torch.float64)
    d2 = (y[:, None, None] - y[ty][None, None, :]) ** 2 \
        + (x[None, :, None] - x[tx][None, None, :]) ** 2
    return torch.sqrt(d2.min(-1).values)


def axes(h, w, kind, g):
    """Cell-centre coordinates north up at 10 m, or strictly monotone
    ones with random steps (x descending)."""
    if kind == "metres":
        return ((h - torch.arange(h, dtype=torch.float64) - 0.5) * 10.0,
                (torch.arange(w, dtype=torch.float64) + 0.5) * 10.0)
    y = torch.cumsum(torch.rand(h, generator=g, dtype=torch.float64) + 0.1,
                     0)
    x = -torch.cumsum(torch.rand(w, generator=g, dtype=torch.float64) + 0.1,
                      0)
    return y, x


MASKS = [((37, 53), 0.05), ((64, 64), 0.002), ((50, 70), 0.5),
         ((23, 1), 0.2), ((1, 40), 0.1), ((30, 30), 0.0)]


@pytest.mark.parametrize("kind", ["metres", "uneven"])
@pytest.mark.parametrize("shape,share", MASKS)
def test_the_reference_proximity_is_exact(bench, shape, share, kind):
    g = torch.Generator().manual_seed(shape[0] * 1000 + shape[1])
    hit = torch.rand(shape, generator=g) < share
    y, x = axes(*shape, kind, g)
    raster = torch.where(hit, 0.0, 1.0).double()
    raster[0, -1] = math.nan if not hit[0, -1] else 0.0
    got = bench.reference("proximity").run(
        raster, (y, x), {"target_values": [0]}, torch.float64)["proximity"]
    want = brute(hit, y, x)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = ~torch.isnan(want)
    if fin.any():
        scale = max(1.0, float(want[fin].max()))
        assert float((got - want)[fin].abs().max()) <= 1e-12 * scale


def test_the_reference_proximity_takes_max_distance_and_empty_targets(
        bench):
    g = torch.Generator().manual_seed(5)
    hit = torch.rand((40, 30), generator=g) < 0.03
    y, x = axes(40, 30, "metres", g)
    ref = bench.reference("proximity")
    raster = torch.where(hit, 2.5, 0.0).double()
    # no target values: every non-zero finite cell
    got = ref.run(raster, (y, x), {}, torch.float64)["proximity"]
    want = brute(hit, y, x)
    assert float((got - want).abs().max()) <= 1e-9
    near = ref.run(raster, (y, x), {"max_distance": 55.0},
                   torch.float64)["proximity"]
    assert torch.equal(torch.isnan(near), want > 55.0)


@pytest.mark.parametrize("shape,share", MASKS[:4])
def test_the_ports_proximity_is_the_reference_in_float32(bench, shape,
                                                         share):
    """On 10 m cell centres every squared offset is exact in float32, so
    the port's distance is the exact one rounded once."""
    g = torch.Generator().manual_seed(7 + shape[0])
    hit = torch.rand(shape, generator=g) < share
    y, x = axes(*shape, "metres", g)
    raster = torch.where(hit, 0.0, 1.0)
    da = xt.DataArray(raster, dims=("y", "x"),
                      coords={"y": y.numpy(), "x": x.numpy()})
    port = xt.proximity(da, target_values=[0]).data
    ref = bench.reference("proximity").run(
        raster.double(), (y, x), {"target_values": [0]},
        torch.float64)["proximity"]
    assert port.dtype == torch.float32
    assert torch.equal(torch.isnan(port), torch.isnan(ref))
    fin = ~torch.isnan(ref)
    gap = (port.double() - ref).abs()[fin]
    assert bool((gap <= EPS32 * ref[fin]).all()), float(gap.max())


def test_the_reference_binary_is_the_ports(bench):
    z = torch.tensor([[-1.0, 0.0, 90.5], [math.nan, math.inf, -1.0]])
    da = xt.DataArray(z, dims=("y", "x"))
    port = xt.classify.binary(da, values=[-1]).data
    ref = bench.reference("binary").run(z.double(), None, {"values": [-1]},
                                        torch.float64)["binary"]
    want = torch.tensor([[1.0, 0.0, 0.0], [math.nan, math.nan, 1.0]],
                        dtype=torch.float64)
    assert torch.equal(torch.isnan(ref), torch.isnan(want))
    assert torch.equal(ref.nan_to_num(7.0), want.nan_to_num(7.0))
    assert torch.equal(port.double().nan_to_num(7.0), ref.nan_to_num(7.0))


# the tiny cell: dem16k-geo's deployment at 97 x 131, the sites traffic
# with its observer drawn in the central 80% of this raster
TINY = (97, 131)


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark with the cell ``tinygeo-sites``, added as
    new files and entries."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    d = tmp_path / "gpubench"
    cfg = json.loads((d / "configs/dem16k-geo.json").read_text())
    cfg.update(name="tinygeo", shape=list(TINY))
    (d / "configs/tinygeo.json").write_text(json.dumps(cfg))
    traffic = json.loads((d / "traffic/sites.json").read_text())
    traffic.update(warmup_jobs=1, trace_jobs=2)
    args = traffic["steps"][0]["args"]
    for axis, n in (("x", TINY[1]), ("y", TINY[0])):
        args[axis] = {"$uniform": [0.1 * 10.0 * n, 0.9 * 10.0 * n]}
    (d / "traffic/tinysites.json").write_text(json.dumps(traffic))
    shutil.copy(d / "limits/dem16k-sites.json",
                d / "limits/tinygeo-sites.json")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tinygeo", "source": "test",
                            "file": "gpubench/configs/tinygeo.json",
                            "reduced": [], "why": "a test's"})
    spec["workloads"].append({"name": "tinygeo-sites", "config": "tinygeo",
                              "traffic": "tinysites", "chips": 1,
                              "why": "a test's"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path


def test_a_tiny_sites_cell_is_correct(tiny_root):
    r = run.run("tinygeo-sites", SEED, 0.3, False, root=tiny_root,
                devices=[CPU])
    assert r["correct"] is True, r["checks"]
    assert list(r["checks"]) == ["nan_mismatch", "depth_err"]
    assert r["checks"]["depth_err"]["value"] < 1e-6


def test_a_tiny_sites_cell_with_one_distance_altered_is_not_correct(
        tiny_root, monkeypatch):
    real = xt.proximity

    def altered(raster, **kw):
        out = real(raster, **kw)
        d = out.data
        i = int(torch.argmax(torch.nan_to_num(d, nan=-1.0)))
        d.view(-1)[i] += float(d.view(-1)[i]) + 1000.0     # metres
        return out
    monkeypatch.setattr(xt, "proximity", altered)
    r = run.run("tinygeo-sites", SEED, 0.3, False, root=tiny_root,
                devices=[CPU])
    assert r["correct"] is False
    assert r["checks"]["depth_err"]["value"] > 0.5


def test_a_tiny_sites_cell_whose_check_sees_another_draw_is_not_correct(
        tiny_root, monkeypatch):
    """The check's observer stands 20 cells east of the program's."""
    real = joblib.reference_job

    def moved(traffic, drawn, bench):
        drawn = [dict(a) for a in drawn]
        drawn[0]["x"] = drawn[0]["x"] + 200.0
        return real(traffic, drawn, bench)
    monkeypatch.setattr(joblib, "reference_job", moved)
    r = run.run("tinygeo-sites", SEED, 0.3, False, root=tiny_root,
                devices=[CPU])
    assert r["correct"] is False


def test_the_control_fails_and_the_program_passes(tiny_root):
    """Under ``dem16k-sites``' limits the program's float32 chain passes
    and the reference chain in bfloat16 (the control) fails, at the tiny
    cell's size."""
    from gpubench import calibrate
    lim = json.loads((REPO / "gpubench/limits/dem16k-sites.json")
                     .read_text())
    r = calibrate.readings("tinygeo-sites", [5, 2 ** 40 + 3],
                           [6, 2 ** 35 + 9, 123], root=tiny_root,
                           devices=[CPU])
    for seed, numbers in r["program"].items():
        assert run.judge(numbers, lim)[0], (seed, numbers)
    for seed, numbers in r["control"].items():
        assert not run.judge(numbers, lim)[0], (seed, numbers)


@pytest.mark.parametrize("counters,want", [
    ({"xdraw.cells_kernel": 2}, 1.0),
    ({"xdraw.cells_kernel": 1, "xdraw.cells_torchops": 3}, 0.25),
    ({"xdraw.cells_torchops": 2, "host.syncs": 22}, 0.0),
    ({"host.syncs": 22}, None),
])
def test_the_kernel_share_reads_the_ports_counters(bench, monkeypatch,
                                                   counters, want):
    """``xdraw.kernel_share``: the viewsheds whose fields and epilogue ran
    as the card's kernels over all counted, silent where the port counts
    neither (a port without the counters) or where there is no trace."""
    import types

    from gpubench import portspans
    fake = types.SimpleNamespace(counters=lambda: counters)
    monkeypatch.setattr(portspans, "tracing", lambda: fake)
    ctx = types.SimpleNamespace(trace=types.SimpleNamespace(jobs=2))
    reader = bench.reader("xdraw.kernel_share")
    assert reader.read(ctx) == want
    assert reader.read(types.SimpleNamespace(trace=None)) is None
    monkeypatch.setattr(portspans, "tracing", lambda: None)
    assert reader.read(ctx) is None


def test_the_sites_viewshed_on_the_cpu_counts_the_torch_passes(bench):
    """The port's real counters, traced on the CPU: the torch-op route,
    so the share reads 0."""
    import types

    from torch.profiler import ProfilerActivity, profile

    from xrspatial_torch import tracing
    data = dem_of(geo(bench, (40, 56)), SEED)[0]
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        xt.viewshed(data, x=float(data["x"].data[20]),
                    y=float(data["y"].data[15]), observer_elev=100.0,
                    exact=False)
    ctx = types.SimpleNamespace(trace=types.SimpleNamespace(jobs=1))
    try:
        assert bench.reader("xdraw.kernel_share").read(ctx) == 0.0
    finally:
        tracing.clear()
