"""The readers of the port's spans and counters (``portspans``): on a
made-up trace and a made-up port whose clock lies a known offset from the
trace's; silent where the port has no tracing module; and on a CPU run of
a 2x2 mesh, every new metric reported, the halo counters of the in-place
route at the count from the shapes."""

import json
import types

import pytest
from conftest import CPU, REPO

import xrspatial_torch.parallel.halo as halo
from gpubench import portspans, run
from gpubench import trace as tr
from gpubench.run import Context, Job
from gpubench.spec import Bench

US = 1e-6
OFFSET = 5.0                # the trace's clock less the host clock, s
NEW = ["setup.library_s", "api.args_ms", "api.dataset_ms",
       "dispatch.host_ms", "mesh.halo_host_ms", "mesh.halo_gib",
       "mesh.halo_ops", "api.idle_ms", "dispatch.idle_ms", "mesh.idle_ms"]


def span(name, t0, t1, index, parent, request):
    return types.SimpleNamespace(index=index, name=name, t0=t0, t1=t1,
                                 parent=parent, request=request)


def us(t):
    """Host seconds -> the trace's microseconds."""
    return (t + OFFSET) / US


def ev(dev, t0, t1):
    return {"ph": "X", "cat": "kernel", "name": "k", "pid": dev,
            "ts": us(t0), "dur": (t1 - t0) / US, "args": {"device": dev}}


def user(name, t0, t1):
    return {"ph": "X", "cat": "user_annotation", "name": name,
            "ts": us(t0), "dur": (t1 - t0) / US}


# host clock, s: an untraced job at 9.0, then two traced jobs; each traced
# call (1000 us) is one request of the port
T = 10.0
JOBS = [Job(9.0, 9.001, 9.004, True, False),
        Job(T, T + 1000 * US, T + 3000 * US, True, True),
        Job(T + 4000 * US, T + 5000 * US, T + 7000 * US, True, True)]


def port_spans():
    out = [span("setup.library", 1.0, 1.25, 0, -1, 0),
           # the untraced job's request, left out
           span("api.terrain_pipeline", 9.0001, 9.0009, 1, -1, 1)]
    i = 2
    for r, t in ((2, T), (3, T + 4000 * US)):
        root = i
        out += [span("api.args", t + 100 * US, t + 200 * US, i + 1, root, r),
                span("mesh.halo_extend", t + 400 * US, t + 500 * US, i + 3,
                     i + 2, r),
                span("dispatch.surface", t + 300 * US, t + 600 * US, i + 2,
                     root, r),
                span("api.dataset", t + 700 * US, t + 800 * US, i + 4, root,
                     r),
                span("api.terrain_pipeline", t + 50 * US, t + 950 * US, root,
                     -1, r)]
        i += 5
    return out


def chrome():
    events = [user("gpubench.window", T - 100 * US, T + 7100 * US)]
    for j in JOBS[1:]:
        events += [user("gpubench.api", j.issue + 1 * US, j.ret - 1 * US),
                   user("gpubench.sync", j.ret, j.done)]
    # card 0 busy from 550 us into each call to 2500 us past its start;
    # card 1 busy from 250 us to 450 us and from 700 us to 2000 us
    for t in (T, T + 4000 * US):
        events += [ev(0, t + 550 * US, t + 2500 * US),
                   ev(1, t + 250 * US, t + 450 * US),
                   ev(1, t + 700 * US, t + 2000 * US)]
    return {"traceEvents": events}


@pytest.fixture
def ctx(monkeypatch):
    fake = types.SimpleNamespace(
        spans=port_spans,
        counters=lambda: {"mesh.halo_ops": 88, "mesh.halo_bytes": 2 ** 31})
    monkeypatch.setattr(portspans, "tracing", lambda: fake)
    t = tr.Trace.from_chrome(chrome(), cards=2)
    return Context(setup_s=2.0, jobs=JOBS, window_s=None, pixels=1,
                   peak_bytes=0, trace=t, work=(1, 1), cards=2,
                   port_kernels=frozenset())


def read(name, c):
    return Bench(REPO).reader(name).read(c)


def test_the_clocks_are_aligned_by_the_api_spans(ctx):
    offs = portspans.offsets(ctx)
    assert len(offs) == 2
    assert offs == pytest.approx([OFFSET, OFFSET], abs=1e-9)
    assert portspans.offset(ctx) == pytest.approx(OFFSET, abs=1e-9)


def test_only_the_traced_jobs_spans_are_kept(ctx):
    kept = portspans.spans(ctx)
    assert {s.request for s in kept} == {2, 3}
    assert len(kept) == 10


def test_host_time_by_layer(ctx):
    # a job each: args 100 us, the dataset 100 us, dispatch 300 us less
    # the exchange's 100, the exchange 100
    assert read("api.args_ms", ctx) == pytest.approx(0.1)
    assert read("api.dataset_ms", ctx) == pytest.approx(0.1)
    assert read("dispatch.host_ms", ctx) == pytest.approx(0.2)
    assert read("mesh.halo_host_ms", ctx) == pytest.approx(0.1)
    assert read("setup.library_s", ctx) == pytest.approx(0.25)


def test_idle_time_by_the_innermost_span(ctx):
    # in each call (us from its start): the root alone 50-100, 200-300,
    # 600-700, 800-950; args 100-200; dispatch 300-400, 500-600; the
    # exchange 400-500; the dataset 700-800.  Card 0 idles until 550,
    # card 1 outside 250-450 and 700-2000.
    # api: card 0 50-100, 100-200, 200-300 (250 us); card 1 50-100,
    # 100-200, 200-250, 600-700 (300 us)
    assert read("api.idle_ms", ctx) == pytest.approx(0.275)
    # dispatch: card 0 300-400, 500-550 (150); card 1 500-600 (100)
    assert read("dispatch.idle_ms", ctx) == pytest.approx(0.125)
    # the exchange: card 0 400-500 (100); card 1 450-500 (50)
    assert read("mesh.idle_ms", ctx) == pytest.approx(0.075)


def test_counters_a_job(ctx):
    assert read("mesh.halo_ops", ctx) == 44
    assert read("mesh.halo_gib", ctx) == 1.0


def test_a_port_without_tracing_leaves_every_metric_out(ctx, monkeypatch):
    monkeypatch.setattr(portspans, "tracing", lambda: None)
    for name in NEW:
        assert read(name, ctx) is None


def test_a_run_reports_every_new_metric(bench_root):
    # the counters hold this run's traced jobs alone, as in a run's own
    # process
    portspans.tracing().clear()
    spec = json.loads((bench_root / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        if m["name"] in NEW:
            m["workloads"].append("tinymesh-terrain")
    (bench_root / "BENCHMARK.json").write_text(json.dumps(spec))
    r = run.run("tinymesh-terrain", 2 ** 33 + 7, 0.3, True, root=bench_root,
                devices=[CPU] * 4)
    assert r["correct"], r["checks"]
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(NEW) - {"setup.library_s"} <= set(got)
    # a (96, 130) raster on 2x2: tiles 48 x 65, radius 1, each stencil in
    # place; two a job, each block's bands written by 10 fills and copies:
    # a row band of 8 r rows of tx + 2 r + BAND_SLACK floats and a column
    # band of ty rows of 6 r + BAND_SLACK, rows rounded up to 16 bytes
    def pitch(width):
        per = halo.ROW_ALIGN_BYTES // 4
        return -(-width // per) * per
    ty, tx, r = 48, 65, 1
    cells = 8 * r * pitch(tx + 2 * r + halo.BAND_SLACK) \
        + ty * pitch(6 * r + halo.BAND_SLACK)
    assert got["mesh.halo_ops"] == 2 * 4 * 10
    assert got["mesh.halo_gib"] * 2 ** 30 == pytest.approx(2 * 4 * cells * 4)
    for k in NEW:
        assert k not in got or got[k] >= 0
