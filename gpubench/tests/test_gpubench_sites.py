"""The ``dem16k-sites`` cell's six per-layer readers on a made-up trace and
a made-up port, silent where the port records nothing; its work files at
16384^2; and its references and work files load nothing of the port, of
JAX or of the JAX package."""

import json
import subprocess
import sys
import types

import pytest
from conftest import REPO

from gpubench import peaks, portspans
from gpubench import trace as tr
from gpubench.run import Context, Job
from gpubench.spec import Bench

US = 1e-6
NEW = ["chain.roofline_pct", "xdraw.roofline_pct", "jfa.roofline_pct",
       "torchops.device_ms", "torchops.host_ms", "api.host_syncs"]
CELLS = 16384 ** 2
T = 10.0
# two traced jobs of 1000 us each; the port's calls take 600 us of each
JOBS = [Job(T, T + 600 * US, T + 1000 * US, True, True),
        Job(T + 1000 * US, T + 1600 * US, T + 2000 * US, True, True)]
OWN = frozenset({"xdraw_banded_kernel", "jfa_staged_kernel",
                 "jfa_vector_kernel", "surface_staged_kernel"})


def ev(cat, name, t0, dur):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
            "ts": t0 / US, "dur": dur / US, "args": {"device": 0}}


def user(name, t0, t1):
    return {"ph": "X", "cat": "user_annotation", "name": name,
            "ts": t0 / US, "dur": (t1 - t0) / US}


def chrome():
    """Each job: X1 100 us, two rounds of 30 and 20 us, two torch kernels
    of 50 and 150 us and a 10 us fill; busy 360 us."""
    events = [user("gpubench.window", T - 100 * US, T + 2100 * US)]
    for j in JOBS:
        t = j.issue
        events += [
            user("gpubench.api", t + 1 * US, j.ret - 1 * US),
            user("gpubench.sync", j.ret, j.done),
            ev("kernel", "void at::native::vectorized_elementwise_kernel<4,"
               " at::native::sqrt_kernel_cuda>(int, ...)", t, 50 * US),
            ev("kernel", "xdraw_banded_kernel(XDrawBanded)", t + 50 * US,
               100 * US),
            ev("kernel", "void at::native::reduce_kernel<512, 1>(...)",
               t + 150 * US, 150 * US),
            ev("kernel", "void (anonymous namespace)::jfa_staged_kernel<1>"
               "(CUtensorMap, int)", t + 300 * US, 30 * US),
            ev("kernel", "jfa_vector_kernel<0>(int*, float*)",
               t + 330 * US, 20 * US),
            ev("gpu_memset", "Memset (Device)", t + 350 * US, 10 * US)]
    return {"traceEvents": events}


def spans():
    """Each job's port spans: api.viewshed with its torch-op passes (40
    and 60 us of self time) and dispatch.xdraw, api.proximity with its
    mask (20 us) and epilogue (30 us)."""
    out, i = [], 0
    for r, j in enumerate(JOBS):
        t = j.issue

        def s(name, a, b, parent):
            nonlocal i
            i += 1
            return types.SimpleNamespace(index=i, name=name, t0=t + a * US,
                                         t1=t + b * US, parent=parent,
                                         request=r)
        vs = s("api.viewshed", 5, 300, -1)
        px = s("api.proximity", 310, 590, -1)
        out += [vs, s("torchops.viewshed_fields", 10, 50, vs.index),
                s("dispatch.xdraw", 50, 100, vs.index),
                s("torchops.viewshed_epilogue", 100, 160, vs.index),
                px, s("torchops.proximity_mask", 320, 340, px.index),
                s("dispatch.jfa", 340, 500, px.index),
                s("torchops.proximity_epilogue", 500, 530, px.index)]
    return out


@pytest.fixture
def ctx(monkeypatch):
    fake = types.SimpleNamespace(spans=spans,
                                 counters=lambda: {"host.syncs": 22})
    monkeypatch.setattr(portspans, "tracing", lambda: fake)
    return Context(setup_s=1.0, jobs=JOBS, window_s=0.002, pixels=CELLS,
                   peak_bytes=0, trace=tr.Trace.from_chrome(chrome(), 1),
                   work=(24 * CELLS, 31 * CELLS), cards=1, port_kernels=OWN)


def read(name, c):
    return Bench(REPO).reader(name).read(c)


def test_the_roofline_shares(ctx):
    least = 8 * CELLS / peaks.HBM_BYTES_S
    assert abs(least * 1e3 - 0.641) < 1e-3
    assert read("xdraw.roofline_pct", ctx) == pytest.approx(
        100 * least / 100e-6)
    rounds = 12 * CELLS / peaks.HBM_BYTES_S
    assert abs(rounds * 1e3 - 0.962) < 1e-3
    assert read("jfa.roofline_pct", ctx) == pytest.approx(
        100 * rounds / 50e-6)
    assert read("chain.roofline_pct", ctx) == pytest.approx(
        100 * 3 * least / 360e-6)


def test_the_torch_ops_and_the_waits(ctx):
    # kernels that are not the port's own: 50 + 150 us a job (the fill is
    # not a kernel)
    assert read("torchops.device_ms", ctx) == pytest.approx(0.2)
    # self time of the torchops spans: 40 + 60 + 20 + 30 us a job
    assert read("torchops.host_ms", ctx) == pytest.approx(0.15)
    assert read("api.host_syncs", ctx) == 11


def test_a_port_that_records_nothing_leaves_them_out(ctx, monkeypatch):
    monkeypatch.setattr(portspans, "tracing", lambda: None)
    assert read("torchops.host_ms", ctx) is None
    assert read("api.host_syncs", ctx) is None
    quiet = types.SimpleNamespace(spans=lambda: [], counters=lambda: {})
    monkeypatch.setattr(portspans, "tracing", lambda: quiet)
    assert read("torchops.host_ms", ctx) is None
    assert read("api.host_syncs", ctx) is None
    # no trace: every reader is silent
    bare = Context(setup_s=1.0, jobs=JOBS, window_s=0.002, pixels=CELLS,
                   peak_bytes=0, trace=None, work=(1, 1), cards=1,
                   port_kernels=OWN)
    for name in NEW:
        assert read(name, bare) is None


def test_a_trace_without_the_kernels_leaves_their_shares_out(ctx):
    ctx.trace.events = [e for e in ctx.trace.events
                        if "xdraw" not in e[1] and "jfa" not in e[1]]
    assert read("xdraw.roofline_pct", ctx) is None
    assert read("jfa.roofline_pct", ctx) is None


def test_the_work_of_a_sites_job():
    bench = Bench(REPO)
    traffic = bench.traffic("sites")
    shape = tuple(bench.config("dem16k-geo")["shape"])
    assert shape == (16384, 16384)
    total = [0, 0]
    for step in traffic["steps"]:
        op = step["op"].rpartition(".")[2]
        b, o = bench.work(op).work(shape, step["args"])
        assert b == 8 * CELLS
        total = [total[0] + b, total[1] + o]
    least = max(total[0] / peaks.HBM_BYTES_S, total[1] / peaks.F32_FLOP_S)
    assert abs(least * 1e3 - 1.923) < 1e-3        # bound by the bytes


REFERENCES_ONLY = r"""
import json, sys
sys.path.insert(0, {repo!r})
from gpubench.spec import Bench
b = Bench({repo!r})
for op in ("viewshed", "binary", "proximity"):
    b.reference(op)
    b.work(op)
print(json.dumps(sorted(sys.modules)))
"""


def test_the_sites_references_load_nothing_of_the_port():
    p = subprocess.run([sys.executable, "-c",
                        REFERENCES_ONLY.format(repo=str(REPO))],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    tops = {m.split(".")[0] for m in
            json.loads(p.stdout.strip().splitlines()[-1])}
    assert "torch" in tops
    assert not tops & {"xrspatial_torch", "xrspatial_tpu", "jax", "jaxlib",
                       "flax"}
