"""The trace readers on a made-up Chrome trace of two cards: busy and
idle time, launches, the port's kernels, copies, the roofline share and
the breakdown."""

import pytest
from conftest import REPO

from gpubench import trace as tr
from gpubench.run import Context
from gpubench.spec import Bench

US = 1e-6


def ev(cat, name, dev, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "pid": dev, "tid": 7,
            "ts": ts, "dur": dur, "args": {"device": dev}}


def span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "pid": 1,
            "tid": 1, "ts": ts, "dur": dur}


# a window of 1000 us and two jobs; card 0 runs 700 us, card 1 400 us
TRACE = {"traceEvents": [
    span("gpubench.window", 1000, 1000),
    span("gpubench.api", 1000, 100), span("gpubench.sync", 1100, 400),
    span("gpubench.drop", 1500, 10),
    span("gpubench.api", 1510, 90), span("gpubench.sync", 1600, 390),
    # card 0: the port's kernel twice, a fill, a peer copy; one kernel
    # straddling the window's start counts only inside it
    ev("kernel", "void surface_staged_kernel<64, 128>(CUtensorMap, "
       "xrt::SurfaceArgs)", 0, 900, 250),
    ev("kernel", "focal_halo_staged_kernel<4>(CUtensorMap, StagedArgs)", 0,
       1150, 200),
    ev("kernel", "void at::native::vectorized_elementwise_kernel<4, "
       "at::native::FillFunctor<float>>(int, ...)", 0, 1600, 50),
    ev("gpu_memcpy", "Memcpy PtoP (Device -> Device)", 0, 1650, 200),
    ev("kernel", "(anonymous namespace)::focal_halo_staged_kernel<4>(x)", 0,
       1850, 100),
    # card 1: one kernel and a memset, overlapping
    ev("kernel", "surface_staged_kernel<64, 128>(x)", 1, 1200, 300),
    ev("gpu_memset", "Memset (Device)", 1, 1400, 200),
    ev("kernel", "void direct_copy_kernel_cuda(x)", 1, 2500, 100),
    {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 1, "tid": 1,
     "ts": 1000, "dur": 5},
]}


@pytest.fixture
def t():
    return tr.Trace.from_chrome(TRACE, cards=2)


def test_busy_idle_and_gaps(t):
    assert t.window_s == pytest.approx(1000 * US)
    assert t.jobs == 2
    assert t.busy_s(0) == pytest.approx(700 * US)
    assert t.busy_s(1) == pytest.approx(400 * US)
    assert t.busiest() == 0
    assert [(round(a / US), round(b / US)) for a, b in t.gaps(0)] == [
        (1350, 1600), (1950, 2000)]


def test_the_breakdown(t):
    b = t.breakdown()
    ops = dict(b["device_ops"])
    assert ops["Memcpy PtoP"] == pytest.approx(200 * US)
    # summed over the cards: 150 us on card 0 (clipped), 300 on card 1
    assert ops["surface_staged_kernel<64, 128>"] == pytest.approx(450 * US)
    assert ops["focal_halo_staged_kernel<4>"] == pytest.approx(300 * US)
    idle = dict(b["idle_gaps"])
    # card 0 idles 1350-1600 (150 us in the first sync, 10 in the drop,
    # 90 in the second api span) and 1950-2000 (40 in the second sync, 10
    # between jobs); card 1 idles 1000-1200 (100 in the first api span,
    # 100 in the first sync) and 1600-2000 (390 in the second sync, 10
    # between jobs): the mean over the two cards
    assert idle["gpubench.sync"] == pytest.approx((150 + 40 + 100 + 390)
                                                  / 2 * US)
    assert idle["gpubench.api"] == pytest.approx((90 + 100) / 2 * US)
    assert idle["gpubench.drop"] == pytest.approx(10 / 2 * US)
    assert idle["gpubench.between_jobs"] == pytest.approx((10 + 10) / 2 * US)
    assert sum(idle.values()) == pytest.approx((300 + 600) / 2 * US)


def _ctx(t, work=(3.35e12 * 700e-6, 0)):
    return Context(setup_s=1.0, jobs=[], window_s=None, pixels=1,
                   peak_bytes=0, trace=t, work=work, cards=2,
                   port_kernels=tr.port_kernels(REPO / "xrspatial_torch"))


def read(name, c):
    return Bench(REPO).reader(name).read(c)


def test_the_readers(t):
    c = _ctx(t)
    assert read("dispatch.launches", c) == 5 / 2
    # the port's kernels on card 0: 150 + 200 + 100 us over 2 jobs
    assert read("kernels.device_ms", c) == pytest.approx(0.225)
    # the memcpy on card 0 (the copy kernel ran on card 1)
    assert read("mesh.copy_ms", c) == pytest.approx(0.1)
    assert read("device.idle_pct", c) == pytest.approx(45.0)
    # least time (700 us of bytes over two cards) / busy time a job
    assert read("kernels.roofline_pct", c) == pytest.approx(
        100 * 350e-6 / 350e-6)


def test_port_kernels_are_read_from_the_sources():
    names = tr.port_kernels(REPO / "xrspatial_torch")
    assert {"surface_staged_kernel", "focal_halo_staged_kernel",
            "screen_hilo_kernel", "jfa_vector_kernel"} <= names
    assert "vectorized_elementwise_kernel" not in names
    assert tr.base_name("void ns::k<1, 2>(int)") == "k"
    assert tr.base_name("(anonymous namespace)::k2(int)") == "k2"


def test_a_trace_without_a_window_is_refused():
    with pytest.raises(ValueError):
        tr.Trace.from_chrome({"traceEvents": [span("gpubench.api", 0, 1)]},
                             1)
