"""The port's spans and counters (``xrspatial_torch.tracing``) on the CPU.

Off (no ``torch.profiler`` session) nothing is recorded and ``span``
returns the shared no-op context; under a CPU profiler ``terrain_pipeline``
on one raster and on a 2x2 mesh records its span tree, whose names also
appear in the profiler's Chrome trace; the halo counters of both mesh
routes equal a count made from the shapes, and the route counters count
every block; the ring stays bounded; the library's set-up span is
recorded without a profiler; the exact viewshed's phases are spans.
"""

import json
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import xrspatial_torch as xt
from xrspatial_torch import tracing
from xrspatial_torch.kernels import _cuda
from xrspatial_torch.kernels.dispatch import run_stencil
from xrspatial_torch.parallel import distribute, make_raster_mesh
from xrspatial_torch.parallel.halo import BAND_SLACK, ROW_ALIGN_BYTES

CPU = torch.device("cpu")
SHAPE = (64, 128)           # a 2x2 mesh's tiles: 32 x 64


@pytest.fixture(autouse=True)
def fresh():
    """Each test starts with an empty ring and no counters."""
    tracing.clear()
    yield
    tracing.clear()


def dem(shape=SHAPE, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g, dtype=torch.float32) * 100


def raster(data, mesh=False):
    if mesh:
        data = distribute(data, make_raster_mesh(2, 2, devices=[CPU] * 4))
    return xt.DataArray(data, dims=("y", "x"), name="dem",
                        attrs={"res": (10.0, 10.0)})


def traced(fn, *args, **kw):
    """``fn(*args, **kw)`` under a CPU profiler; (result, profiler)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args, **kw)
    return out, prof


@pytest.mark.parametrize("mesh", [False, True], ids=["one", "mesh2x2"])
def test_without_a_profiler_nothing_is_recorded(mesh):
    assert not tracing.on()
    assert tracing.span("api.args") is tracing.OFF
    assert tracing.span("dispatch.surface") is tracing.OFF
    with tracing.span("api.args") as s:
        assert s is tracing.OFF
    tracing.count("mesh.halo_ops", 5)
    xt.terrain_pipeline(raster(dem(), mesh))
    assert tracing.spans() == []
    assert tracing.counters() == {}


def _tree(spans):
    by_index = {s.index: s for s in spans}
    children = {}
    for s in spans:
        children.setdefault(s.parent, []).append(s)
    return by_index, children


@pytest.mark.parametrize("mesh", [False, True], ids=["one", "mesh2x2"])
def test_the_span_tree_under_the_profiler(mesh, tmp_path):
    data = raster(dem(), mesh)

    def two_calls():
        xt.terrain_pipeline(data)
        xt.terrain_pipeline(data)

    _, prof = traced(two_calls)
    spans = tracing.spans()
    names = {s.name for s in spans}
    want = {"api.terrain_pipeline", "api.args", "api.dataset",
            "dispatch.surface", "api.focal_stats", "dispatch.focal"}
    assert names == (want | {"mesh.halo_extend"} if mesh else want)

    by_index, children = _tree(spans)
    roots = children[-1]
    # one request an outermost call, shared by every span inside it
    assert [r.name for r in roots] == ["api.terrain_pipeline"] * 2
    assert len({r.request for r in roots}) == 2
    for s in spans:
        if s.parent == -1:
            continue
        p = by_index[s.parent]
        assert s.request == p.request
        # inside its parent in time
        assert p.t0 <= s.t0 <= s.t1 <= p.t1
    for r in roots:
        kids = [c.name for c in sorted(children[r.index], key=lambda c: c.t0)]
        assert kids == ["api.args", "api.dataset", "dispatch.surface",
                        "api.dataset", "api.focal_stats", "api.dataset"]
        focal = next(c for c in children[r.index]
                     if c.name == "api.focal_stats")
        assert [c.name for c in sorted(children[focal.index],
                                       key=lambda c: c.t0)] == [
            "api.args", "api.args", "dispatch.focal", "api.dataset"]
        for d in (c for c in spans if c.request == r.request
                  and c.name.startswith("dispatch.")
                  and by_index.get(c.parent, r).name.startswith("api.")):
            inner = sorted(children.get(d.index, []), key=lambda c: c.t0)
            if not mesh:
                assert inner == []
                continue
            # in place: one dispatch a tile, then the strips of every
            # block's bands, then one dispatch a band (two a block)
            kinds = [c.name for c in inner]
            assert kinds.count("mesh.halo_extend") == 1
            k = kinds.index("mesh.halo_extend")
            assert kinds[:k].count(d.name) == 4
            assert kinds[k + 1:].count(d.name) == 8
            assert set(kinds) <= {d.name, "api.args", "mesh.halo_extend"}

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    exported = {e["name"] for e in events if e.get("ph") == "X"}
    assert {tracing.PREFIX + n for n in names} <= exported


def pitch(width, item=4):
    """`width` rounded up to ``ROW_ALIGN_BYTES``."""
    per = ROW_ALIGN_BYTES // item
    return math.ceil(width / per) * per


def halo_count(h, w, r, item=4):
    """(ops, bytes) of the strips of one in-place stencil of radius r on a
    2x2 mesh whose tiles divide the raster evenly, each at least 4r deep.

    Each block builds a row band of 8r rows (two parts of 4r: r halo rows
    and 3r of the tile's edge rows) and a column band of ty rows (two
    parts of 3r columns), each BAND_SLACK columns wider than its parts and
    rounded up to 16 bytes: every cell of both is written once, by a copy
    or a fill, in two phases.  Each block of a 2x2 mesh lies at a corner
    of the raster.  Ops a block: in x, the row band's rows of the tile's
    own row of tiles one op a tile (its own, its neighbour's, fill on the
    raster's edge), the column band's own columns one copy and its halo
    columns one op a side, and one fill of each band's slack (8); in y,
    the row band's halo rows one op a side (a copy of the rows the band
    of the block above or below holds, fill on the raster's edge) (2)."""
    ty, tx = h // 2, w // 2
    cells = 8 * r * pitch(tx + 2 * r + BAND_SLACK, item) \
        + ty * pitch(6 * r + BAND_SLACK, item)
    return 4 * 10, 4 * cells * item


def extended_count(h, w, r, item=4):
    """(ops, bytes) of one ``halo_extend`` of radius r on a 2x2 mesh whose
    tiles divide the raster evenly, each tile wider and taller than r.

    Every block's extended block is (ty + 2r) x pitch, pitch the width
    tx + 2r rounded up to 16 bytes; the window the raster fills is
    (ty + r) x (tx + r) (the outer halo lies beyond the raster on two
    sides).  The exchange writes the fills outside the window, the
    tile's own ty x tx cells, a ty x r column from the neighbour in x and
    r full rows of pitch from the neighbour in y.  Ops: 2 copies in x
    and 1 in y a block, and the fills: the row band and the outer column
    band of each block, and the right band past the pitch where it has
    columns (the blocks at the left edge write one fewer)."""
    ty, tx = h // 2, w // 2
    p = pitch(tx + 2 * r, item)
    fills = (ty + 2 * r) * p - (ty + r) * (tx + r)
    cells = fills + ty * tx + ty * r + r * p
    fill_ops = 4 * 2 + 2 * (p > tx + 2 * r)
    return fill_ops + 4 * 3, 4 * cells * item


@pytest.mark.parametrize("shape", [SHAPE, (96, 72)])
def test_halo_counters_equal_the_count_from_the_shapes(shape):
    data = raster(dem(shape), mesh=True)
    ops, nbytes = halo_count(*shape, r=1)
    traced(xt.terrain_pipeline, data)
    # two stencils of radius 1, each in place on the four blocks: the
    # surface pass and the focal pass
    assert tracing.counters() == {"mesh.halo_ops": 2 * ops,
                                  "mesh.halo_bytes": 2 * nbytes,
                                  "mesh.inplace_blocks": 8}
    tracing.clear()
    traced(xt.focal_stats, data, np.ones((5, 5)), ["mean"])
    ops, nbytes = halo_count(*shape, r=2)
    assert tracing.counters() == {"mesh.halo_ops": ops,
                                  "mesh.halo_bytes": nbytes,
                                  "mesh.inplace_blocks": 4}
    exchanges = [s for s in tracing.spans() if s.name == "mesh.halo_extend"]
    assert len(exchanges) == 1


@pytest.mark.parametrize("shape", [SHAPE, (96, 72)])
@pytest.mark.parametrize("r", [1, 2])
def test_the_extended_route_counts_the_whole_tiles(shape, r):
    """A kernel that is not window-local takes the extended blocks: the
    count of ``halo_extend`` from the shapes, every block counted on
    ``mesh.extended_blocks``."""
    data = distribute(dem(shape), make_raster_mesh(2, 2, devices=[CPU] * 4))
    traced(run_stencil, lambda b: b * 2.0, r, data, window_local=False)
    ops, nbytes = extended_count(*shape, r=r)
    assert tracing.counters() == {"mesh.halo_ops": ops,
                                  "mesh.halo_bytes": nbytes,
                                  "mesh.extended_blocks": 4}


def test_the_halo_count_at_the_mosaics_size():
    # the 65536^2 mosaic on 2x2 cards, radius 1: 40 ops and 25,170,432
    # bytes (0.0234 GiB) a stencil, against 22 ops and 16.003 GiB (4 GiB
    # of each a tile's own cells) for the extended blocks
    ops, nbytes = halo_count(65536, 65536, r=1)
    assert ops == 40
    assert nbytes == 4 * 4 * (8 * 32804 + 32768 * 40) == 25_170_432
    assert nbytes < 0.025 * 2 ** 30
    ops, nbytes = extended_count(65536, 65536, r=1)
    assert ops == 22
    assert nbytes == 4 * 4 * 1_073_938_443
    assert 16 * 2 ** 30 < nbytes < 16.01 * 2 ** 30


def test_counters_count_only_under_the_profiler():
    tracing.count("x", 3)
    assert tracing.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.on()
        tracing.count("x", 3)
        tracing.count("x")
    tracing.count("x", 5)
    assert tracing.counters() == {"x": 4}


def test_the_ring_stays_bounded():
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(tracing.RING + 10):
            with tracing.span("t"):
                pass
    spans = tracing.spans()
    assert len(spans) == tracing.RING
    idx = [s.index for s in spans]
    # the newest kept, in the order they ended
    assert idx == list(range(idx[0], idx[0] + tracing.RING))
    assert len({s.request for s in spans}) == tracing.RING


def test_the_library_set_up_is_recorded_without_a_profiler(monkeypatch,
                                                            tmp_path):
    lib = tmp_path / "lib.so"

    def fake_build(out):
        out.touch()
        return out, "built"

    monkeypatch.setattr(_cuda, "_library_path", lambda: lib)
    monkeypatch.setattr(_cuda, "_build", fake_build)
    # stale: the build is a span inside the set-up
    assert _cuda.build() == (lib, "built")
    assert [s.name for s in tracing.spans()] == ["setup.build"]
    tracing.clear()
    monkeypatch.setattr(_cuda, "_load", lambda: "lib")
    assert _cuda.library.__wrapped__() == "lib"
    (s,) = tracing.spans()
    assert (s.name, s.parent) == ("setup.library", -1) and s.t1 >= s.t0
    tracing.clear()
    # current: hashed and loaded, nothing built
    assert _cuda.build() == (lib, "")
    assert tracing.spans() == []


def test_the_exact_viewshed_phases_are_spans(capsys):
    data = xt.DataArray(dem((40, 36), seed=3), dims=("y", "x"),
                        coords={"y": np.arange(40.0), "x": np.arange(36.0)},
                        attrs={"res": (1.0, 1.0)})
    want = xt.viewshed(data, x=10, y=12, observer_elev=5)
    got, _ = traced(xt.viewshed, data, x=10, y=12, observer_elev=5)
    assert torch.equal(got.data, want.data)
    assert capsys.readouterr().err == ""
    spans = tracing.spans()
    by_index, children = _tree(spans)
    (root,) = children[-1]
    assert root.name == "viewshed_exact.grid"
    phases = [c.name for c in sorted(children[root.index],
                                     key=lambda c: c.t0)]
    assert phases[:3] == ["viewshed_exact.cache", "viewshed_exact.plan",
                          "viewshed_exact.screen"]
    assert phases[-1] == "viewshed_exact.epilogue"
    assert all(s.name.startswith("viewshed_exact.") for s in spans)


def geo_dem(shape=(48, 56), seed=4):
    h, w = shape
    return xt.DataArray(dem(shape, seed), dims=("y", "x"), name="dem",
                        coords={"y": (h - np.arange(h) - 0.5) * 10.0,
                                "x": (np.arange(w) + 0.5) * 10.0},
                        attrs={"res": (10.0, 10.0)})


def sites_job(data):
    """The sites job: XDraw's viewshed from a 100 m mast, its hidden
    cells, their distance to the nearest seen cell."""
    vis = xt.viewshed(data, x=210.0, y=300.0, observer_elev=100.0,
                      exact=False)
    hidden = xt.classify.binary(vis, values=[-1])
    depth = xt.proximity(hidden, target_values=[0],
                         distance_metric="EUCLIDEAN")
    return vis, hidden, depth


SITES_SPANS = {
    "api.viewshed": ["api.args", "torchops.viewshed_fields",
                     "dispatch.xdraw", "torchops.viewshed_epilogue",
                     "api.dataset"],
    "api.binary": ["api.args", "torchops.binary", "api.dataset"],
    "api.proximity": ["api.args", "torchops.proximity_mask",
                      "torchops.proximity_mask", "dispatch.jfa",
                      "torchops.proximity_epilogue",
                      "torchops.proximity_epilogue", "api.dataset"]}


def test_the_sites_spans_nest_as_named(tmp_path):
    _, prof = traced(sites_job, geo_dem())
    spans = tracing.spans()
    by_index, children = _tree(spans)
    roots = sorted(children[-1], key=lambda s: s.t0)
    assert [r.name for r in roots] == list(SITES_SPANS)
    for r in roots:
        kids = sorted(children[r.index], key=lambda c: c.t0)
        assert [c.name for c in kids] == SITES_SPANS[r.name]
        for c in kids:
            assert r.t0 <= c.t0 <= c.t1 <= r.t1 and c.request == r.request
            # the passes and the dispatches hold no span of their own
            assert children.get(c.index, []) == []
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    exported = {e["name"] for e in events if e.get("ph") == "X"}
    assert {tracing.PREFIX + s.name for s in spans} <= exported


def test_without_a_profiler_the_sites_job_records_nothing():
    sites_job(geo_dem())
    assert tracing.spans() == []
    assert tracing.counters() == {}


# where the host waits on the card: XDraw's torch-op route (the CPU's)
# copies the viewpoint's row and column, the observer's height, the two
# spacings, the distance's floor and the target's height to the card
# (``_f32``) and reads the floor back (``.item()``) in its fields, and
# copies the target's height again in its epilogue (the card's kernel
# route passes them all as arguments); proximity copies its two
# coordinate axes.  The CPU's twin of X1 stands in for the kernel and
# waits for nothing.
SYNCS = {"viewshed": 7 + 1 + 1, "binary": 0, "proximity": 2}


def test_host_syncs_count_the_paths_transfer_sites():
    data = geo_dem()
    vis, hidden, _ = sites_job(data)
    calls = {
        "viewshed": lambda: xt.viewshed(data, x=210.0, y=300.0,
                                        observer_elev=100.0, exact=False),
        "binary": lambda: xt.classify.binary(vis, values=[-1]),
        "proximity": lambda: xt.proximity(hidden, target_values=[0])}
    for op, call in calls.items():
        tracing.clear()
        traced(call)
        assert tracing.counters().get("host.syncs", 0) == SYNCS[op], op
    tracing.clear()
    traced(sites_job, data)
    assert tracing.counters() == {"host.syncs": sum(SYNCS.values()),
                                  "xdraw.cells_torchops": 1} == \
        {"host.syncs": 11, "xdraw.cells_torchops": 1}


def test_the_sites_outputs_are_the_same_bits_under_the_profiler():
    data = geo_dem(seed=9)
    plain = sites_job(data)
    under, _ = traced(sites_job, data)
    for a, b in zip(plain, under):
        assert torch.equal(torch.isnan(a.data), torch.isnan(b.data))
        assert torch.equal(a.data.nan_to_num(-7.0), b.data.nan_to_num(-7.0))
        assert a.data.dtype == b.data.dtype == torch.float32
