"""The jump-flood round kernel's plan and its new routes' algorithms (CPU).

``kernels/jfa_plan.py::round_plan`` chooses, for each round, the route of
``csrc/jfa.cu``: staged (a window in shared memory, by TMA or cp.async),
vector (9 unconditional 16-byte loads a 4-cell group) or simple (the
first port).  Checked here:

- the plan's route, tile, window and shared bytes at every stride of the
  16384^2 schedule, both state forms, with and without a value plane;
  the cases that go to simple or to cp.async; TMA's rules (box sides at
  most 256, a 16-byte-aligned first column); the k-phase row order;
- torch emulations of the two new routes, written with the kernels'
  index arithmetic (the staged window with TMA's zero fill and the
  sentinel written over it, 4 cells a thread from three 16-byte groups a
  row, the winner's window offset; the vector route's clamped addresses
  and invalid mask, the value taken at the winner), equal bit for bit to
  ``jfa_rounds.round_packed`` / ``round_coords`` over whole schedules,
  and for one round to the JAX package's XLA round.

Tolerances: none; every comparison is bit for bit.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrspatial_torch.kernels import jfa_plan, jfa_rounds
from xrspatial_torch.kernels.emulate import axes, layout
from xrspatial_torch.kernels.jfa import _stride_schedule, packed_state_plan
from xrspatial_torch.kernels.jfa_plan import round_plan
from xrspatial_tpu.kernels import jfa as jjfa

INF_BITS = 0x7F800000


@pytest.fixture(autouse=True)
def one_thread():
    """Many small torch ops: one thread keeps them fast when several
    pytest workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the plan -----------------------------------------------------------------

def staged_plan(k, planes):
    """The staged route's plan of a 16384^2 round at stride k."""
    pad = max(4, k)
    rows, pitch = 32 + 2 * k, 128 + 2 * pad
    shared = 256 + planes * -(-rows * pitch * 4 // 128) * 128
    return ("staged", "tma", (32, 128), pad, pitch, rows, planes, shared,
            False, 512 * 128)


# the routes of proximity's schedule at 16384^2, from phase 8's table on
# an H100 (PERF.md §6): (route, k-phase order) by stride
PROXIMITY_ROUTES = {8192: ("vector", True), 4096: ("vector", True),
                    2048: ("vector", True), 1024: ("vector", True),
                    512: ("vector", True), 256: ("vector", True),
                    128: ("vector", False), 64: ("vector", False),
                    32: ("staged", False), 16: ("staged", False),
                    8: ("staged", False), 4: ("staged", False),
                    2: ("staged", False), 1: ("staged", False)}


@pytest.mark.parametrize("with_val", [False, True], ids=["state", "value"])
@pytest.mark.parametrize("form", ["packed", "coords"])
def test_plan_at_every_stride_of_the_16384_schedule(form, with_val):
    planes = (1 if form == "packed" else 2) + with_val
    state_bytes = 4 * (1 if form == "packed" else 2)
    for k in _stride_schedule(16384):
        k = int(k)
        plan = round_plan(16384, 16384, k, form, with_val)
        assert plan.planes == planes
        staged = staged_plan(k, planes)
        if k <= 32 and (staged[7] <= 233472 // 2 - 1024 or k < 4):
            assert plan == staged, k
        else:
            # k-phase order where 2k rows of state pass half the 50 MiB L2
            phased = 2 * k * 16384 * state_bytes > 50 * 2 ** 20 // 2
            assert plan == ("vector", "", (1, 1024), 0, 0, 0, planes, 0,
                            phased, 16384 * 16), k
    if (form, with_val) == ("packed", False):
        assert {int(k): (round_plan(16384, 16384, int(k), form, False).route,
                         round_plan(16384, 16384, int(k), form,
                                    False).phased)
                for k in _stride_schedule(16384)} == PROXIMITY_ROUTES
    # the staged windows of the 16384^2 schedule: 18,816 bytes at k = 1 up
    # to 73,984 at k = 32
    assert staged_plan(1, 1)[7] == 18816 and staged_plan(32, 1)[7] == 73984


def test_the_schedule_takes_16_rounds_on_new_routes():
    routes = [round_plan(16384, 16384, int(k), "packed", False).route
              for k in _stride_schedule(16384)]
    assert len(routes) == 16 and "simple" not in routes
    assert routes.count("staged") == 8 and routes.count("vector") == 8


@pytest.mark.parametrize("h,w,k,ptr,route,stage", [
    (70, 302, 64, 0, "simple", ""),       # w % 4 != 0 at a vector stride
    (70, 300, 128, 4, "simple", ""),      # an unaligned base
    (2, 5, 1024, 0, "simple", ""),
    (1025, 2049, 64, 0, "simple", ""),
    (1025, 2049, 2, 0, "staged", "async"),  # TMA refuses the pitch
    (70, 302, 16, 0, "staged", "async"),
    (70, 300, 1, 8, "staged", "async"),   # ... or the base
    (70, 300, 2, 0, "staged", "tma"),
    (70, 300, 32, 0, "vector", ""),       # two planes of 96 x 192 a block
    (70, 300, 64, 0, "vector", ""),
])
def test_where_the_plan_sends_a_round(h, w, k, ptr, route, stage):
    plan = round_plan(h, w, k, "packed", True, ptr)
    assert (plan.route, plan.stage) == (route, stage)
    if route == "simple":
        assert plan.grid == -(-w // 32) * -(-h // 8)
    if route == "vector":
        assert plan.grid == h * -(-(w // 4) // 256)


@pytest.mark.parametrize("form", ["packed", "coords"])
@pytest.mark.parametrize("shape", [(70, 300), (1025, 2049), (16384, 16384),
                                   (3, 4)])
def test_staged_windows_keep_the_tma_rules(shape, form):
    """Every stride the staged route takes: one box a plane of at most 256
    a side, whose first column (tile column minus pad) is a multiple of 4
    cells (16 bytes), a window that covers the tile and its halo, and
    shared bytes that hold it."""
    h, w = shape
    for k in (1, 2, 4, 8, 16, 32, 64):
        for with_val in (False, True):
            planes = FORMS[form] + with_val
            plane = (32 + 2 * k) * (128 + 2 * max(k, 4)) * 4
            need = 256 + planes * -(-plane // 128) * 128
            if need > jfa_plan.SMEM_PER_BLOCK:
                # k = 64 with two or three planes: refused, by name too
                assert k == 64 and planes > 1
                with pytest.raises(ValueError, match="staged route cannot"):
                    round_plan(h, w, k, form, with_val, route="staged")
                assert round_plan(h, w, k, form, with_val).route != "staged"
                continue
            p = round_plan(h, w, k, form, with_val, route="staged")
            th, tw = p.tile
            assert p.pitch <= 256 and p.rows <= 256
            assert p.pad >= k and p.pad % 4 == 0
            assert all((c0 - p.pad) % 4 == 0 for c0 in range(0, w, tw))
            assert p.pitch == tw + 2 * p.pad and p.rows == th + 2 * k
            assert p.shared_bytes == need
            assert p.grid == -(-h // th) * -(-w // tw)
    for k in (3, 128, 8192):
        with pytest.raises(ValueError, match="staged route cannot"):
            round_plan(h, w, k, form, False, route="staged")


def test_vector_needs_32_bit_offsets_and_aligned_groups():
    assert round_plan(46344, 46344, 64, "coords", False).route == "simple"
    assert round_plan(32768, 32768, 64, "packed", False).route == "vector"
    for w, k, ptr in ((302, 8, 0), (300, 2, 0), (300, 8, 8)):
        with pytest.raises(ValueError, match="vector route cannot"):
            round_plan(70, w, k, "packed", False, ptr, route="vector")
    assert round_plan(70, 302, 8, "packed", False, route="simple").route \
        == "simple"
    with pytest.raises(ValueError, match="route is one of"):
        round_plan(70, 300, 8, "packed", False, route="ring")


@pytest.mark.parametrize("h,k", [(16384, 8192), (16384, 128), (1025, 64),
                                 (70, 4), (5, 8), (2049, 2048)])
def test_phase_rows_is_a_permutation_in_k_phase_order(h, k):
    rows = jfa_plan.phase_rows(h, k)
    assert sorted(rows) == list(range(h))
    steps = [b - a for a, b in zip(rows, rows[1:])]
    # inside a phase the next slot is k rows on
    assert sum(s == k for s in steps) == h - min(h, k)


# -- emulations of the new routes -------------------------------------------

FORMS = {"packed": 1, "coords": 2}


def words(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def keys(form, metric, steps, xs, ys, rows, cols, a, b):
    """Key of candidate words (a, b) from cells (rows, cols)."""
    if form == "packed":
        return jfa_rounds.key_packed(rows.to(torch.int32),
                                     cols.to(torch.int32), a, metric, steps)
    h, w = ys.numel(), xs.numel()
    px = xs[cols.clamp(0, w - 1)]
    py = ys[rows.clamp(0, h - 1)]
    return jfa_rounds.coords_key(px, py, a.view(torch.float32),
                                 b.view(torch.float32), metric)


def sentinel(form, q):
    return -1 if form == "packed" and q == 0 else INF_BITS


def emulate_staged(form, planes, value, k, metric, steps, xs, ys, plan,
                   repair=True):
    """One round on the staged route: every tile's window of every plane
    (TMA's zero fill, then the sentinel outside the raster unless
    `repair` is False), 4 cells a thread from three 16-byte groups of
    each candidate row, the value at the winner's window offset."""
    h, w = planes[0].shape
    th, tw = plan.tile
    pad, pitch, nrows = plan.pad, plan.pitch, plan.rows
    n_ty, n_tx = -(-h // th), -(-w // tw)
    wr = (torch.arange(n_ty) * th - k)[:, None] + torch.arange(nrows)
    wc = (torch.arange(n_tx) * tw - pad)[:, None] + torch.arange(pitch)
    inside = ((wr >= 0) & (wr < h))[:, None, :, None] & \
        ((wc >= 0) & (wc < w))[None, :, None, :]
    srcs = [words(p) for p in planes] + ([words(value)] if value is not None
                                         else [])
    wins = []
    for q, src in enumerate(srcs):
        g = src[wr.clamp(0, h - 1)[:, None, :, None],
                wc.clamp(0, w - 1)[None, :, None, :]]
        win = torch.where(inside, g, 0)                 # TMA's zero fill
        if repair and q < FORMS[form]:
            win = torch.where(inside, win, sentinel(form, q))
        wins.append(win)
    # thread (tile, tr, lane), cell j: window row tr + k + sy*k, column
    # wx + (g - 1) * G + i % 4 for word i = 4 + j + sx*D, g = i // 4
    d = k if k < 4 else 4
    gap = 4 if k < 4 else k
    c = torch.arange(tw)
    wx = pad + 4 * (c // 4)
    tr = torch.arange(th)
    rows = (torch.arange(n_ty) * th)[:, None, None, None] + tr[:, None]
    cols = (torch.arange(n_tx) * tw)[None, :, None, None] + c
    rows, cols = rows.expand(n_ty, n_tx, th, tw), cols.expand(n_ty, n_tx,
                                                             th, tw)

    def cand(sy, sx):
        i = 4 + c % 4 + sx * d
        col = wx + (i // 4 - 1) * gap + i % 4
        row = tr + k + sy * k
        off = row[:, None] * pitch + col[None, :]
        return [wn[:, :, row][:, :, :, col] for wn in wins], off

    own, off = cand(0, 0)
    s = own[:FORMS[form]]
    best = keys(form, metric, steps, xs, ys, rows, cols, s[0], s[-1])
    wo = off.expand(n_ty, n_tx, th, tw)
    for sy, sx in jfa_rounds.CANDIDATES:
        cw, off = cand(sy, sx)
        nd = keys(form, metric, steps, xs, ys, rows, cols, cw[0],
                  cw[FORMS[form] - 1])
        better = nd < best
        s = [torch.where(better, a, b) for a, b in zip(cw, s)]
        wo = torch.where(better, off, wo)
        best = torch.where(better, nd, best)
    v = None
    if value is not None:
        flat = wins[-1].reshape(n_ty, n_tx, nrows * pitch)
        v = torch.gather(flat, 2, wo.reshape(n_ty, n_tx, -1)).reshape(
            wo.shape)

    def raster(t):
        return t.permute(0, 2, 1, 3).reshape(n_ty * th, n_tx * tw)[:h, :w]

    out = [raster(t) for t in s]
    return out, None if v is None else raster(v), raster(best)


def emulate_vector(form, planes, value, k, metric, steps, xs, ys):
    """One round on the vector route: each 4-cell group loads 4 words at
    each of the 9 positions, clamped into the raster; an invalid position
    gets the sentinel; the value comes from the winner's index."""
    h, w = planes[0].shape
    assert w % 4 == 0 and k % 4 == 0
    row = torch.arange(h)[:, None]
    col = (torch.arange(w // 4) * 4)[None, :]
    flats = [words(p).reshape(-1) for p in planes]
    j = torch.arange(4)

    def load(sy, sx):
        r, c = row + sy * k, col + sx * k
        ok = ((r >= 0) & (r < h)) & ((c >= 0) & (c < w))
        rr = torch.where((r >= 0) & (r < h), r, row)
        cc = torch.where((c >= 0) & (c < w), c, col)
        idx = (rr * w + cc)[..., None] + j            # (h, w/4, 4)
        return [f[idx] for f in flats], ok[..., None].expand(idx.shape), idx

    rows = row[..., None].expand(h, w // 4, 4)
    cols = (col[..., None] + j).expand(h, w // 4, 4)
    s, _, wi = load(0, 0)
    best = keys(form, metric, steps, xs, ys, rows, cols, s[0], s[-1])
    for sy, sx in jfa_rounds.CANDIDATES:
        cw, ok, idx = load(sy, sx)
        cw[0] = torch.where(ok, cw[0], sentinel(form, 0))
        nd = keys(form, metric, steps, xs, ys, rows, cols, cw[0], cw[-1])
        better = nd < best
        s = [torch.where(better, a, b) for a, b in zip(cw, s)]
        wi = torch.where(better, idx, wi)
        best = torch.where(better, nd, best)
    v = None if value is None else value.reshape(-1)[wi].reshape(h, w)
    return [t.reshape(h, w) for t in s], v, best.reshape(h, w)


def setup(shape, kind, metric, with_val, seed, empty=False):
    """(form, state planes, value, steps, xs, ys) of jump_flood's round-0
    state on a sparse layout."""
    data = layout(shape, 0.02, seed)
    if empty:
        data[:] = 0
    ys_np, xs_np = (np.ascontiguousarray(a, dtype=np.float32)
                    for a in axes(kind, *shape))
    mask = torch.from_numpy(data != 0)
    xs, ys = torch.from_numpy(xs_np), torch.from_numpy(ys_np)
    value = torch.from_numpy(data) if with_val else None
    plan = packed_state_plan(xs_np, ys_np, metric)
    if plan is not None:
        h, w = shape
        iy = torch.arange(h, dtype=torch.int32)[:, None]
        ix = torch.arange(w, dtype=torch.int32)[None, :]
        state = torch.where(mask, (iy << 15) | ix, -1)
        return "packed", [state], value, plan[0], xs, ys
    tx = torch.where(mask, xs[None, :], math.inf)
    ty = torch.where(mask, ys[:, None], math.inf)
    return "coords", [tx, ty], value, None, xs, ys


def twin_round(form, planes, value, k, metric, steps, xs, ys):
    if form == "packed":
        s, v, best = jfa_rounds.round_packed(planes[0], value, k, metric,
                                             steps)
        return [s], v, best
    tx, ty, v = jfa_rounds.round_coords(planes[0], planes[1], value, xs, ys,
                                        k, metric)
    return [tx, ty], v, None


def route_round(route, form, planes, value, k, metric, steps, xs, ys):
    """One round on `route` where it can run, else the twin round."""
    h, w = planes[0].shape
    try:
        plan = round_plan(h, w, k, form, value is not None, route=route)
    except ValueError:
        plan = None
    if plan is None or route == "simple":
        return twin_round(form, planes, value, k, metric, steps, xs, ys)
    if route == "staged":
        out, v, best = emulate_staged(form, planes, value, k, metric, steps,
                                      xs, ys, plan)
    else:
        out, v, best = emulate_vector(form, planes, value, k, metric, steps,
                                      xs, ys)
    if form == "coords":
        out = [t.view(torch.float32) for t in out]
    if v is not None:
        v = v.view(torch.float32)
    return out, v, best if form == "packed" else None


def assert_same(got, ref):
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            assert torch.equal(g, r)


# (kind of axes, metric, value plane): the packed state on affine axes,
# the coordinate state on the others
MODES = {"packed_euclidean_values": ("affine_desc", 0, True),
         "packed_manhattan": ("affine_asc", 2, False),
         "coords_euclidean_values": ("nonaffine", 0, True),
         "coords_great_circle": ("lonlat", 1, False),
         "coords_manhattan": ("nonaffine", 2, False)}
SHAPES = {"70x300": (70, 300), "2x5": (2, 5), "1025x2048": (1025, 2048),
          "1025x2049": (1025, 2049), "no_target_70x300": (70, 300)}
# the large shapes in one mode each, on the routes that run there, to keep
# the file quick
CASES = ([(s, m, r) for s in ("70x300", "2x5", "no_target_70x300")
          for m in MODES for r in ("staged", "vector", "plan")]
         + [("1025x2049", "packed_euclidean_values", r)
            for r in ("staged", "plan")]
         + [("1025x2048", "coords_manhattan", r) for r in ("vector", "plan")])


@pytest.mark.parametrize("shape,mode,route", CASES)
def test_route_emulation_equals_the_twin_over_whole_schedules(shape, mode,
                                                              route):
    """Every round of jump_flood's schedule on the route (the twin where
    it cannot run; "plan": the route round_plan names) equals the twin
    round, bit for bit, in every plane and the best key."""
    kind, metric, with_val = MODES[mode]
    form, planes, value, steps, xs, ys = setup(
        SHAPES[shape], kind, metric, with_val, 5,
        empty=shape.startswith("no_target"))
    h, w = planes[0].shape
    ran = 0
    for k in _stride_schedule(max(h, w)):
        k = int(k)
        name = route
        if route == "plan":
            name = round_plan(h, w, k, form, with_val).route
        got = route_round(name, form, planes, value, k, metric, steps, xs,
                          ys)
        ref = twin_round(form, planes, value, k, metric, steps, xs, ys)
        assert_same(got[0], ref[0])
        assert_same((got[1], got[2]), (ref[1], ref[2]))
        ran += name != "simple"
        planes, value = ref[0], ref[1]
    assert ran > 0 or route == "vector"


def test_without_the_sentinel_tma_zero_fill_would_adopt_cell_0_0():
    """The trap: TMA fills outside the raster with 0, the packed target of
    row 0, column 0; without the sentinel written over it, cells at the
    edge adopt that phantom target."""
    form, planes, value, steps, xs, ys = setup((70, 300), "affine_desc", 0,
                                               False, 5, empty=True)
    plan = round_plan(70, 300, 1, form, False, route="staged")
    good, _, _ = emulate_staged(form, planes, None, 1, 0, steps, xs, ys,
                                plan)
    bad, _, _ = emulate_staged(form, planes, None, 1, 0, steps, xs, ys,
                               plan, repair=False)
    assert bool((good[0] == -1).all())
    assert int((bad[0] == 0).sum()) > 0


@pytest.mark.parametrize("k", [1, 2, 4, 16, 64])
@pytest.mark.parametrize("metric", [0, 2], ids=["euclidean", "manhattan"])
def test_one_round_of_each_emulation_matches_jax(metric, k):
    """One round of the staged and vector emulations, in both state forms,
    against one XLA round of the JAX package on a dense layout where many
    cells see equidistant candidates."""
    shape = (72, 96)
    data = layout(shape, 0.3, 15 + k)
    ys_np, xs_np = (np.ascontiguousarray(a, dtype=np.float32)
                    for a in axes("affine_desc", *shape))
    mask = data != 0
    tx = np.where(mask, xs_np[None, :], np.inf).astype(np.float32)
    ty = np.where(mask, ys_np[:, None], np.inf).astype(np.float32)
    rtx, rty, rval, _ = jjfa._jfa_rounds(
        *map(jnp.asarray, (tx, ty, data, xs_np, ys_np)), strides=(k,),
        metric=metric, shape=shape)
    rtx, rty, rval = map(np.asarray, (rtx, rty, rval))
    xs, ys = torch.from_numpy(xs_np), torch.from_numpy(ys_np)
    value = torch.from_numpy(data)
    steps = packed_state_plan(xs_np, ys_np, metric)[0]
    iy, ix = np.nonzero(mask)
    state = np.full(shape, -1, np.int32)
    state[iy, ix] = (iy << 15) | ix
    routes = ["staged"] + (["vector"] if k % 4 == 0 else [])
    for route in routes:
        got, v, _ = route_round(route, "packed", [torch.from_numpy(state)],
                                value, k, metric, steps, xs, ys)
        s = got[0].numpy()
        ok = s >= 0
        np.testing.assert_array_equal(
            np.where(ok, xs_np[np.where(ok, s & 0x7FFF, 0)], np.inf), rtx)
        np.testing.assert_array_equal(
            np.where(ok, ys_np[np.where(ok, s >> 15, 0)], np.inf), rty)
        np.testing.assert_array_equal(v.numpy(), rval)
        got, v, _ = route_round(route, "coords", [torch.from_numpy(tx),
                                                  torch.from_numpy(ty)],
                                value, k, metric, None, xs, ys)
        np.testing.assert_array_equal(got[0].numpy(), rtx)
        np.testing.assert_array_equal(got[1].numpy(), rty)
        np.testing.assert_array_equal(v.numpy(), rval)
