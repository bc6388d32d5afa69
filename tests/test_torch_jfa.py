"""Units of the torch port's jump flood against the JAX package (CPU).

The stride schedule, the packed and great-circle keys, the host plans, one
round of each twin, the Manhattan scans' tie rules, and the twins against
exhaustive search.  The public functions are held to the JAX package in
``test_torch_proximity.py``, whose input builders this file shares.

Tolerances: keys and choices of EUCLIDEAN and MANHATTAN bit for bit;
great-circle keys rtol 1e-5 (torch's and XLA's float32 trig differ by an
ulp or two); distances rtol 1e-5 / atol 1e-5 against exhaustive search.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrspatial_torch.kernels import jfa as tjfa
from xrspatial_torch.kernels import jfa_rounds
from xrspatial_torch.kernels.emulate import GC_RTOL, TOL, axes, layout
from xrspatial_tpu.kernels import jfa as jjfa
from xrspatial_tpu.kernels import pallas_jfa


@pytest.mark.parametrize("max_dim", [1, 2, 3, 5, 64, 257, 16384])
def test_stride_schedule_matches_jax(max_dim):
    got = tjfa._stride_schedule(max_dim)
    np.testing.assert_array_equal(got, jjfa._stride_schedule(max_dim))
    assert list(got[-2:]) == [2, 1]


def test_stride_schedule_at_16384_is_16_rounds():
    assert list(tjfa._stride_schedule(16384)) == \
        [2 ** e for e in range(13, -1, -1)] + [2, 1]


@pytest.mark.parametrize("metric", [0, 2], ids=["euclidean", "manhattan"])
@pytest.mark.parametrize("sy,sx,y0,x0", [
    (1.0, 1.0, 0.0, 0.0), (-2.0, 8.0, 100.0, -50.0), (0.5, -0.25, 3.5, 1.25)])
def test_packed_key_matches_jax(sy, sx, y0, x0, metric):
    """Bitwise against pallas_jfa._key_packed, and against the coordinate
    key (the parity packed_state_plan proves), sentinel included."""
    rng = np.random.default_rng(8)
    h, w = 64, 96
    ys = (y0 + np.arange(h) * sy).astype(np.float32)
    xs = (x0 + np.arange(w) * sx).astype(np.float32)
    plan = tjfa.packed_state_plan(xs, ys, metric)
    assert plan == jjfa.packed_state_plan(xs, ys, metric)
    steps = plan[0]
    ciy, cix, piy, pix = (rng.integers(0, n, 500).astype(np.int32)
                          for n in (h, w, h, w))
    cand = ((ciy.astype(np.int64) << 15) | cix).astype(np.int32)
    cand[:7] = -1
    ref = np.asarray(pallas_jfa._key_packed(
        jnp.asarray(piy), jnp.asarray(pix), jnp.asarray(cand), metric, steps))
    got = jfa_rounds.key_packed(torch.from_numpy(piy), torch.from_numpy(pix),
                                torch.from_numpy(cand), metric, steps).numpy()
    np.testing.assert_array_equal(got, ref)
    assert np.isinf(got[:7]).all()
    coord = jfa_rounds.coords_key(
        torch.from_numpy(xs[pix]), torch.from_numpy(ys[piy]),
        torch.from_numpy(xs[cix]), torch.from_numpy(ys[ciy]), metric).numpy()
    np.testing.assert_array_equal(got[7:], coord[7:])


@pytest.mark.parametrize("metric", [0, 1, 2],
                         ids=["euclidean", "great_circle", "manhattan"])
def test_metric_key_and_distance_match_jax(metric):
    rng = np.random.default_rng(21)
    n = 4000
    lon1 = rng.uniform(-179, 179, n).astype(np.float32)
    lat1 = rng.uniform(-89, 89, n).astype(np.float32)
    near = rng.random(n) < 0.5          # near-coincident pairs
    lon2 = np.where(near, lon1 + rng.uniform(-0.01, 0.01, n),
                    rng.uniform(-179, 179, n)).astype(np.float32)
    lat2 = np.where(near, lat1 + rng.uniform(-0.01, 0.01, n),
                    rng.uniform(-89, 89, n)).astype(np.float32)
    lon2[:50], lat2[:50] = lon1[:50], lat1[:50]   # coincident
    args = (lon1, lon2, lat1, lat2)
    ref_key = np.asarray(jjfa._metric_key(*map(jnp.asarray, args), metric))
    got_key = tjfa.metric_key(*map(torch.from_numpy, args), metric).numpy()
    ref_d = np.asarray(jjfa.metric_distance(*map(jnp.asarray, args), metric))
    got_d = tjfa.metric_distance(*map(torch.from_numpy, args),
                                 metric).numpy()
    if metric == 1:
        # torch's and XLA's float32 sin/cos/asin differ by an ulp or two
        np.testing.assert_allclose(got_key, ref_key, rtol=1e-5, atol=1e-12)
        np.testing.assert_allclose(got_d, ref_d, rtol=GC_RTOL, atol=1e-3)
        assert (got_key[:50] == 0).all() and (got_d[:50] == 0).all()
    else:
        np.testing.assert_array_equal(got_key, ref_key)
        # torch's CPU sqrt (MKL) is within an ulp, not correctly rounded
        np.testing.assert_allclose(got_d, ref_d, rtol=2.4e-7, atol=0)


PLAN_AXES = {
    "unit": (np.arange(512), np.arange(256)[::-1]),
    "scaled": (np.arange(512) * 8.0, np.arange(256)[::-1] * 0.5),
    "nonuniform": (np.where(np.arange(512) == 100, 100.5, np.arange(512)),
                   np.arange(256)[::-1]),
    "step_0.1": (np.arange(512) * 0.1, np.arange(256)[::-1]),
    "too_wide": (np.arange(40000), np.arange(256)[::-1]),
    "one_wide": (np.array([3.0]), np.arange(256)[::-1]),
    "descending_x": (np.arange(64)[::-1] * 2.0, np.arange(32) - 7.0),
    "nonmonotone": (np.array([0.0, 5.0, 2.0, 8.0]), np.array([0.0, 1, 3])),
}


@pytest.mark.parametrize("metric", [0, 1, 2],
                         ids=["euclidean", "great_circle", "manhattan"])
@pytest.mark.parametrize("name", list(PLAN_AXES))
def test_host_plans_match_jax(name, metric):
    """packed_state_plan and manhattan_scan_plan on the JAX tests'
    coordinate cases (tests/test_proximity.py, the packed-plan gate)."""
    xs, ys = (np.ascontiguousarray(a, dtype=np.float32)
              for a in PLAN_AXES[name])
    assert tjfa.packed_state_plan(xs, ys, metric) == \
        jjfa.packed_state_plan(xs, ys, metric)
    assert tjfa.manhattan_scan_plan(xs, ys) == \
        jjfa.manhattan_scan_plan(xs, ys)


def initial_state(data, xs, ys):
    """(tx, ty, value) float32 planes of the targets of `data`."""
    mask = data != 0
    tx = np.where(mask, xs[None, :], np.inf).astype(np.float32)
    ty = np.where(mask, ys[:, None], np.inf).astype(np.float32)
    return tx, ty, data.astype(np.float32)


@pytest.mark.parametrize("k", [1, 2, 4, 16, 64])
@pytest.mark.parametrize("metric", [0, 1, 2],
                         ids=["euclidean", "great_circle", "manhattan"])
def test_one_round_matches_jax(metric, k):
    """One round of the coordinate twin against one XLA round of the JAX
    package on a dense target layout, where most cells see several
    equidistant candidates: bit for bit, so the candidate order and the
    strict < agree."""
    data = layout((70, 90), 0.3, 15 + k)
    kind = "lonlat" if metric == 1 else "affine_desc"
    ys, xs = (a.astype(np.float32) for a in axes(kind, 70, 90))
    tx, ty, val = initial_state(data, xs, ys)
    rtx, rty, rval, _ = jjfa._jfa_rounds(
        *map(jnp.asarray, (tx, ty, val, xs, ys)), strides=(k,),
        metric=metric, shape=data.shape)
    gtx, gty, gval = jfa_rounds.round_coords(
        *map(torch.from_numpy, (tx, ty, val, xs, ys)), k, metric)
    if metric == 1:
        # an ulp of trig may turn a near-tie; the rest is bitwise
        same = (gtx.numpy() == np.asarray(rtx)) & \
            (gty.numpy() == np.asarray(rty))
        assert same.mean() > 0.99
        return
    for g, r in ((gtx, rtx), (gty, rty), (gval, rval)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if metric in (0, 2):
        # the packed twin makes the same choices
        plan = tjfa.packed_state_plan(xs, ys, metric)
        iy, ix = np.nonzero(data != 0)
        state = np.full(data.shape, -1, np.int32)
        state[iy, ix] = (iy << 15) | ix
        s, v, best = jfa_rounds.round_packed(
            torch.from_numpy(state), torch.from_numpy(val), k, metric,
            plan[0])
        s = s.numpy()
        ok = s >= 0
        np.testing.assert_array_equal(
            np.where(ok, xs[np.where(ok, s & 0x7FFF, 0)], np.inf),
            np.asarray(rtx))
        np.testing.assert_array_equal(v.numpy(), np.asarray(rval))


@pytest.mark.parametrize("values", [False, True], ids=["coords", "values"])
@pytest.mark.parametrize("flip", [False, True], ids=["x_asc", "x_desc"])
def test_manhattan_scans_match_jax_at_ties(flip, values):
    """Equidistant layouts: the port's cummin/cummax scans keep the JAX
    combiners' tie rules (the row above wins in a column, the left
    candidate wins in a row, the nearest index wins among equal minima),
    so targets match bit for bit."""
    h, w = 21, 31
    data = np.zeros((h, w), np.float32)
    for i, (r, c) in enumerate([(2, 3), (2, 27), (18, 3), (18, 27), (10, 15),
                                (6, 9), (6, 21), (14, 9), (14, 21)]):
        data[r, c] = i + 1
    xs = np.arange(w, dtype=np.float32) * 2.0
    if flip:
        xs = xs[::-1].copy()
    ys = np.arange(h, dtype=np.float32)[::-1].copy()
    mask = data != 0
    vals = data if values else None
    ref = jjfa.jump_flood(jnp.asarray(mask), jnp.asarray(xs), jnp.asarray(ys),
                          2, values=None if vals is None else
                          jnp.asarray(vals))
    got = tjfa.jump_flood(torch.from_numpy(mask), torch.from_numpy(xs),
                          torch.from_numpy(ys), 2,
                          values=None if vals is None else
                          torch.from_numpy(vals))
    for g, r in zip(got, ref):
        if r is None:
            assert g is None
            continue
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_manhattan_tie_rules_pinned():
    """On a row, the left of two equidistant targets wins; in a column,
    the one at the lower row index wins."""
    row = np.zeros((1, 5), bool)
    row[0, [0, 4]] = True
    xs = np.arange(5, dtype=np.float32)
    _, tx, _, _ = tjfa.jump_flood(torch.from_numpy(row), torch.from_numpy(xs),
                                  torch.zeros(1), 2)
    assert tx[0, 2] == 0.0
    col = np.zeros((5, 1), bool)
    col[[0, 4], 0] = True
    ys = np.arange(5, dtype=np.float32)
    _, _, ty, _ = tjfa.jump_flood(torch.from_numpy(col), torch.zeros(1),
                                  torch.from_numpy(ys), 2)
    assert ty[2, 0] == 0.0


def brute_force(mask, xs, ys, metric):
    """Exact nearest-target distances (float64) by exhaustive search."""
    t_iy, t_ix = np.nonzero(mask)
    dx = xs[:, None].astype(np.float64) - xs[t_ix][None, :]
    dy = ys[:, None].astype(np.float64) - ys[t_iy][None, :]
    h, w = mask.shape
    if not t_iy.size:
        return np.full((h, w), np.inf)
    if metric == 2:
        d = np.abs(dy)[:, None, :] + np.abs(dx)[None, :, :]
    else:
        d = np.sqrt(dy[:, None, :] ** 2 + dx[None, :, :] ** 2)
    return d.min(axis=2)


@pytest.mark.parametrize("metric", [0, 2], ids=["euclidean", "manhattan"])
@pytest.mark.parametrize("kind", ["affine_desc", "affine_asc", "nonaffine"])
@pytest.mark.parametrize("seed", [31, 32])
def test_twins_match_brute_force(seed, kind, metric):
    """jump_flood on the CPU (packed or coordinate twin, or the Manhattan
    scans) against exhaustive search; the carried targets realize the
    optimum and carry their own values."""
    data = layout((37, 45), 0.02, seed)
    ys, xs = (a.astype(np.float32) for a in axes(kind, 37, 45, seed))
    mask = data != 0
    d, tx, ty, tv = tjfa.jump_flood(
        torch.from_numpy(mask), torch.from_numpy(xs), torch.from_numpy(ys),
        metric, values=torch.from_numpy(data))
    best = brute_force(mask, xs, ys, metric)
    np.testing.assert_allclose(d.numpy(), best, **TOL)
    tx, ty, tv = tx.numpy(), ty.numpy(), tv.numpy()
    if metric == 2:
        dd = np.abs(xs[None, :] - tx) + np.abs(ys[:, None] - ty)
    else:
        dd = np.hypot(xs[None, :] - tx, ys[:, None] - ty)
    np.testing.assert_allclose(dd, best, **TOL)
    lookup = {(float(ys[i]), float(xs[j])): data[i, j]
              for i, j in zip(*np.nonzero(mask))}
    assert all(tv[i, j] == lookup[(float(ty[i, j]), float(tx[i, j]))]
               for i in range(0, 37, 3) for j in range(0, 45, 4))


@pytest.mark.parametrize("metric,kind", [(0, "affine_desc"),
                                         (0, "nonaffine"),
                                         (1, "lonlat")],
                         ids=["packed", "coordinates", "great_circle"])
def test_mesh_branch_is_not_ported_yet(metric, kind):
    """Once a NotImplementedError (ROADMAP A13): the mesh branch now gives
    the unsharded transform, on a mesh of 2 x 2 CPU blocks, the mask given
    as a plain tensor (placed on the mesh by the call), packed and
    coordinate states bit for bit."""
    from xrspatial_torch.parallel import get_raster_mesh, make_raster_mesh
    h, w = 37, 45
    data = layout((h, w), 0.03, 12)
    ys, xs = (np.ascontiguousarray(a, dtype=np.float32)
              for a in axes(kind, h, w, seed=12))
    mask = torch.from_numpy(data != 0)
    vals = torch.from_numpy(data)
    mesh = make_raster_mesh(2, 2, devices=[torch.device("cpu")] * 4)
    ref = tjfa.jump_flood(mask, torch.from_numpy(xs), torch.from_numpy(ys),
                          metric, values=vals)
    with pytest.warns(UserWarning, match="REPLICATED"):
        got = tjfa.jump_flood(mask, xs, ys, metric, values=vals, mesh=mesh)
    for g, r in zip(got, ref):
        assert get_raster_mesh(g) is mesh
        np.testing.assert_array_equal(g.gather().numpy(), r.numpy())
