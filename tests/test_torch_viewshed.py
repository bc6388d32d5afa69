"""Parity of the torch port's exact viewshed with the JAX package (CPU).

The same numpy rasters, made from seeds, go through ``xrspatial_tpu`` and
``xrspatial_torch``.  On the CPU the JAX package runs its default XLA scan
screen (one case also its Pallas screen kernel, in interpret mode), the
port its torch twin ``kernels/screen.py::screen_hilo``.

Tolerances:
- host attributes and plans (numpy float64, copied code): bit for bit;
- the table expansion, float32 and float64: bit for bit in key and idx,
  within `EXPAND_ULPS` ulps in the angles, gradients and clip range
  (torch's and XLA's atan may differ by an ulp); the slopes s01, s21 and
  the bands ts, tw divide by a difference of two angles, so they are held
  to 8 ulps of the angle (up to 2 pi) and of the gradients over that
  difference;
- screen bounds on the same expanded stacks: within `HILO_ULPS` ulps of
  the JAX scan body and of the Pallas kernel (XLA may contract the
  interpolation's product and sum into an fma; the twin rounds them
  apart), and the JAX screen's classification equal at every target;
- `viewshed`: visibility (``out == -1``) equal at every cell of every
  case; angles within rtol `ANGLE_RTOL` (float64 atan ulps in the
  epilogue).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xrspatial_torch as xt
from xrspatial_torch.kernels import cuda_screen
from xrspatial_torch.kernels import screen as TS
from xrspatial_torch.kernels import viewshed as TV
from xrspatial_torch.kernels import viewshed_exact as TE
from xrspatial_tpu.kernels import viewshed as JV
from xrspatial_tpu.kernels import viewshed_exact as JE
from xrspatial_tpu.utils import x64
from xrspatial_tpu.xrlib import DataArray as JaxDataArray


@pytest.fixture(autouse=True)
def numpy_rasters_on_the_cpu():
    """These tests give numpy rasters and compare on the CPU."""
    saved = xt.default_device()
    xt.set_default_device("cpu")
    yield
    xt.set_default_device(saved)


# the modules, not the functions of the same name the packages export
jvs = importlib.import_module("xrspatial_tpu.viewshed")
tvs = importlib.import_module("xrspatial_torch.viewshed")

EXPAND_ULPS = 2
HILO_ULPS = 2
ANGLE_RTOL = 1e-12
ATTR_FIELDS = ("key", "a0", "a1", "a2", "g0", "g1", "g2", "grad_t", "is_vp",
               "valid_b")


def attrs_raster(vp):
    """The 40x56 raster of tests/test_viewshed.py's attribute tests."""
    rng = np.random.default_rng(vp[0] * 7 + vp[1])
    data = (rng.random((40, 56)) * 80).astype(np.float64)
    data[np.unravel_index(rng.integers(0, data.size, 15), data.shape)] = \
        np.nan
    return data


def screen_raster():
    """96x112 with a ridge and NaN cells (tests/test_viewshed.py:464)."""
    rng = np.random.default_rng(9)
    data = (rng.random((96, 112)) * 60).astype(np.float64)
    data[40, :] += 80.0
    data[np.unravel_index(rng.integers(0, data.size, 12),
                          data.shape)] = np.nan
    return data


def bitwise_raster(shape):
    """The random ridge raster of tests/test_viewshed.py:157."""
    rng = np.random.default_rng(sum(shape) * 31 + shape[0])
    data = (rng.random(shape) * 60).astype(np.float64)
    data[shape[0] // 3, :] += 100.0
    data[np.unravel_index(rng.integers(0, data.size, 20), shape)] = np.nan
    return data


# -- (i) host attributes ---------------------------------------------------

@pytest.mark.parametrize("vp", [(10, 20), (0, 0), (39, 55), (0, 30),
                                (17, 0), (39, 12), (20, 55)])
def test_cell_attrs_host_bitwise(vp):
    data = attrs_raster(vp)
    ref = JV.cell_attrs_host(data, vp[0], vp[1], 3.0, 0.5, 1.5, -1.0)
    got = TV.cell_attrs_host(data, vp[0], vp[1], 3.0, 0.5, 1.5, -1.0)
    assert got["vp_elev"] == ref["vp_elev"] and got["shape"] == ref["shape"]
    for f in ATTR_FIELDS:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)


@pytest.mark.parametrize("vp", [(10, 20), (0, 0), (39, 55), (0, 30),
                                (20, 55)])
def test_cell_attrs_subset_bitwise(vp):
    data = attrs_raster(vp)
    h, w = data.shape
    rng = np.random.default_rng(vp[0] + 3)
    idx = np.unique(np.concatenate([
        rng.integers(0, h * w, 200), np.array([0, h * w - 1,
                                               vp[0] * w + vp[1]]),
        np.arange(vp[0] * w, vp[0] * w + w), np.arange(h) * w + vp[1]]))
    ref = JV.cell_attrs_subset(data, idx, vp[0], vp[1], 3.0, 0.5, 1.5, -1.0)
    got = TV.cell_attrs_subset(data, idx, vp[0], vp[1], 3.0, 0.5, 1.5, -1.0)
    for f in ATTR_FIELDS:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    full = TV.cell_attrs_host(data, vp[0], vp[1], 3.0, 0.5, 1.5, -1.0)
    for f in ATTR_FIELDS:
        np.testing.assert_array_equal(got[f], full[f][idx], err_msg=f)


@pytest.mark.parametrize("vp", [(10, 20), (0, 0), (39, 55), (0, 30),
                                (17, 0), (39, 12), (20, 55)])
def test_attrs_fast_paths_bitwise(vp):
    """The port's slab-written host fast paths equal its generic helpers
    bit for bit (the JAX suite's test_attrs_fast_paths_bitwise), and the
    torch forms of the generic angle and corner helpers, which the device
    expansion uses, agree with the numpy ones: corner offsets bit for bit,
    float64 angles within an ulp (two atan implementations)."""
    data = attrs_raster(vp)
    h, w = data.shape
    vr, vc = vp
    rows = np.arange(h, dtype=np.float64)[:, None] + np.zeros((1, w))
    cols = np.arange(w, dtype=np.float64)[None, :] + np.zeros((h, 1))
    ref_offs = TV._corner_offsets(rows, cols, float(vr), float(vc), xp=np)
    for r, f in zip(ref_offs, TV._corner_offsets_np(h, w, vr, vc)):
        np.testing.assert_array_equal(r, f)
    t_offs = TV._corner_offsets(torch.from_numpy(rows), torch.from_numpy(cols),
                                float(vr), float(vc), xp=torch)
    for r, t in zip(ref_offs, t_offs):
        np.testing.assert_array_equal(t.numpy(), r)
    e_dy, e_dx, x_dy, x_dx = ref_offs
    np.testing.assert_array_equal(TV._corner_elev(data, e_dy, e_dx),
                                  TV._corner_elev_np(data, vr, vc, True))
    np.testing.assert_array_equal(TV._corner_elev(data, x_dy, x_dx),
                                  TV._corner_elev_np(data, vr, vc, False))
    with np.errstate(invalid="ignore"):
        for dy, dx in ((e_dy, e_dx), (0.0, 0.0), (x_dy, x_dx)):
            ang = TV._calculate_angle(cols + dx, rows + dy, vc, vr, xp=np)
            np.testing.assert_array_equal(
                ang, TV._calculate_angle_np(rows + dy - vr, cols + dx - vc))
            t_ang = TV._calculate_angle(torch.from_numpy(cols + dx),
                                        torch.from_numpy(rows + dy),
                                        float(vc), float(vr), xp=torch)
            assert ulps(t_ang.numpy(), ang) <= 1
        vp_elev = data[vr, vc] + 7.0
        enter = TV._corner_elev_np(data, vr, vc, enter=True)
        for dy, dx, elev in ((0.0, 0.0, data), (e_dy, e_dx, enter)):
            np.testing.assert_array_equal(
                TV._gradient(rows + dy - vr, cols + dx - vc, elev, vp_elev,
                             1.25, -0.75),
                TV._gradient_np(rows + dy - vr, cols + dx - vc, elev,
                                vp_elev, 1.25, -0.75, (vr, vc)))


# -- (ii) the plan ---------------------------------------------------------

PLAN_CASES = {"ridge_96x112": (screen_raster, (50, 30)),
              "corner_64x48": (lambda: bitwise_raster((64, 48)), (0, 0))}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_bitwise(case):
    make, (vr, vc) = PLAN_CASES[case]
    data = make()
    args = (data, vr, vc, 3.0, 0.5, 1.0, -1.0)
    scs = (JE._screen_cache(*args), TE._screen_cache(*args))
    for f in ("a1", "d_c", "d_e", "d_x", "d_t", "d_c64", "d_e64", "d_x64",
              "d_t64", "order"):
        np.testing.assert_array_equal(scs[1][f], scs[0][f], err_msg=f)
    plans, tables = [], []
    for mod, sc in zip((JE, TE), scs):
        cache = (sc["glob"][0],
                 [(ext, keys, W) for ext, keys, _, W in sc["tiers"]])
        plan = mod._bucket_plan({"a1": sc["a1"]}, vr, vc, 512, cache=cache,
                                dense_order=sc["order"])
        tperm, glob_idx, tiers, A, C = plan
        packed, offs, metas = mod._screen_build_tables(
            sc, glob_idx, sc["glob"][1], tiers,
            [sh for _, _, sh, _ in sc["tiers"]])
        group = mod._group_plan(metas, A, C)
        plans.append((tperm, glob_idx, [los for _, los, _ in tiers],
                      [E for _, _, E in tiers], A, C, group))
        tables.append(({f: np.asarray(v) for f, v in packed.items()}, offs,
                       metas))
    (jt, jg, jlos, jE, jA, jC, jgrp), (tt, tg, tlos, tE, tA, tC, tgrp) = plans
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tg, jg)
    assert (tE, tA, tC) == (jE, jA, jC)
    for a, b in zip(tlos, jlos):
        np.testing.assert_array_equal(a, b)
    assert tgrp[0] == jgrp[0] and tgrp[2] == jgrp[2]      # B, NBs
    for a, b in zip(tgrp[1], jgrp[1]):                      # rows
        np.testing.assert_array_equal(a, b)
    (jp, joffs, jm), (tp, toffs, tm) = tables
    assert toffs == joffs and tp.keys() == jp.keys()
    for f in jp:
        np.testing.assert_array_equal(tp[f], jp[f], err_msg=f)
    for (a, ea), (b, eb) in zip(tm, jm):
        assert ea == eb
        np.testing.assert_array_equal(a, b)


# -- (iii) the table expansion ---------------------------------------------

def ulps(got, ref):
    """Largest distance in ulps of `ref`; equal infinities count 0."""
    got, ref = np.asarray(got), np.asarray(ref)
    same = (got == ref) | (np.isnan(got) & np.isnan(ref))
    with np.errstate(invalid="ignore"):
        d = np.where(same, 0.0, np.abs(got.astype(np.float64)
                                       - ref.astype(np.float64))
                     / np.spacing(np.abs(ref)).astype(np.float64))
    return float(np.max(d)) if d.size else 0.0


@pytest.mark.parametrize("level", [1, 2])
def test_expand_table_matches_jax(level):
    data = screen_raster()
    vr, vc = 50, 30
    sc = TE._screen_cache(data, vr, vc, 3.0, 0.5, 1.0, -1.0)
    f64 = level == 2
    cache = TE._plan_cache(sc)
    _, glob_idx, tiers, _, _ = TE._bucket_plan({"a1": sc["a1"]}, vr, vc, 512,
                                               cache=cache,
                                               dense_order=sc["order"])
    packed, offs, metas = TE._screen_build_tables(
        sc, glob_idx, sc["glob"][1], tiers,
        [sh for _, _, sh, _ in sc["tiers"]], f64=f64)
    taus = (JE._TAUS_F64 if f64 else JE._TAUS_F32)
    ttaus = (TE._TAUS_F64 if f64 else TE._TAUS_F32)
    assert ttaus == taus
    w = data.shape[1]
    for i in range(len(offs) - 1):
        tab = {f: v[offs[i]:offs[i + 1]] for f, v in packed.items()}
        got = TE._expand_table({f: torch.from_numpy(v) for f, v in
                                tab.items()}, w, vr, vc, 1.0, -1.0, ttaus)
        with x64() if f64 else jax.default_device(jax.devices("cpu")[0]):
            ft = jnp.float64 if f64 else jnp.float32
            ref = JE._expand_table({f: jnp.asarray(v) for f, v in
                                    tab.items()}, w, jnp.int32(vr),
                                   jnp.int32(vc), ft(1.0), ft(-1.0), taus)
            ref = {f: np.asarray(v) for f, v in ref.items()}
        for f in ("key", "idx"):
            np.testing.assert_array_equal(got[f].numpy(), ref[f], err_msg=f)
        # the slopes and bands of valid candidates (invalid ones fail both
        # cover tests, whatever their fields)
        valid = np.isfinite(ref["a0w"])
        f64v = {f: ref[f].astype(np.float64) for f in ref}
        a1e = f64v["a1e"]
        dmin = np.maximum(np.minimum(a1e - (f64v["a0w"] + f64v["a0n"]) / 2,
                                     (f64v["a2w"] + f64v["a2n"]) / 2 - a1e),
                          1e-30)
        dt = ref["a1e"].dtype

        def ulp(v):
            return np.spacing(np.abs(v).astype(dt)).astype(np.float64)

        gmax = np.maximum(np.abs(f64v["mn"]), np.abs(f64v["mx"]))
        for f in TS.F13:
            g = got[f].numpy()
            assert g.dtype == ref[f].dtype
            if f in ("s01", "s21", "ts", "tw"):
                # each divides by a difference of two angles (or its
                # inverse): one ulp of the angles, up to 2 pi, over the
                # smaller span
                bound = (8 * (ulp(gmax) + np.abs(f64v[f])
                              * ulp(np.float64(2 * np.pi))) / dmin
                         + 4 * ulp(f64v[f]))
                err = np.abs(g.astype(np.float64) - f64v[f])
                assert (err <= bound)[valid].all(), f
            else:
                assert ulps(g, ref[f]) <= EXPAND_ULPS, (f, ulps(g, ref[f]))


# -- (iv) the screen's bounds and classification ----------------------------

def jax_scan_hilo(glob, stacks, al, klo, khi, it, rows, A, C, Es, NBs, B):
    """hi/lo of the JAX package's scan screen: `_screen_scan`'s body around
    its `_screen_pairs`, which `_screen_scan` reduces to (vis, amb)."""
    G, T = A // B, B * C
    gstk, gidx = glob
    glob_c = {f: gstk[i][None] for i, f in enumerate(JE._F13)}
    glob_c["idx"] = gidx[None]
    xs = dict(al=al.reshape(G, T), klo=klo.reshape(G, T),
              khi=khi.reshape(G, T), it=it.reshape(G, T), r=rows)

    def body(_, x):
        a, kl, kh, i = (x[k][:, None] for k in ("al", "klo", "khi", "it"))
        hi, lo = JE._screen_pairs(a, kl, kh, i, glob_c)
        for t, ((stk, idx), E, NB) in enumerate(zip(stacks, Es, NBs)):
            nb = min(NB, idx.shape[0])
            r = jnp.minimum(x["r"][t], idx.shape[0] - nb)
            zero = jnp.int32(0)
            wnd = jax.lax.dynamic_slice(stk, (r, zero, zero), (nb, 13, E))
            c = {f: wnd[:, k][None] for k, f in enumerate(JE._F13)}
            c["idx"] = jax.lax.dynamic_slice(idx, (r, zero), (nb, E))[None]
            h2, l2 = JE._screen_pairs(a[:, :, None], kl[:, :, None],
                                      kh[:, :, None], i[:, :, None], c)
            hi, lo = jnp.maximum(hi, h2), jnp.maximum(lo, l2)
        return None, (hi, lo)

    _, (hi, lo) = jax.lax.scan(body, None, xs)
    return np.asarray(hi).ravel(), np.asarray(lo).ravel()


def to_jax(args):
    glob, stacks, al, klo, khi, it, rows, A, C, Es, NBs, B = args
    J = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    return ((J(glob[0]), J(glob[1])),
            tuple((J(s), J(i)) for s, i in stacks),
            J(al), J(klo), J(khi), J(it), J(rows), A, C, Es, NBs, B)


@pytest.mark.parametrize("route", ["scan_f32", "scan_f64", "pallas_f32"])
def test_twin_bounds_match_jax(route):
    level = 2 if route == "scan_f64" else 1
    data = screen_raster()
    args = TE.screen_inputs(data, 50, 30, 3.0, 0.5, 1.0, -1.0, level=level)
    hi, lo = TS.screen_hilo(*args)
    assert hi.dtype == (torch.float64 if level == 2 else torch.float32)
    with x64() if level == 2 else jax.default_device(jax.devices("cpu")[0]):
        jargs = to_jax(args)
        if route == "pallas_f32":
            from xrspatial_tpu.kernels.pallas_screen import screen_hilo_pallas
            glob, stacks, al, klo, khi, it, rows, A, C, Es, NBs, B = jargs
            rh, rl = screen_hilo_pallas(
                glob, stacks, al, klo, khi, it,
                tuple(rows[:, t] for t in range(rows.shape[1])), A, C, Es,
                NBs, B, interpret=True)
            rh, rl = np.asarray(rh), np.asarray(rl)
        else:
            rh, rl = jax_scan_hilo(*jargs)
    assert np.array_equal(np.isneginf(hi.numpy()), np.isneginf(rh))
    assert np.array_equal(np.isneginf(lo.numpy()), np.isneginf(rl))
    assert ulps(hi.numpy(), rh) <= HILO_ULPS
    assert ulps(lo.numpy(), rl) <= HILO_ULPS


@pytest.mark.parametrize("level", [1, 2])
def test_classification_matches_jax_scan(level):
    """`_screen_scan`'s own (vis, amb) against the port's on the same
    expanded stacks and targets."""
    data = screen_raster()
    vr, vc = 50, 30
    sc = TE._screen_cache(data, vr, vc, 3.0, 0.5, 1.0, -1.0)
    if level == 1:
        cargs, _ = TE._level1(sc, vr, vc, 1.0, -1.0, 512, "cpu")
    else:
        targets = np.arange(0, data.size, 5, dtype=np.int64)
        plans, E_all = TE._level2_plans(sc, targets, vr, vc, 512)
        cargs = next(TE._level2_tables(sc, plans, E_all, vr, vc, 1.0, -1.0,
                                       "cpu"))
    vis, amb = TE._screen_classify(*cargs)
    (glob, stacks, tperm, a1_t, d_t, rows, A, C, Es, NBs, B, w, _, _, ew, ns,
     taus, _) = cargs
    with x64() if level == 2 else jax.default_device(jax.devices("cpu")[0]):
        ft = jnp.float64 if level == 2 else jnp.float32
        J = lambda t: jnp.asarray(t.numpy())  # noqa: E731
        jvis, jamb = JE._screen_scan(
            (J(glob[0]), J(glob[1])), tuple((J(s), J(i)) for s, i in stacks),
            jnp.asarray(tperm.astype(np.int32)),
            None if a1_t is None else jnp.asarray(a1_t), jnp.asarray(d_t),
            tuple(jnp.asarray(r) for r in rows), A, C, Es, NBs, B, w,
            jnp.int32(vr), jnp.int32(vc), ft(ew), ft(ns),
            jnp.int32(vr * w + vc), taus=taus)
    np.testing.assert_array_equal(vis, np.asarray(jvis))
    np.testing.assert_array_equal(amb, np.asarray(jamb))
    assert 0 < amb.sum() < amb.size


# -- (v) public viewshed against the JAX package ---------------------------

def rasters(data, res=(1.0, 1.0)):
    """(JAX DataArray, port DataArray) with tests/general_checks.py's
    coordinates: y descending, x ascending, spacing `res` (y, x)."""
    h, w = data.shape
    ys = np.linspace((h - 1) * res[0], 0, h)
    xs = np.linspace(0, (w - 1) * res[1], w)
    jagg = JaxDataArray(data, dims=("y", "x"), coords={"y": ys, "x": xs},
                        attrs={"res": res})
    tagg = xt.DataArray(torch.from_numpy(data.copy()), dims=("y", "x"),
                        coords={"y": ys, "x": xs}, attrs={"res": res})
    return jagg, tagg


def compare_viewshed(data, calls, res=(1.0, 1.0)):
    """Each (row, col, observer_elev, target_elev) through both packages:
    visibility equal at every cell, angles within ANGLE_RTOL.  Returns
    the port's outputs."""
    jagg, tagg = rasters(data, res)
    ys, xs = np.asarray(jagg["y"].data), np.asarray(jagg["x"].data)
    outs = []
    for r, c, oe, te in calls:
        ref = np.asarray(jvs.viewshed(jagg, x=xs[c], y=ys[r],
                                      observer_elev=oe, target_elev=te).data)
        got = xt.viewshed(tagg, x=xs[c], y=ys[r], observer_elev=oe,
                          target_elev=te)
        assert isinstance(got.data, torch.Tensor)
        assert got.data.dtype == torch.float64 and got.shape == data.shape
        g = got.data.numpy()
        np.testing.assert_array_equal(g == -1, ref == -1,
                                      err_msg=str((r, c, oe, te)))
        np.testing.assert_allclose(g, ref, rtol=ANGLE_RTOL, atol=0,
                                   err_msg=str((r, c, oe, te)))
        assert g[r, c] == 180.0
        outs.append(g)
    return outs


def cone(h, w, vr, vc):
    rr, cc = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return 0.5 * np.sqrt((rr - vr) ** 2.0 + (cc - vc) ** 2.0)


def case_symmetry():
    rng = np.random.default_rng(0)
    half = rng.random((7, 4))
    return np.concatenate([half, rng.random((7, 1)), half[:, ::-1]], axis=1)


def case_wall(height):
    data = np.zeros((5, 9))
    data[:, 4] = height
    return data


def case_nan():
    data = np.zeros((5, 7))
    data[2, 3] = np.nan
    return data


def case_peak():
    data = np.zeros((9, 9))
    data[4, 4] = 100.0
    return data


# name -> (raster, [(row, col, observer_elev, target_elev)], res (y, x))
VIEWSHED_CASES = {
    "flat": (np.zeros((6, 7)), [(0, 0, 1, 0), (3, 3, 1, 0), (5, 6, 1, 0),
                                (2, 5, 1, 0)], (1.0, 1.0)),
    "wall": (case_wall(10.0), [(2, 1, 0, 0)], (1.0, 1.0)),
    "peak": (case_peak(), [(4, 0, 0, 0)], (1.0, 1.0)),
    "symmetry": (case_symmetry(), [(3, 4, 0.5, 0)], (1.0, 1.0)),
    "target_elev": (case_wall(2.0), [(2, 0, 1, 0), (2, 0, 1, 50)],
                    (1.0, 1.0)),
    "nan_cells": (case_nan(), [(2, 0, 2, 0)], (1.0, 1.0)),
    "bitwise_48x64": (bitwise_raster((48, 64)), [(10, 10, 3.0, 0.5)],
                      (1.0, 1.5)),
    "corner_64x48": (bitwise_raster((64, 48)), [(0, 0, 3.0, 0.5)],
                     (1.0, 1.5)),
    # at eye level on flat ground or a ramp every target ties: the screen
    # cannot separate them and the safety valve re-evaluates all of them
    "valve_flat": (np.zeros((64, 96)), [(32, 48, 0.0, 0)], (1.0, 1.0)),
    "valve_ramp": (np.tile(np.arange(96.0), (64, 1)), [(30, 5, 0.0, 0)],
                   (1.0, 1.0)),
    # the same ramp seen from its middle: level 2, then the oracle
    "level2_ramp": (np.tile(np.arange(96.0), (64, 1)), [(30, 60, 0.0, 0)],
                    (1.0, 1.0)),
}


@pytest.mark.parametrize("case", list(VIEWSHED_CASES))
def test_viewshed_matches_jax(case):
    data, calls, res = VIEWSHED_CASES[case]
    outs = compare_viewshed(data, calls, res)
    if case.startswith("valve"):
        assert TE.LAST_CALL["route"] == "valve"
    if case == "level2_ramp":
        assert TE.LAST_CALL["route"] == "l2+gathered"
        assert TE.LAST_CALL["amb2"] > 0
    if case == "wall":
        assert (outs[0][:, 6:] == -1).all() and (outs[0][:, :4] > -1).all()
    if case == "peak":
        assert outs[0][4, 5] == -1 and outs[0][4, 4] > -1
    if case == "symmetry":
        np.testing.assert_array_equal(outs[0] > -1, (outs[0] > -1)[:, ::-1])
    if case == "target_elev":
        assert (outs[1] > -1).all() and (outs[0] > -1).sum() < outs[0].size
    if case == "nan_cells":
        assert outs[0][2, 3] == -1 and outs[0][2, 4] > -1


@pytest.mark.parametrize("obs_elev", [-1, 1])
def test_observer_elev_scenarios(obs_elev):
    """A part of the JAX suite's elevate-the-viewpoint matrix, through
    both packages."""
    calls = []
    for elev_at_vp in (-1, 1):
        for r, c in ((2, 2), (0, 4)):
            data = np.zeros((5, 5))
            data[r, c] = elev_at_vp
            outs = compare_viewshed(data, [(r, c, obs_elev, 0)])
            if obs_elev + elev_at_vp >= 0 and obs_elev >= abs(elev_at_vp):
                assert (outs[0] > -1).all()
            calls.append(outs)
    assert len(calls) == 4


def test_viewshed_level2_slabs_match_jax(monkeypatch):
    """The cone, where hundreds of true near-ties stay ambiguous after
    the float32 screen, with the shortcut and volume guard off and slabs
    of 64 targets, in both packages."""
    for mod in (JE, TE):
        monkeypatch.setattr(mod, "_L2_MIN_AMB", 0)
        monkeypatch.setattr(mod, "_L2_SLAB", 64)
        monkeypatch.setattr(mod, "_DIRECT_MAX_ELEMS", 0)
    compare_viewshed(cone(80, 88, 40, 22), [(40, 22, 0.0, 0.0)])
    assert TE.LAST_CALL["route"].startswith("l2")
    assert TE.LAST_CALL["slabs"] >= 2 and TE.LAST_CALL["amb1"] > 128


def test_viewshed_no_screen_matches_jax(monkeypatch):
    monkeypatch.setenv("XRSPATIAL_VS_NO_SCREEN", "1")
    compare_viewshed(bitwise_raster((48, 64)), [(10, 10, 3.0, 0.5)],
                     (1.0, 1.5))


# -- (vi) the exact path against the port's own pairwise oracle ------------

@pytest.mark.parametrize("shape,vp", [((48, 64), (10, 10)),
                                      ((64, 48), (0, 0)),
                                      ((96, 112), (50, 30))])
def test_exact_equals_pairwise_oracle(shape, vp):
    data = screen_raster() if shape == (96, 112) else bitwise_raster(shape)
    t = torch.from_numpy(data)
    pw = TV.viewshed_grid(t, vp[0], vp[1], 3.0, 0.5, 1.5, -1.0)
    ex = TE.viewshed_grid_exact(t, vp[0], vp[1], 3.0, 0.5, 1.5, -1.0,
                                chunk=128)
    assert pw.dtype == ex.dtype == torch.float64
    assert torch.equal(pw, ex)


def test_exact_routes_equal_bitwise(monkeypatch):
    """Every re-evaluation route gives the same bits: the gathered oracle,
    the level-2 re-screen, and float64 for every target."""
    data = bitwise_raster((48, 64))
    t = torch.from_numpy(data)
    args = (t, 10, 10, 3.0, 0.5, 1.5, -1.0)
    base = TE.viewshed_grid_exact(*args)
    assert TE.LAST_CALL["route"] == "gathered"
    monkeypatch.setattr(TE, "_L2_MIN_AMB", 0)
    l2 = TE.viewshed_grid_exact(*args)
    assert TE.LAST_CALL["route"].startswith("l2")
    monkeypatch.setattr(TE, "_VALVE_MIN_AMB", 0)
    monkeypatch.setattr(TE, "_VALVE_FRAC", 0.0)
    valve = TE.viewshed_grid_exact(*args)
    assert TE.LAST_CALL["route"] == "valve"
    assert torch.equal(base, l2) and torch.equal(base, valve)


# -- (vii) arguments and routes ------------------------------------------

def test_viewpoint_outside_raises():
    _, tagg = rasters(np.zeros((5, 5)))
    xs, ys = np.asarray(tagg["x"].data), np.asarray(tagg["y"].data)
    with pytest.raises(ValueError):
        xt.viewshed(tagg, x=xs.min() - 1, y=0)
    with pytest.raises(ValueError):
        xt.viewshed(tagg, x=0, y=ys.max() + 1)


def test_xdraw_raises_not_implemented(monkeypatch):
    """The routing that took the place of the refusal this test was named
    for: the exact predicate (float64) at or under the ceiling by default
    and with exact=True above it, XDraw (float32, the scan twin on the
    CPU) above it by default and with exact=False under it; each equal to
    the JAX package's route (visibility at every cell here, XDraw's
    near-tie cells are held in tests/test_torch_xdraw.py)."""
    data = bitwise_raster((48, 64))
    jagg, tagg = rasters(data)
    xs, ys = np.asarray(tagg["x"].data), np.asarray(tagg["y"].data)
    kw = dict(x=xs[3], y=ys[5], observer_elev=2.0)
    los = TV.viewshed_grid_los(torch.from_numpy(data), 5, 3, 2.0, 0.0,
                               float(xs[1] - xs[0]), float(ys[1] - ys[0]))

    def both(**extra):
        got = xt.viewshed(tagg, **kw, **extra).data
        ref = np.asarray(jvs.viewshed(jagg, **kw, **extra).data)
        np.testing.assert_array_equal(got.numpy() == -1, ref == -1)
        return got

    for mod in (jvs, tvs):
        monkeypatch.setattr(mod, "_EXACT_MAX_CELLS", 48 * 64)
    at_ceiling = both()
    assert at_ceiling.dtype == torch.float64
    assert torch.equal(at_ceiling, both(exact=True))
    xdraw = both(exact=False)
    assert xdraw.dtype == torch.float32 and torch.equal(xdraw, los)
    for mod in (jvs, tvs):
        monkeypatch.setattr(mod, "_EXACT_MAX_CELLS", 40 * 40)
    assert torch.equal(both(), los)
    assert torch.equal(both(exact=True), at_ceiling)


# -- (viii) the kernel wrapper ---------------------------------------------

def test_cuda_wrapper_refuses_cpu_tensors():
    args = TE.screen_inputs(np.zeros((12, 9)), 4, 3, 1.0, 0.0, 1.0, -1.0)
    before = cuda_screen.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        cuda_screen.screen_hilo_cuda(*args)
    assert cuda_screen.LAUNCHES == before
