"""Exact viewshed at ~N^1.5 cost: angle-sorted bucket evaluation.

Counterpart of ``xrspatial_tpu/kernels/viewshed_exact.py``.  The pairwise
path (``viewshed.py``) evaluates the GRASS r.viewshed predicate for every
target against ALL cells, O(N^2).  This module computes the bit-identical
result with ~sqrt(N)-fold less work by pruning candidates geometrically:

1. all cells are sorted by center angle ``a1`` (host argsort) and targets
   are processed in angle buckets of ``C``;
2. a bucket's candidate blockers are a conservative SUPERSET of every
   cell whose angular span can cover any bucket angle: cells are tiered
   by index-distance rho from the viewpoint (a cell at distance rho has
   angular halfspan <= asin(sqrt(2)/2 / rho)), so tier candidates are one
   contiguous slice of the tier's angle-sorted table; near cells and
   cells whose span crosses angle 0 are candidates for every bucket;
3. each bucket runs the shared predicate `_interp_blocked_max` over its
   candidate block; extra candidates fail the exact cover test and
   contribute -inf, and float max is order-independent, so the result
   equals the pairwise oracle bit for bit.

By default a sound interval screen classifies most targets first
(`_screened_visibility`): level 1 in float32, the ambiguous rest in a
float64 level-2 re-screen, the last ties in the float64 predicate.  The
screen's pair evaluation is the CUDA kernel ``csrc/screen.cu`` for a
raster on the card and its torch twin ``screen.py::screen_hilo`` for a
raster on the CPU; nothing else decides between them.

Planning is host numpy, copied from the JAX package, so both packages
build the same plans from the same raster.  The device work (table
expansion, target preparation, the float64 bucket evaluation, the
classification) is torch ops on the raster's device.
"""

from __future__ import annotations

import os
from math import asin

import numpy as np
import torch

from ..tracing import span
from . import screen as _screen
from .viewshed import (PI, _calculate_angle, _corner_diffs_np,
                       _corner_offsets, _interp_blocked_max, _np_rects,
                       _visibility_epilogue, cell_attrs_host,
                       cell_attrs_subset_fn)

__all__ = ["viewshed_grid_exact", "screen_inputs", "LAST_CALL"]

_F13 = _screen.F13
_PLANES = ("key", "a0", "a1", "a2", "g0", "g1", "g2")

# index-distance tier boundaries (ratio 2: the per-tier halfspan bound
# asin(sqrt(2)/2 / r_lo) overshoots a cell's true halfspan by at most
# ~2x); the first bound is also the near-set radius
_TIER_BOUNDS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192,
                16384)

# safety margin added to the analytic halfspan bound: covers float
# rounding of the f32 sort keys / bucket endpoints vs the true f64
# angles (>= 2 * _E_ANG + margin; the bound itself is exact
# real-arithmetic)
_W_EPS = 1e-5

# float64 candidate pairs per step of the bucket evaluation: several
# buckets share one batched step (element-wise, so batching changes no
# bit)
_PAIRS_PER_STEP = 1 << 24

# what the last `_screened_visibility` call did: ambiguous counts of each
# level and the re-evaluation route (for the chip check and diagnosis)
LAST_CALL: dict = {}


def _round_up(x: int, m: int) -> int:
    return max(m, ((x + m - 1) // m) * m)


def _blocker_table(at, idx):
    """Host-side f64 attribute table for the candidate cells `idx`
    (uploaded packed by `_build_tables`)."""
    tab = {f: at[f][idx] for f in _PLANES}
    tab["valid_b"] = at["valid_b"][idx]
    tab["idx"] = idx.astype(np.int64)
    return tab


def _tier_cache(at, vp_row, vp_col):
    """Target-independent half of the plan: the near/crossing global
    candidate set and per-tier angle-sorted cell tables, shared between
    the f32 screen plan and the f64 re-evaluation plans."""
    n = at["a1"].size
    h, w = at["shape"]
    a1 = at["a1"]
    crossing = at["a0"] > at["a2"]
    rows, cols = np.divmod(np.arange(n), w)
    rho = np.hypot(rows - vp_row, cols - vp_col)

    glob_mask = (rho <= _TIER_BOUNDS[0]) | crossing
    glob_idx = np.nonzero(glob_mask)[0]

    tier_list = []
    bounds = [b for b in _TIER_BOUNDS if b < rho.max()] + [np.inf]
    for r_lo, r_hi in zip(bounds[:-1], bounds[1:]):
        mask = (rho > r_lo) & (rho <= r_hi) & ~crossing
        tidx = np.nonzero(mask)[0]
        if tidx.size == 0:
            continue
        W = asin(min(1.0, 0.7071067811865476 / r_lo)) + _W_EPS
        order = np.argsort(a1[tidx], kind="stable")
        tidx = tidx[order]
        tier_list.append((tidx, a1[tidx], W))
    return glob_idx, tier_list


def _bucket_plan(at, vp_row, vp_col, C, targets=None, cache=None,
                 dense_order=None, unify_E=False):
    """Host-side plan: target permutation, tier tables, slice offsets.

    ``targets`` restricts the TARGET side to a subset of cell indices
    (the f64 re-evaluation of screen-ambiguous targets); the candidate
    tiers always cover every cell.  ``cache`` (from `_tier_cache`) skips
    recomputing the target-independent tier sorts; ``dense_order``
    optionally supplies the all-cells angle argsort."""
    a1 = at["a1"]
    if cache is None:
        cache = _tier_cache(at, vp_row, vp_col)
    glob_idx, tier_list = cache

    if targets is None:
        n_all = a1.size
        targets = np.arange(n_all, dtype=np.int64)
        dense = True
    else:
        n_all = a1.size
        dense = False
    n_t = targets.size
    C = min(C, n_t)
    if dense and dense_order is not None:
        perm = dense_order
    else:
        perm = np.argsort(a1[targets], kind="stable")
    a1s = a1[targets][perm]

    if dense:
        A = -(-n_t // C)
        lo_t = np.minimum(np.arange(A, dtype=np.int64) * C, n_t - C)
        if n_t % C == 0:
            # buckets tile the permutation exactly
            tperm = targets[perm]
        else:
            tperm = targets[perm[(lo_t[:, None]
                                  + np.arange(C)[None, :]).ravel()]]
        starts = a1s[lo_t]
        ends = a1s[lo_t + C - 1]
    else:
        # SPARSE target subsets (the f64 re-eval of screen-ambiguous
        # cells) bucket by ANGLE SPAN, not just count: C scattered
        # targets can span the whole circle, making every tier's
        # candidate window the entire tier.  Quantize angle into cells of
        # dmax, sub-chunk each cell by C, and pad short buckets by
        # repeating their last member (duplicates write equal values).
        # dmax is taken from a geometric menu, minimizing the evaluation
        # volume A * sumE.
        g0 = 4.0 * C / max(n_all, 1) * 2.0 * np.pi
        arange_t = np.arange(n_t, dtype=np.int64)
        best = None
        for mult in (1.0, 4.0, 16.0, 64.0, 256.0):
            dmax = min(g0 * mult, 7.0)
            cell = np.floor(a1s / dmax).astype(np.int64)
            first = np.zeros(n_t, dtype=bool)
            first[0] = True
            first[1:] = cell[1:] != cell[:-1]
            cell_start = np.maximum.accumulate(
                np.where(first, arange_t, 0))
            new_b = ((arange_t - cell_start) % C) == 0
            s_b = np.nonzero(new_b)[0]
            e_b = np.append(s_b[1:], n_t)
            # the bucket COUNT is padded to a power of two by repeating
            # the last bucket (a small menu of shapes)
            A = 1 << (max(int(s_b.size), 8) - 1).bit_length()
            pad = A - s_b.size
            if pad:
                s_b = np.append(s_b, np.full(pad, s_b[-1]))
                e_b = np.append(e_b, np.full(pad, e_b[-1]))
            starts = a1s[s_b]
            ends = a1s[e_b - 1]
            sumE = 0
            for tidx, ta1, W in tier_list:
                los_t = np.searchsorted(ta1, starts - W, side="left")
                his_t = np.searchsorted(ta1, ends + W, side="right")
                need = max(int((his_t - los_t).max()), 128)
                sumE += 1 << (need - 1).bit_length()
            if best is None or A * sumE < best[0]:
                best = (A * sumE, s_b, e_b, A)
            if dmax >= 7.0:
                break
        _, s_b, e_b, A = best
        member = s_b[:, None] + np.minimum(np.arange(C)[None, :],
                                           (e_b - s_b - 1)[:, None])
        tperm = targets[perm[member.ravel()]]
        starts = a1s[s_b]
        ends = a1s[e_b - 1]

    tiers = []
    for tidx, ta1, W in tier_list:
        los = np.searchsorted(ta1, starts - W, side="left")
        his = np.searchsorted(ta1, ends + W, side="right")
        # next power of two: a small shape menu at <= 2x extra masked work
        need = max(int((his - los).max()), 128)
        E = 1 << (need - 1).bit_length()
        tiers.append((tidx, los, E))
    if unify_E and not dense and tiers:
        # level-2 screen plans only: every tier's window length unified to
        # the max, so the slabs share one table build; wider windows are
        # sound supersets (the clamp epilogue argument)
        E_uni = max(E for _, _, E in tiers)
        tiers = [(tidx, los, E_uni) for tidx, los, _ in tiers]
    return tperm, glob_idx, tiers, A, C


def viewshed_grid_exact(data, vp_row: int, vp_col: int,
                        observer_elev: float, target_elev: float,
                        ew_res: float, ns_res: float, chunk: int = 512):
    """Exact visibility grid at any size (bit-identical to viewshed_grid).

    `data` is a 2-D tensor (a numpy array is taken as a CPU tensor); the
    result is float64 on its device.  The host planning reads one float64
    copy of the raster; ``XRSPATIAL_VS_NO_SCREEN=1`` runs the float64
    bucket evaluation for every target, ``XRSPATIAL_VS_EXACT_CHUNK`` sets
    the bucket size.  Under ``torch.profiler`` the call is the span
    ``viewshed_exact.grid`` and each phase a ``viewshed_exact.<phase>``
    span inside it (``xrspatial_torch.tracing``), each phase's device
    work beneath it on the profiler's timeline.
    """
    chunk = int(os.environ.get("XRSPATIAL_VS_EXACT_CHUNK", chunk))
    data = torch.as_tensor(data)
    device = data.device
    with span("viewshed_exact.grid"):
        # the one host copy: float64, as the planning needs it
        data_np = data.detach().to("cpu", torch.float64).numpy()
        h, w = data_np.shape
        n = h * w
        vp_elev = data_np[vp_row, vp_col] + observer_elev

        if os.environ.get("XRSPATIAL_VS_NO_SCREEN") == "1":
            with span("viewshed_exact.attrs"):
                at = cell_attrs_host(data_np, vp_row, vp_col, observer_elev,
                                     target_elev, ew_res, ns_res)
            with span("viewshed_exact.f64_buckets"):
                tperm, glob_idx, tiers, A, C = _bucket_plan(at, vp_row,
                                                            vp_col, chunk)
                vis_np = _run_buckets_f64(at, tperm, glob_idx, tiers, A, C,
                                          device)
                visible = np.empty(n, dtype=bool)
                # clamped-overlap duplicates write equal values
                visible[tperm] = vis_np
        else:
            visible = _screened_visibility(data_np, vp_row, vp_col,
                                           observer_elev, target_elev,
                                           ew_res, ns_res, chunk, device)

        with span("viewshed_exact.epilogue"):
            visible_dev = torch.from_numpy(visible.reshape(h, w)).to(device)
            return _visibility_epilogue(data.to(torch.float64), visible_dev,
                                        vp_elev, vp_row, vp_col, target_elev,
                                        ew_res, ns_res)


def _pad_tab(tab, L):
    """Pad a host candidate table up to a coarse length quantum; inert
    pad entries are filtered by the predicate (valid_b False -> -inf)."""
    cur = tab["idx"].shape[0]
    if cur >= L:
        return tab
    pad = L - cur
    return {f: np.pad(v, (0, pad),
                      constant_values=(False if f == "valid_b"
                                       else -1 if f == "idx" else 0.0))
            for f, v in tab.items()}


def _upload(host, device):
    """One upload per field of the concatenated [glob, tier...] host
    tables, carved back into per-table views by plain slices."""
    offs = np.cumsum([0] + [t["idx"].size for t in host])
    packed = {f: torch.from_numpy(np.concatenate([t[f] for t in host]))
              .to(device) for f in host[0]}
    return _carve(packed, offs)


def _carve(packed, offs):
    """Slice each packed field back into the [glob, tier...] tables."""
    return tuple({f: v[int(offs[i]):int(offs[i + 1])]
                  for f, v in packed.items()}
                 for i in range(len(offs) - 1))


def _build_tables(at, glob_idx, tiers, make_table, device):
    """Build the [glob, tier...] candidate tables host-side and upload
    them.  Returns the global table, [(tier table, E)] and each tier's
    (A,) first-block index j of the two-block window the bucket
    evaluation reads."""
    host = [_pad_tab(make_table(at, glob_idx),
                     _round_up(glob_idx.size, 1024))]
    metas = []
    for tidx, los, E in tiers:
        L = max(E, _round_up(tidx.size, 16384))
        host.append(_pad_tab(make_table(at, tidx), L))
        # clamp so the fixed-length slice stays in-bounds (extra
        # candidates from clamping are filtered by the cover test)
        metas.append((np.minimum(np.maximum(los, 0),
                                 L - E).astype(np.int32), E))
    dev = _upload(host, device)
    tier_tabs = [(tab, E) for tab, (_, E) in zip(dev[1:], metas)]
    return dev[0], tier_tabs, [los for los, _ in metas]


def _run_buckets_f64_gathered(attrs_of, tperm, glob_idx, tiers, A, C,
                              device):
    """Float64 bucket evaluation for a SMALL target subset: gather on the
    host ONLY the (A, E) candidate slices each bucket reads, flatten them
    to (A*E,) blocks, and evaluate them with stride-E window starts.
    Identical candidate supersets + identical predicate => bit-identical
    visibility to `_run_buckets_f64`.

    ``attrs_of(flat_idx) -> dict`` supplies the f64 attributes at
    arbitrary flat indices (cell_attrs_subset_fn)."""
    host_tabs = []

    def _host_tab(flat, inb):
        a = attrs_of(flat)
        tab = {f: a[f] for f in _PLANES}
        tab["valid_b"] = a["valid_b"] & inb
        tab["idx"] = np.where(inb, flat, -1).astype(np.int64)
        return tab

    with span("viewshed_exact.gather"):
        gpad = _round_up(glob_idx.size, 1024)
        gext = np.pad(glob_idx, (0, gpad - glob_idx.size))
        host_tabs.append(_host_tab(
            gext, np.arange(gpad) < glob_idx.size))
        Es = []
        for tidx, los, E in tiers:
            # same clamp semantics as _build_tables: slices stay in-bounds
            # of the padded table; pad rows are invalid (filtered by the
            # predicate), clamp-overlap extras fail the cover test
            los = np.minimum(np.maximum(los, 0), max(tidx.size - E, 0))
            pos = los[:, None] + np.arange(E)[None, :]
            flat = tidx[np.minimum(pos, tidx.size - 1)].ravel()
            inb = (pos < tidx.size).ravel()
            host_tabs.append(_host_tab(flat, inb))
            Es.append(E)

    with span("viewshed_exact.upload"):
        dev_tabs = _upload(host_tabs, device)

    with span("viewshed_exact.eval"):
        ta = attrs_of(tperm)
        tgt = _targets(ta["a1"], ta["key"], ta["grad_t"], tperm, device)
        tier_tabs = [(tab, E) for tab, E in zip(dev_tabs[1:], Es)]
        tier_los = [(np.arange(A, dtype=np.int64) * E).astype(np.int32)
                    for E in Es]
        return _eval_buckets(tgt, dev_tabs[0], tier_tabs, tier_los, A, C)


def _targets(a1, key, grad_t, tperm, device):
    """The f64 target vectors of a bucket evaluation, on `device`."""
    def up(v):
        return torch.from_numpy(np.ascontiguousarray(v)).to(device)

    return {"a1": up(a1), "key": up(key), "grad_t": up(grad_t),
            "idx": up(tperm.astype(np.int64))}


def _run_buckets_f64(at, tperm, glob_idx, tiers, A, C, device):
    """The float64 bucket evaluation over `tperm` targets (flat bool,
    on the host)."""
    tgt = _targets(at["a1"][tperm], at["key"][tperm], at["grad_t"][tperm],
                   tperm, device)
    glob, tier_tabs, tier_los = _build_tables(at, glob_idx, tiers,
                                              _blocker_table, device)
    return _eval_buckets(tgt, glob, tier_tabs, tier_los, A, C)


def _eval_buckets(tgt, glob, tier_tabs, tier_los, A, C):
    """f64 bucket evaluation: each bucket's C targets against the global
    table and, per tier, two E-aligned blocks [j*E, (j+nb)*E) with
    j = clip(los // E, 0, nblk - nb), nb = min(2, nblk).  The aligned
    block pair always covers the planned window [lo, lo+E); candidates
    outside it cannot cover any bucket target, so they fail the cover
    test and contribute -inf.  Several buckets are evaluated per step
    (`_PAIRS_PER_STEP`); returns the (A*C,) visibility on the host."""
    dev = tgt["a1"].device
    xs = {f: tgt[f].reshape(A, C) for f in ("a1", "key", "idx", "grad_t")}
    windows = []
    for (tab, E), los in zip(tier_tabs, tier_los):
        nblk = tab["idx"].shape[0] // E
        nb = min(2, nblk)
        j = np.clip(los // E, 0, nblk - nb).astype(np.int64)
        windows.append((tab, E, nb, torch.from_numpy(j).to(dev)))
    widest = max([glob["idx"].shape[0]]
                 + [nb * E for _, E, nb, _ in windows])
    step = max(1, _PAIRS_PER_STEP // (C * widest))
    vis = torch.empty((A, C), dtype=torch.bool, device=dev)
    for a0 in range(0, A, step):
        a1 = min(a0 + step, A)
        al = xs["a1"][a0:a1, :, None]
        kt = xs["key"][a0:a1, :, None]
        it = xs["idx"][a0:a1, :, None]

        def run(c):
            return _interp_blocked_max(
                al, kt, it, c["key"], c["a0"], c["a1"], c["a2"], c["g0"],
                c["g1"], c["g2"], c["valid_b"], c["idx"])

        blocked = run({f: v[None, None] for f, v in glob.items()})
        for tab, E, nb, j in windows:
            pos = (j[a0:a1, None] * E
                   + torch.arange(nb * E, device=dev)[None, :])
            c = {f: v[pos][:, None] for f, v in tab.items()}
            blocked = torch.maximum(blocked, run(c))
        vis[a0:a1] = blocked <= xs["grad_t"][a0:a1]
    return vis.cpu().numpy().ravel()




# ---------------------------------------------------------------------------
# Device-expanded float32 interval screen
#
# The screen never touches f64 host planes: the host computes only f32
# elevation DIFFERENCE planes (f64 subtract then cast: the subtraction
# must happen in f64 or cancellation costs ~ulp(elev) absolute error),
# a separable f32 center-angle plane for sorting/windows, and the tier
# partition; everything else (corner angles, gradients, interpolation
# slopes, tolerance fields) is expanded on the device from 5 small
# uploaded fields per candidate (int32 idx, 3 diffs, shift flag).
#
# float32 error budget (the JAX package's constants, measured there on CPU
# and TPU backends; each >= 3x the measured maxima):
#   _E_ANG: |f32 angle - f64 angle| for a0/a1/a2/a1e and the target's
#           sort angle (arctan + quadrant assembly + 2pi unwrap).
#   _TAU_C: cover band; exceeds 2*_E_ANG so the widened test
#           (al > a0 - _TAU_C) captures every truly-covering pair and
#           the narrowed test only fires on truly-covering pairs.
#   _TAU_GR: RELATIVE gradient band (diff cast + f32 atan + divide).
#   _TAU_K: relative key band ((dx*ew)^2 + (dy*ns)^2 in f32).
#   _KA_S:  interpolation angle-error amplification: |gi - gi_true| <=
#           gband + span * KA / min(d10, d21) for in-span evaluation,
#           gband = _TG_ABS + _TAU_GR * max|g|.
#   _KA_W:  same plus linear EXTRAPOLATION across the tau_c cover band.
#   gi is clipped to [min3, max3] before the tolerance is applied, so
#   even degenerate segments (d -> 0) yield sound bounds.
# ---------------------------------------------------------------------------

_E_ANG = 2e-6
_TAU_C = np.float32(6e-6)      # cover band (> 2*_E_ANG + margin)
_TAU_K = np.float32(2e-6)      # relative key band
_KA_S = np.float32(8 * _E_ANG)
_KA_W = np.float32(8 * _E_ANG + 2 * 6e-6)
# gradient bands are RELATIVE to the gradient magnitude (plus a dust
# floor): every error source in g = atan(diff32 / dist32) is relative
_TAU_GR = np.float32(1.5e-6)   # relative gradient band
_TG_ABS = np.float32(1e-10)    # absolute dust floor for |g| ~ 0

# tolerance sets for the two screen levels
# (tau_c, ka_s, ka_w, tau_gr, tg_abs, tau_k).  Level 2 re-screens
# level-1-ambiguous targets in device float64 (exact f64 diffs; angles
# and gradients from exact integer coordinates), where the only
# deviations from the host-numpy f64 attributes are libm ulps, so
# 1e-12-scale bands classify everything except true f64-epsilon ties,
# which fall through to the host-f64 oracle evaluation.
_TAUS_F32 = (float(_TAU_C), float(_KA_S), float(_KA_W),
             float(_TAU_GR), float(_TG_ABS), float(_TAU_K))
_TAUS_F64 = (1e-12, 8e-12, 1e-11, 1e-12, 1e-30, 1e-12)

# Routing thresholds.  Every route gives the same bits, so they decide
# time only.  They start at the JAX package's values; re-deriving them
# from H100 times is later work (ROADMAP A11).
# below this many level-1-ambiguous targets the f64 re-screen MAY be
# skipped in favour of the gathered f64 oracle
_L2_MIN_AMB = 2048
# gathered-oracle volume ceiling (elements = A * sum(E)); above it the
# level-2 re-screen runs
_DIRECT_MAX_ELEMS = 1 << 19
# level-2 re-screen slab size (targets per slab, angle-ordered)
_L2_SLAB = 8192
# safety valve: above max(_VALVE_FRAC * n, _VALVE_MIN_AMB) ambiguous
# targets the screen failed to separate (flat/ramp degeneracies) and
# every target is re-evaluated in f64
_VALVE_FRAC = 0.05
_VALVE_MIN_AMB = 4096


def _angle_plane32(h, w, vp_row, vp_col):
    """Separable f32 center-angle plane: |dr| x (1/|dc|) outer product
    through one arctan pass, quadrant-assembled with the same slab
    rectangles as _calculate_angle_np.  Only used as a sort key / window
    coordinate: any value within _E_ANG of the true f64 angle is sound
    (windows are widened by _W_EPS >= 2*_E_ANG)."""
    dr = np.abs(np.arange(h, dtype=np.float32) - np.float32(vp_row))
    adc = np.abs(np.arange(w, dtype=np.float32) - np.float32(vp_col))
    rec = np.where(adc == 0.0, np.float32(1.0), adc)
    rec = (np.float32(1.0) / rec).astype(np.float32)
    ang = np.arctan(dr[:, None] * rec[None, :])
    out = np.zeros((h, w), dtype=np.float32)
    r, c = _np_rects(h, w, vp_row, vp_col)
    pi = np.float32(np.pi)
    out[r[0], c[2]] = ang[r[0], c[2]]
    out[r[0], c[0]] = pi - ang[r[0], c[0]]
    out[r[2], c[0]] = pi + ang[r[2], c[0]]
    out[r[2], c[2]] = np.float32(2.0 * np.pi) - ang[r[2], c[2]]
    out[r[0], c[1]] = np.float32(np.pi / 2.0)
    out[r[2], c[1]] = np.float32(3.0 * np.pi / 2.0)
    out[r[1], c[2]] = 0.0
    out[r[1], c[0]] = pi
    out[r[1], c[1]] = 0.0
    return out


def _screen_cache(data_np, vp_row, vp_col, observer_elev, target_elev,
                  ew_res, ns_res):
    """Host half of the screen: f32 difference planes, f32 angle plane,
    tier partition (ONE global argsort + a stable tier re-sort), and
    crossing-cell duplication.

    Crossing cells (spans wrapping through angle 0) are exactly the east
    ray (row == vp_row, col > vp_col).  Each appears twice in its tier
    table: at its center angle 0 covering [a0 - 2pi, a2], and as a +2pi
    copy (sort key 2pi) covering [a0, a2 + 2pi]; both interpolate
    identically to the f64 predicate's unwrap, so no bucket needs
    crossing-aware logic."""
    h, w = data_np.shape
    vp_elev = data_np[vp_row, vp_col] + observer_elev
    d2 = data_np - vp_elev
    # corner diffs are averaged on the DIFF plane (association differs
    # from avg-then-subtract by f64 ulps, far inside both screen levels'
    # bands; the host-f64 oracle keeps its own exact attrs)
    pad = np.pad(d2, 1, constant_values=np.nan)
    d_e64 = _corner_diffs_np(d2, vp_row, vp_col, pad=pad)
    d_x64 = _corner_diffs_np(d2, vp_row, vp_col, enter=False, pad=pad)
    del pad
    d_c64 = d2.ravel()
    d_e64 = d_e64.ravel()
    d_x64 = d_x64.ravel()
    d_c = d_c64.astype(np.float32)
    d_e = d_e64.astype(np.float32)
    d_x = d_x64.astype(np.float32)
    if target_elev == 0.0:
        d_t64 = d_c64
        d_t = d_c
    else:
        d_t64 = d_c64 + target_elev
        d_t = d_t64.astype(np.float32)
    a1 = _angle_plane32(h, w, vp_row, vp_col).ravel()

    dr = np.arange(h, dtype=np.float32) - np.float32(vp_row)
    dc = np.arange(w, dtype=np.float32) - np.float32(vp_col)
    rho2 = (np.abs(dr)[:, None] ** 2 + np.abs(dc)[None, :] ** 2).ravel()
    tid = np.zeros(rho2.size, dtype=np.int8)
    for b in _TIER_BOUNDS:
        tid += rho2 > np.float32(b) ** 2
    order = np.argsort(a1, kind="stable")
    ord2 = order[np.argsort(tid[order], kind="stable")]
    counts = np.bincount(tid, minlength=len(_TIER_BOUNDS) + 1)
    two_pi = np.float32(2.0 * np.pi)
    # the crossing (east-ray) cells are one contiguous flat-index range
    ray_lo = vp_row * w + vp_col
    ray_hi = vp_row * w + w

    def extend(idx_sorted):
        cross = (idx_sorted > ray_lo) & (idx_sorted < ray_hi)
        cidx = idx_sorted[cross]
        ext = np.concatenate([idx_sorted, cidx])
        keys = np.concatenate([a1[idx_sorted],
                               np.full(cidx.size, two_pi, np.float32)])
        shifted = np.zeros(ext.size, dtype=bool)
        shifted[idx_sorted.size:] = True
        return ext.astype(np.int64), keys, shifted

    glob_idx, _, glob_shift = extend(ord2[:counts[0]])
    off = int(counts[0])
    tiers = []
    for t in range(1, counts.size):
        cnt = int(counts[t])
        if cnt == 0:
            continue
        tidx = ord2[off:off + cnt]
        off += cnt
        W = asin(min(1.0, 0.7071067811865476 / _TIER_BOUNDS[t - 1])) \
            + _W_EPS
        tiers.append(extend(tidx) + (W,))
    return dict(a1=a1, d_c=d_c, d_e=d_e, d_x=d_x, d_t=d_t,
                d_c64=d_c64, d_e64=d_e64, d_x64=d_x64, d_t64=d_t64,
                glob=(glob_idx, glob_shift), tiers=tiers, order=order,
                vp_elev=vp_elev, shape=(h, w))


def _screen_build_tables(sc, glob_idx, glob_shift, tiers, tier_shifts,
                         f64=False):
    """[glob, tier...] screen-input tables, on the host: per candidate
    only int32 idx, the 3 elevation diffs, and the crossing-copy flag;
    the 13 derived predicate fields are expanded on the device
    (_expand_table).  ``f64`` selects the exact f64 diff planes for the
    level-2 re-screen.  Returns (host tables, offsets, metas)."""
    ft = np.float64 if f64 else np.float32
    s = "64" if f64 else ""

    def tab(idx, shifted, L):
        m = idx.size
        out = {
            "idx": np.full(L, -1, np.int32),
            "sh": np.zeros(L, dtype=bool),
            "dc": np.zeros(L, ft),
            "de": np.zeros(L, ft),
            "dx": np.zeros(L, ft),
        }
        out["idx"][:m] = idx
        out["sh"][:m] = shifted
        out["dc"][:m] = sc["d_c" + s][idx]
        out["de"][:m] = sc["d_e" + s][idx]
        out["dx"][:m] = sc["d_x" + s][idx]
        return out

    # 256-entry glob quantum (pow2 above 1024): every target is held
    # against the whole padded glob table, so its pad is pure pair work
    gsz = glob_idx.size
    gL = (_round_up(gsz, 256) if gsz <= 1024
          else 1 << (gsz - 1).bit_length())
    host = [tab(glob_idx, glob_shift, gL)]
    metas = []
    for (tidx, los, E), shifted in zip(tiers, tier_shifts):
        # L divides into whole E-blocks for the grouped window reads
        # (_group_plan); E is a power of two <= the pad quantum
        L = _round_up(max(E, _round_up(tidx.size, 16384)), E)
        host.append(tab(tidx, shifted, L))
        metas.append((np.minimum(np.maximum(los, 0),
                                 L - E).astype(np.int32), E))
    offs = tuple(int(o) for o in
                 np.cumsum([0] + [t["idx"].size for t in host]))
    packed = {f: np.concatenate([t[f] for t in host]) for f in host[0]}
    return packed, offs, metas


def _expand_table(tab, w, vp_row, vp_col, ew, ns, taus=_TAUS_F32):
    """Per-candidate derived fields computed on the device from
    (idx, diffs, shift): corner angles via the shared quadrant table,
    gradients, unwrapped span/node, interpolation slopes, [min3, max3]
    clip range, and the sure/maybe tolerance fields.  Validity (pad
    entries, NaN elevation, the viewpoint itself) is folded into the
    cover bounds (a0w/a0n = +inf kills both tests).

    The working dtype follows the diff fields: f32 for screen level 1,
    f64 (exact diffs) for the level-2 re-screen; ``taus`` supplies the
    matching tolerance set.  Every constant is a tensor of that dtype,
    as the JAX package's are."""
    dt = tab["dc"].dtype
    dev = tab["dc"].device

    def const(v):
        return torch.tensor(v, dtype=dt, device=dev)

    tau_c, ka_s, ka_w, tau_gr, tg_abs, _ = (const(t) for t in taus)
    ew = const(ew)
    ns = const(ns)
    idx = tab["idx"]
    safe = torch.clamp(idx, min=0)
    row = safe // w
    col = safe - row * w
    dy = (row - vp_row).to(dt)
    dx = (col - vp_col).to(dt)
    e_dy, e_dx, x_dy, x_dx = (o.to(dt) for o in
                              _corner_offsets(row, col, vp_row, vp_col,
                                              xp=torch))
    ey0 = dy + e_dy
    ex0 = dx + e_dx
    ey2 = dy + x_dy
    ex2 = dx + x_dx
    a0 = _calculate_angle(ex0, ey0, 0.0, 0.0, xp=torch)
    a1 = _calculate_angle(dx, dy, 0.0, 0.0, xp=torch)
    a2 = _calculate_angle(ex2, ey2, 0.0, 0.0, xp=torch)

    def grad(d, py, px):
        d2 = (px * ew) ** 2 + (py * ns) ** 2
        return torch.arctan(d / torch.sqrt(torch.where(d2 == 0, 1.0, d2)))

    g0 = grad(tab["de"], ey0, ex0)
    g1 = grad(tab["dc"], dy, dx)
    g2 = grad(tab["dx"], ey2, ex2)
    key = (dx * ew) ** 2 + (dy * ns) ** 2

    two_pi = const(2.0 * PI)
    zero = const(0.0)
    crossing = (dy == 0.0) & (dx > 0.0)
    sh = tab["sh"]
    a0u = a0 - torch.where(crossing & ~sh, two_pi, zero)
    shift2 = torch.where(crossing & sh, two_pi, zero)
    a2u = a2 + shift2
    a1e = a1 + shift2
    d10 = a1e - a0u
    d21 = a2u - a1e
    tiny = const(1e-12 if dt == torch.float32 else 1e-200)
    s01 = (g0 - g1) / torch.maximum(d10, tiny)
    s21 = (g2 - g1) / torch.maximum(d21, tiny)
    mx = torch.maximum(g0, torch.maximum(g1, g2))
    mn = torch.minimum(g0, torch.minimum(g1, g2))
    span = mx - mn
    dmin = torch.maximum(torch.minimum(d10, d21), tiny)
    one = const(1.0)
    gband = tg_abs + tau_gr * torch.maximum(torch.abs(mn), torch.abs(mx))
    tol_s = gband + span * torch.minimum(one, ka_s / dmin)
    tol_w = gband + span * torch.minimum(one, ka_w / dmin)

    valid = ((idx >= 0) & torch.isfinite(tab["dc"])
             & ((row != vp_row) | (col != vp_col)))
    inf = const(torch.inf)
    a0w = torch.where(valid, a0u - tau_c, inf)
    a0n = torch.where(valid, a0u + tau_c, inf)
    return dict(a0w=a0w, a0n=a0n, a2w=a2u + tau_c, a2n=a2u - tau_c,
                a1e=a1e, g1=g1, s01=s01, s21=s21, mn=mn, mx=mx,
                ts=tol_s, tw=tol_w, key=key, idx=idx)


def _expand_stack(tab, w, vp_row, vp_col, ew, ns, E=None,
                  taus=_TAUS_F32):
    """Expand one candidate table and stack the 13 predicate fields.

    ``E=None`` (the global table) returns ((13, L), (L,) idx).  With a
    tier block length E the fields come back BLOCK-LEADING as
    ((L/E, 13, E), (L/E, E) idx): a group window is then a run of whole
    blocks, contiguous in memory."""
    ex = _expand_table(tab, w, vp_row, vp_col, ew, ns, taus)
    if E is None:
        return torch.stack([ex[f] for f in _F13]), ex["idx"]
    nblk = ex["idx"].shape[0] // E
    stk = torch.stack([ex[f].reshape(nblk, E) for f in _F13], dim=1)
    return stk, ex["idx"].reshape(nblk, E)


# per-group target count for the screen evaluation: B buckets of C
# targets are evaluated against one shared contiguous window per tier.
# Larger groups widen every tier window by ~B*C extra candidates (the
# group spans a wider angle range).
_GROUP_TARGETS = 4096


def _group_plan(metas, A, C):
    """Host grouping of the A angle-sorted buckets into G = A/B groups
    that share one CONTIGUOUS block-quantized candidate window per tier.

    Soundness of the window superset: extra candidates beyond a bucket's
    exact slice either fail the cover test (the plan guarantees every
    candidate that can cover a bucket's targets is in that bucket's
    slice) or are genuine covering pairs, which the predicate's max
    treats identically (supersets are idempotent for hi; for lo they only
    add TRUE pairs, keeping lo <= the true blocked max).

    Returns (B, rows, NBs): rows[t] is the (G,) int32 first-block
    index per group, NBs[t] the pow2-quantized per-group block count.
    The screen caps NB at the tier's total block count and clamps the
    start so every window is a valid in-table slice."""
    B = 1
    while B * 2 * C <= _GROUP_TARGETS and A % (B * 2) == 0:
        B *= 2
    G = A // B
    rows, NBs = [], []
    for los, E in metas:
        lo2 = los.reshape(G, B)
        rmin = lo2.min(axis=1) // E
        rmax = (lo2.max(axis=1) + E - 1) // E + 1
        nb = int((rmax - rmin).max()) if A else 2
        nb = 1 << (max(nb, 2) - 1).bit_length()
        rows.append(rmin.astype(np.int32))
        NBs.append(nb)
    return B, tuple(rows), tuple(NBs)


def _screen_hilo(glob, stacks, al, klo, khi, it, rows, A, C, Es, NBs, B):
    """The pair evaluation, by the device of the targets: the torch twin
    for a tensor on the CPU, the CUDA kernel for any other (its wrapper
    raises on a tensor that is not on the card)."""
    if al.device.type == "cpu":
        return _screen.screen_hilo(glob, stacks, al, klo, khi, it, rows, A,
                                   C, Es, NBs, B)
    from .cuda_screen import screen_hilo_cuda
    return screen_hilo_cuda(glob, stacks, al, klo, khi, it, rows, A, C, Es,
                            NBs, B)


def _screen_stacks(packed, offs, Es, w, vp_row, vp_col, ew, ns, taus,
                   device):
    """One upload of the packed screen tables to `device`, carved into the
    [glob, tier...] tables, each expanded: (glob stack, tier stacks)."""
    tabs = _carve({f: torch.from_numpy(v).to(device)
                   for f, v in packed.items()}, offs)
    stacks = tuple(_expand_stack(t, w, vp_row, vp_col, ew, ns,
                                 E if i else None, taus)
                   for i, (t, E) in enumerate(zip(tabs, (0,) + Es)))
    return stacks[0], stacks[1:]


def _screen_args(glob, stacks, tperm, a1_t, d_t, rows, A, C, Es, NBs, B,
                 w, vp_row, vp_col, ew, ns, taus, device):
    """The pair evaluation's arguments for the targets `tperm` (bucket
    order) on `device`, in the dtype of `d_t`, and the targets' own
    gradients.  ``a1_t`` None (level 2, float64) computes the target
    angles from the exact integer coordinates: the f32 host plane is far
    outside the 1e-12 cover band."""
    d = torch.from_numpy(np.ascontiguousarray(d_t)).to(device)
    dt = d.dtype

    def const(v):
        return torch.tensor(v, dtype=dt, device=device)

    it = torch.from_numpy(tperm.astype(np.int32)).to(device)
    row = it // w
    col = it - row * w
    dy = (row - vp_row).to(dt)
    dx = (col - vp_col).to(dt)
    if a1_t is None:
        al = _calculate_angle(dx, dy, 0.0, 0.0, xp=torch)
    else:
        al = torch.from_numpy(np.ascontiguousarray(a1_t)).to(device)
    key_t = (dx * const(ew)) ** 2 + (dy * const(ns)) ** 2
    one = const(1.0)
    gt = torch.arctan(d / torch.sqrt(torch.where(key_t == 0, one, key_t)))
    tau_k = const(taus[5])
    rows_t = torch.from_numpy(
        np.stack(rows, axis=1) if rows
        else np.zeros((A // B, 0), np.int32)).to(device)
    return (glob, stacks, al, key_t * (one - tau_k), key_t * (one + tau_k),
            it, rows_t, A, C, Es, NBs, B), gt


def _screen_classify(glob, stacks, tperm, a1_t, d_t, rows, A, C, Es, NBs,
                     B, w, vp_row, vp_col, ew, ns, taus, device):
    """Screen the targets `tperm` (bucket order) against expanded tables:
    per-target (visible, ambiguous) bits on the host.  A target is
    visible when even the upper bound of its blocked gradient lies below
    its own gradient band, blocked when the lower bound lies above it,
    and ambiguous otherwise; NaN targets fail both comparisons, and the
    viewpoint target (whose device gradient is wrong at distance 0) is
    forced ambiguous."""
    args, gt = _screen_args(glob, stacks, tperm, a1_t, d_t, rows, A, C, Es,
                            NBs, B, w, vp_row, vp_col, ew, ns, taus, device)
    hi, lo = _screen_hilo(*args)
    dt = gt.dtype
    tcls = (torch.tensor(taus[4], dtype=dt, device=device)
            + torch.tensor(taus[3], dtype=dt, device=device)
            * torch.abs(gt))
    vis = hi <= gt - tcls
    blk = lo > gt + tcls
    amb = (~(vis | blk)).cpu().numpy() | (tperm == vp_row * w + vp_col)
    return vis.cpu().numpy(), amb


def _plan_cache(sc):
    """The screen cache's global set and tiers in `_bucket_plan`'s form."""
    return (sc["glob"][0],
            [(ext, keys, W) for ext, keys, _, W in sc["tiers"]])


def _level1(sc, vp_row, vp_col, ew, ns, chunk, device):
    """Level-1 plan, tables and expanded stacks (float32, every target).
    Returns (screen arguments, the plan)."""
    h, w = sc["shape"]
    at32 = {"a1": sc["a1"]}
    tperm, glob_idx, tiers, A, C = _bucket_plan(at32, vp_row, vp_col, chunk,
                                                cache=_plan_cache(sc),
                                                dense_order=sc["order"])
    tier_shifts = [sh for _, _, sh, _ in sc["tiers"]]
    packed, offs, metas = _screen_build_tables(sc, glob_idx, sc["glob"][1],
                                               tiers, tier_shifts)
    Es = tuple(E for _, E in metas)
    B, rows, NBs = _group_plan(metas, A, C)
    glob, stacks = _screen_stacks(packed, offs, Es, w, vp_row, vp_col, ew,
                                  ns, _TAUS_F32, device)
    args = (glob, stacks, tperm, sc["a1"][tperm], sc["d_t"][tperm], rows, A,
            C, Es, NBs, B, w, vp_row, vp_col, ew, ns, _TAUS_F32, device)
    return args, (tperm, glob_idx, tiers, A, C)


def _level2_plans(sc, targets, vp_row, vp_col, chunk):
    """Angle-ordered slabs of at most `_L2_SLAB` of the `targets`, each
    with its sparse bucket plan; window widths unified across tiers and
    slabs, so that one table build serves every slab.  Returns
    (plans, E_all)."""
    order = np.argsort(sc["a1"][targets], kind="stable")
    srt = targets[order]
    plans = []
    for s in range(0, srt.size, _L2_SLAB):
        sl = srt[s:s + _L2_SLAB]
        L = 1 << (max(int(sl.size), 128) - 1).bit_length()
        sub = np.pad(sl, (0, L - sl.size), mode="edge")
        plans.append(_bucket_plan({"a1": sc["a1"]}, vp_row, vp_col,
                                  min(chunk, 128), targets=sub,
                                  cache=_plan_cache(sc), unify_E=True))
    E_all = max(E for _, _, tiers, _, _ in plans for _, _, E in tiers)
    return plans, E_all


def _level2_tables(sc, plans, E_all, vp_row, vp_col, ew, ns, device):
    """One float64 table build and upload for every level-2 slab, and
    each slab's screen arguments."""
    h, w = sc["shape"]
    tier_shifts = [sh for _, _, sh, _ in sc["tiers"]]
    tperm0, glob_i, tiers0, _, _ = plans[0]
    packed, offs, _ = _screen_build_tables(
        sc, glob_i, sc["glob"][1], [(t, los, E_all) for t, los, _ in tiers0],
        tier_shifts, f64=True)
    Es = (E_all,) * len(tiers0)
    glob, stacks = _screen_stacks(packed, offs, Es, w, vp_row, vp_col, ew,
                                  ns, _TAUS_F64, device)
    lens = [offs[i + 1] - offs[i] for i in range(1, len(offs) - 1)]
    for tperm, _, tiers, A, C in plans:
        # the tables are slab-independent: only the window starts change
        metas = [(np.minimum(np.maximum(los, 0), L - E_all).astype(np.int32),
                  E_all) for (_, los, _), L in zip(tiers, lens)]
        B, rows, NBs = _group_plan(metas, A, C)
        yield (glob, stacks, tperm, None, sc["d_t64"][tperm], rows, A, C, Es,
               NBs, B, w, vp_row, vp_col, ew, ns, _TAUS_F64, device)


def screen_inputs(data, vp_row, vp_col, observer_elev, target_elev, ew_res,
                  ns_res, level=1, chunk=512, stride=7, device="cpu"):
    """The pair evaluation's inputs as the exact path builds them, for
    checks of the kernel against its twin: level 1 screens every target
    in float32; level 2 re-screens, in float64, every `stride`-th cell as
    one slab.  Returns the arguments of `screen.screen_hilo`."""
    data_np = np.asarray(data, dtype=np.float64)
    sc = _screen_cache(data_np, vp_row, vp_col, observer_elev, target_elev,
                       ew_res, ns_res)
    if level == 1:
        args, _ = _level1(sc, vp_row, vp_col, ew_res, ns_res, chunk, device)
    else:
        targets = np.arange(0, data_np.size, stride, dtype=np.int64)
        plans, E_all = _level2_plans(sc, targets, vp_row, vp_col, chunk)
        args = next(_level2_tables(sc, plans[:1], E_all, vp_row, vp_col,
                                   ew_res, ns_res, device))
    return _screen_args(*args)[0]


def _screened_visibility(data_np, vp_row, vp_col, observer_elev,
                         target_elev, ew_res, ns_res, chunk, device):
    """Interval-screened exact visibility.  The float32 level-1 screen
    computes per target a SOUND [blocked_lo, blocked_hi] interval for the
    max blocker gradient; targets whose interval straddles their own
    gradient band (plus every NaN, plus the viewpoint) are re-evaluated:
    - above max(5% of the cells, 4096) of them (the safety valve: flat or
      ramp degeneracies), every target in float64 over full planes;
    - at most `_L2_MIN_AMB` of them with a gathered plan of at most
      `_DIRECT_MAX_ELEMS` elements, by the float64 predicate over
      host-gathered candidate slices;
    - else by the float64 level-2 re-screen in slabs of `_L2_SLAB`
      targets, whose own ambiguous targets (true float64 ties) go to the
      float64 predicate, gathered or over full tables by volume.
    Bit-identical to the f64-only path: the screens only CLASSIFY, with
    tolerances that dominate every rounding error.  `LAST_CALL` records
    the ambiguous counts and the route."""
    h, w = data_np.shape
    n = h * w
    LAST_CALL.clear()
    with span("viewshed_exact.cache"):
        sc = _screen_cache(data_np, vp_row, vp_col, observer_elev,
                           target_elev, ew_res, ns_res)
    with span("viewshed_exact.plan"):
        args, (tperm, glob_idx, tiers, A, C) = _level1(
            sc, vp_row, vp_col, ew_res, ns_res, chunk, device)
    with span("viewshed_exact.screen"):
        vis, amb = _screen_classify(*args)
        del args

    visible = np.empty(n, dtype=bool)
    visible[tperm] = vis
    amb_idx = np.unique(tperm[amb])
    LAST_CALL.update(amb1=int(amb_idx.size), amb2=0, slabs=0,
                     route="none")
    if not amb_idx.size:
        return visible
    with span("viewshed_exact.reeval"):
        if amb_idx.size > max(_VALVE_FRAC * n, _VALVE_MIN_AMB):
            # safety valve: run full f64 over the same (extended) candidate
            # tables; duplicates evaluate identically
            with span("viewshed_exact.f64"):
                at = cell_attrs_host(data_np, vp_row, vp_col, observer_elev,
                                     target_elev, ew_res, ns_res)
                visible[tperm] = _run_buckets_f64(at, tperm, glob_idx,
                                                  tiers, A, C, device)
            LAST_CALL["route"] = "valve"
            return visible
        at32 = {"a1": sc["a1"]}
        if amb_idx.size <= _L2_MIN_AMB:
            # small ambiguous sets skip the level-2 re-screen when the
            # gathered oracle's data volume is small
            with span("viewshed_exact.reeval_plan"):
                L = 1 << (max(int(amb_idx.size), 128) - 1).bit_length()
                sub = np.pad(amb_idx, (0, L - amb_idx.size), mode="edge")
                tperm_a, glob_a, tiers_a, A_a, C_a = _bucket_plan(
                    at32, vp_row, vp_col, min(chunk, 128), targets=sub,
                    cache=_plan_cache(sc))
                gath_elems = sum(A_a * E for _, _, E in tiers_a)
            if gath_elems <= _DIRECT_MAX_ELEMS:
                with span("viewshed_exact.f64"):
                    attrs_of = cell_attrs_subset_fn(
                        data_np, vp_row, vp_col, observer_elev, target_elev,
                        ew_res, ns_res)
                    visible[tperm_a] = _run_buckets_f64_gathered(
                        attrs_of, tperm_a, glob_a, tiers_a, A_a, C_a, device)
                LAST_CALL["route"] = "gathered"
                return visible
        # level 2: re-screen the ambiguous subset in device float64
        with span("viewshed_exact.reeval_plan"):
            plans, E_all = _level2_plans(sc, amb_idx, vp_row, vp_col, chunk)
        with span("viewshed_exact.screen2"):
            amb2_parts = []
            for args in _level2_tables(sc, plans, E_all, vp_row, vp_col,
                                       ew_res, ns_res, device):
                vis2, amb2 = _screen_classify(*args)
                tperm_s = args[2]
                visible[tperm_s] = vis2
                amb2_parts.append(tperm_s[amb2])
        amb2_idx = np.unique(np.concatenate(amb2_parts))
        LAST_CALL.update(route="l2", slabs=len(plans),
                         amb2=int(amb2_idx.size))
        if not amb2_idx.size:
            return visible
        with span("viewshed_exact.reeval_plan"):
            L2 = 1 << (max(int(amb2_idx.size), 128) - 1).bit_length()
            sub2 = np.pad(amb2_idx, (0, L2 - amb2_idx.size), mode="edge")
            tperm_b, glob_b, tiers_b, A_b, C_b = _bucket_plan(
                at32, vp_row, vp_col, min(chunk, 128), targets=sub2,
                cache=_plan_cache(sc))
        # route by data volume: the gathered path moves A*sum(E) elements,
        # the table path the full padded tiers (~n) and needs the full f64
        # planes; both evaluate identical candidate supersets with the
        # identical f64 predicate
        gath_elems = sum(A_b * E for _, _, E in tiers_b)
        tab_elems = sum(max(E, _round_up(tidx.size, 16384))
                        for tidx, _, E in tiers_b)
        with span("viewshed_exact.f64"):
            if gath_elems < tab_elems:
                attrs_of = cell_attrs_subset_fn(data_np, vp_row, vp_col,
                                                observer_elev, target_elev,
                                                ew_res, ns_res)
                visible[tperm_b] = _run_buckets_f64_gathered(
                    attrs_of, tperm_b, glob_b, tiers_b, A_b, C_b, device)
                LAST_CALL["route"] = "l2+gathered"
            else:
                at = cell_attrs_host(data_np, vp_row, vp_col, observer_elev,
                                     target_elev, ew_res, ns_res)
                visible[tperm_b] = _run_buckets_f64(at, tperm_b, glob_b,
                                                    tiers_b, A_b, C_b, device)
                LAST_CALL["route"] = "l2+tables"
    return visible
