"""Torch emulations of two CUDA kernels' algorithms, for the CPU tests.

A CUDA kernel cannot run without a card, so the tests hold these
emulations, written with the kernels' own window, index arithmetic and
loop order, to the kernels' plain versions bit for bit:

- ``emulate_staged``: ``csrc/focal_halo.cu::focal_halo_staged_kernel``
  (B2's and B5's staged template), against ``window.window_stats``;
- ``blocks_of`` and ``emulate_culled``: ``csrc/screen.cu::
  screen_culled_kernel`` (B7's culled route), against
  ``screen.screen_hilo``; ``blocks_of`` also gives the (warp, chunk)
  pairs the kernel keeps, which the card's tests hold its counters to.

Nothing in the package calls them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import focal_halo as fh
from . import screen as TS

__all__ = ["emulate_staged", "halo_case", "same_bits", "SCREEN_R",
           "SCREEN_WARP", "SCREEN_BLOCK", "group_segments", "blocks_of",
           "emulate_culled"]


# -- the staged focal template ------------------------------------------------

def emulate_staged(x, offsets):
    """The staged kernel's statistics of the 2D float32 CPU tensor `x`
    (dict by stat), and each tile's NaN-free flag: each tile's window with
    its NaN fill, the run table's addresses, four cells along x a lane,
    offsets order in every cell, and the NaN-free branch that takes the
    count from the number of offsets."""
    h, w = x.shape
    plan = fh.halo_plan(h, w, offsets)
    if plan.route == "ring":
        raise ValueError("the ring route is not the staged kernel")
    th, tw = plan.tile
    ry = max(abs(dy) for dy, _ in offsets)
    ty, tx = -(-h // th), -(-w // tw)
    # window (i, k) of the tile at (r0, c0) is raster (r0 - ry + i,
    # c0 - pad + k), NaN outside it: the TMA map's fill
    big = F.pad(x, (plan.pad, tx * tw + plan.pitch, ry, ty * th + plan.rows),
                value=math.nan)
    wins = torch.stack([big[a * th:a * th + plan.rows,
                            b * tw:b * tw + plan.pitch].reshape(-1)
                        for a in range(ty) for b in range(tx)])
    nan_free = ~torch.isnan(wins).any(dim=1)
    # lane l's cell j at tile row tr starts at window float tr*pitch + 4l + j
    tr = torch.arange(th)[:, None, None]
    lane = torch.arange(32)[None, :, None]
    cell = torch.arange(fh.CELLS)[None, None, :]
    base = tr * plan.pitch + 4 * lane + cell
    shape = (wins.shape[0], th, 32, fh.CELLS)

    def values():
        """Each offset's value for every cell, in the kernel's order."""
        for quad, code in fh.run_table(offsets, plan):
            for m in range(code >> 2):
                idx = base + 4 * quad + (code & 3) + m
                yield wins[:, idx.reshape(-1)].reshape(shape)

    cnt, ssum = torch.zeros(shape), torch.zeros(shape)
    smin, smax = torch.full(shape, math.inf), torch.full(shape, -math.inf)
    for s in values():
        ok = ~torch.isnan(s)
        cnt = cnt + ok
        ssum = torch.where(ok, ssum + s, ssum)
        smin = torch.where(ok & (s < smin), s, smin)
        smax = torch.where(ok & (s > smax), s, smax)
    # the NaN-free branch: the count is the number of offsets
    cnt = torch.where(nan_free[:, None, None, None], float(len(offsets)), cnt)
    mean = torch.where(cnt > 0, ssum / torch.clamp(cnt, min=1.0), math.nan)
    dev2 = torch.zeros(shape)
    for s in values():
        dv = s - mean
        dev2 = torch.where(torch.isnan(s), dev2, dev2 + dv * dv)
    smin = torch.where(torch.isinf(smin), math.nan, smin)
    smax = torch.where(torch.isinf(smax), math.nan, smax)
    var = torch.where(cnt > 0, dev2 / torch.clamp(cnt, min=1.0), math.nan)
    planes = {"mean": mean, "sum": ssum, "min": smin, "max": smax,
              "range": smax - smin, "var": var, "std": torch.sqrt(var)}

    def raster(t):                                # (tiles, th, 32, 4)
        t = t.reshape(ty, tx, th, tw).permute(0, 2, 1, 3)
        return t.reshape(ty * th, tx * tw)[:h, :w]

    return {k: raster(v) for k, v in planes.items()}, nan_free


def halo_case(shape, seed):
    """A float32 CPU raster of `shape` made from `seed`, with a NaN block
    and +-inf cells."""
    rng = np.random.default_rng(seed)
    data = (rng.random(shape) * 50).astype(np.float32)
    h, w = shape
    data[h // 8:h // 8 + 3, w // 5:w // 5 + 9] = np.nan
    data[h - 1, w - 1] = np.inf
    data[0, w // 2] = -np.inf
    data[h // 9, 3] = np.inf
    return torch.from_numpy(data)


def same_bits(got, ref):
    """Equal values, NaN where NaN and the same infinities."""
    return (torch.equal(torch.isnan(got), torch.isnan(ref))
            and torch.equal(torch.nan_to_num(got, 0.0, 1.0, -1.0),
                            torch.nan_to_num(ref, 0.0, 1.0, -1.0))
            and torch.equal(torch.isinf(got), torch.isinf(ref)))


# -- the interval screen's culled route ----------------------------------------

SCREEN_R = 4                      # targets a thread (screen.cu kR)
SCREEN_WARP = 32 * SCREEN_R       # targets a warp
SCREEN_BLOCK = 4 * SCREEN_WARP    # targets a block: 128 threads
_F = {k: i for i, k in enumerate(TS.F13)}


def group_segments(args, bounds, g):
    """Group g's candidates as the kernel walks them: the global table,
    then each tier's window; (fields (13, L), idx (L,), bounds (L/128,
    2)).  `args` are ``screen.screen_hilo``'s, on the CPU."""
    glob, stacks, *_, rows, A, C, Es, NBs, B = args
    nglob = glob[1].shape[0] // TS.CHUNK
    fields, idx, bnd = [glob[0]], [glob[1]], [bounds[:nglob]]
    off = nglob
    for t, ((stk, ix), E, NB) in enumerate(zip(stacks, Es, NBs)):
        nblk = ix.shape[0]
        nb = min(NB, nblk)
        r = max(0, min(int(rows[g, t]), nblk - nb))
        fields.append(stk[r:r + nb].transpose(0, 1).reshape(len(TS.F13), -1))
        idx.append(ix[r:r + nb].reshape(-1))
        per = E // TS.CHUNK
        bnd.append(bounds[off + r * per:off + (r + nb) * per])
        off += nblk * per
    return torch.cat(fields, dim=1), torch.cat(idx), torch.cat(bnd)


def blocks_of(args):
    """Each block of the culled kernel: (group, flat target slice, the
    target angles padded with NaN to SCREEN_BLOCK, kept (warp, chunk) mask,
    the group's fields and idx)."""
    glob, stacks, al, klo, khi, it, rows, A, C, Es, NBs, B = args
    G, T = A // B, B * C
    bounds = TS.chunk_bounds(glob, stacks).reshape(-1, 2)
    for g in range(G):
        fields, idx, bnd = group_segments(args, bounds, g)
        lo, hi = bnd[:, 0], bnd[:, 1]
        for b0 in range(0, T, SCREEN_BLOCK):
            sl = slice(g * T + b0, g * T + min(b0 + SCREEN_BLOCK, T))
            a = torch.full((SCREEN_BLOCK,), torch.nan, dtype=al.dtype)
            a[:sl.stop - sl.start] = al[sl]
            warps = a.reshape(-1, SCREEN_WARP)
            ok = ~torch.isnan(warps)
            inf = torch.tensor(torch.inf, dtype=al.dtype)
            wmin = torch.where(ok, warps, inf).amin(dim=1)
            wmax = torch.where(ok, warps, -inf).amax(dim=1)
            bmin, bmax = wmin.min(), wmax.max()
            block_keep = ~((bmax <= lo) | (bmin >= hi))
            kept = block_keep[None] & ~((wmax[:, None] <= lo[None])
                                        | (wmin[:, None] >= hi[None]))
            yield g, sl, a, kept, fields, idx


def emulate_culled(args):
    """The culled kernel's (hi, lo), written with its loop order: each warp
    of each block evaluates its 128 targets against the candidates of the
    chunks it keeps, the wide cover and kt_hi first."""
    glob, stacks, al, klo, khi, it, rows, A, C, Es, NBs, B = args
    ninf = torch.tensor(-torch.inf, dtype=al.dtype)
    hi = torch.full_like(al, -torch.inf)
    lo = torch.full_like(al, -torch.inf)
    lane = torch.arange(TS.CHUNK)
    for g, sl, a, kept, fields, idx in blocks_of(args):
        for w in range(kept.shape[0]):
            t0 = sl.start + w * SCREEN_WARP
            n = min(SCREEN_WARP, sl.stop - t0)
            if n <= 0 or not bool(kept[w].any()):
                continue
            cand = (kept[w].nonzero()[:, 0, None] * TS.CHUNK
                    + lane[None]).reshape(-1)
            f = {k: fields[i][cand][None] for k, i in _F.items()}
            t = a[w * SCREEN_WARP:w * SCREEN_WARP + n, None]
            kl, kh, me = (v[t0:t0 + n, None] for v in (klo, khi, it))
            # first the wide cover and kt_hi: three fields
            m = (t > f["a0w"]) & (t < f["a2w"]) & (f["key"] < kh)
            # then, for the pairs that pass, the index and the rest
            m = m & (idx[cand][None] != me)
            d = t - f["a1e"]
            gi = f["g1"] + d * torch.where(d < 0, -f["s01"], f["s21"])
            gi = torch.minimum(torch.maximum(gi, f["mn"]), f["mx"])
            hi[t0:t0 + n] = torch.where(m, gi + f["tw"], ninf).amax(dim=1)
            s = m & (t > f["a0n"]) & (t < f["a2n"]) & (f["key"] < kl)
            lo[t0:t0 + n] = torch.where(s, gi - f["ts"], ninf).amax(dim=1)
    return hi, lo
