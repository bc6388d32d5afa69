"""The exact viewshed's interval screen: the pair predicate and its twin.

Counterpart of ``xrspatial_tpu/kernels/viewshed_exact.py::_screen_pairs``
and of the scan body of ``_screen_scan``.  ``screen_hilo`` is the plain
torch version of the CUDA kernel ``csrc/screen.cu`` (wrapper
``cuda_screen.py``), which replaces the TPU kernel
``xrspatial_tpu/kernels/pallas_screen.py::screen_hilo_pallas``: for every
target, sound (hi, lo) bounds of the largest blocked gradient over the
candidates of its bucket group.  Both take the same inputs: the expanded
candidate stacks of ``viewshed_exact._expand_stack`` and the per-target
vectors in bucket order, in float32 (screen level 1) or float64 (the
level-2 re-screen).

Each group of T = B*C targets is held against the whole global table and
against one window of ``nb = min(NB, nblk)`` E-blocks per tier, starting
at block ``min(rows[g, t], nblk - nb)``: the scan's window, so the kernel
and this twin read the same candidates and their maxima agree bit for bit.
"""

from __future__ import annotations

import torch

__all__ = ["F13", "CHUNK", "screen_pairs", "screen_hilo", "chunk_bounds"]

# stacked-field order of the expanded candidate tables (idx rides
# separately as int32: flat indices above 2^24 are not exact in f32)
F13 = ("a0w", "a0n", "a2w", "a2n", "a1e", "g1", "s01", "s21", "mn",
       "mx", "ts", "tw", "key")

# candidates a chunk: the CUDA kernels stage and cull the tables in runs of
# CHUNK candidates, and every block length E and glob length is a multiple
CHUNK = 128


def screen_pairs(al, kt_lo, kt_hi, it, c):
    """Sound (hi, lo) bounds per target over one candidate block: 2
    interval tests, 2 key tests, one linear interpolation (slopes
    precomputed per candidate), clipped to the candidate's [mn, mx].
    Broadcast contract: the target operands carry trailing length-1
    candidate axes, the candidate fields in ``c`` broadcast against them
    (candidates on the trailing axes, 1 or 2 of them); the max reduces
    every candidate axis.  Every operation is a separate torch op, so each
    product and sum is rounded on its own."""
    ninf = torch.tensor(-torch.inf, dtype=c["g1"].dtype,
                        device=c["g1"].device)
    kb = c["key"]
    not_self = c["idx"] != it
    maybe = ((al > c["a0w"]) & (al < c["a2w"])
             & (kb < kt_hi) & not_self)
    sure = ((al > c["a0n"]) & (al < c["a2n"])
            & (kb < kt_lo) & not_self)
    d = al - c["a1e"]
    gi = c["g1"] + d * torch.where(d < 0, -c["s01"], c["s21"])
    gi = torch.minimum(torch.maximum(gi, c["mn"]), c["mx"])
    red = tuple(range(1, gi.ndim))
    hi = torch.amax(torch.where(maybe, gi + c["tw"], ninf), dim=red)
    lo = torch.amax(torch.where(sure, gi - c["ts"], ninf), dim=red)
    return hi, lo


def screen_hilo(glob, stacks, al, klo, khi, it, rows, A, C, Es, NBs, B):
    """Per-target (hi, lo) over the group windows, as plain torch ops.

    ``glob`` is ``((13, Lg), (Lg,) int32)``; each of ``stacks`` is
    ``((nblk, 13, E), (nblk, E) int32)`` with ``E = Es[t]``; ``al``,
    ``klo``, ``khi`` and the int32 target index ``it`` are (A*C,) in
    bucket order; ``rows`` is the (G, ntier) int32 first-block index of
    each group's window, G = A // B.  Returns two (A*C,) tensors of
    ``al``'s dtype.
    """
    G = A // B
    T = B * C
    gstk, gidx = glob
    glob_c = {f: gstk[i][None] for i, f in enumerate(F13)}
    glob_c["idx"] = gidx[None]
    al2, klo2, khi2, it2 = (v.reshape(G, T) for v in (al, klo, khi, it))
    starts = rows.tolist()
    hi = torch.empty((G, T), dtype=al.dtype, device=al.device)
    lo = torch.empty_like(hi)
    for g in range(G):
        a, kl, kh, i = (v[g][:, None] for v in (al2, klo2, khi2, it2))
        h, l = screen_pairs(a, kl, kh, i, glob_c)
        for t, ((stk, idx), E, NB) in enumerate(zip(stacks, Es, NBs)):
            nblk = idx.shape[0]
            nb = min(NB, nblk)
            r = max(0, min(starts[g][t], nblk - nb))
            wnd = stk[r:r + nb]
            c = {f: wnd[:, k][None] for k, f in enumerate(F13)}
            c["idx"] = idx[r:r + nb][None]
            h2, l2 = screen_pairs(a[:, :, None], kl[:, :, None],
                                  kh[:, :, None], i[:, :, None], c)
            h = torch.maximum(h, h2)
            l = torch.maximum(l, l2)
        hi[g] = h
        lo[g] = l
    return hi.reshape(A * C), lo.reshape(A * C)


def chunk_bounds(glob, stacks):
    """(lo, hi) of every CHUNK-candidate chunk of the global table, then of
    each tier's table (all its blocks) in order, as one flat tensor of
    2 values a chunk: ``lo`` is the least ``a0w`` and ``hi`` the largest
    ``a2w`` over the chunk's candidates with ``a0w < a2w`` (+inf and -inf
    when it has none).  A pair passes the wide cover ``a0w < al < a2w``
    only if ``lo < al < hi``.  The plain version of the culled route's
    pre-pass (``csrc/screen.cu::screen_bounds_kernel``)."""
    ia0w, ia2w = F13.index("a0w"), F13.index("a2w")
    parts = []
    for stk in (glob[0][None], *(s for s, _ in stacks)):
        w0 = stk[:, ia0w].reshape(-1, CHUNK)
        w2 = stk[:, ia2w].reshape(-1, CHUNK)
        ok = w0 < w2
        inf = torch.tensor(torch.inf, dtype=w0.dtype, device=w0.device)
        lo = torch.where(ok, w0, inf).amin(dim=1)
        hi = torch.where(ok, w2, -inf).amax(dim=1)
        parts.append(torch.stack([lo, hi], dim=1).reshape(-1))
    return torch.cat(parts)
