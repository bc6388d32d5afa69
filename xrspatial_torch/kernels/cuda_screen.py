"""Wrapper of the CUDA interval-screen kernels (``csrc/screen.cu``).

Replaces ``xrspatial_tpu/kernels/pallas_screen.py::screen_hilo_pallas``.
``screen_hilo_cuda`` takes the arguments of its plain version
``screen.screen_hilo``, all on the card: float32 for the level-1 screen,
float64 for the level-2 re-screen.  Two routes give the same bits:

- "culled" (the default): the pre-pass ``chunk_bounds_cuda`` gives each
  128-candidate chunk its angular bounds, then ``screen_culled_kernel``
  evaluates 4 targets a thread against the chunks it cannot cull, staged by
  bulk copies; every table's base must be 16-byte aligned;
- "simple": the first port, ``screen_hilo_kernel``, by name.

The wrapper builds the kernel library at the first call, checks device,
dtypes, shapes, contiguity and alignment, allocates the outputs, launches
on PyTorch's current stream and raises if a launch fails; it never falls
back from one route to the other.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .screen import CHUNK, F13

__all__ = ["screen_hilo_cuda", "chunk_bounds_cuda", "ROUTES", "LAUNCHES",
           "F64_LAUNCHES", "CULLED_LAUNCHES", "SIMPLE_LAUNCHES",
           "BOUNDS_LAUNCHES"]

ROUTES = ("culled", "simple")

# launches in this process, for checks that a path ran on the kernels:
# LAUNCHES counts the pair evaluation on every route, F64_LAUNCHES the
# float64 ones among them, CULLED_LAUNCHES and SIMPLE_LAUNCHES each route's,
# BOUNDS_LAUNCHES the culled route's pre-pass
LAUNCHES = 0
F64_LAUNCHES = 0
CULLED_LAUNCHES = 0
SIMPLE_LAUNCHES = 0
BOUNDS_LAUNCHES = 0

_MAX_TIERS = 12
_PTRS = ctypes.c_void_p * _MAX_TIERS
_INTS = ctypes.c_int * _MAX_TIERS


def _check(name, t, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"screen_hilo_cuda takes CUDA tensors, got {name} "
                         f"on {t.device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"screen_hilo_cuda: {name} must be {dtype} "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"screen_hilo_cuda: {name} must be contiguous")


def _check_tables(glob, stacks, dt):
    """Check the candidate tables; returns (Lg, [nblk of each tier])."""
    if len(stacks) > _MAX_TIERS:
        raise ValueError(f"screen_hilo_cuda takes at most {_MAX_TIERS} "
                         f"tiers, got {len(stacks)}")
    gstk, gidx = glob
    Lg = gidx.shape[0]
    if Lg % CHUNK:
        raise ValueError(f"screen_hilo_cuda: the global table's length "
                         f"{Lg} is not a multiple of {CHUNK}")
    _check("glob fields", gstk, dt, (len(F13), Lg))
    _check("glob idx", gidx, torch.int32, (Lg,))
    nblks = []
    for t, (stk, idx) in enumerate(stacks):
        nblk, E = idx.shape[0], idx.shape[-1]
        if E % CHUNK or nblk < 1:
            raise ValueError(f"screen_hilo_cuda: tier {t} has block length "
                             f"{E} (a multiple of {CHUNK} is needed) and "
                             f"{nblk} blocks")
        _check(f"tier {t} fields", stk, dt, (nblk, len(F13), E))
        _check(f"tier {t} idx", idx, torch.int32, (nblk, E))
        nblks.append(nblk)
    return Lg, nblks


def _tier_ptrs(stacks):
    return (_PTRS(*(s.data_ptr() for s, _ in stacks)),
            _PTRS(*(i.data_ptr() for _, i in stacks)))


def chunk_bounds_cuda(glob, stacks):
    """Each 128-candidate chunk's (lo, hi) on the card, as
    ``screen.chunk_bounds``; the culled route's pre-pass."""
    global BOUNDS_LAUNCHES
    gstk = glob[0]
    dt = gstk.dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"chunk_bounds_cuda takes float32 or float64 "
                         f"tables, got {dt}")
    Lg, nblks = _check_tables(glob, stacks, dt)
    Es = [idx.shape[-1] for _, idx in stacks]
    chunks = Lg // CHUNK + sum(n * E // CHUNK for n, E in zip(nblks, Es))
    out = torch.empty(2 * chunks, dtype=dt, device=gstk.device)
    stk_p, _ = _tier_ptrs(stacks)
    lib = _cuda.library()
    fn = lib.screen_bounds_f32 if dt == torch.float32 else \
        lib.screen_bounds_f64
    with torch.cuda.device(gstk.device):
        err = fn(gstk.data_ptr(), Lg, len(stacks), stk_p, _INTS(*Es),
                 _INTS(*nblks), out.data_ptr(), _cuda.stream_of(gstk.device))
    _cuda.check(err, "screen_bounds")
    BOUNDS_LAUNCHES += 1
    return out


def screen_hilo_cuda(glob, stacks, al, klo, khi, it, rows, A, C, Es, NBs,
                     B, route=None, stats=None):
    """Per-target (hi, lo) on the card; see ``screen.screen_hilo``.

    `route` None or "culled" takes the redesigned kernel after its
    pre-pass, "simple" the first port.  `stats`, on the culled route only,
    is None or an int64 tensor of 4 on the card that the kernel adds its
    counts to: pairs evaluated, (warp, chunk) pairs evaluated, (warp,
    chunk) pairs culled, chunks staged."""
    global LAUNCHES, F64_LAUNCHES, CULLED_LAUNCHES, SIMPLE_LAUNCHES
    route = route or "culled"
    if route not in ROUTES:
        raise ValueError(f"screen_hilo_cuda: route {route!r} is not one of "
                         f"{ROUTES}")
    dt = al.dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"screen_hilo_cuda takes float32 or float64 "
                         f"targets, got {dt}")
    if A % B:
        raise ValueError(f"screen_hilo_cuda: {A} buckets do not split into "
                         f"groups of {B}")
    G, T = A // B, B * C
    ntier = len(stacks)
    if len(Es) != ntier or len(NBs) != ntier:
        raise ValueError(f"screen_hilo_cuda: {ntier} tiers need one E and "
                         f"NB each, got {len(Es)} and {len(NBs)}")
    for name, t in (("al", al), ("klo", klo), ("khi", khi)):
        _check(name, t, dt, (A * C,))
    _check("it", it, torch.int32, (A * C,))
    _check("rows", rows, torch.int32, (G, ntier))
    Lg, nblks = _check_tables(glob, stacks, dt)
    if tuple(idx.shape[-1] for _, idx in stacks) != tuple(Es):
        raise ValueError(f"screen_hilo_cuda: block lengths {tuple(Es)} do "
                         f"not match the tables'")
    nbs = [min(NB, n) for NB, n in zip(NBs, nblks)]
    if stats is not None:
        if route != "culled":
            raise ValueError("screen_hilo_cuda: stats are counted on the "
                             "culled route only")
        _check("stats", stats, torch.int64, (4,))
    gstk, gidx = glob
    if route == "culled":
        tables = [gstk, gidx, *(t for st in stacks for t in st)]
        if any(t.data_ptr() % 16 for t in tables):
            raise ValueError("screen_hilo_cuda: the culled route's bulk "
                             "copies need 16-byte aligned tables")
        bounds = chunk_bounds_cuda(glob, stacks)
    hi = torch.empty_like(al)
    lo = torch.empty_like(al)
    stk_p, idx_p = _tier_ptrs(stacks)
    lib = _cuda.library()
    f32 = dt == torch.float32
    head = (al.data_ptr(), klo.data_ptr(), khi.data_ptr(), it.data_ptr(),
            gstk.data_ptr(), gidx.data_ptr(), Lg, ntier, stk_p, idx_p,
            _INTS(*Es), _INTS(*nblks), _INTS(*nbs), rows.data_ptr(), G, T)
    with torch.cuda.device(al.device):
        if route == "culled":
            fn = lib.screen_culled_f32 if f32 else lib.screen_culled_f64
            err = fn(*head, bounds.data_ptr(),
                     None if stats is None else stats.data_ptr(),
                     hi.data_ptr(), lo.data_ptr(), _cuda.stream_of(al.device))
        else:
            fn = lib.screen_hilo_f32 if f32 else lib.screen_hilo_f64
            err = fn(*head, hi.data_ptr(), lo.data_ptr(),
                     _cuda.stream_of(al.device))
    _cuda.check(err, f"screen_hilo ({route})")
    LAUNCHES += 1
    if not f32:
        F64_LAUNCHES += 1
    if route == "culled":
        CULLED_LAUNCHES += 1
    else:
        SIMPLE_LAUNCHES += 1
    return hi, lo
