"""Wrapper of the CUDA interval-screen kernel (``csrc/screen.cu``).

Replaces ``xrspatial_tpu/kernels/pallas_screen.py::screen_hilo_pallas``.
``screen_hilo_cuda`` takes the arguments of its plain version
``screen.screen_hilo``, all on the card: float32 for the level-1 screen,
float64 for the level-2 re-screen.  It builds the kernel library at the
first call, checks device, dtypes, shapes and contiguity, allocates the two
outputs, launches on PyTorch's current stream and raises if the launch
fails.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .screen import F13

__all__ = ["screen_hilo_cuda", "LAUNCHES", "F64_LAUNCHES"]

# launches of the kernel in this process, for checks that a path ran on it;
# F64_LAUNCHES counts the float64 ones among them
LAUNCHES = 0
F64_LAUNCHES = 0

_MAX_TIERS = 12
_CHUNK = 128   # the kernel's staging chunk: every block length divides by it


def _check(name, t, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"screen_hilo_cuda takes CUDA tensors, got {name} "
                         f"on {t.device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"screen_hilo_cuda: {name} must be {dtype} "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"screen_hilo_cuda: {name} must be contiguous")


def screen_hilo_cuda(glob, stacks, al, klo, khi, it, rows, A, C, Es, NBs,
                     B):
    """Per-target (hi, lo) on the card; see ``screen.screen_hilo``."""
    global LAUNCHES, F64_LAUNCHES
    dt = al.dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"screen_hilo_cuda takes float32 or float64 "
                         f"targets, got {dt}")
    if A % B:
        raise ValueError(f"screen_hilo_cuda: {A} buckets do not split into "
                         f"groups of {B}")
    G, T = A // B, B * C
    ntier = len(stacks)
    if ntier > _MAX_TIERS or len(Es) != ntier or len(NBs) != ntier:
        raise ValueError(f"screen_hilo_cuda takes at most {_MAX_TIERS} "
                         f"tiers with one E and NB each, got {ntier}")
    for name, t in (("al", al), ("klo", klo), ("khi", khi)):
        _check(name, t, dt, (A * C,))
    _check("it", it, torch.int32, (A * C,))
    _check("rows", rows, torch.int32, (G, ntier))
    gstk, gidx = glob
    Lg = gidx.shape[0]
    if Lg % _CHUNK:
        raise ValueError(f"screen_hilo_cuda: the global table's length "
                         f"{Lg} is not a multiple of {_CHUNK}")
    _check("glob fields", gstk, dt, (len(F13), Lg))
    _check("glob idx", gidx, torch.int32, (Lg,))
    nblks, nbs = [], []
    for t, ((stk, idx), E, NB) in enumerate(zip(stacks, Es, NBs)):
        nblk = idx.shape[0]
        if E % _CHUNK or nblk < 1:
            raise ValueError(f"screen_hilo_cuda: tier {t} has block length "
                             f"{E} (a multiple of {_CHUNK} is needed) and "
                             f"{nblk} blocks")
        _check(f"tier {t} fields", stk, dt, (nblk, len(F13), E))
        _check(f"tier {t} idx", idx, torch.int32, (nblk, E))
        nblks.append(nblk)
        nbs.append(min(NB, nblk))
    hi = torch.empty_like(al)
    lo = torch.empty_like(al)
    ptrs = ctypes.c_void_p * _MAX_TIERS
    ints = ctypes.c_int * _MAX_TIERS
    lib = _cuda.library()
    fn = lib.screen_hilo_f32 if dt == torch.float32 else lib.screen_hilo_f64
    with torch.cuda.device(al.device):
        err = fn(al.data_ptr(), klo.data_ptr(), khi.data_ptr(), it.data_ptr(),
                 gstk.data_ptr(), gidx.data_ptr(), Lg, ntier,
                 ptrs(*(s.data_ptr() for (s, _) in stacks)),
                 ptrs(*(i.data_ptr() for (_, i) in stacks)),
                 ints(*Es), ints(*nblks), ints(*nbs), rows.data_ptr(), G, T,
                 hi.data_ptr(), lo.data_ptr(), _cuda.stream_of(al.device))
    _cuda.check(err, "screen_hilo")
    LAUNCHES += 1
    if dt == torch.float64:
        F64_LAUNCHES += 1
    return hi, lo
