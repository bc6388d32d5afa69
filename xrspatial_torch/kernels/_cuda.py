"""Build and load the package's hand-written CUDA kernels.

Counterpart of ``xrspatial_tpu/native/__init__.py`` (on-demand g++ +
ctypes), with no fallback: if ``nvcc`` is missing, or the build or the
load fails, the caller gets the error.

``csrc/*.cu`` compile into one shared library with a plain C interface,
under ``csrc/_build/`` at the first CUDA call: one ``nvcc`` process per
source, all started together, then one link.  The library's name carries a
hash of the flags and of every source and header (``csrc/*.cu``,
``csrc/*.cuh``), so an edited source or header is rebuilt and a current
library is reused.  Several processes may build at once (pytest-xdist
workers): each writes temporary files and renames the library into place.
The first ``library()`` of a process is the span ``setup.library`` (the
hash, the build when stale, the load), recorded whether or not a profiler
runs, and a build inside it the span ``setup.build``
(``xrspatial_torch.tracing``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..tracing import span

__all__ = ["build", "library", "check", "stream_of"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
# no --use_fast_math / -ftz: flushing subnormal gradients and approximate
# sqrt/division would move the kernels off their torch twins
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-shared",)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        return str(Path(cuda_home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libxrspatial_torch-{h.hexdigest()[:16]}.so"


def build() -> tuple:
    """Compile ``csrc/*.cu`` unless a current library exists.

    Returns ``(path, log)``: the library's path and the compiler's output
    (``-Xptxas -v`` register and spill lines), empty when nothing was
    compiled.  Raises ``RuntimeError`` if ``nvcc`` fails.
    """
    out = _library_path()
    if out.exists():
        return out, ""
    with span("setup.build", always=True):
        return _build(out)


def _build(out: Path) -> tuple:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in _sources()]
    link = [_nvcc(), *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
    compiles = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(_sources(), objs)]
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in compiles]
        # wait for every compiler, so none outlives a failed build
        outputs = [proc.communicate()[0] for proc in procs]
        steps = list(zip(compiles, [p.returncode for p in procs], outputs))
        if all(rc == 0 for _, rc, _ in steps):
            proc = subprocess.run(link, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            steps.append((link, proc.returncode, proc.stdout))
        for cmd, rc, output in steps:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n"
                                   f"{output}")
        os.replace(tmp, out)
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    log = "".join(output for *_, output in steps)
    return out, log


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    with span("setup.library", always=True):
        return _load()


def _load() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
    # every pointer and the stream as c_void_p: without argtypes ctypes
    # would pass a Python int as a 32-bit int and cut the pointer
    lib.surface_launch.argtypes = [p, p, p, p, p, i64, i64, i32,
                                   f32, f32, f32, f32, f32, f32, p]
    lib.surface_launch.restype = i32
    lib.surface_staged_launch.argtypes = [p, p, p, p, p, i64, i64, i32,
                                          f32, f32, f32, f32, f32, f32, i32,
                                          i32, i32, i32, i32, i32, p]
    lib.surface_staged_launch.restype = i32
    lib.surface_stacked_launch.argtypes = [p, p, i64, i64, i32, i32, i32, i32,
                                           f32, f32, f32, f32, f32, f32, p]
    lib.surface_stacked_launch.restype = i32
    lib.surface_stacked_staged_launch.argtypes = [
        p, p, i64, i64, i32, i32, i32, i32, f32, f32, f32, f32, f32, f32, i32,
        i32, i32, i32, i32, i32, p]
    lib.surface_stacked_staged_launch.restype = i32
    for fn in (lib.stream_copy_launch, lib.stream_add_launch):
        fn.restype = i32
    lib.stream_copy_launch.argtypes = [p, p, i64, i64, i64, p]
    lib.stream_add_launch.argtypes = [p, p, p, i64, i64, i64, p]
    lib.focal_launch.argtypes = [p, p, i32, ctypes.POINTER(i32), p,
                                 i64, i64, p]
    lib.focal_launch.restype = i32
    lib.focal_halo_launch.argtypes = [p, p, i32, ctypes.POINTER(i32), p,
                                      i64, i64, i32, p]
    lib.focal_halo_launch.restype = i32
    lib.focal_halo_staged_launch.argtypes = [
        p, p, i32, i32, ctypes.POINTER(i32), p, i64, i64, i32, i32, i32, i32,
        i32, i32, i32, i32, i32, i32, i64, i32, p]
    lib.focal_halo_staged_launch.restype = i32
    lib.pipeline_staged_launch.argtypes = [
        p, p, p, p, p, i32, f32, f32, f32, f32, f32, f32, p, i32, i32,
        ctypes.POINTER(i32), p, i64, i64, i32, i32, i32, i32, i32, i32, i32,
        i32, i32, i32, i64, i32, p]
    lib.pipeline_staged_launch.restype = i32
    lib.pipeline_launch.argtypes = [p, p, p, p, p, i32, f32, f32, f32, f32,
                                    f32, f32, p, i32, ctypes.POINTER(i32), p,
                                    i64, i64, p]
    lib.pipeline_launch.restype = i32
    lib.jfa_round_packed.argtypes = [p, p, p, p, p, i64, i64, i64, f32, f32,
                                     i32, i32, i32, p]
    lib.jfa_round_packed.restype = i32
    lib.jfa_round_coords.argtypes = [p, p, p, p, p, p, p, p, i64, i64, i64,
                                     i32, p]
    lib.jfa_round_coords.restype = i32
    pp = ctypes.POINTER(p)
    lib.jfa_round_routed.argtypes = [i32, pp, pp, p, p, p, i64, i64, i64,
                                     f32, f32, i32, i32, i32, i32, i32, i32,
                                     i32, i32, i32, i32, i64, i32, i32,
                                     p]
    lib.jfa_round_routed.restype = i32
    tier_args = [i32, i32, ctypes.POINTER(p), ctypes.POINTER(p),
                 ctypes.POINTER(i32), ctypes.POINTER(i32),
                 ctypes.POINTER(i32), p, i32, i32]
    for fn in (lib.screen_hilo_f32, lib.screen_hilo_f64):
        fn.argtypes = [p, p, p, p, p, p, *tier_args, p, p, p]
        fn.restype = i32
    for fn in (lib.screen_culled_f32, lib.screen_culled_f64):
        fn.argtypes = [p, p, p, p, p, p, *tier_args, p, p, p, p, p]
        fn.restype = i32
    for fn in (lib.screen_bounds_f32, lib.screen_bounds_f64):
        fn.argtypes = [p, i32, i32, ctypes.POINTER(p), ctypes.POINTER(i32),
                       ctypes.POINTER(i32), p, p]
        fn.restype = i32
    lib.jfa_group_packed.argtypes = [p, p, i64, i64, ctypes.POINTER(i32),
                                     i32, i32, i32, f32, f32, i32, p]
    lib.jfa_group_packed.restype = i32
    lib.jfa_group_coords.argtypes = [p, p, p, p, p, p, i64, i64,
                                     ctypes.POINTER(i32), i32, i32, i32, i32,
                                     p]
    lib.jfa_group_coords.restype = i32
    lib.jfa_group_single.argtypes = [i32, pp, pp, p, p, i64, i64,
                                     ctypes.POINTER(i32), i32, i32, i32, i32,
                                     i32, i32, i32, i32, f32, f32, i32, p]
    lib.jfa_group_single.restype = i32
    lib.stencil_probe_launch.argtypes = [p, p, i64, i64, i32, i32, i32, i32,
                                         i32, i64, i64, i64, i64, f32, f32,
                                         ctypes.c_uint, p]
    lib.stencil_probe_launch.restype = i32
    lib.stencil_staged_launch.argtypes = [p, p, i64, i64, i32, i32, i32, i32,
                                          i32, i32, i32, i32, i32, i64, f32,
                                          f32, p]
    lib.stencil_staged_launch.restype = i32
    lib.stencil_edge_launch.argtypes = [p, p, i64, i64, i64, i64, i64, i64,
                                        f32, f32, p]
    lib.stencil_edge_launch.restype = i32
    lib.xdraw_scratch_bytes.argtypes = [i32, i32]
    lib.xdraw_scratch_bytes.restype = i64
    lib.xdraw_scan_launch.argtypes = [p, p, p, i32, i32, i32, i32, p, p]
    lib.xdraw_scan_launch.restype = i32
    lib.xdraw_banded_launch.argtypes = [p, p, i32, i32, i32, i32, i32, i32,
                                        i32, p, p, p]
    lib.xdraw_banded_launch.restype = i32
    side = [p, p, p, p, i64, i32, i32, i32]
    lib.xdraw_strip_launch.argtypes = side + side + [
        p, p, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, p]
    lib.xdraw_strip_launch.restype = i32
    lib.xdraw_fields_launch.argtypes = [p, i64, p, i32, i32, i32, i32, i32,
                                        i32, p, f32, f32, f32, f32, p]
    lib.xdraw_fields_launch.restype = i32
    lib.xdraw_epilogue_launch.argtypes = [p, i64, i32, i32, i32, p, i64, p,
                                          i32, i32, i32, i32, i32, i32, p,
                                          f32, f32, f32, f32, f32, f32, p]
    lib.xdraw_epilogue_launch.restype = i32
    lib.bump_scan_launch.argtypes = [p, p, p, i64, i32, i32, i32, p, p]
    lib.bump_scan_launch.restype = i32
    lib.bump_rounds_grid.argtypes = [i32]
    lib.bump_rounds_grid.restype = i32
    lib.bump_rounds_launch.argtypes = [p, p, p, p, p, p, p, p, i32, i32, i32,
                                       i32, p, i32, i32, p]
    lib.bump_rounds_launch.restype = i32
    lib.xrt_error_string.argtypes = [i32]
    lib.xrt_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch entry point returned a CUDA error code."""
    if err != 0:
        msg = library().xrt_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def stream_of(device) -> int:
    """Raw handle of PyTorch's current stream on `device`."""
    return torch.cuda.current_stream(device).cuda_stream
