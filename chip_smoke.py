#!/usr/bin/env python3
"""Drive the xrspatial_torch port once on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: torch/CUDA versions, the card's name and power limit;
2. build: ``nvcc`` compiles ``xrspatial_torch/csrc/*.cu`` (build time and
   ``-Xptxas -v`` register/spill lines are printed);
3. kernels: each CUDA kernel against its torch twin, on the card, at small
   and ragged shapes with NaN patches and +-inf cells;
4. main path: ``terrain_pipeline`` on a 16384^2 float32 DEM on the card,
   the call users make; one launch of each kernel, outputs on the card,
   exact NaN ring, full-size agreement with the twins;
5. timing (informational): warm ``terrain_pipeline`` and each kernel
   against its twin, from CUDA events.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device the
script exits 1 before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N = 16384  # the main path's DEM edge (float32)
SMALL_SHAPES = ((70, 300), (1, 1000), (2, 5), (1025, 2049), (2048, 2048))
SURFACE_TOL = dict(rtol=1e-4, atol=5e-5)
FOCAL_TOL = dict(rtol=1e-5, atol=1e-5)
ALL_STATS = ("mean", "max", "min", "range", "std", "var", "sum")
PIPELINE_STATS = ("mean", "max", "min", "std")
PIPELINE_SURFACE = ("slope", "hillshade")


class SmokeFailure(Exception):
    pass


def gaussian_bump(ny: int, nx: int, device):
    """Synthetic DEM: a Gaussian hill with ripples (bench.py's, in torch)."""
    import torch
    y = torch.linspace(-1.0, 1.0, ny, dtype=torch.float32,
                       device=device)[:, None]
    x = torch.linspace(-1.0, 1.0, nx, dtype=torch.float32,
                       device=device)[None, :]
    z = 1000.0 * torch.exp(-(x * x + y * y) * 4.0)
    return z + 20.0 * torch.sin(x * 40.0) * torch.cos(y * 40.0)


def compare(got, ref, rtol, atol, circular=None):
    """Compare two float tensors on their device.

    Returns ``(n_bad, max_abs_err, n_wrapped)``: cells outside
    ``atol + rtol*|ref|`` (a NaN-mask mismatch or an unequal infinity
    counts as bad), the largest difference where both are not NaN, and,
    with ``circular`` (a period), the cells that pass only as a circular
    difference.
    """
    import torch
    nan_g, nan_r = torch.isnan(got), torch.isnan(ref)
    both = ~(nan_g | nan_r)
    same = got == ref  # equal infinities included
    diff = torch.where(both & ~same, (got - ref).abs(), 0.0)
    limit = atol + rtol * ref.abs()
    finite = torch.isfinite(got) & torch.isfinite(ref)
    n_wrapped = 0
    if circular is not None:
        cdiff = torch.minimum(diff, (circular - diff).abs())
        n_wrapped = int(((diff > limit) & (cdiff <= limit) & both).sum())
        diff = cdiff
    bad = (nan_g != nan_r) | (both & ~same & (~finite | (diff > limit)))
    return int(bad.sum()), float(diff.max()) if diff.numel() else 0.0, \
        n_wrapped


def check(name, got, ref, tol, circular=None):
    n_bad, err, wrapped = compare(got, ref, circular=circular, **tol)
    note = f" wrapped_cells={wrapped}" if circular is not None else ""
    print(f"  {name}: max_abs_diff={err:.3e} bad_cells={n_bad}{note}")
    if n_bad:
        raise SmokeFailure(f"{name}: {n_bad} cells outside rtol "
                           f"{tol['rtol']} / atol {tol['atol']}")
    return err


def test_raster(shape, seed):
    """Random float32 raster with NaN patches, on the host."""
    rng = np.random.default_rng(seed)
    h, w = shape
    a = (rng.random(shape) * 100).astype(np.float32)
    a[h // 3:h // 3 + max(1, h // 20), w // 3:w // 3 + max(1, w // 15)] = \
        np.nan
    a[rng.integers(0, h, 3), rng.integers(0, w, 3)] = np.nan
    return a


def cuda_time_ms(fn, reps):
    """Mean device time of `fn` over `reps` runs, from CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def paired_ms(kernel_fn, plain_fn, reps_kernel, reps_plain):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    plain = [cuda_time_ms(plain_fn, reps_plain)]
    kern = [cuda_time_ms(kernel_fn, reps_kernel),
            cuda_time_ms(kernel_fn, reps_kernel)]
    plain.append(cuda_time_ms(plain_fn, reps_plain))
    return sum(kern) / 2, sum(plain) / 2


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card and has no CPU mode", file=sys.stderr)
        return 1

    from xrspatial_torch import DataArray, terrain_pipeline
    from xrspatial_torch.convolution import circle_kernel
    from xrspatial_torch.kernels import _cuda, cuda_surface, cuda_window
    from xrspatial_torch.kernels.surface import PRODUCTS, surface_multi
    from xrspatial_torch.kernels.window import kernel_offsets, window_stats

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip()
    print(f"== device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{name}, {torch.cuda.device_count()} visible")
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- build -------------------------------------------------------------
    t0 = time.perf_counter()
    path, log = _cuda.build()
    _cuda.library()
    print(f"== build: {time.perf_counter() - t0:.1f} s -> {path.name}")
    for line in log.splitlines():
        if any(k in line for k in ("registers", "spill", "Compiling entry")):
            print("  ptxas:", line.strip().removeprefix("ptxas info    : "))

    # -- kernels against their twins, small and ragged shapes ---------------
    print("== kernels vs twins on the card")
    kernels = {"r1": circle_kernel(1, 1, 1.5), "r2": circle_kernel(1, 1, 2.5)}
    for k, shape in enumerate(SMALL_SHAPES):
        host = test_raster(shape, seed=100 + k)
        x = torch.from_numpy(host).to(dev)
        got = cuda_surface.surface_cuda(x, PRODUCTS, 2.0, 3.0, 225.0, 25.0)
        ref = surface_multi(x, 2.0, 3.0, 225.0, 25.0, PRODUCTS)
        for p, g in zip(PRODUCTS, got):
            # aspect jumps from 0 to 360 at angle 90: compared circularly
            check(f"surface {shape} {p}", g, ref[p], SURFACE_TOL,
                  circular=360.0 if p == "aspect" else None)
        host[shape[0] // 2, shape[1] // 2] = np.inf
        host[0, shape[1] - 1] = -np.inf
        x = torch.from_numpy(host).to(dev)
        for kname, kern in kernels.items():
            offsets = kernel_offsets(kern)
            got = cuda_window.focal_stats_cuda(x, offsets, ALL_STATS)
            ref = window_stats(x, offsets, ALL_STATS)
            for i, s in enumerate(ALL_STATS):
                check(f"focal {shape} {kname} {s}", got[i], ref[s], FOCAL_TOL)
        torch.cuda.synchronize()

    # -- the main path -------------------------------------------------------
    print(f"== main path: terrain_pipeline on a {N}x{N} float32 DEM")
    dem = gaussian_bump(N, N, dev)
    agg = DataArray(dem, dims=("y", "x"), name="dem",
                    attrs={"res": (1.0, 1.0)})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_surface.LAUNCHES = 0
    cuda_window.LAUNCHES = 0
    t0 = time.perf_counter()
    ds = terrain_pipeline(agg, surface=PIPELINE_SURFACE,
                          stats_funcs=PIPELINE_STATS)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"surface_kernel": cuda_surface.LAUNCHES,
                "focal_kernel": cuda_window.LAUNCHES}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"  first call {first_s * 1e3:.1f} ms (host clock), launches "
          f"{launches}, peak allocated {peak_gib:.2f} GiB")
    if launches != {"surface_kernel": 1, "focal_kernel": 1}:
        raise SmokeFailure(f"expected one launch of each kernel, got "
                           f"{launches}")

    slope = ds["dem-slope"].data
    hill = ds["dem-hillshade"].data
    fs = ds["focal_stats"].data
    for label, t, shape in (("slope", slope, (N, N)),
                            ("hillshade", hill, (N, N)),
                            ("focal_stats", fs, (len(PIPELINE_STATS), N, N))):
        if t.device.type != "cuda" or tuple(t.shape) != shape:
            raise SmokeFailure(f"{label}: {tuple(t.shape)} on {t.device}, "
                               f"expected {shape} on cuda")
    ring = torch.ones((N, N), dtype=torch.bool, device=dev)
    ring[1:-1, 1:-1] = False
    for label, t in (("slope", slope), ("hillshade", hill)):
        if not torch.equal(torch.isnan(t), ring):
            raise SmokeFailure(f"{label}: NaN cells are not exactly the "
                               f"1-cell ring")
    if not bool(torch.isfinite(fs).all()):
        raise SmokeFailure("focal_stats: non-finite values on a finite DEM")
    inner = (slope[1:-1, 1:-1], hill[1:-1, 1:-1])
    if not (bool((inner[0] >= 0).all()) and bool((inner[0] < 90).all())
            and bool((inner[1] >= 0).all()) and bool((inner[1] <= 1).all())):
        raise SmokeFailure("slope or hillshade outside its range")
    mean, smax, smin, std = fs
    if not (bool((smin <= mean + 1e-3).all())
            and bool((mean <= smax + 1e-3).all())
            and bool((std >= 0).all())):
        raise SmokeFailure("focal stats out of order (min <= mean <= max, "
                           "std >= 0)")
    del inner, mean, smax, smin, std, ring

    print("  full-size agreement with the twins")
    max_err = {}
    ref = surface_multi(dem, 1.0, 1.0, 225.0, 25.0, PIPELINE_SURFACE)
    max_err["surface_kernel"] = max(
        check(f"surface {p}", ds[f"dem-{p}"].data, ref[p], SURFACE_TOL)
        for p in PIPELINE_SURFACE)
    del ref
    offsets = kernel_offsets(circle_kernel(1, 1, 1.5))
    ref = window_stats(dem, offsets, PIPELINE_STATS)
    max_err["focal_kernel"] = max(
        check(f"focal {s}", fs[i], ref[s], FOCAL_TOL)
        for i, s in enumerate(PIPELINE_STATS))
    del ref, ds, slope, hill, fs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # -- timing (informational) ---------------------------------------------
    print(f"== timing at {N}x{N} on {card}")

    def pipeline():
        terrain_pipeline(agg, surface=PIPELINE_SURFACE,
                         stats_funcs=PIPELINE_STATS)

    pipe_ms = cuda_time_ms(pipeline, 10)
    print(f"  terrain_pipeline warm: {pipe_ms:.3f} ms "
          f"({N * N / 1e3 / pipe_ms:.1f} Mpix/s), {card}")
    ms = {}
    ms["surface_kernel"] = paired_ms(
        lambda: cuda_surface.surface_cuda(dem, PIPELINE_SURFACE),
        lambda: surface_multi(dem, 1.0, 1.0, 225.0, 25.0, PIPELINE_SURFACE),
        20, 5)
    ms["focal_kernel"] = paired_ms(
        lambda: cuda_window.focal_stats_cuda(dem, offsets, PIPELINE_STATS),
        lambda: window_stats(dem, offsets, PIPELINE_STATS), 20, 5)
    for k, (kern_ms, plain_ms) in ms.items():
        print(f"  {k}: kernel {kern_ms:.3f} ms, twin {plain_ms:.3f} ms, "
              f"{card}")
    print(f"  peak allocated by the main-path call: {peak_gib:.2f} GiB, "
          f"{card}")

    sources = {"surface_kernel": (
        "xrspatial_torch/csrc/surface.cu",
        "xrspatial_tpu/kernels/pallas_surface2.py:178"),
        "focal_kernel": (
        "xrspatial_torch/csrc/focal.cu",
        "xrspatial_tpu/kernels/pallas_window2.py:160")}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": max_err[k],
         "ms": ms[k][0], "plain_ms": ms[k][1]}
        for k, (src, rep) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
