"""What the measurement tools share: the card's line, device timing from
CUDA events in turns, the probes' input rasters and their checks."""

from __future__ import annotations

import math
import subprocess
import sys

import torch

__all__ = ["NOMINAL_BYTES_S", "card_line", "device_ms", "in_turns",
           "require_card", "header", "gaussian_bump", "rasters", "mismatch",
           "SURFACE_TOL"]

NOMINAL_BYTES_S = 3.35e12   # H100 SXM device memory rate
SURFACE_TOL = dict(rtol=1e-4, atol=5e-5)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def require_card(tool: str) -> torch.device:
    """The first card; raises RuntimeError when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{tool} needs an NVIDIA card: "
                           f"torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


def header(dev, out=sys.stdout) -> str:
    """Print the torch device and the card first; return the card's line,
    which every timing line repeats."""
    card = card_line()
    print(f"torch {torch.__version__} on {dev} "
          f"({torch.cuda.get_device_name(dev)}), {card}", file=out)
    return card


def device_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` runs after one warm run."""
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


def in_turns(legs: dict) -> dict:
    """{label: mean ms} of `legs` ({label: (fn, reps)}), each timed twice,
    in the order given and then in reverse."""
    times = {}
    for label in [*legs, *reversed(legs)]:
        fn, reps = legs[label]
        times.setdefault(label, []).append(device_ms(fn, reps))
    return {k: sum(v) / len(v) for k, v in times.items()}


def gaussian_bump(ny: int, nx: int, device) -> torch.Tensor:
    """Synthetic DEM: a Gaussian hill with ripples (``bench.py``'s)."""
    y = torch.linspace(-1.0, 1.0, ny, dtype=torch.float32,
                       device=device)[:, None]
    x = torch.linspace(-1.0, 1.0, nx, dtype=torch.float32,
                       device=device)[None, :]
    z = 1000.0 * torch.exp(-(x * x + y * y) * 4.0)
    return z + 20.0 * torch.sin(x * 40.0) * torch.cos(y * 40.0)


def rasters(n: int, dev) -> dict:
    """The stencil probes' (n, n) float32 inputs: ``gaussian_bump`` (the
    JAX tools' bench DEM) and uniform noise from seed 0 (their ``rand``)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    return {"gaussian_bump": gaussian_bump(n, n, dev),
            "rand": torch.rand((n, n), generator=gen, device=dev)}


def mismatch(got, ref, rtol=0.0, atol=0.0) -> tuple:
    """(cells outside atol + rtol*|ref|, largest difference where both are
    numbers); a NaN-mask mismatch or an unequal infinity is outside."""
    nan_g, nan_r = torch.isnan(got), torch.isnan(ref)
    both = ~(nan_g | nan_r)
    same = got == ref
    diff = torch.where(both & ~same, (got - ref).abs(), 0.0)
    finite = torch.isfinite(got) & torch.isfinite(ref)
    bad = (nan_g != nan_r) | (both & ~same & (
        ~finite | (diff > atol + rtol * ref.abs())))
    err = float(diff.max()) if diff.numel() else 0.0
    return int(bad.sum()), (0.0 if math.isnan(err) else err)
