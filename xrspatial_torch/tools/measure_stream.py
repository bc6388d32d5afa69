"""Measure the card's achievable device-memory stream rate.

    python -m xrspatial_torch.tools.measure_stream [N]     (N = 16384)

Counterpart of ``tools/measure_stream.py``: the port's kernels are judged
against their bound at the nominal 3.35 TB/s of an H100 SXM, and this
tool measures the roof that a stream actually reaches on the card.  On an
(N, N) float32 raster it times, from CUDA events, in turns:

- copy (1 read + 1 write): ``stream_copy_kernel``, its twin ``x.clone()``
  and the library call ``Tensor.copy_``;
- add (2 reads + 1 write): ``stream_add_kernel``, its twin ``x + y`` and
  the library call ``torch.add``.

It prints the torch device and the card (name and power limit) first, a
line for each time, and last the measured stream roof (the best GB/s of
all rows) and its share of 3.35 TB/s.  Each kernel is checked against its
twin, bit for bit, before it is timed.  Without a card it exits 1.
"""

from __future__ import annotations

import sys

import torch

from ..kernels import stream
from ._probe import NOMINAL_BYTES_S, card_line
from ._probe import device_ms as _ms

__all__ = ["measure", "NOMINAL_BYTES_S"]


def measure(n: int = 16384, reps: int = 20, out=sys.stdout) -> dict:
    """Time the probes at (n, n) and print the rows and the roof.

    Returns ``{"copy": row, "add": row, "roof_gb_s": best, "card": ...}``
    where a row holds ``bytes`` and, for "kernel", "twin" and "library",
    the mean ms and GB/s.  Raises if there is no card or a kernel differs
    from its twin.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("measure_stream needs an NVIDIA card: "
                           "torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"torch {torch.__version__} on {dev} "
          f"({torch.cuda.get_device_name(dev)}), {card}", file=out)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((n, n), generator=gen, device=dev)
    y = torch.rand((n, n), generator=gen, device=dev)
    z = torch.empty_like(x)
    plane = x.numel() * x.element_size()
    probes = {
        "copy": (2 * plane, lambda: stream.copy(x),
                 lambda: stream.stream_copy(x), lambda: z.copy_(x),
                 "Tensor.copy_"),
        "add": (3 * plane, lambda: stream.add(x, y),
                lambda: stream.stream_add(x, y),
                lambda: torch.add(x, y, out=z), "torch.add"),
    }
    result = {"card": card}
    for name, (nbytes, kernel, twin, library, lib_name) in probes.items():
        if not torch.equal(kernel(), twin()):
            raise RuntimeError(f"stream {name}: the kernel differs from its "
                               f"twin")
        order = (("library", library), ("twin", twin), ("kernel", kernel),
                 ("kernel", kernel), ("twin", twin), ("library", library))
        times = {}
        for label, fn in order:
            times.setdefault(label, []).append(_ms(fn, reps))
        row = {"bytes": nbytes}
        for label, ts in times.items():
            ms = sum(ts) / len(ts)
            row[label] = {"ms": ms, "gb_s": nbytes / ms / 1e6}
            what = lib_name if label == "library" else label
            print(f"{name} {what}: {ms:.4f} ms, {nbytes / ms / 1e6:.1f} GB/s "
                  f"({nbytes / 1e9:.3f} GB), {card}", file=out)
        result[name] = row
    roof = max(r[label]["gb_s"] for r in (result["copy"], result["add"])
               for label in ("kernel", "twin", "library"))
    result["roof_gb_s"] = roof
    print(f"measured stream roof: {roof:.1f} GB/s "
          f"({roof * 1e9 / NOMINAL_BYTES_S * 100:.1f}% of the nominal "
          f"{NOMINAL_BYTES_S / 1e12:.2f} TB/s), {card}", file=out)
    return result


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("measure_stream: torch.cuda.is_available() is false; this "
              "tool needs an NVIDIA card", file=sys.stderr)
        return 1
    measure(int(argv[0]) if argv else 16384)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
