"""The run that the four stencil probes share: each kernel checked against
its twin at full size on both inputs, then every leg timed in turns."""

from __future__ import annotations

import sys

import torch

from ._probe import header, in_turns, mismatch, rasters, require_card

__all__ = ["run", "EXACT"]

EXACT = dict(rtol=0.0, atol=0.0)


def run(tool: str, n: int, checks, legs, out=sys.stdout) -> dict:
    """Run a stencil probe at (n, n) on the card.

    ``checks(x)`` lists ``(label, got_fn, ref_fn, tol, region)``: the two
    results must agree within `tol` (NaN masks equal) on `region` (a pair
    of slices, or None for every cell); a `tol` of None only prints the
    difference.  ``legs(x)`` maps a label to ``(fn, reps, bytes)``.  Prints
    the torch device and the card first and the card on every line.
    Returns ``{"card", "n", "inputs": {input: {"checks": {label: max
    difference}, "legs": {label: {"ms", "gb_s", "bytes"}}}}}``; raises
    RuntimeError if there is no card or a check fails.
    """
    dev = require_card(tool)
    card = header(dev, out)
    result = {"card": card, "n": n, "inputs": {}}
    for name, x in rasters(n, dev).items():
        errs = {}
        for label, got_fn, ref_fn, tol, region in checks(x):
            got, ref = got_fn(), ref_fn()
            if region is not None:
                got, ref = got[region], ref[region]
            n_bad, err = mismatch(got, ref, **(tol or EXACT))
            del got, ref
            if tol is None:
                print(f"{name} {label}: max_abs_diff {err:.3e} "
                      f"(informational)", file=out)
                continue
            print(f"{name} check {label}: max_abs_diff {err:.3e}, "
                  f"{n_bad} cells outside rtol {tol['rtol']} / atol "
                  f"{tol['atol']}", file=out)
            if n_bad:
                raise RuntimeError(f"{tool} {name}: {label}: {n_bad} cells "
                                   f"differ")
            errs[label] = err
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        timed = legs(x)
        ms = in_turns({k: (fn, reps) for k, (fn, reps, _) in timed.items()})
        rows = {}
        for label, (_, _, nbytes) in timed.items():
            rows[label] = {"ms": ms[label], "gb_s": nbytes / ms[label] / 1e6,
                           "bytes": nbytes}
            print(f"{name} {label}: {ms[label]:.4f} ms, "
                  f"{rows[label]['gb_s']:.1f} GB/s ({nbytes / 1e9:.3f} GB), "
                  f"{card}", file=out)
        result["inputs"][name] = {"checks": errs, "legs": rows}
        del x, timed
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return result


def main(tool: str, measure, argv) -> int:
    """``python -m xrspatial_torch.tools.<tool> [N]``: exits 1 without a
    card."""
    if not torch.cuda.is_available():
        print(f"{tool}: torch.cuda.is_available() is false; this tool needs "
              f"an NVIDIA card", file=sys.stderr)
        return 1
    measure(int(argv[0]) if argv else 16384)
    return 0
