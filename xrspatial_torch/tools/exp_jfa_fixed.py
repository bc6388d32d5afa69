"""A group of small-stride jump-flood rounds in one launch, against the
round kernel launched once per round.

    python -m xrspatial_torch.tools.exp_jfa_fixed [N]     (N = 4096)

Counterpart of ``tools/exp_jfa_fixed.py``, whose TPU kernel
``multi_round_fixed`` (B8g) is ``csrc/jfa_group.cu``: each block runs the
group on one fixed (T+2H)^2 window in shared memory, single-buffered (the
default route) or double-buffered (the first port, route "double").  On
the JAX probe's (N, N) raster (256 targets from ``default_rng(0)``, unit
axes, Euclidean) it runs, in both state forms (float32 coordinates, the
TPU probe's, and packed int32, proximity's), the JAX probe's two groups
(64,) and (64, 32, 16, 8, 4, 2, 1, 2, 1) and proximity's tail (16, 8, 4,
2, 1, 2, 1).  A
group whose window does not fit in a block's shared memory is printed as
not run, with the bytes it needs.  For each group that runs it prints the
cells where each route of the fused group and the round kernel differ (it
must be 0) and the times, in turns, from CUDA events.  Without a card it
exits 1.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..kernels import cuda_jfa
from ..kernels.jfa import packed_state_plan
from ..kernels.jfa_group import TAIL, group_coords, group_packed, window_plan
from ..kernels.jfa_rounds import PACK_BITS
from ._probe import header, in_turns, require_card

__all__ = ["measure", "GROUPS", "initial_states"]

GROUPS = {"the JAX probe's first group": (64,),
          "the JAX probe's group": (64, 32, 16, 8, 4, 2, 1, 2, 1),
          "proximity's tail": TAIL}


def initial_states(n: int, dev) -> dict:
    """The JAX probe's round-0 state on an (n, n) raster, in both forms:
    {"coords": (tx, ty, xs, ys), "packed": (state, steps)}."""
    rng = np.random.default_rng(0)
    mask_np = np.zeros((n, n), bool)
    mask_np[rng.integers(0, n, 256), rng.integers(0, n, 256)] = True
    mask = torch.from_numpy(mask_np).to(dev)
    xs_np = np.arange(n, dtype=np.float32)
    ys_np = np.arange(n, dtype=np.float32)
    xs, ys = torch.from_numpy(xs_np).to(dev), torch.from_numpy(ys_np).to(dev)
    iy = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    ix = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    steps = packed_state_plan(xs_np, ys_np, 0)[0]
    return {"coords": (torch.where(mask, xs[None, :], np.inf),
                       torch.where(mask, ys[:, None], np.inf), xs, ys),
            "packed": (torch.where(mask, (iy << PACK_BITS) | ix, -1), steps)}


def _runs(form, state, ks):
    """(fused on `route`, per round) callables of the group on `state`."""
    if form == "packed":
        s, steps = state

        def per_round():
            out = s
            for k in ks:
                out, _, _ = cuda_jfa.round_packed_cuda(out, None, k, 0, steps)
            return (out,)
        return (lambda route: (group_packed(s, ks, 0, steps, route),),
                per_round)
    tx, ty, xs, ys = state

    def per_round():
        a, b = tx, ty
        for k in ks:
            a, b, _ = cuda_jfa.round_coords_cuda(a, b, None, xs, ys, k, 0)
        return a, b
    return (lambda route: group_coords(tx, ty, xs, ys, ks, 0, route),
            per_round)


def measure(n: int = 4096, reps: int = 10, out=sys.stdout) -> dict:
    """Run, check and time every group in both forms at (n, n), on the
    single route and, where its window fits, the double route.

    Returns ``{"card", "runs": {(group, form): {"ks", "tile", "shared",
    "mismatch", "fused_ms", "double_ms", "rounds_ms"}}, "not_run":
    {(group, form): message}}`` (``double_ms`` None where the double
    route does not fit); raises RuntimeError if there is no card or a
    fused group differs from the round kernel.
    """
    dev = require_card("exp_jfa_fixed")
    card = header(dev, out)
    states = initial_states(n, dev)
    result = {"card": card, "runs": {}, "not_run": {}}
    for gname, ks in GROUPS.items():
        for form, state in states.items():
            try:
                plan = window_plan(ks, form)
            except ValueError as exc:
                print(f"{gname} {ks}, {form}: not run: {exc}", file=out)
                result["not_run"][(gname, form)] = str(exc)
                continue
            routes = ["single"]
            try:
                window_plan(ks, form, "double")
                routes.append("double")
            except ValueError:
                pass
            fused, per_round = _runs(form, state, ks)
            ref = per_round()
            mismatch = sum(int((g != r).sum()) for route in routes
                           for g, r in zip(fused(route), ref))
            print(f"{gname} {ks}, {form}: T = {plan.tile}, H = {plan.halo}, "
                  f"{plan.shared_bytes} bytes of shared memory, staged by "
                  f"{plan.stage}; routes {routes}: {mismatch} cells differ "
                  f"from the round kernel", file=out)
            if mismatch:
                raise RuntimeError(f"exp_jfa_fixed: {gname} {ks} {form}: "
                                   f"{mismatch} cells differ")
            legs = {route: (lambda route=route: fused(route), reps)
                    for route in routes}
            legs["rounds"] = (per_round, reps)
            ms = in_turns(legs)
            double = ms.get("double")
            print(f"{gname} {ks}, {form}: fused {ms['single']:.4f} ms, "
                  f"first port (double) "
                  f"{'not run' if double is None else f'{double:.4f} ms'}, "
                  f"{len(ks)} round launches {ms['rounds']:.4f} ms, {card}",
                  file=out)
            result["runs"][(gname, form)] = {
                "ks": ks, "tile": plan.tile, "shared": plan.shared_bytes,
                "mismatch": mismatch, "fused_ms": ms["single"],
                "double_ms": double, "rounds_ms": ms["rounds"]}
    return result


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("exp_jfa_fixed: torch.cuda.is_available() is false; this tool "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    measure(int(argv[0]) if argv else 4096)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
