"""The jump-flood round kernel's times, for comparing two trees of the
package on one card.

    python -m xrspatial_torch.tools.time_jfa_rounds [LABEL] [N]
    python OTHER_TREE/xrspatial_torch/tools/time_jfa_rounds.py [LABEL] [N]

The package is imported from the working directory, so the second form
times the tree it is run from with this file, which only calls what every
tree of the port has (``cuda_jfa.round_packed_cuda``).  Run it from the
root of each tree in turns (parent, change, change, parent) within one
chip call.  On ``gaussian_bump``'s targets ``dem > 900`` at (N, N) (N =
16384) it times, with CUDA events: ``proximity``'s whole packed
schedule of rounds on the plan's routes; then single rounds at strides
1, 8, 32, 128 and 1024 on the state the schedule leaves (a target at
every cell), the first port at k = 8, and, where the tree's kernel takes
a block origin, k = 8 and 128 through an origin (a mesh block's
instantiation).  Prints the card's line and one line ``LABEL {...}``.
Without a card it exits 1.
"""

from __future__ import annotations

import inspect
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from xrspatial_torch.kernels import _cuda, cuda_jfa  # noqa: E402
from xrspatial_torch.kernels.jfa import _stride_schedule  # noqa: E402
from xrspatial_torch.tools._probe import (device_ms, gaussian_bump,  # noqa: E402
                                          header)

__all__ = ["measure"]

STRIDES = (1, 8, 32, 128, 1024)


def measure(n: int = 16384) -> dict:
    """{leg: ms} of the schedule and single rounds at (n, n)."""
    dev = torch.device("cuda", 0)
    _cuda.library()
    mask = gaussian_bump(n, n, dev) > 900
    iy = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    ix = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    state0 = torch.where(mask, (iy << 15) | ix, -1)
    strides = [int(k) for k in _stride_schedule(n)]
    steps = (1.0, 1.0)

    def schedule():
        s = state0
        for i, k in enumerate(strides):
            s, _, _ = cuda_jfa.round_packed_cuda(
                s, None, k, 0, steps, emit_best=i == len(strides) - 1)
        return s

    full = schedule()

    def one(k, **kw):
        return lambda: cuda_jfa.round_packed_cuda(full, None, k, 0, steps,
                                                  **kw)
    out = {"schedule": device_ms(schedule, 10)}
    for k in STRIDES:
        out[f"k{k}"] = device_ms(one(k), 30)
    out["simple_k8"] = device_ms(one(8, route="simple"), 10)
    if "origin" in inspect.signature(cuda_jfa.round_packed_cuda).parameters:
        for k in (8, 128):
            out[f"origin_k{k}"] = device_ms(one(k, origin=(1, 1)), 30)
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("time_jfa_rounds needs an NVIDIA card: "
              "torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    label = argv[0] if argv else "tree"
    n = int(argv[1]) if len(argv) > 1 else 16384
    header(torch.device("cuda", 0))
    ms = measure(n)
    print(label, {k: round(v, 4) for k, v in ms.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
