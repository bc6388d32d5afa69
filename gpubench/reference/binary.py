"""The plain reference of ``classify.binary``: 1 where a cell's value is
one of ``values`` (each as float32, as the op takes them), 0 elsewhere,
NaN where the value is not finite; in the check's dtype."""

from __future__ import annotations

import torch


def planes(args):
    return ["binary"]


def run(raster, coords, args, dtype=torch.float64):
    z = raster.to(dtype)
    member = torch.zeros(z.shape, dtype=torch.bool, device=z.device)
    for v in args["values"]:
        member |= z == float(torch.tensor(float(v), dtype=torch.float32))
    return {"binary": torch.where(torch.isfinite(z), member.to(dtype),
                                  float("nan"))}
