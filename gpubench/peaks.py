"""The published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at
its 700 W limit) and the card's own power limit, read beside them."""

from __future__ import annotations

import subprocess

HBM_BYTES_S = 3.35e12      # device memory
F32_FLOP_S = 67e12         # float32 outside the tensor cores


def power_limits() -> list:
    """Each visible card's ``power.limit`` in W (empty where
    ``nvidia-smi`` cannot say)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    vals = []
    for line in out.splitlines():
        try:
            vals.append(float(line))
        except ValueError:
            pass
    return vals
