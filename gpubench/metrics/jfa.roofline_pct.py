"""jfa.roofline_pct: the least time of the jump flood's rounds (the seed
state read once, the nearest target's state and its key written once,
``work/proximity.py::rounds``, at 3.35 TB/s or 67 TFLOP/s) over the
device time a job of the ``__global__`` kernels of the port's
``csrc/jfa.cu`` and ``csrc/jfa_group.cu`` on the busiest card of the
traced window."""

import importlib
import re
from pathlib import Path

from gpubench import peaks
from gpubench.run import PORT
from gpubench.spec import Bench
from gpubench.trace import base_name

SOURCES = ("jfa.cu", "jfa_group.cu")
GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)"
                    r"\s*)?(\w+)\s*\(")


def kernels() -> frozenset:
    """The ``__global__`` names of the rounds' sources."""
    names = set()
    csrc = Path(importlib.import_module(PORT).__file__).parent / "csrc"
    for src in SOURCES:
        path = csrc / src
        if path.is_file():
            names.update(GLOBAL.findall(path.read_text()))
    return frozenset(names)


def read(ctx):
    t = ctx.trace
    if t is None or not t.jobs:
        return None
    own = kernels()
    s = t.total_s(t.busiest(),
                  lambda c, n: c == "kernel" and base_name(n) in own)
    if s <= 0:
        return None
    work = Bench(Path(__file__).resolve().parents[2]).work("proximity")
    nbytes, ops = work.rounds(ctx.pixels)
    least = max(nbytes / peaks.HBM_BYTES_S, ops / peaks.F32_FLOP_S)
    return 100.0 * least / (s / t.jobs)
