"""The control (the reference in bfloat16, the precision below the
configuration's float32) comes out not correct under each cell's limits,
while the program's float32 twins pass them, at a size the CPU holds."""

import json

import pytest
from conftest import CPU, REPO, add_cell

from gpubench import calibrate, run

CELLS = [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("limits", CELLS)
def test_the_control_fails_and_the_program_passes(bench_root, limits):
    cell = add_cell(bench_root, "ctl", (64, 72), [2, 2], limits=limits)
    lim = json.loads((bench_root / f"gpubench/limits/{cell}.json")
                     .read_text())
    r = calibrate.readings(cell, [31, 2 ** 35 + 1], [41, 42, 2 ** 40 + 3],
                           root=bench_root, devices=[CPU] * 4)
    for seed, numbers in r["program"].items():
        assert run.judge(numbers, lim)[0], (seed, numbers)
    for seed, numbers in r["control"].items():
        assert not run.judge(numbers, lim)[0], (seed, numbers)
    # every limit lies below the control's smallest reading of it, or
    # the number is exact
    for k, v in lim.items():
        assert v == 0 or v < r["upper"][k] or r["upper"][k] == 0, k
