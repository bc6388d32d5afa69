"""The readings that a cell's correctness limits are set from.

    python3 -m gpubench.calibrate --workload <name> --seeds <n> ... \
        [--control-seeds <n> ...] [--out <file>]

In one process, at the cell's own size and on its cards: for each of
``--seeds`` the program's numbers (the timed path's job on that seed's
DEM, its outputs compared as a run compares them), and for each of
``--control-seeds`` the control's: the plain reference computed in
bfloat16, the precision below the configuration's float32, compared with
the float64 reference in the same way, on the job that the program's
first job on that seed is (every step's args drawn from the seed in step
order).  The lower reading of a number is the largest over the program's
seeds, the upper the smallest over the control's; both are printed.
Benchmark runs never run this.
"""

from __future__ import annotations

import argparse
import json
import random
import sys

import torch

from . import dem as demlib
from . import jobs as joblib
from .run import PORT, Cards, cuda_devices, dem_input, planes_of
from .spec import ROOT, Bench

CONTROL_DTYPE = torch.bfloat16


def readings(workload: str, seeds, control_seeds, *, root=None,
             devices=None) -> dict:
    """{"program": {seed: numbers}, "control": {seed: numbers}, "lower",
    "upper"}; `devices` given (a test) skips the look for cards."""
    import importlib
    bench = Bench(root or ROOT)
    cell = bench.cell(workload)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    if devices is None:
        devices = cuda_devices(int(cell["chips"]))
    port = importlib.import_module(PORT)
    cards = Cards(devices)
    check = bench.check(traffic.get("check", "stencil"))
    out = {"program": {}, "control": {}}
    for seed in seeds:
        blocks = demlib.make_blocks(config, seed, devices)
        dem = dem_input(port, config, blocks, devices)
        jobs = joblib.Jobs(traffic, {"dem": dem}, seed, PORT)
        drawn = jobs.draw()
        result = jobs.run(jobs.prepare(drawn))
        cards.sync()
        job = joblib.reference_job(traffic, drawn, bench)
        planes = planes_of(result, dem.data, job[-1].name)
        per_plane = check.gaps(config, blocks, job,
                               check.program(planes, config))
        out["program"][seed] = check.numbers(per_plane)
        del result, planes, jobs, dem, blocks
        print(json.dumps({"seed": seed, "program": out["program"][seed]}),
              flush=True)
    for seed in control_seeds:
        blocks = demlib.make_blocks(config, seed, devices)
        job = joblib.reference_job(
            traffic, joblib.draw_job(traffic, random.Random(seed)), bench)
        per_plane = check.gaps(config, blocks, job,
                               check.control(job, config, CONTROL_DTYPE))
        out["control"][seed] = check.numbers(per_plane)
        del blocks
        print(json.dumps({"seed": seed, "control": out["control"][seed]}),
              flush=True)
    for side, pick, key in (("program", max, "lower"),
                            ("control", min, "upper")):
        runs = list(out[side].values())
        if runs:
            out[key] = {k: pick(r[k] for r in runs) for k in runs[0]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m gpubench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out")
    a = p.parse_args(argv)
    r = readings(a.workload, a.seeds, a.control_seeds)
    r["card"] = torch.cuda.get_device_name(0)
    line = json.dumps({k: r[k] for k in ("card", "lower", "upper")
                       if k in r})
    print(line)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(r, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
