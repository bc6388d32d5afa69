"""One run of one cell of the port's benchmark.

    python3 -m gpubench --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the port (``xrspatial_torch``).  The run

1. makes the cell's DEM on its card(s) from the seed, loads (the first
   time in a checkout: builds) the port's kernel library and runs the
   traffic's warm-up jobs: the set-up;
2. runs jobs back to back for ``--seconds``, one outstanding at a time,
   each ended by a ``torch.cuda.synchronize`` on every card, its outputs
   dropped before the next (``--trace 1``: the profiler traces a stretch
   of jobs after the first third of the window, and the window ends with
   that stretch);
3. compares the last job's outputs, every cell, with the plain reference
   (``checks/<check>.py``, which gets every step of that job with its
   drawn args), against ``limits/<workload>.json``;
4. prints the numbers compared beside their limits as its last lines on
   standard error, and one JSON line on standard output: ``correct``,
   ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
   or with ``--trace 1`` its per-layer ones), ``device``, ``breakdown``
   (``--trace 1``) and ``checks``.

It exits 2, printing no result, where CUDA is not available or fewer
cards are visible than the cell asks for; 3 where a module of JAX, of the
JAX package or of the old benchmark is loaded once the window has
closed; 1 on any other failure.  It sets no switch of the port.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import math
import os
import sys
import time
import traceback
from contextlib import nullcontext
from dataclasses import dataclass
from pathlib import Path

PORT = "xrspatial_torch"
# whole top-level module names that the process may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "xrspatial_tpu", "benchmarks", "bench")
TRACE_AFTER = 1.0 / 3.0     # the window's share run before tracing starts


class NoCard(RuntimeError):
    pass


@dataclass
class Job:
    issue: float            # host clock, s
    ret: float              # the call into the port returned
    done: float             # complete on every card
    ok: bool
    traced: bool


@dataclass
class Context:
    """What the metric readers read."""
    setup_s: float
    jobs: list
    window_s: float
    pixels: int             # DEM pixels a job
    peak_bytes: int         # the window's peak, the fullest card
    trace: object           # trace.Trace, or None
    work: tuple             # (bytes, operations) a job
    cards: int
    port_kernels: frozenset


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time, 10 ms
    steps); since this module's import where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - \
            start / os.sysconf("SC_CLK_TCK")
        if 0.0 <= age < 3600.0:
            return age
    except (OSError, ValueError, IndexError):
        pass
    return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class Cards:
    """The cell's devices: waits, memory peaks."""

    def __init__(self, devices):
        import torch
        self.torch = torch
        self.devices = list(devices)
        self.cuda = sorted({d for d in self.devices if d.type == "cuda"},
                           key=lambda d: d.index)

    def sync(self):
        for d in self.cuda:
            self.torch.cuda.synchronize(d)

    def reset_peak(self):
        for d in self.cuda:
            self.torch.cuda.reset_peak_memory_stats(d)

    def peak(self) -> int:
        return max((self.torch.cuda.max_memory_allocated(d)
                    for d in self.cuda), default=0)


def cuda_devices(n: int) -> list:
    import torch
    if not torch.cuda.is_available():
        raise NoCard("CUDA is not available: the benchmark runs only on "
                     "the card")
    if torch.cuda.device_count() < n:
        raise NoCard(f"the cell needs {n} cards, "
                     f"{torch.cuda.device_count()} visible")
    return [torch.device("cuda", i) for i in range(n)]


def dem_input(port, config, blocks, devices):
    """The DEM as the port's DataArray: one tensor, or the blocks as a
    ``ShardedRaster`` over the port's mesh of the cell's devices; with the
    whole raster's coordinates where the configuration states them
    (``dem.coords``)."""
    from . import dem as demlib
    yx = demlib.coords(config)
    if config.get("mesh"):
        par = importlib.import_module(PORT + ".parallel")
        my, mx = config["mesh"]
        mesh = par.make_raster_mesh(my, mx, devices=devices[:my * mx])
        payload = par.ShardedRaster(blocks, tuple(config["shape"]), mesh,
                                    (True, True))
    else:
        payload = blocks[0][0]
    return port.DataArray(payload, dims=("y", "x"), name="dem",
                          coords=None if yx is None else
                          {"y": yx[0], "x": yx[1]},
                          attrs={"res": tuple(config["cellsize_m"])})


def planes_of(result, skip, name) -> dict:
    """The output planes of a job's result (a Dataset or a DataArray),
    each as a grid of blocks: a variable whose payload is `skip` (the
    input) is left out, a stacked variable gives one plane per label of
    its first dim, and a ``<input>-`` prefix is dropped from names.  An
    unnamed DataArray's plane takes `name`, its step's."""
    arrays = ([result[k] for k in result.data_vars]
              if hasattr(result, "data_vars") else [result])
    out = {}
    for a in arrays:
        if a.data is skip:
            continue
        grid = a.data.blocks if hasattr(a.data, "blocks") else [[a.data]]
        if len(a.dims) == 3:
            for k, label in enumerate(a.coords[a.dims[0]].data):
                out[str(label)] = [[b[k] for b in row] for row in grid]
        elif a.name is None:
            out[name] = grid
        else:
            out[str(a.name).split("-", 1)[-1]] = grid
    return out


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): each number beside its limit, in the limits'
    order; a number above its limit, or missing, is not correct."""
    checks, ok = {}, True
    for k, lim in limits.items():
        v = numbers.get(k, math.inf)
        checks[k] = {"value": v, "limit": lim}
        ok = ok and v <= lim
    return ok, checks


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        root=None, devices=None) -> dict:
    """One run; returns the result line's object (``checks`` last).
    `devices` given (a test) skips the look for cards."""
    from . import dem as demlib
    from . import jobs as joblib
    from . import peaks
    from . import trace as tracelib
    from .spec import ROOT, Bench
    bench = Bench(root or ROOT)
    cell = bench.cell(workload)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    limits = bench.limits(workload)
    devices_given = devices
    if devices is None:
        devices = cuda_devices(int(cell["chips"]))
    import torch
    port = importlib.import_module(PORT)
    if devices_given is None and not Path(port.__file__).resolve() \
            .is_relative_to(bench.root.resolve()):
        raise RuntimeError(f"{PORT} was imported from {port.__file__}, "
                           f"not from the checkout {bench.root}")
    if traffic.get("loop", "closed") != "closed" or \
            int(traffic.get("outstanding", 1)) != 1:
        raise NotImplementedError("the generator runs a closed loop with "
                                  "one job outstanding")
    cards = Cards(devices)
    on_card = bool(cards.cuda)

    blocks = demlib.make_blocks(config, seed, devices)
    dem = dem_input(port, config, blocks, devices)
    jobs = joblib.Jobs(traffic, {"dem": dem}, seed, PORT)
    for _ in range(int(traffic.get("warmup_jobs", 2))):
        out = jobs.run(jobs.prepare(jobs.draw()))
        cards.sync()
        del out
    if trace:
        tracelib.warm(on_card)
    setup_s = process_age_s()
    setup_peak = cards.peak()
    cards.reset_peak()

    records, failed, last, last_drawn = [], 0, None, None
    prof = window_span = None
    tracing, n_traced = False, 0

    def span(name):
        return (torch.profiler.record_function(name) if tracing
                else nullcontext())
    trace_jobs = int(traffic.get("trace_jobs", 100))
    gc.collect()
    gc.disable()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    trace_at = t0 + seconds * TRACE_AFTER if trace else math.inf
    try:
        while True:
            if not tracing and time.perf_counter() >= trace_at:
                prof = tracelib.start(on_card)
                window_span = torch.profiler.record_function(tracelib.WINDOW)
                window_span.__enter__()
                tracing = True
            drawn = jobs.draw()
            ready = jobs.prepare(drawn)
            ti = time.perf_counter()
            ok = True
            try:
                with span(tracelib.API):
                    out = jobs.run(ready)
                tr = time.perf_counter()
                with span(tracelib.SYNC):
                    cards.sync()
            except Exception:
                if not failed:
                    traceback.print_exc()
                failed += 1
                ok, out, tr = False, None, time.perf_counter()
            td = time.perf_counter()
            records.append(Job(ti, tr, td, ok, tracing))
            n_traced += tracing
            # a traced run ends with its traced stretch
            if n_traced >= trace_jobs or (td >= deadline and not trace):
                last, last_drawn = out, drawn
                break
            with span(tracelib.DROP):
                del out
    finally:
        gc.enable()
    t_end = records[-1].done
    window_peak = cards.peak()
    traced = None
    if prof is not None:
        window_span.__exit__(None, None, None)
        traced = tracelib.stop(prof, len(cards.cuda) or 1)

    # the work a job does, from the reference's view of its arguments
    shape = tuple(config["shape"])
    job = joblib.reference_job(traffic, last_drawn, bench)
    work_bytes = work_ops = 0
    for step in job:
        b, o = bench.work(step.op).work(shape, step.args)
        work_bytes, work_ops = work_bytes + b, work_ops + o
    ctx = Context(
        setup_s=setup_s, jobs=records, window_s=t_end - t0,
        pixels=shape[0] * shape[1], peak_bytes=window_peak, trace=traced,
        work=(work_bytes, work_ops), cards=len(devices),
        port_kernels=tracelib.port_kernels(Path(port.__file__).parent))
    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench.metrics(group, workload):
        v = bench.reader(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # correctness: the last job's outputs against the plain reference; a
    # plane it lacks leaves its numbers out, which reads as not correct
    numbers = {}
    if last is not None:
        check = bench.check(traffic.get("check", "stencil"))
        planes = planes_of(last, dem.data, job[-1].name)
        if set(check.planes(job)) <= set(planes):
            numbers = check.numbers(check.gaps(
                config, blocks, job, check.program(planes, config)))
        del planes
    del last, jobs, dem
    correct, checks = judge(numbers, limits)
    correct = correct and failed == 0 and bool(records)

    device = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(cards.cuda[0]) if on_card
        else "cpu",
        "count": len(devices),
        "memory_peak_bytes": int(max(setup_peak, window_peak)),
        "power_limit_w": peaks.power_limits() if on_card else [],
    }
    result = {"correct": bool(correct), "attempted": len(records),
              "failed": failed, "metrics": metrics, "device": device}
    if traced is not None:
        busy = [traced.busy_s(d) for d in range(traced.cards)]
        device["busy_s"] = sum(busy) / len(busy)
        device["window_s"] = traced.window_s
        result["breakdown"] = traced.breakdown()
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m gpubench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    from .spec import ROOT
    # CUDA's JIT kernel cache, at a fixed place in the checkout
    os.environ["CUDA_CACHE_PATH"] = str(ROOT / ".gpubench-cache" / "cuda")
    try:
        result = run(a.workload, a.seed, a.seconds, bool(a.trace))
    except NoCard as e:
        print(f"gpubench: {e}", file=sys.stderr)
        return 2
    except Exception:
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"gpubench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
