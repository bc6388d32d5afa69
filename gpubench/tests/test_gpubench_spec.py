"""Every cell finds its files by name, and a cell, configuration, traffic
mix and per-layer metric are added as new files and entries alone."""

import hashlib
import json

import pytest
from conftest import CPU, REPO, add_cell

from gpubench import jobs as joblib
from gpubench import run
from gpubench.spec import Bench

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_files(cell):
    bench = Bench(REPO)
    w = bench.cell(cell)
    config = bench.config(w["config"])
    assert config["name"] == w["config"] and len(config["shape"]) == 2
    traffic = bench.traffic(w["traffic"])
    assert traffic["steps"]
    limits = bench.limits(cell)
    assert limits["nan_mismatch"] == 0
    for group in ("end_to_end", "per_layer"):
        for m in bench.metrics(group, cell):
            assert callable(bench.reader(m["name"]).read)
    check = bench.check(traffic.get("check", "stencil"))
    for step in traffic["steps"]:
        op = step["op"].rpartition(".")[2]
        ref = bench.reference(op)
        args = joblib.reference_args(step.get("args", {}), bench)
        assert set(limits) >= {f"{p}_err" for p in ref.planes(args)}
        assert bench.work(op).work(config["shape"], args)[0] > 0
    assert callable(check.gaps)


def test_a_metric_a_workload_lists_is_reported_only_there():
    bench = Bench(REPO)
    names = [m["name"] for m in bench.metrics("per_layer", "dem16k-terrain")]
    assert "mesh.copy_ms" not in names and "kernels.roofline_pct" in names
    assert "mesh.copy_ms" in [m["name"] for m in bench.metrics(
        "per_layer", "dem64k-mesh2x2-terrain")]


def test_an_unknown_name_is_refused():
    bench = Bench(REPO)
    for find in (lambda: bench.cell("no-such-cell"),
                 lambda: bench.traffic("no-such-traffic"),
                 lambda: bench.reader("no.such_metric")):
        with pytest.raises(KeyError):
            find()


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "gpubench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_is_added_by_new_files_and_one_entry(bench_root):
    before = _digests(bench_root)
    # a traffic mix (slope and the focal mean alone), a per-layer metric
    # and a configuration, each a new file; one entry each in the spec
    (bench_root / "gpubench/traffic/slopemean.json").write_text(json.dumps(
        {"warmup_jobs": 1, "trace_jobs": 3, "check": "stencil",
         "steps": [{"op": "terrain_pipeline", "input": "dem",
                    "args": {"surface": ["slope"],
                             "stats_funcs": ["mean", "max", "min", "std"],
                             "kernel": {"$call": "convolution.circle_kernel",
                                        "args": [1, 1, 1.5]}}}]}))
    (bench_root / "gpubench/metrics/extra.jobs_traced.py").write_text(
        "def read(ctx):\n"
        "    return sum(j.traced for j in ctx.jobs) or None\n")
    cell = add_cell(bench_root, "extra", (40, 52), None,
                    traffic="slopemean")
    lim = bench_root / f"gpubench/limits/{cell}.json"
    limits = json.loads(lim.read_text())
    del limits["hillshade_err"]
    lim.write_text(json.dumps(limits))
    spec = json.loads((bench_root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "extra.jobs_traced", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "api", "moves": "mpix_s",
                              "workloads": [cell]})
    (bench_root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digests(bench_root)
    assert {k: v for k, v in after.items() if k in before} == before

    traced = run.run(cell, 11, 0.3, True, root=bench_root, devices=[CPU])
    assert traced["correct"], traced["checks"]
    assert traced["metrics"]["extra.jobs_traced"]["value"] >= 1
    assert set(traced["checks"]) == set(limits)
    plain = run.run(cell, 12, 0.3, False, root=bench_root, devices=[CPU])
    assert set(plain["metrics"]) == {"setup_s", "mpix_s", "job_ms_p95",
                                     "peak_gib"}
