"""A run end to end on the CPU (the look for a card skipped): the last
line's keys, and the runs that must fail instead of printing a result."""

import json
import shutil
import subprocess
import sys

import pytest
from conftest import CPU, REPO

from gpubench import run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell,devices", [("tiny-terrain", [CPU]),
                                          ("tinymesh-terrain", [CPU] * 4)])
@pytest.mark.parametrize("trace", [False, True])
def test_the_result_has_exactly_the_contracts_keys(bench_root, cell, devices,
                                                   trace):
    r = run.run(cell, 2 ** 40 + 3, 0.3, trace, root=bench_root,
                devices=devices)
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(r) == want                       # checks come last
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    dev = r["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes",
            "power_limit_w"} <= set(dev)
    assert dev["count"] == len(devices)
    if trace:
        assert dev["window_s"] > 0 and "busy_s" in dev
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(r["metrics"]) == {"setup_s", "mpix_s", "job_ms_p95",
                                     "peak_gib"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(r)


def _cli(cwd):
    return subprocess.run(
        [sys.executable, "-m", "gpubench", "--workload", "dem16k-terrain",
         "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300)


def test_a_run_with_no_card_fails_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    p = _cli(REPO)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_a_run_without_the_port_fails_and_prints_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(tmp_path)
    assert p.returncode != 0 and p.stdout == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("jaxfoo", "xrspatial_tpu_extra", "benchmarks2"):
        monkeypatch.setitem(sys.modules, name, object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "xrspatial_tpu", object())
    assert run.forbidden_modules() == ["jax.numpy", "xrspatial_tpu"]


def test_numbers_over_their_limits_are_not_correct():
    ok, checks = run.judge({"a": 0.0, "b": 2e-6}, {"a": 0, "b": 1e-6})
    assert not ok and checks["b"] == {"value": 2e-6, "limit": 1e-6}
    ok, checks = run.judge({"a": 0.0}, {"a": 0, "b": 1e-6})
    assert not ok and checks["b"]["value"] == float("inf")
    assert run.judge({"a": 0.0, "b": 1e-7}, {"a": 0, "b": 1e-6})[0]
