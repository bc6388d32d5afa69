"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with
throwaway cells small enough for the CPU (the port's torch twins stand in
for its kernels there)."""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
CPU = torch.device("cpu")
SMALL = (96, 130)       # a 2x2 grid of 48 x 65 blocks


def add_cell(root: Path, name: str, shape, mesh, limits="dem16k-terrain",
             traffic="terrain") -> str:
    """A configuration `name` (dem16k's recipe at `shape` on `mesh`) and a
    cell ``<name>-<traffic>`` with the limits of cell `limits`, added as
    new files and new entries; returns the cell's name."""
    cfg = json.loads((root / "gpubench/configs/dem16k.json").read_text())
    cfg.update(name=name, shape=list(shape), mesh=mesh)
    (root / f"gpubench/configs/{name}.json").write_text(json.dumps(cfg))
    cell = f"{name}-{traffic}"
    shutil.copy(root / f"gpubench/limits/{limits}.json",
                root / f"gpubench/limits/{cell}.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": name, "source": "test", "reduced": [],
                             "file": f"gpubench/configs/{name}.json",
                             "why": "a test's"})
    bench["workloads"].append({"name": cell, "config": name,
                               "traffic": traffic, "chips": 1,
                               "why": "a test's"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell


@pytest.fixture
def bench_root(tmp_path):
    """A copy of ``BENCHMARK.json`` and the benchmark's folder, with the
    cells ``tiny-terrain`` (one block) and ``tinymesh-terrain`` (2x2)."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    add_cell(tmp_path, "tiny", SMALL, None)
    add_cell(tmp_path, "tinymesh", SMALL, [2, 2])
    return tmp_path


@pytest.fixture(autouse=True)
def on_cpu():
    """Numpy rasters of the port go to the CPU in these tests."""
    import xrspatial_torch as xt
    before = xt.default_device()
    xt.set_default_device("cpu")
    yield
    xt.set_default_device(before)
