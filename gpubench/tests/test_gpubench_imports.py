"""Nothing the benchmark loads is JAX, the JAX package or the old
benchmark (whole top-level names: the port's name begins with the JAX
package's); the references load nothing of the port."""

import json
import subprocess
import sys

from conftest import REPO

RUN_A_CELL = r"""
import json, sys, torch
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
import xrspatial_torch as xt
xt.set_default_device("cpu")
from conftest import add_cell
from pathlib import Path
import shutil
root = Path({root!r})
shutil.copy(Path({repo!r}) / "BENCHMARK.json", root)
shutil.copytree(Path({repo!r}) / "gpubench", root / "gpubench",
                ignore=shutil.ignore_patterns("tests", "__pycache__"))
cell = add_cell(root, "tinymesh", (40, 44), [2, 2])
from gpubench import calibrate, run
r = run.run(cell, 5, 0.2, True, root=root, devices=[torch.device("cpu")] * 4)
calibrate.readings(cell, [1], [2], root=root,
                   devices=[torch.device("cpu")] * 4)
assert r["correct"], r
print(json.dumps(sorted(sys.modules)))
"""

REFERENCES_ONLY = r"""
import json, sys
sys.path.insert(0, {repo!r})
from gpubench.spec import Bench
b = Bench({repo!r})
for op in ("terrain_pipeline", "circle_kernel"):
    b.reference(op)
b.work("terrain_pipeline")
b.check("stencil")
b.check("chain")
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code):
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def _tops(mods):
    return {m.split(".")[0] for m in mods}


def test_a_run_loads_no_jax_nor_the_jax_package(tmp_path):
    mods = _modules(RUN_A_CELL.format(repo=str(REPO), root=str(tmp_path),
                                      tests=str(REPO / "gpubench/tests")))
    tops = _tops(mods)
    assert "xrspatial_torch" in tops         # the port ran
    assert not tops & {"jax", "jaxlib", "flax", "xrspatial_tpu",
                       "benchmarks", "bench"}


def test_the_references_load_nothing_of_the_port():
    tops = _tops(_modules(REFERENCES_ONLY.format(repo=str(REPO))))
    assert not tops & {"xrspatial_torch", "xrspatial_tpu", "jax", "jaxlib",
                       "flax"}
