"""``BENCHMARK.json`` and the files it names, found by name.

Everything that belongs to one configuration, traffic mix, per-layer
metric or op sits in a file of its own under the benchmark's folder:

- ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives), the
  deployment's sizes (with ``"coords": "cell_centres"``, its raster's
  coordinates: ``dem.coords``);
- ``traffic/<traffic>.json``, the job mix the generator reads;
- ``metrics/<metric>.py``, the reader of one per-layer metric;
- ``work/<op>.py``, the bytes and operations of one op's job;
- ``reference/<op>.py``, the plain reference of one op (or of a helper
  the traffic calls by name, ``run(*args)``), in the form its check
  reads: for ``stencil``, ``planes(args)``, ``halo(args)`` and
  ``run(win, origin, shape, args, cellsize, dtype)`` on a band of rows
  with its halo; for ``chain``, ``planes(args)`` and ``run(raster,
  coords, args, dtype)`` over the whole raster, returning ``{plane:
  tensor}``;
- ``checks/<check>.py``, a way of comparing a job's outputs with the
  reference, which the traffic names: ``stencil`` (one local op, in
  bands) or ``chain`` (every step of a global job in turn, whole);
- ``limits/<workload>.json``, the limits of a cell's correctness check.

A check module has ``planes(job)``, ``gaps(config, blocks, job,
judged)``, ``numbers(per_plane)``, ``program(planes, config)`` and
``control(job, config, dtype)``; ``job`` is the judged job's steps
(``jobs.Step``: op, input, name, args as the reference sees them, and
the reference module).

A new cell is new files and one new entry; no file here changes.
"""

from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Bench:
    """The benchmark at `root` (a checkout holding ``BENCHMARK.json`` and
    the benchmark's folder)."""

    def __init__(self, root=ROOT):
        self.root = Path(root)
        self.dir = self.root / HERE.name
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)

    def _entry(self, key: str, name: str) -> dict:
        for e in self.spec[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"BENCHMARK.json has no {key} entry named {name!r}")

    def cell(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        with open(self.root / self._entry("configs", name)["file"]) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        return _json(self.dir / "traffic" / f"{name}.json")

    def limits(self, workload: str) -> dict:
        return _json(self.dir / "limits" / f"{workload}.json")

    def metrics(self, group: str, workload: str) -> list:
        """The `group` ("end_to_end" or "per_layer") metrics that
        `workload` reports: those with no ``workloads`` key and those that
        list it."""
        return [m for m in self.spec[group]
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str):
        """The per-layer metric's reader module (``read(ctx)``)."""
        return _module(self.dir / "metrics" / f"{metric}.py")

    def work(self, op: str):
        """The op's work module (``work(shape, args)``)."""
        return _module(self.dir / "work" / f"{op}.py")

    def reference(self, op: str):
        """The op's plain reference module."""
        return _module(self.dir / "reference" / f"{op}.py")

    def check(self, name: str):
        """A correctness check's module (``checks/<name>.py``)."""
        return _module(self.dir / "checks" / f"{name}.py")


def _json(path: Path) -> dict:
    if not path.is_file():
        raise KeyError(f"no file {path}")
    with open(path) as f:
        return json.load(f)


@functools.lru_cache(maxsize=None)
def _module(path: Path):
    """Load a module from its file (its name may hold dots)."""
    if not path.is_file():
        raise KeyError(f"no file {path}")
    name = f"gpubench_{path.parent.name}_{path.stem.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
