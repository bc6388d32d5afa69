"""The general job generator: a traffic file's steps as calls into the port.

A traffic file (``traffic/<name>.json``) describes one job as steps::

    {"steps": [{"op": "terrain_pipeline", "input": "dem",
                "args": {"kernel": {"$call": "convolution.circle_kernel",
                                    "args": [1, 1, 1.5]}}}], ...}

Each step calls the port's function ``op`` (``a.b`` is function ``b`` of
the port's module ``a``) with the raster named by ``input`` first and
``args`` as keywords; its result takes the step's ``name`` (default
``out``) and later steps may name it.  An argument is a JSON value or:

- ``{"$call": "mod.fn", "args": [...]}``: the port's function, called once
  at set-up (a footprint, a table); the reference calls its own
  ``reference/<fn>.py`` instead;
- ``{"$uniform": [lo, hi]}``: a float in [lo, hi), drawn for each job
  from the run's seed (an observer's place, say).

The job's result is the last step's.  Every job draws its steps' args
in step order from one ``random.Random(seed)`` (``draw_job``), so a
check that draws with the same seed draws what the program's first job
did.
"""

from __future__ import annotations

import importlib
import json
import random
from dataclasses import dataclass


def port_function(port: str, name: str):
    """The port's function `name` ("fn" or "module.fn")."""
    mod, _, fn = name.rpartition(".")
    return getattr(importlib.import_module(port + ("." + mod if mod else "")),
                   fn)


def _is(value, key) -> bool:
    return isinstance(value, dict) and key in value


def _key(value) -> str:
    return json.dumps(value, sort_keys=True)


def resolve(value, call):
    """`value` with each ``$call`` replaced by ``call(name, args)``."""
    if _is(value, "$call"):
        return call(value["$call"], [resolve(a, call)
                                     for a in value.get("args", [])])
    if isinstance(value, dict):
        return {k: resolve(v, call) for k, v in value.items()}
    if isinstance(value, list):
        return [resolve(v, call) for v in value]
    return value


def draw(value, rng: random.Random):
    """`value` with each per-job draw made from `rng`."""
    if _is(value, "$uniform"):
        return rng.uniform(*value["$uniform"])
    if isinstance(value, dict) and not _is(value, "$call"):
        return {k: draw(v, rng) for k, v in value.items()}
    if isinstance(value, list):
        return [draw(v, rng) for v in value]
    return value


def draw_job(traffic: dict, rng: random.Random) -> list:
    """Each step's arguments for one job, its draws made from `rng` in
    step order."""
    return [draw(s.get("args", {}), rng) for s in traffic["steps"]]


class Jobs:
    """The jobs of a traffic mix, as calls into the port `port`."""

    def __init__(self, traffic: dict, inputs: dict, seed: int,
                 port: str = "xrspatial_torch"):
        self.inputs = dict(inputs)
        self.rng = random.Random(int(seed))
        self.traffic = traffic
        self.steps = [(port_function(port, s["op"]), s.get("input"),
                       s.get("args", {}), s.get("name", "out"))
                      for s in traffic["steps"]]
        # every $call is made once, here
        self.made = {}

        def call(name, args):
            k = _key([name, args])
            if k not in self.made:
                self.made[k] = port_function(port, name)(*args)
            return self.made[k]
        self._call = call
        for _, _, args, _ in self.steps:
            resolve(args, call)

    def draw(self) -> list:
        """Each step's arguments for the next job, its draws made."""
        return draw_job(self.traffic, self.rng)

    def prepare(self, drawn: list) -> list:
        """`drawn` with each ``$call`` made."""
        return [resolve(args, self._call) for args in drawn]

    def run(self, prepared: list):
        """Run one job with the arguments `prepared` (from ``prepare``)."""
        env = dict(self.inputs)
        out = None
        for (fn, inp, _, name), args in zip(self.steps, prepared):
            out = fn(*([env[inp]] if inp else []), **args)
            env[name] = out
        return out


def reference_args(args, bench):
    """A step's drawn arguments for the reference: each ``$call`` made by
    ``reference/<fn>.py``."""
    return resolve(args, lambda name, a: bench.reference(
        name.rpartition(".")[2]).run(*a))


@dataclass
class Step:
    """One step of a judged job as the reference sees it."""
    op: str             # the port's function's own name ("a.b" -> "b")
    input: object       # the name of the raster it takes, or None
    name: str           # the name its result takes
    args: dict          # its drawn arguments, each $call the reference's
    reference: object   # the module reference/<op>.py


def reference_job(traffic: dict, drawn: list, bench) -> list:
    """The job whose steps' arguments are `drawn` (from ``draw_job``), as
    ``Step``s for a check."""
    out = []
    for s, args in zip(traffic["steps"], drawn):
        op = s["op"].rpartition(".")[2]
        out.append(Step(op, s.get("input"), s.get("name", "out"),
                        reference_args(args, bench), bench.reference(op)))
    return out
