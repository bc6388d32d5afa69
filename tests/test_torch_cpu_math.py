"""The torch twins give the same bits on their first call in a process.

PyTorch sends float ``sqrt``, ``atan``, ``sin``, ``cos`` and their kin
through MKL's vector math on the CPU, split across OpenMP threads.  When
the first such call of a process came from several threads at once, one
thread could take a low-accuracy path for its chunk (errors near 3e-4
relative, 11 bits): ``test_window_stats_matches_jax[circle_r1-nan]`` (std)
and ``test_public_op_matches_jax[patches_70x300-slope]`` failed that way
as the first test of a fresh pytest worker, while the JAX package's XLA
threads were busy beside it.  ``xrspatial_torch.kernels`` now makes each
such call once on one thread when it is imported.

Here fresh interpreters, started together, each run the JAX package's
focal stats first, then the port's std, slope and great-circle key twice,
and report whether the first call's bits equal the second's.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PROCESSES = 6

SCRIPT = r"""
import hashlib, json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from xrspatial_tpu.kernels.window import window_stats as jax_window_stats

rng = np.random.default_rng(9)
data = (rng.random((70, 300)) * 50).astype(np.float32)
data[30:34, 120:135] = np.nan
offsets = ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))
np.asarray(jax_window_stats(jnp.asarray(data), offsets, ("std",))["std"])

import torch
from xrspatial_torch.kernels import jfa_rounds
from xrspatial_torch.kernels.surface import surface_multi
from xrspatial_torch.kernels.window import window_stats

x = torch.from_numpy(data)
lon = torch.linspace(-170.0, 170.0, 21000)
lat = torch.linspace(75.0, -75.0, 21000)

def run():
    outs = (window_stats(x, offsets, ("std",))["std"],
            surface_multi(x, 2.0, 3.0, 225.0, 25.0, ("slope",))["slope"],
            jfa_rounds.metric_key(lon, lon.flip(0), lat, lat * 0.5, 1))
    return [hashlib.sha256(o.numpy().tobytes()).hexdigest() for o in outs]

print(json.dumps({"first": run(), "second": run()}))
"""


def test_first_call_in_a_fresh_process_matches_later_calls():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-c", SCRIPT], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(PROCESSES)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-2000:]
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r in results:
        assert r["first"] == r["second"], r
    assert len({tuple(r["first"]) for r in results}) == 1, results
