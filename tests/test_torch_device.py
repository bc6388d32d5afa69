"""Where numpy rasters go: the package's default device.

A numpy payload goes to ``xrspatial_torch.default_device()``, which is
``cuda`` in a fresh process; a machine without a card raises and names
``set_default_device`` rather than running on the CPU.  A tensor payload
stays on its own device.  The fresh-process checks run in a subprocess,
so no other test's setting can reach them.
"""

import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import xrspatial_torch as xt
from xrspatial_torch.utils import dataarray_from, to_torch

FRESH = textwrap.dedent("""
    import numpy as np, torch
    import xrspatial_torch as xt
    assert xt.default_device().type == "cuda", xt.default_device()
    agg = xt.DataArray(np.ones((6, 7), np.float32), dims=("y", "x"),
                       attrs={"res": (1.0, 1.0)})
    if torch.cuda.is_available():
        out = xt.slope(agg).data
        assert out.device.type == "cuda", out.device
        print("ran on", out.device)
    else:
        try:
            xt.slope(agg)
        except RuntimeError as exc:
            assert "set_default_device('cpu')" in str(exc), exc
            print("raised:", exc)
        else:
            raise AssertionError("a numpy raster ran without a card")
""")


def test_fresh_process_defaults_to_the_card():
    proc = subprocess.run([sys.executable, "-c", FRESH], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith(("raised:", "ran on cuda"))


@pytest.fixture
def default_restored():
    saved = xt.default_device()
    yield
    xt.set_default_device(saved)


def test_set_default_device_moves_numpy_payloads(default_restored):
    a = xt.DataArray(np.arange(12, dtype=np.float32).reshape(3, 4))
    xt.set_default_device("cpu")
    assert xt.default_device() == torch.device("cpu")
    assert to_torch(a).device.type == "cpu"
    xt.set_default_device("cuda")
    assert xt.default_device().type == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="set_default_device"):
            to_torch(a)


def test_tensor_payload_stays_on_its_device(default_restored):
    xt.set_default_device("cuda")
    t = torch.ones((3, 4))
    a = xt.DataArray(t, dims=("y", "x"), attrs={"res": (1.0, 1.0)})
    assert to_torch(a) is t
    assert xt.slope(a).data.device.type == "cpu"


def test_dataarray_from_uses_the_default(default_restored):
    other = xt.DataArray(np.ones((2, 3), np.float32), dims=("y", "x"),
                         name="z")
    xt.set_default_device("cpu")
    assert dataarray_from(other).data.device.type == "cpu"
    assert dataarray_from(other, device="cpu").data.device.type == "cpu"
    if not torch.cuda.is_available():
        xt.set_default_device("cuda")
        with pytest.raises(RuntimeError, match="set_default_device"):
            dataarray_from(other)
