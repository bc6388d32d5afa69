"""Example datasets and terrain synthesis helpers.

Counterpart of ``xrspatial_tpu/datasets/__init__.py``.  The bundled
sentinel-2 bands (``sentinel-2/*.npz``, byte for byte the JAX package's
files) load as DataArrays on the default device; ``make_terrain`` is the
reference's multi-octave fBm terrain on the perlin lattice path
(``perlin.octave_tables`` on the host, ``octave_eval`` on the device),
accumulated in float64 as in the JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..perlin import octave_eval, octave_tables
from ..terrain import carve_octave, pack_octaves
from ..utils import _payload_device
from ..xrlib import DataArray

__all__ = ["available_datasets", "get_data", "make_terrain"]

_module_path = os.path.dirname(os.path.abspath(__file__))
_available_datasets = [p for p in next(os.walk(_module_path))[1]
                       if not p.startswith("__")]
available_datasets = _available_datasets
available = available_datasets


def get_data(dataset):
    """Open example multispectral band data by dataset name.

    Loads every ``.npz`` band file in the dataset folder (keys ``data``,
    ``name`` and optionally the ``y``/``x`` coordinates and ``res``); each
    band's tensor goes to the default device.
    """
    data = {}
    if dataset not in _available_datasets:
        raise ValueError(
            f'The dataset {dataset} is not available. '
            f'Available folders are {available_datasets}.')
    dev = _payload_device(None)
    folder_path = os.path.abspath(os.path.join(_module_path, dataset))
    for band_file in sorted(next(os.walk(folder_path))[2]):
        path = os.path.join(folder_path, band_file)
        if band_file.endswith(".npz"):
            with np.load(path) as f:
                arr = DataArray(torch.from_numpy(np.array(f["data"])).to(dev),
                                dims=("y", "x"), name=str(f["name"]))
                if "y" in f and "x" in f:
                    arr["y"] = f["y"]
                    arr["x"] = f["x"]
                if "res" in f:
                    res = f["res"]
                    arr.attrs["res"] = (float(res[0]), float(res[1]))
                data[str(f["name"])] = arr
    return data


def make_terrain(shape=(1024, 1024), scale=100.0, octaves=6,
                 persistence=0.5, lacunarity=2.0, chunks=None) -> DataArray:
    """Generate pseudo-random fBm terrain on the default device.

    Parameters mirror the reference (scale/octaves/persistence/
    lacunarity); `chunks` is accepted for API compatibility and ignored.
    """
    h, w = shape
    ys = np.arange(h, dtype=np.float32) / scale
    xs = np.arange(w, dtype=np.float32) / scale

    octs, weights = [], []
    amplitude, frequency = 1.0, 1.0
    for i in range(octaves):
        octs.append(octave_tables(42 + i, xs * np.float32(frequency),
                                  ys * np.float32(frequency)))
        weights.append(amplitude)
        amplitude *= persistence
        frequency *= lacunarity
    tables, idx, frac, plan = pack_octaves(octs)

    dev = _payload_device(None)
    tables, idx, frac = (torch.from_numpy(a).to(dev)
                         for a in (tables, idx, frac))
    # each octave scaled in float32 (the JAX package's weak-typed weight),
    # summed in float64
    acc = torch.zeros((h, w), dtype=torch.float64, device=dev)
    for entry, weight in zip(plan, weights):
        val = octave_eval(*carve_octave(tables, idx, frac, entry))
        acc += val.mul_(float(np.float32(weight)))
    out = DataArray(acc.to(torch.float32), name="terrain", dims=("y", "x"),
                    attrs={"res": 1})
    out["y"] = np.linspace(0, 500, h, endpoint=False) + 250.0 / h
    out["x"] = np.linspace(0, 500, w, endpoint=False) + 250.0 / w
    return out
