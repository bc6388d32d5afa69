"""Parity of the torch port's host modules with the JAX package (CPU):
the bundled datasets, the command line, ``esri`` and the rest of
``utils`` (projection, image helpers, backend predicates).

The sentinel-2 band files are copies of the JAX package's, byte for byte
(their hashes are compared), and load to the same values, names,
coordinates and attrs.  The CLI's commands give the JAX package's output,
but ``info``, which reports torch and the cards where the JAX one reports
jax.  ``esri`` runs against a fake ``requests`` module: no network.  Every
comparison is exact.
"""

import hashlib
import importlib
import sys
import types
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import xrspatial_torch as xt
from xrspatial_torch import utils as TU
from xrspatial_tpu import utils as JU

TD = importlib.import_module("xrspatial_torch.datasets")
JD = importlib.import_module("xrspatial_tpu.datasets")
TE = importlib.import_module("xrspatial_torch.esri")
JE = importlib.import_module("xrspatial_tpu.esri")
TM = importlib.import_module("xrspatial_torch.__main__")
JM = importlib.import_module("xrspatial_tpu.__main__")


@pytest.fixture(autouse=True)
def numpy_rasters_on_the_cpu():
    saved = xt.default_device()
    xt.set_default_device("cpu")
    yield
    xt.set_default_device(saved)


def digests(folder):
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(Path(folder).glob("*.npz"))}


def test_band_files_are_the_jax_packages():
    port = digests(Path(TD._module_path) / "sentinel-2")
    assert len(port) == 6
    assert port == digests(Path(JD._module_path) / "sentinel-2")


def test_get_data_matches_jax():
    assert TD.available_datasets == JD.available_datasets == ["sentinel-2"]
    got, ref = TD.get_data("sentinel-2"), JD.get_data("sentinel-2")
    assert list(got) == list(ref)
    for name in ref:
        a, b = got[name], ref[name]
        assert isinstance(a.data, torch.Tensor)
        assert a.data.device.type == "cpu"
        np.testing.assert_array_equal(a.values, np.asarray(b.data))
        assert a.values.dtype == np.asarray(b.data).dtype
        assert a.name == b.name == name and a.dims == b.dims
        assert a.attrs == b.attrs
        for c in ("x", "y"):
            np.testing.assert_array_equal(a[c].values, np.asarray(b[c].data))


def test_get_data_unknown_raises_as_jax():
    with pytest.raises(ValueError) as jax_err:
        JD.get_data("landsat-99")
    with pytest.raises(ValueError) as err:
        TD.get_data("landsat-99")
    assert str(err.value) == str(jax_err.value)


def test_bands_feed_the_ports_ndvi():
    data = TD.get_data("sentinel-2")
    out = xt.ndvi(data["NIR"], data["Red"]).values
    assert np.isfinite(out).all() and (out > 0.4).mean() > 0.05


# -- the command line -------------------------------------------------------------

@pytest.mark.parametrize("args", [["examples"], ["bogus"]])
def test_cli_matches_jax(args, capsys):
    rc = JM.main(args)
    ref = capsys.readouterr().out
    assert TM.main(args) == rc
    assert capsys.readouterr().out == ref


def test_cli_fetch_data(tmp_path, capsys):
    assert TM.main(["fetch-data", str(tmp_path / "d")]) == 0
    assert f"-> {tmp_path / 'd' / 'sentinel-2'}" in capsys.readouterr().out
    assert digests(tmp_path / "d" / "sentinel-2") == \
        digests(Path(JD._module_path) / "sentinel-2")


def test_cli_info_reports_torch(capsys):
    assert TM.main(["info"]) == 0
    out = capsys.readouterr().out
    assert "xrspatial_torch 0.1.0" in out
    assert f"torch {torch.__version__}" in out and "jax" not in out
    assert f"available={torch.cuda.is_available()}" in out
    assert TM.main([]) == 0   # info is the default


# -- esri ---------------------------------------------------------------------------

class FakeRequests:
    """A stand-in for ``requests``: ``post`` answers from a table of object
    ids and features and records every call."""

    def __init__(self, n_features, ids=True):
        self.calls = []
        self.n = n_features
        self.ids = ids

    def post(self, url, data):
        self.calls.append((url, dict(data)))
        if data["returnIdsOnly"]:
            body = {"objectIds": list(range(self.n)) if self.ids else None}
        else:
            wanted = [int(i) for i in data["objectIds"].split(",")]
            body = {"features": [{"attributes": {"OBJECTID": i,
                                                 "v": i * 1.5}}
                                 for i in wanted],
                    "fieldAliases": {"v": "Value"}}
        return types.SimpleNamespace(json=lambda: body,
                                     raise_for_status=lambda: None)


@pytest.mark.parametrize("n,ids", [(7, True), (0, True), (3, False)])
def test_query_layer_matches_jax(monkeypatch, n, ids):
    results = []
    for mod in (JE, TE):
        fake = FakeRequests(n, ids)
        monkeypatch.setitem(sys.modules, "requests", fake)
        fs = mod.query_layer("https://example.invalid/layer/0", "1=1",
                             chunkSize=3)
        df = mod.query_to_dataframe("https://example.invalid/layer/0",
                                    "1=1", chunkSize=3)
        results.append((fs, df, fake.calls))
    (fs_j, df_j, calls_j), (fs_t, df_t, calls_t) = results
    assert fs_t == fs_j and calls_t == calls_j
    pd.testing.assert_frame_equal(df_t, df_j)
    if n and ids:
        assert list(df_t.columns) == ["OBJECTID", "Value"]
        assert len(df_t) == n


def test_featureset_and_chunker_match_jax():
    fs = {"features": [{"attributes": {"id": 1, "v": 10.0}},
                       {"attributes": {"id": 2, "v": 20.0}}],
          "fieldAliases": {"v": "value"}}
    for kw in ({}, {"use_aliases": True}):
        pd.testing.assert_frame_equal(TE.featureset_to_dataframe(fs, **kw),
                                      JE.featureset_to_dataframe(fs, **kw))
    assert [list(c) for c in TE.chunker(list(range(5)), 2)] == \
        [list(c) for c in JE.chunker(list(range(5)), 2)]


def test_esri_imports_requests_only_inside_query_layer():
    src = Path(TE.__file__).read_text()
    assert "import pandas as pd" in src
    head = src.split("def query_layer")[0]
    assert "requests" not in head.split('"""', 2)[2]


# -- the rest of utils -------------------------------------------------------------

def test_backend_predicates_answer_for_torch():
    for name in ("has_cuda_and_cupy", "has_dask_array",
                 "has_dask_dataframe"):
        assert getattr(TU, name)() is getattr(JU, name)() is False
    assert TU.is_cupy_array(torch.zeros(3)) is False
    assert TU.is_cupy_backed(xt.DataArray(torch.zeros(3))) is False
    assert TU.is_dask_cupy(None) is False
    for fn in (TU.cuda_args, TU.calc_cuda_dims):
        with pytest.raises(NotImplementedError):
            fn((4, 4))
    with pytest.raises(NotImplementedError, match="nope"):
        TU.not_implemented_func(None, messages="nope")


def test_projection_helpers_match_jax():
    lon, lat = [-120.5, 0.0, 7.25], [45.0, 0.0, -33.3]
    for a, b in zip(TU.lnglat_to_meters(lon, lat),
                    JU.lnglat_to_meters(lon, lat)):
        np.testing.assert_array_equal(a, b)
    assert TU.lnglat_to_meters(10.0, 20.0) == JU.lnglat_to_meters(10.0, 20.0)
    args = (800, (0.0, 250.0), (-40.0, 60.0))
    assert TU.height_implied_by_aspect_ratio(*args) == \
        JU.height_implied_by_aspect_ratio(*args)


@pytest.mark.parametrize("tensor", [False, True])
def test_image_helpers_match_jax(tensor):
    from xrspatial_tpu.xrlib import DataArray as JaxDataArray
    r = np.array([[10.0, np.nan], [1.0, 200.0]])
    g = np.full((2, 2), 20.0)
    b = np.full((2, 2), 30.7)
    bands = [torch.from_numpy(v) if tensor else v for v in (r, g, b)]
    got = TU.bands_to_img(*bands, nodata=1)
    ref = JU.bands_to_img(r, g, b, nodata=1)
    np.testing.assert_array_equal(got.values, np.asarray(ref.data))
    assert got.values.dtype == np.uint32 and got.name == "image"
    cats = np.array([[1, 2], [3, 1]])
    key = {1: "red", 2: "#00ff00", 3: (0, 0, 255)}
    got = TU.color_values(xt.DataArray(torch.from_numpy(cats) if tensor
                                       else cats, dims=("y", "x")), key,
                          alpha=128)
    ref = JU.color_values(JaxDataArray(cats, dims=("y", "x")), key,
                          alpha=128)
    np.testing.assert_array_equal(got.values, np.asarray(ref.data))
    with pytest.raises(ValueError, match="convert color"):
        TU.color_values(cats, {1: "no-such-colour"})
