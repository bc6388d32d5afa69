"""The ops the JAX package leaves to GSPMD, on a mesh of CPU devices.

Meshes of ``torch.device("cpu")`` repeated: 2x2 and 1x4, on a raster that
divides both (40x48) and one that neither splits evenly (41x38: 2x2
replicates y, 1x4 replicates x, and the blocks cut it into uneven
tiles).  Each op on a raster split over the mesh is held to the port's
unsharded call on the same numpy raster, and its result must lie on the
same mesh (trim and crop return the kept window as one tensor, as the
JAX package returns it unsharded; the host functions ``combine``,
``zonal_apply``, ``polygonize``, ``maximum_breaks``' break search and
``zonal_stats``' custom callables gather the raster with a
``UserWarning``).

Tolerances: bit for bit (NaN where NaN), except
- ``zonal_stats``' sum, mean, var and std: rtol 1e-12 (the blocks' float64
  sums are added in another order; count, min, max and majority equal);
- the breaks of ``std_mean`` and ``head_tail_breaks``: rtol 1e-6 (their
  means come from the blocks' float64 partial sums, the unsharded call
  sums in float32), the classes equal except at cells within that of a
  break.

A last test holds each op to the JAX package's call on a raster sharded
over its 2x2 mesh of virtual CPU devices, at the tolerance the op's own
parity test uses (``tests/test_torch_multispectral.py`` and the others).
"""

import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import xrspatial_torch as xt
from xrspatial_torch import classify as tclassify
from xrspatial_torch import local as tlocal
from xrspatial_torch import multispectral as tms
from xrspatial_torch.parallel import (distribute, get_raster_mesh,
                                      make_raster_mesh)
from xrspatial_torch.xrlib import DataArray, Dataset

CPU = torch.device("cpu")
MESHES = [(2, 2), (1, 4)]
SHAPES = [(40, 48), (41, 38)]
SUM_RTOL = 1e-12
ZONAL_STATS = ["mean", "max", "min", "sum", "std", "var", "count", "majority"]
BREAK_RTOL = 1e-6

tpoly = importlib.import_module("xrspatial_torch.experimental.polygonize")


@pytest.fixture(autouse=True)
def numpy_rasters_on_the_cpu():
    saved = xt.default_device()
    xt.set_default_device("cpu")
    yield
    xt.set_default_device(saved)


def cpu_mesh(ny, nx):
    return make_raster_mesh(ny, nx, devices=[CPU] * (ny * nx))


@pytest.fixture(params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def mesh(request):
    return cpu_mesh(*request.param)


def coords_of(shape, lonlat=False):
    h, w = shape
    if lonlat:
        return {"y": np.linspace(41.0, 40.0, h), "x": np.linspace(-100, -99, w)}
    return {"y": np.arange(h, dtype=np.float64)[::-1] * 2.0,
            "x": np.arange(w, dtype=np.float64)}


def raster(data, coords=None):
    return DataArray(torch.from_numpy(np.array(data)), dims=("y", "x"),
                     coords=coords or coords_of(data.shape), name="dem",
                     attrs={"res": (1.0, 2.0)})


def sharded(data, mesh, coords=None):
    agg = raster(data, coords)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # a replicated axis
        agg.data = distribute(agg.data, mesh)
    return agg


def elevation(shape, seed, nan=True):
    rng = np.random.default_rng(seed)
    data = (rng.random(shape) * 100).astype(np.float32)
    if nan:
        data[shape[0] // 3, shape[1] // 4] = np.nan
        data[0, -1] = np.inf
    return data


def zones_of(data):
    return np.nan_to_num(np.floor(data / 20), nan=-1, posinf=9).astype(
        np.int64)


def gathered(out, mesh):
    data = out.data if isinstance(out, DataArray) else out
    assert get_raster_mesh(data) is mesh
    return data.gather()


def assert_same(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


# -- multispectral ---------------------------------------------------------------

BANDS = {"arvi": ("nir", "red", "blue"), "evi": ("nir", "red", "blue"),
         "gci": ("nir", "green"), "nbr": ("nir", "swir2"),
         "nbr2": ("swir1", "swir2"), "ndvi": ("nir", "red"),
         "ndmi": ("nir", "swir1"), "savi": ("nir", "red"),
         "sipi": ("nir", "red", "blue"), "ebbi": ("red", "swir", "tir")}


def bands(shape, names, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for k, n in enumerate(names):
        b = (rng.random(shape) * 4000).astype(np.float32)
        b[k, k] = 0.0
        b[-1, k] = np.nan
        out[n] = b
    return out


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("index", list(BANDS))
def test_multispectral_indices_per_block(index, shape, mesh):
    values = bands(shape, BANDS[index], 1)
    fn = getattr(tms, index)
    ref = fn(*(raster(values[n]) for n in BANDS[index])).data
    out = fn(*(sharded(values[n], mesh) for n in BANDS[index]))
    assert_same(gathered(out, mesh), ref)


def test_an_index_of_a_split_and_a_whole_band(mesh):
    """A band on one device joins the split one's mesh by distribute."""
    values = bands((40, 48), ("nir", "red"), 2)
    ref = xt.ndvi(raster(values["nir"]), raster(values["red"])).data
    out = xt.ndvi(sharded(values["nir"], mesh), raster(values["red"]))
    assert_same(gathered(out, mesh), ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_true_color_takes_the_blocks_extremes(shape, mesh):
    """(y, x, band) blocks on the mesh, each band normalised by its min and
    max over the blocks: the unsharded (y, x, band) composite, alpha
    last."""
    values = bands(shape, ("r", "g", "b"), 3)
    ref = tms.true_color(*(raster(values[n]) for n in "rgb"))
    out = tms.true_color(*(sharded(values[n], mesh) for n in "rgb"))
    assert out.dims == ref.dims == ("y", "x", "band")
    assert out.shape == ref.shape
    assert_same(gathered(out, mesh), ref.data)
    assert_same(out.data[2:9, 3:30][..., 3], ref.data[2:9, 3:30, 3])


# -- local -------------------------------------------------------------------------

def dataset(shape, seed, mesh=None):
    rng = np.random.default_rng(seed)
    names = ("a", "b", "c", "ref")
    vals = {k: np.round(rng.random(shape) * 4).astype(np.float32)
            for k in names}
    vals["a"][1, 2] = np.nan
    vals["ref"][3, 3] = np.nan
    vals["ref"][4, 4] = -2.0
    make = (lambda v: sharded(v, mesh)) if mesh is not None else raster
    return Dataset({k: make(v) for k, v in vals.items()})


LOCAL = {
    **{f"cell_stats_{f}": (lambda ds, f=f: tlocal.cell_stats(
        ds, ["a", "b", "c"], func=f)) for f in tlocal._FUNCS},
    "lesser_frequency": lambda ds: tlocal.lesser_frequency(ds, "ref"),
    "equal_frequency": lambda ds: tlocal.equal_frequency(ds, "ref"),
    "greater_frequency": lambda ds: tlocal.greater_frequency(ds, "ref"),
    "lowest_position": lambda ds: tlocal.lowest_position(ds, ["a", "b", "c"]),
    "highest_position": lambda ds: tlocal.highest_position(ds, ["a", "b", "c"]),
    "popularity": lambda ds: tlocal.popularity(ds, "ref"),
    "rank": lambda ds: tlocal.rank(ds, "ref"),
}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", list(LOCAL))
def test_local_functions_per_block(name, shape, mesh):
    ref = LOCAL[name](dataset(shape, 4)).data
    out = LOCAL[name](dataset(shape, 4, mesh))
    assert_same(gathered(out, mesh), ref)


def test_combine_warns_and_gathers(mesh):
    ref = tlocal.combine(dataset((40, 48), 5))
    with pytest.warns(UserWarning, match="combine.*HOST"):
        out = tlocal.combine(dataset((40, 48), 5, mesh))
    assert_same(out.data, ref.data)
    assert out.attrs["key"] == ref.attrs["key"]


# -- classify ----------------------------------------------------------------------

CLASSIFY = {
    "binary": lambda a: xt.binary(a, [10.0, 20.0]),
    "reclassify": lambda a: xt.reclassify(a, [10.0, 50.0, 90.0],
                                          [1.0, 2.0, 3.0]),
    "equal_interval": lambda a: xt.equal_interval(a, k=6),
    "natural_breaks": lambda a: xt.natural_breaks(a, num_sample=500, k=4),
    "natural_breaks_all": lambda a: xt.natural_breaks(a, num_sample=None,
                                                      k=3),
}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", list(CLASSIFY))
def test_classifiers_on_a_mesh(name, shape, mesh):
    data = elevation(shape, 6)
    ref = CLASSIFY[name](raster(data)).data
    out = CLASSIFY[name](sharded(data, mesh))
    assert_same(gathered(out, mesh), ref)


def test_maximum_breaks_warns_and_bins_on_the_blocks(mesh):
    data = elevation((40, 48), 7)
    ref = xt.maximum_breaks(raster(data)).data
    with pytest.warns(UserWarning, match="maximum_breaks.*HOST"):
        out = xt.maximum_breaks(sharded(data, mesh))
    assert_same(gathered(out, mesh), ref)


def breaks_of(call, agg, monkeypatch):
    """(classes, the breaks ``_bin`` was given) of a classifier's call."""
    seen = []
    real = tclassify._bin

    def spy(data, bins, new_values):
        seen.append(np.asarray(bins, dtype=np.float64))
        return real(data, bins, new_values)
    monkeypatch.setattr(tclassify, "_bin", spy)
    out = call(agg)
    monkeypatch.setattr(tclassify, "_bin", real)
    return out, seen[0]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["std_mean", "head_tail_breaks"])
def test_mean_breaks_from_block_sums(name, shape, mesh, monkeypatch):
    data = elevation(shape, 8)
    data[5:9, 5:9] += 400.0                      # a heavy tail
    call = getattr(xt, name)
    ref, ref_bins = breaks_of(call, raster(data), monkeypatch)
    out, bins = breaks_of(call, sharded(data, mesh), monkeypatch)
    np.testing.assert_allclose(bins, ref_bins, rtol=BREAK_RTOL)
    got = gathered(out, mesh).numpy()
    near = np.zeros(data.shape, dtype=bool)
    with np.errstate(invalid="ignore"):
        for b in ref_bins:
            near |= np.abs(data - b) <= BREAK_RTOL * abs(b)
    np.testing.assert_array_equal(got[~near], ref.data.numpy()[~near])


# -- zonal -------------------------------------------------------------------------

def frames_close(got, ref):
    assert list(got.columns) == list(ref.columns)
    for col in ref.columns:
        if col in ("sum", "mean", "var", "std"):
            np.testing.assert_allclose(got[col], ref[col], rtol=SUM_RTOL,
                                       equal_nan=True)
        else:
            np.testing.assert_array_equal(got[col], ref[col])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kw", [{}, dict(nodata_values=0.0),
                                dict(zone_ids=[1, 3, 7]),
                                dict(stats_funcs=["majority", "count"])],
                         ids=["default", "nodata", "zone_ids", "majority"])
def test_zonal_stats_on_a_mesh(kw, shape, mesh):
    data = elevation(shape, 9)
    data[2:6, 2:6] = 0.0
    data[10:12, :] = np.round(data[10:12, :] / 10) * 10   # repeated values
    zones = zones_of(data)
    stats = list(kw.get("stats_funcs", ZONAL_STATS))
    kw = dict(kw, stats_funcs=stats)
    ref = xt.zonal_stats(raster(zones), raster(data), **kw)
    got = xt.zonal_stats(sharded(zones, mesh), sharded(data, mesh), **kw)
    frames_close(got, ref)


def test_zonal_stats_float_zones_and_the_dataarray_return(mesh):
    data = elevation((41, 38), 10)
    zones = np.floor(data / 25)
    zones[4, 4] = np.nan
    kw = dict(stats_funcs=["mean", "max", "count"],
              return_type="xarray.DataArray")
    ref = xt.zonal_stats(raster(zones), raster(data), **kw)
    out = xt.zonal_stats(sharded(zones, mesh), sharded(data, mesh), **kw)
    assert out.dims == ref.dims
    np.testing.assert_allclose(gathered(out, mesh).numpy(),
                               ref.data.numpy(), rtol=SUM_RTOL,
                               equal_nan=True)


def test_zonal_stats_custom_functions_warn_and_gather(mesh):
    data = elevation((40, 48), 11)
    zones = zones_of(data)
    kw = dict(stats_funcs={"top": np.max, "n": len})
    ref = xt.zonal_stats(raster(zones), raster(data), **kw)
    with pytest.warns(UserWarning, match="custom stats_funcs.*HOST"):
        got = xt.zonal_stats(sharded(zones, mesh), sharded(data, mesh), **kw)
    pd.testing.assert_frame_equal(got, ref)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("agg", ["count", "percentage"])
def test_zonal_crosstab_counts_per_block(agg, shape, mesh):
    data = elevation(shape, 12)
    zones = zones_of(data)
    cats = np.round(np.nan_to_num(data, nan=0.0, posinf=0.0) / 30)
    ref = xt.zonal_crosstab(raster(zones), raster(cats), agg=agg,
                            nodata_values=1.0)
    got = xt.zonal_crosstab(sharded(zones, mesh), sharded(cats, mesh),
                            agg=agg, nodata_values=1.0)
    pd.testing.assert_frame_equal(got, ref)


def test_zonal_crosstab_of_3d_values(mesh):
    rng = np.random.default_rng(13)
    zones = rng.integers(0, 4, (40, 48))
    cube = (rng.random((3, 40, 48)) * 10).astype(np.float32)

    def values(data):
        return DataArray(data, dims=("band", "y", "x"),
                         coords={"band": [10, 20, 30]})
    whole = values(torch.from_numpy(cube))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        split = values(distribute(torch.from_numpy(cube), mesh))
    for agg in ("mean", "sum", "max", "count"):
        ref = xt.zonal_crosstab(raster(zones), whole, agg=agg)
        got = xt.zonal_crosstab(sharded(zones, mesh), split, agg=agg)
        for col in ref.columns:
            np.testing.assert_allclose(got[col], ref[col], rtol=SUM_RTOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_trim_and_crop_find_their_bounds_per_block(shape, mesh):
    data = elevation(shape, 14, nan=False)
    data[:3, :] = 0.0
    data[:, -5:] = 0.0
    data[-2:, :] = np.nan
    for call in (lambda a: xt.trim(a, values=(0.0,)),
                 lambda a: xt.trim(a, values=(0.0, 1e9)),
                 lambda a: xt.crop(a, a, [float(data[7, 9])]),
                 lambda a: xt.trim(a, values=(-1.0,))):
        ref = call(raster(data))
        out = call(sharded(data, mesh))
        assert isinstance(out.data, torch.Tensor)
        assert_same(out.data, ref.data)
        for d in ("y", "x"):
            np.testing.assert_array_equal(out[d].data, ref[d].data)
    every = np.zeros(shape, np.float32)
    assert xt.trim(sharded(every, mesh), values=(0.0,)).shape == (0, 0)


def test_zonal_apply_warns_and_gathers(mesh):
    data = elevation((40, 48), 15)
    zones = zones_of(data)
    ref_vals, vals = raster(data), sharded(data, mesh)
    xt.zonal_apply(raster(zones), ref_vals, lambda v: v * 2.0, nodata=1)
    with pytest.warns(UserWarning, match="zonal_apply.*HOST"):
        xt.zonal_apply(sharded(zones, mesh), vals, lambda v: v * 2.0,
                       nodata=1)
    assert_same(gathered(vals, mesh), ref_vals.data)


def asymmetric_pairs(n, seed):
    """n float32 pairs (c, b), c < b, where b takes c's label and c does
    not take b's: the connectivity test is not symmetric."""
    f32 = np.float32
    rng = np.random.default_rng(seed)
    c = (rng.random(400_000) * 900 + 10).astype(f32)
    rhs_c = f32(1e-8) + f32(1e-5) * c
    b = (c + rhs_c).astype(f32)
    for _ in range(3):
        b = np.where(b - c <= rhs_c, np.nextafter(b, f32(np.inf)), b)
    asym = (b - c > rhs_c) & (b - c <= f32(1e-8) + f32(1e-5) * b)
    return c[asym][:n], b[asym][:n]


def seam_raster(shape, seed, pairs=True):
    """Quantised values, a snake of equal cells that crosses every seam
    many times, with `pairs` one-way near-tolerance pairs placed across
    the seams of a 2x2 and a 1x4 mesh, and NaN cells."""
    rng = np.random.default_rng(seed)
    h, w = shape
    data = np.round(rng.random(shape) * 3).astype(np.float32) * 100.0 + 50.0
    snake = np.zeros(shape, dtype=bool)
    for r in range(1, h - 1, 4):
        snake[r, 1:w - 1] = True
        c = w - 2 if (r // 4) % 2 == 0 else 1
        snake[r:r + 4, c] = True
    data[snake] = 7.0
    cs, bs = asymmetric_pairs(16 if pairs else 0, seed)
    my, mx = -(-h // 2), -(-w // 2)
    for i, (c, b) in enumerate(zip(cs, bs)):
        if i % 2:     # across a vertical seam
            col = (mx, -(-w // 4), 3 * -(-w // 4))[i % 3] - 1
            data[2 + 2 * i % (h - 2), col:col + 2] = (c, b) if i % 4 == 1 \
                else (b, c)
        else:         # across the horizontal seam
            data[my - 1:my + 1, 3 + 3 * i % (w - 3)] = (c, b) if i % 4 \
                else (b, c)
    data[rng.integers(0, h, 5), rng.integers(0, w, 5)] = np.nan
    return data


@pytest.mark.parametrize("one_way", [True, False],
                         ids=["one_way", "both_ways"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("neighborhood", [4, 8])
def test_regions_merge_across_the_seams(neighborhood, shape, one_way, mesh,
                                        monkeypatch):
    """One-way pairs across the seams take the rounds of per-block
    propagation; a raster whose connections all hold both ways (the
    snake and the quantised values alone) the union of the blocks'
    components."""
    tzonal = importlib.import_module("xrspatial_torch.zonal")
    data = seam_raster(shape, sum(shape) + neighborhood, pairs=one_way)
    ran = []
    for name in ("_propagated_labels", "_merged_labels"):
        real = getattr(tzonal, name)
        monkeypatch.setattr(tzonal, name, lambda *a, real=real, name=name:
                            ran.append(name) or real(*a))
    ref = xt.regions(raster(data), neighborhood=neighborhood)
    out = xt.regions(sharded(data, mesh), neighborhood=neighborhood)
    assert ran == ["_propagated_labels" if one_way else "_merged_labels"]
    assert out.dims == ref.dims and out.name == ref.name
    assert_same(gathered(out, mesh), ref.data)


# -- the stencils with coordinates or a long halo ----------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fn", ["slope", "aspect"])
def test_geodesic_on_a_mesh(fn, shape, mesh):
    data = elevation(shape, 16, nan=False) * 30
    data[shape[0] // 2, 5] = np.nan
    coords = coords_of(shape, lonlat=True)
    call = getattr(xt, fn)
    ref = call(raster(data, coords), method="geodesic").data
    out = call(sharded(data, mesh, coords), method="geodesic")
    assert_same(gathered(out, mesh), ref)


def test_geodesic_on_a_mesh_with_2d_coordinates(mesh):
    h, w = 40, 48
    lat = np.linspace(41.0, 40.0, h)[:, None] + np.zeros((1, w))
    lon = np.linspace(-100, -99, w)[None, :] + 0.001 * np.arange(h)[:, None]
    coords = {"lat": (("y", "x"), lat), "lon": (("y", "x"), lon)}
    data = elevation((h, w), 17, nan=False) * 30

    def agg(payload):
        return DataArray(payload, dims=("y", "x"), coords=coords)
    ref = xt.slope(agg(torch.from_numpy(data)), method="geodesic").data
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        split = agg(distribute(torch.from_numpy(data), mesh))
    out = xt.slope(split, method="geodesic")
    assert_same(gathered(out, mesh), ref)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sun", [(225, 25), (90, 10), (330, 45)])
def test_hillshade_shadows_on_a_mesh(sun, shape, mesh):
    """The march's halo covers these rasters, so run_stencil warns."""
    data = elevation(shape, 18, nan=False) * 5
    data[10:14, 10:14] += 300.0
    data[-1, 3] = np.nan
    kw = dict(azimuth=sun[0], angle_altitude=sun[1], shadows=True)
    ref = xt.hillshade(raster(data), **kw).data
    with pytest.warns(UserWarning, match="covers the whole raster"):
        out = xt.hillshade(sharded(data, mesh), **kw)
    assert_same(gathered(out, mesh), ref)


def test_polygonize_warns_and_gathers(mesh):
    data = np.floor(elevation((40, 48), 19, nan=False) / 30).astype(
        np.int32)
    ref = tpoly.polygonize(raster(data))
    with pytest.warns(UserWarning, match="polygonize.*HOST"):
        got = tpoly.polygonize(sharded(data, mesh))
    assert got[0] == ref[0]
    for a, b in zip(got[1], ref[1]):
        assert len(a) == len(b)
        for ra, rb in zip(a, b):
            np.testing.assert_array_equal(ra, rb)


# -- against the JAX package's sharded calls ----------------------------------------

def jax_sharded(data, coords=None):
    from xrspatial_tpu.parallel import distribute as jax_distribute
    from xrspatial_tpu.parallel import make_raster_mesh as jax_mesh
    from xrspatial_tpu.xrlib import DataArray as JaxDataArray
    agg = JaxDataArray(data, dims=("y", "x"),
                       coords=coords or coords_of(data.shape), name="dem",
                       attrs={"res": (1.0, 2.0)})
    agg.data = jax_distribute(jnp.asarray(data), jax_mesh(2, 2))
    return agg


JAX_DATA = elevation((32, 32), 20, nan=False)
JAX_ZONES = zones_of(JAX_DATA).astype(np.int32)
# (call, comparison): "equal", an rtol, or "frame"
JAX_CASES = {
    "ndvi": (lambda m, a, z: m.ndvi(a, a), 1e-5),
    # uint8 within 1, alpha and the (y, x, band) layout exactly
    "true_color": (lambda m, a, z: importlib.import_module(
        m.__name__ + ".multispectral").true_color(a, a, a),
        "uint8"),
    "binary": (lambda m, a, z: m.binary(a, [50.0]), "equal"),
    "equal_interval": (lambda m, a, z: m.equal_interval(a), "equal"),
    "std_mean": (lambda m, a, z: m.std_mean(a), "equal"),
    "head_tail_breaks": (lambda m, a, z: m.head_tail_breaks(a), "equal"),
    "natural_breaks": (lambda m, a, z: m.natural_breaks(a, num_sample=300),
                       "equal"),
    "maximum_breaks": (lambda m, a, z: m.maximum_breaks(a), "equal"),
    "regions": (lambda m, a, z: m.regions(z), "equal"),
    "zonal_stats": (lambda m, a, z: m.zonal_stats(
        z, a, stats_funcs=["count", "min", "max", "sum", "mean"]), "frame"),
    "zonal_crosstab": (lambda m, a, z: m.zonal_crosstab(z, z), "frame"),
    "trim": (lambda m, a, z: m.trim(a, values=(0.0,)), "equal"),
    "hillshade_shadows": (lambda m, a, z: m.hillshade(a, shadows=True),
                          1e-6),
}


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_matches_the_jax_package_on_a_mesh(name):
    import xrspatial_tpu as xj
    call, tol = JAX_CASES[name]
    m = cpu_mesh(2, 2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        ref = call(xj, jax_sharded(JAX_DATA), jax_sharded(JAX_ZONES))
        got = call(xt, sharded(JAX_DATA, m), sharded(JAX_ZONES, m))
    if tol == "frame":
        for col in ref.columns:
            np.testing.assert_allclose(got[col].astype(float),
                                       ref[col].astype(float), rtol=1e-6)
        return
    data = got.data
    g = (data if isinstance(data, torch.Tensor) else data.gather()).numpy()
    r = np.asarray(ref.data)
    assert got.dims == ref.dims and g.shape == r.shape
    if tol == "equal":
        np.testing.assert_array_equal(g, r)
    elif tol == "uint8":
        assert g.dtype == r.dtype == np.uint8
        assert np.abs(g.astype(int) - r.astype(int)).max() <= 1
        np.testing.assert_array_equal(g[..., 3], r[..., 3])
    else:
        np.testing.assert_allclose(g, r, rtol=tol, atol=tol, equal_nan=True)


def test_geodesic_slope_matches_the_jax_package_on_a_mesh():
    from xrspatial_tpu import slope as jax_slope
    coords = coords_of((32, 32), lonlat=True)
    data = JAX_DATA * 30
    ref = np.asarray(jax_slope(jax_sharded(data, coords),
                               method="geodesic").data)
    m = cpu_mesh(2, 2)
    got = gathered(xt.slope(sharded(data, m, coords), method="geodesic"),
                   m).numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - ref.view(np.int32).astype(np.int64))
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert (ulps[~np.isnan(ref)] <= 1).all()
