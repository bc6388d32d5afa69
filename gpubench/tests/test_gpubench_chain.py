"""A global job of several steps on a georeferenced DEM, as data files
alone: a configuration with ``coords`` gives the port a DEM with cell
centres in metres; every step of the judged job reaches the check and
the control, its draws as the program made them; ``checks/chain.py``
runs the steps' references in turn over the whole raster.  The toy job:
the cells above a drawn contour (``classify.reclassify``), then the
distance to them (``proximity``), its references plain torch written
here, proximity by brute force.  And the terrain cells' check numbers
are the parent's, bit for bit."""

import json
import random

import numpy as np
import pytest
import torch
from conftest import CPU, SMALL, add_cell

import xrspatial_torch as xt
from gpubench import calibrate, run
from gpubench import dem as demlib
from gpubench import jobs as joblib
from gpubench.spec import Bench

CONTOUR = {"warmup_jobs": 1, "trace_jobs": 3, "check": "chain", "steps": [
    {"op": "classify.reclassify", "input": "dem", "name": "above",
     "args": {"bins": [{"$uniform": [400.0, 600.0]}, float("inf")],
              "new_values": [0, 1]}},
    {"op": "proximity", "input": "above", "name": "dist",
     "args": {"target_values": [1]}}]}

RECLASSIFY = '''
import torch


def planes(args):
    return ["reclassify"]


def run(raster, coords, args, dtype=torch.float64):
    """Class i where bins[i-1] < z <= bins[i], the bins in float32."""
    z = raster.to(dtype)
    bins = [float(torch.tensor(b, dtype=torch.float32)) for b in args["bins"]]
    out = torch.full_like(z, float("nan"))
    for b, v in reversed(list(zip(bins, args["new_values"]))):
        out = torch.where(torch.isfinite(z) & (z <= b), float(v), out)
    return {"reclassify": out}
'''

PROXIMITY = '''
import torch


def planes(args):
    return ["proximity"]


def run(raster, coords, args, dtype=torch.float64):
    """The Euclidean distance in metres from each cell centre to the
    nearest target cell, over every pair."""
    y, x = (c.to(dtype) for c in coords)
    hit = torch.zeros(raster.shape, dtype=torch.bool, device=raster.device)
    for v in args["target_values"]:
        hit |= raster == v
    ty = y[:, None].expand(raster.shape)[hit]
    tx = x[None, :].expand(raster.shape)[hit]
    rows = []
    for r in range(raster.shape[0]):
        d2 = (x[:, None] - tx[None, :]) ** 2 + (y[r] - ty[None, :]) ** 2
        rows.append(torch.sqrt(d2.min(dim=1).values))
    return {"proximity": torch.stack(rows)}
'''

WORK = '''
def work(shape, args):
    cells = int(shape[0]) * int(shape[1])
    return 8 * cells, cells
'''


def add_chain_cell(root, name, mesh, coords="cell_centres"):
    """A configuration `name` (SMALL, with `coords`) and its cell
    ``<name>-contour`` on the toy traffic, its references, work files and
    limits: new files and entries alone."""
    d = root / "gpubench"
    (d / "traffic/contour.json").write_text(json.dumps(CONTOUR))
    for op, src in (("reclassify", RECLASSIFY), ("proximity", PROXIMITY)):
        (d / f"reference/{op}.py").write_text(src)
        (d / f"work/{op}.py").write_text(WORK)
    cell = add_cell(root, name, SMALL, mesh, traffic="contour")
    cfg_path = d / f"configs/{name}.json"
    cfg = json.loads(cfg_path.read_text())
    if coords is None:
        cfg.pop("coords", None)
    else:
        cfg["coords"] = coords
    cfg_path.write_text(json.dumps(cfg))
    (d / f"limits/{cell}.json").write_text(json.dumps(
        {"nan_mismatch": 0, "dist_err": 1e-5}))
    return cell


CELLS = [("tinysites", None, [CPU]), ("tinysitesmesh", [2, 2], [CPU] * 4)]


@pytest.mark.parametrize("name,mesh,devices", CELLS)
def test_a_configuration_with_coords_gives_cell_centres(bench_root, name,
                                                        mesh, devices):
    add_chain_cell(bench_root, name, mesh)
    bench = Bench(bench_root)
    config = bench.config(name)
    blocks = demlib.make_blocks(config, 3, devices)
    dem = run.dem_input(xt, config, blocks, devices)
    ny, nx = SMALL
    y = np.asarray(dem.coords["y"].values)
    x = np.asarray(dem.coords["x"].values)
    assert y.dtype == x.dtype == np.float64
    assert y.shape == (ny,) and x.shape == (nx,)
    # north up: y from the north edge southward, x eastward, 10 m cells
    assert y[0] == (ny - 0.5) * 10.0 and y[-1] == 5.0
    assert x[0] == 5.0 and x[-1] == (nx - 0.5) * 10.0
    assert np.all(np.diff(y) == -10.0) and np.all(np.diff(x) == 10.0)
    tiny = bench.config("tiny")
    plain = run.dem_input(xt, tiny, demlib.make_blocks(tiny, 3, [CPU]),
                          [CPU])
    assert "y" not in plain.coords and "x" not in plain.coords


def test_only_cell_centres_are_known():
    assert demlib.coords({"shape": [2, 3], "cellsize_m": [1, 1]}) is None
    with pytest.raises(ValueError):
        demlib.coords({"shape": [2, 3], "cellsize_m": [1, 1],
                       "coords": "corners"})


@pytest.mark.parametrize("name,mesh,devices", CELLS)
def test_a_two_step_job_is_correct(bench_root, name, mesh, devices):
    cell = add_chain_cell(bench_root, name, mesh)
    r = run.run(cell, 2 ** 35 + 17, 0.3, False, root=bench_root,
                devices=devices)
    assert r["correct"] is True, r["checks"]
    assert list(r["checks"]) == ["nan_mismatch", "dist_err"]
    assert r["checks"]["dist_err"]["value"] < 1e-6


def test_the_unnamed_result_takes_its_steps_name():
    a = xt.DataArray(torch.zeros(2, 3), dims=("y", "x"))
    b = xt.DataArray(torch.zeros(2, 3), dims=("y", "x"), name="dem-slope")
    assert list(run.planes_of(a, None, "dist")) == ["dist"]
    assert list(run.planes_of(b, None, "dist")) == ["slope"]


@pytest.mark.parametrize("name,mesh,devices", CELLS)
def test_a_job_whose_check_sees_another_draw_is_not_correct(
        bench_root, monkeypatch, name, mesh, devices):
    """The check's step 1 draws a contour 20 m above the program's."""
    cell = add_chain_cell(bench_root, name, mesh)
    real = joblib.reference_job

    def shifted(traffic, drawn, bench):
        drawn = [dict(a) for a in drawn]
        drawn[0]["bins"] = [drawn[0]["bins"][0] + 20.0] + \
            drawn[0]["bins"][1:]
        return real(traffic, drawn, bench)
    monkeypatch.setattr(joblib, "reference_job", shifted)
    r = run.run(cell, 2 ** 35 + 17, 0.3, False, root=bench_root,
                devices=devices)
    assert r["correct"] is False
    assert r["checks"]["dist_err"]["value"] > 1e-5


@pytest.mark.parametrize("name,mesh,devices", CELLS)
def test_an_answer_altered_where_it_is_made_is_not_correct(
        bench_root, monkeypatch, name, mesh, devices):
    cell = add_chain_cell(bench_root, name, mesh)
    real = xt.proximity

    def altered(raster, **kw):
        out = real(raster, **kw)
        b = out.data.blocks[-1][-1] if hasattr(out.data, "blocks") \
            else out.data
        b[b.shape[0] // 2, b.shape[1] // 2] += 10.0     # metres
        return out
    monkeypatch.setattr(xt, "proximity", altered)
    r = run.run(cell, 77, 0.3, False, root=bench_root, devices=devices)
    assert r["correct"] is False


def test_a_step_with_many_planes_may_only_end_the_chain():
    from gpubench.checks import chain

    class Two:
        @staticmethod
        def run(raster, coords, args, dtype):
            return {"a": raster, "b": raster}

    job = [joblib.Step("two", "dem", "s", {}, Two),
           joblib.Step("two", "s", "t", {}, Two)]
    with pytest.raises(ValueError):
        chain.run_chain(job, torch.zeros(2, 2), None, torch.float64)
    assert set(chain.run_chain(job[:1], torch.zeros(2, 2), None,
                               torch.float64)) == {"a", "b"}


def test_a_chain_that_does_not_fit_the_card_is_refused(monkeypatch):
    """A 16384^2 chain of three steps holds 10 float64 planes, 20 GiB:
    refused where the card has less free, counting what torch's
    allocator holds unused."""
    from gpubench.checks import chain
    gib = 2 ** 30
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d: (12 * gib, 80 * gib))
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: 2 * gib)
    config = {"shape": [16384, 16384]}
    job = [None] * 3
    card = torch.device("cuda", 0)
    for reserved in (2 * gib, 9 * gib):
        monkeypatch.setattr(torch.cuda, "memory_reserved",
                            lambda d, r=reserved: r)
        with pytest.raises(MemoryError):
            chain.fits(config, job, card)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d: 10 * gib)
    chain.fits(config, job, card)
    chain.fits(dict(config, shape=[2 ** 20, 2 ** 20]), job, CPU)


def test_the_control_draws_the_programs_contour(bench_root, monkeypatch):
    """Per seed the check of the program's first job and the control see
    the same step-1 draw; the control fails the limits, the program
    passes them."""
    cell = add_chain_cell(bench_root, "tinysites", None)
    seen = []
    real = joblib.reference_job

    def recorded(traffic, drawn, bench):
        seen.append(drawn[0]["bins"][0])
        return real(traffic, drawn, bench)
    monkeypatch.setattr(joblib, "reference_job", recorded)
    seeds = [5, 2 ** 40 + 3]
    r = calibrate.readings(cell, seeds, seeds, root=bench_root,
                           devices=[CPU])
    assert seen[:2] == seen[2:]
    assert seen[:2] == [joblib.Jobs(CONTOUR, {}, s).draw()[0]["bins"][0]
                        for s in seeds]
    assert seen[:2] == [joblib.draw_job(CONTOUR, random.Random(s))[0]
                        ["bins"][0] for s in seeds]
    assert len(set(seen[:2])) == 2 and all(400 <= c < 600 for c in seen)
    lim = json.loads((bench_root / f"gpubench/limits/{cell}.json")
                     .read_text())
    for numbers in r["program"].values():
        assert run.judge(numbers, lim)[0], numbers
    for numbers in r["control"].values():
        assert not run.judge(numbers, lim)[0], numbers


# the parent tree's check numbers of the terrain cells (``calibrate
# .readings`` on program seeds 5 and 2**40 + 3 and control seed 6, and a
# run on seed 2**40 + 3, whose last job is its first: terrain draws
# nothing), on the CPU
PARENT = {
    "tiny-terrain": {
        "program": {
            5: [0.0, 3.915691302608118e-06, 1.3714344837791255e-07,
                1.0905743841678276e-07, 0.0, 0.0, 7.541414218514896e-08],
            2 ** 40 + 3: [0.0, 2.1311298837790745e-06,
                          1.489564245141592e-07, 1.2095437403855635e-07,
                          0.0, 0.0, 7.323769972936407e-08]},
        "control": {
            6: [0.0, 0.16252344505991714, 0.13223299925035292,
                0.0077038905778400975, 0.0019722173964707764,
                0.0020017255053481685, 0.10877298497992322]}},
    "tinymesh-terrain": {
        "program": {
            5: [0.0, 2.2134039808616323e-06, 1.3559324463285008e-07,
                1.0903567364626172e-07, 0.0, 0.0, 7.046921011054148e-08],
            2 ** 40 + 3: [0.0, 2.685984246264585e-06,
                          1.3372820978516117e-07, 1.2098910675787197e-07,
                          0.0, 0.0, 8.720907723091674e-08]},
        "control": {
            6: [0.0, 0.17349878528436577, 0.23696853830756623,
                0.007676877510692842, 0.0019688718652779436,
                0.0019980929706395183, 0.08377829702460762]}}}
NUMBERS = ["nan_mismatch", "slope_err", "hillshade_err", "mean_err",
           "max_err", "min_err", "std_err"]


@pytest.mark.parametrize("cell,devices", [("tiny-terrain", [CPU]),
                                          ("tinymesh-terrain", [CPU] * 4)])
def test_the_terrain_cells_check_numbers_are_the_parents(bench_root, cell,
                                                         devices):
    want = PARENT[cell]
    r = calibrate.readings(cell, list(want["program"]),
                           list(want["control"]), root=bench_root,
                           devices=devices)
    for side in ("program", "control"):
        for seed, values in want[side].items():
            assert r[side][seed] == dict(zip(NUMBERS, values)), (side, seed)
    checks = run.run(cell, 2 ** 40 + 3, 0.2, False, root=bench_root,
                     devices=devices)["checks"]
    assert {k: c["value"] for k, c in checks.items()} == \
        dict(zip(NUMBERS, want["program"][2 ** 40 + 3]))
