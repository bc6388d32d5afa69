"""A run with the timed path broken underneath comes out not correct:
an answer altered where it is made, half of the raster left out, a job
that hands back its input unchanged, the exchange between blocks left
out."""

import pytest
import torch
from conftest import CPU

import xrspatial_torch.analytics as analytics
import xrspatial_torch.parallel.halo as halo
from gpubench import run


def blocks_of(x):
    return [b for row in x.blocks for b in row] if hasattr(x, "blocks") \
        else [x]


def altered(surface_kernels):
    def wrapped(data, which, *a, **k):
        out = surface_kernels(data, which, *a, **k)
        b = blocks_of(out[which[0]])[-1]
        b[b.shape[0] // 2, b.shape[1] // 2] += 5.0      # degrees of slope
        return out
    return wrapped


def half_left_out(surface_kernels):
    def wrapped(data, which, *a, **k):
        out = surface_kernels(data, which, *a, **k)
        for p in which:
            for b in blocks_of(out[p]):
                h = b.shape[0] // 2
                b[h:2 * h] = b[:h].clone()
        return out
    return wrapped


def unchanged(surface_kernels):
    def wrapped(data, which, *a, **k):
        out = surface_kernels(data, which, *a, **k)
        for p in which:
            for b, d in zip(blocks_of(out[p]), blocks_of(data)):
                b.copy_(d)
        return out
    return wrapped


def no_exchange(bands):
    """The in-place route's bands with every cell that comes from another
    block left as fill: the row band's halo rows (its first and last ry)
    and its halo columns (rx each side of the tile's), the column band's
    halo columns (its first rx and [5 rx, 6 rx))."""
    def wrapped(x, spec, fill):
        grid = bands(x, spec, fill)
        ry, rx = spec.ry, spec.rx
        for i, row in enumerate(grid):
            for j, (rows, cols) in enumerate(row):
                wl = x.blocks[i][j].shape[-1]
                if rows is not None:
                    rows[..., :ry, :] = fill
                    rows[..., 7 * ry:, :] = fill
                    rows[..., :, :rx] = fill
                    rows[..., :, rx + wl:2 * rx + wl] = fill
                if cols is not None:
                    cols[..., :rx] = fill
                    cols[..., 5 * rx:6 * rx] = fill
        return grid
    return wrapped


@pytest.mark.parametrize("cell,devices", [("tiny-terrain", [CPU]),
                                          ("tinymesh-terrain", [CPU] * 4)])
@pytest.mark.parametrize("fault", [altered, half_left_out, unchanged])
def test_a_broken_job_is_not_correct(bench_root, monkeypatch, cell, devices,
                                     fault):
    monkeypatch.setattr(analytics, "surface_kernels",
                        fault(analytics.surface_kernels))
    r = run.run(cell, 9, 0.2, False, root=bench_root, devices=devices)
    assert r["correct"] is False


def test_a_mesh_without_its_exchange_is_not_correct(bench_root, monkeypatch):
    monkeypatch.setattr(halo, "_bands", no_exchange(halo._bands))
    r = run.run("tinymesh-terrain", 9, 0.2, False, root=bench_root,
                devices=[CPU] * 4)
    assert r["correct"] is False
    assert r["checks"]["nan_mismatch"]["value"] > 0


def test_the_unbroken_runs_are_correct(bench_root):
    for cell, devices in (("tiny-terrain", [CPU]),
                          ("tinymesh-terrain", [CPU] * 4)):
        r = run.run(cell, 9, 0.2, False, root=bench_root, devices=devices)
        assert r["correct"] is True, r["checks"]
        assert torch.get_default_dtype() == torch.float32
