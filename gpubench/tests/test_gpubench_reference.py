"""The plain reference against NumPy loops on small rasters, NaN cells
and edges included, whole and in bands with their halo."""

import math

import numpy as np
import pytest
import torch

from gpubench.spec import Bench
from conftest import REPO

ARGS = {"surface": ["slope", "hillshade"],
        "stats_funcs": ["mean", "max", "min", "std"],
        "azimuth": 225.0, "angle_altitude": 25.0}
CELL = (10.0, 7.5)


def numpy_planes(z, footprint, cellsize, azimuth, altitude):
    """Slope, hillshade and focal stats by loops over cells."""
    h, w = z.shape
    out = {k: np.full((h, w), np.nan) for k in
           ("slope", "hillshade", "mean", "max", "min", "std")}
    gx_all, gy_all = np.gradient(z)
    az, alt = np.radians(360.0 - azimuth), np.radians(altitude)
    ky, kx = footprint.shape[0] // 2, footprint.shape[1] // 2
    for r in range(h):
        for c in range(w):
            if 0 < r < h - 1 and 0 < c < w - 1:
                a, b, cc = z[r - 1, c - 1], z[r - 1, c], z[r - 1, c + 1]
                d, f = z[r, c - 1], z[r, c + 1]
                g, hh, i = z[r + 1, c - 1], z[r + 1, c], z[r + 1, c + 1]
                dx = ((cc + 2 * f + i) - (a + 2 * d + g)) / (8 * cellsize[0])
                dy = ((g + 2 * hh + i) - (a + 2 * b + cc)) / (8 * cellsize[1])
                out["slope"][r, c] = math.degrees(math.atan(math.hypot(dx,
                                                                       dy)))
                gx, gy = gx_all[r, c], gy_all[r, c]
                sl = math.pi / 2 - math.atan(math.hypot(gx, gy))
                asp = math.atan2(-gx, gy)
                sh = math.sin(alt) * math.sin(sl) + math.cos(alt) * \
                    math.cos(sl) * math.cos(az - math.pi / 2 - asp)
                out["hillshade"][r, c] = (sh + 1) / 2
            vals = [z[r + dy, c + dx]
                    for dy in range(-ky, ky + 1) for dx in range(-kx, kx + 1)
                    if footprint[dy + ky, dx + kx]
                    and 0 <= r + dy < h and 0 <= c + dx < w
                    and not np.isnan(z[r + dy, c + dx])]
            if vals:
                v = np.array(vals)
                out["mean"][r, c] = v.mean()
                out["max"][r, c], out["min"][r, c] = v.max(), v.min()
                out["std"][r, c] = v.std()
    return out


def window(z, rows, cols):
    """z at rows x cols, NaN outside it."""
    out = torch.full((rows[1] - rows[0], cols[1] - cols[0]), math.nan,
                     dtype=torch.float64)
    a, b = max(rows[0], 0), min(rows[1], z.shape[0])
    c, d = max(cols[0], 0), min(cols[1], z.shape[1])
    out[a - rows[0]:b - rows[0], c - cols[0]:d - cols[0]] = \
        torch.from_numpy(z[a:b, c:d])
    return out


@pytest.mark.parametrize("footprint", [
    [[0, 1, 0], [1, 1, 1], [0, 1, 0]],
    [[1, 1, 1, 1, 1], [0, 1, 1, 1, 0], [0, 0, 1, 0, 0]]])
def test_the_reference_equals_numpy_loops(footprint):
    ref = Bench(REPO).reference("terrain_pipeline")
    rng = np.random.default_rng(4)
    z = 300 + np.cumsum(rng.normal(0, 3, (23, 31)), axis=1)
    z[5, 7] = z[0, 12] = z[22, 30] = np.nan
    fp = np.array(footprint)
    args = dict(ARGS, kernel=torch.tensor(fp))
    want = numpy_planes(z, fp, CELL, 225.0, 25.0)
    ry, rx = ref.halo(args)
    for r0, r1 in ((0, 23), (0, 9), (9, 17), (17, 23)):
        win = window(z, (r0 - ry, r1 + ry), (-rx, 31 + rx))
        got = ref.run(win, (r0, 0), z.shape, args, CELL)
        assert list(got) == ["slope", "hillshade", "mean", "max", "min",
                             "std"]
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), want[k][r0:r1], rtol=1e-12,
                                       atol=1e-12, equal_nan=True, err_msg=k)


def test_the_circle_footprint_is_the_ellipse_of_the_radius():
    circle = Bench(REPO).reference("circle_kernel").run
    assert circle(1, 1, 1.5).int().tolist() == [[0, 1, 0], [1, 1, 1],
                                                  [0, 1, 0]]
    k = circle(10, 10, 25)
    assert k.shape == (5, 5) and int(k.sum()) == 13 and bool(k[2, 0])
    assert circle(10, 20, 45).shape == (5, 9)


def test_the_lower_precision_reference_is_far_off():
    ref = Bench(REPO).reference("terrain_pipeline")
    rng = np.random.default_rng(1)
    z = 1000 + rng.normal(0, 2, (40, 40))
    args = dict(ARGS, kernel=torch.tensor([[0, 1, 0], [1, 1, 1],
                                           [0, 1, 0]]))
    win = window(z, (-1, 41), (-1, 41))
    exact = ref.run(win, (0, 0), z.shape, args, CELL)
    low = ref.run(win, (0, 0), z.shape, args, CELL, torch.bfloat16)
    for k in exact:
        gap = np.nanmax(np.abs(low[k].double().numpy() - exact[k].numpy()))
        assert gap > 1e-4 * np.nanmax(np.abs(exact[k].numpy())), k
