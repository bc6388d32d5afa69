#!/usr/bin/env python3
"""Drive the xrspatial_torch port once on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: torch/CUDA versions, the card's name and power limit;
2. build: ``nvcc`` compiles ``xrspatial_torch/csrc/*.cu`` (build time and
   ``-Xptxas -v`` register/spill lines are printed);
3. kernels: each CUDA kernel against its torch twin, on the card, at small
   and ragged shapes with NaN patches and +-inf cells; the focal kernel
   (B2) on its staged route also against its first port by name, bit for
   bit; the surface kernel (B1) on its staged routes against its first
   port by name, bit for bit, at every product mask (each product, slope
   + hillshade, all four), with flat cells (aspect -1), from an aligned
   base and from one 4 bytes off (TMA and cp.async, each launch counted
   on the route its plan names), at every tile, at the small shapes, a
   thin 300x70 and an aligned ragged 263x516;
4. main path: ``terrain_pipeline`` on a 16384^2 float32 DEM on the card,
   the call users make; one launch of each kernel and no other, the
   surface and focal kernels each on its staged TMA route, outputs on the
   card, exact NaN ring, full-size agreement with the twins;
5. timing (informational): warm ``terrain_pipeline`` and each kernel
   against its twin, from CUDA events; then B2's staged route against its
   first port by name, bit for bit, at 16384^2 on the plus (also with a
   nodata cell in every tile), a 3x3, the 1x513 row (rx = 256) and the
   65x1 column (ry = 32), each launch counted on the TMA route; the staged
   route, its first port and B5's staged kernel by name (the yardstick
   leg) timed in turns on the plus, the other footprints' routes in turns;
   B1's staged kernel at each tile against its first port by name at
   16384^2, bit for bit, on TMA, and all of them timed in turns;
6. jump-flood rounds: the CUDA round kernel against its twins over whole
   stride schedules, at small and ragged shapes, for each state form and
   metric, with and without a value channel, including a raster with no
   target, on the routes ``kernels/jfa_plan.py::round_plan`` names and on
   each route by name (staged, vector, simple; simple where the route
   cannot take a stride): bit for bit, great circle within rtol 1e-4;
   every route launched at least once;
7. proximity path: ``proximity``, ``allocation`` and ``direction`` on the
   16384^2 DEM's targets (``dem > 900``, about 2% of the cells), the calls
   users make; exactly 16 round launches per call, counted by route
   (``cuda_jfa.STAGED_LAUNCHES``/``VECTOR_LAUNCHES``/``SIMPLE_LAUNCHES``)
   as the plan names them, and no twin call, full-size agreement with the
   twin path, and exhaustive search on 1024 sampled cells;
8. timing (informational): warm proximity, allocation and direction; the
   round kernel's schedule on the plan against its twin's, and against
   the first port (simple by name) in turns; one round of every stride on
   every route that can take it, in turns (the per-stride table), with
   the strides where the plan's route is slower than simple;
9. halo and pipeline kernels vs twins: the large-footprint focal kernel
   (annulus 40/38, 1x601, 67x1, an irregular mask and a sparse footprint
   of radius 500) on the route its plan names against the ring route
   called by name, bit for bit, and against ``window_stats``, each launch
   counted on its route (TMA, cp.async and the ring each at least once);
   the fused pipeline kernel (B4) on the route its plan names against its
   first port by name and the split kernels (staged B1 + staged B2), bit
   for bit, and its twin, on the plus, a radius-2 circle, a 3x3, a 1x3
   row and a 3x1 column (radii clamped to 1) and the fused gate's largest
   footprint, 65x129 (bits only: the twin takes the conv path), from an
   aligned base and one 4 bytes off, each launch counted on its route; at
   the small shapes, a thin 300x70 and an aligned ragged 263x516;
10. fused path: ``terrain_pipeline`` with ``XRSPATIAL_FUSED_PIPELINE=1``
   at 16384^2: one pipeline launch, on its TMA route, and no other, exact
   NaN ring, equal to the split path at every cell; fused and split timed
   in turns; B4's staged route against its first port by name, bit for
   bit, and the staged route, the first port and the split kernels timed
   in turns;
11. annulus focal path: ``focal_stats`` over the 512-offset annulus at
   16384^2: one halo launch, on the TMA route, and no other, agreement
   with the twin path and the ring route; on the DEM with a nodata cell
   in every tile, which no block reads as NaN-free, the TMA route against
   the ring route, bit for bit; the staged halo kernel (on both DEMs),
   its ring route by name, the focal kernel's first port by name on the
   same footprint and the twin timed in turns;
12. torch-op paths under PyTorch's default TF32 flags: the conv path
   (1257 offsets), ``convolution_2d``, ``hotspots`` and 2-pass ``mean``
   on the card against the CPU at 1024^2; the conv path timed at 16384^2;
13. interval-screen kernel vs twin: the exact viewshed's pair evaluation,
   float32 level 1 and float64 level 2, on the same expanded stacks, on
   the culled route (the default) and the first port by name, each bit
   for bit in hi and lo, with the culled route's pre-pass equal to its
   twin, at 48x64, a corner 64x48, 96x112 with NaN cells, 300x70, a ragged
   257x1025 and the 1024^2 plan of the next phase;
14. exact viewshed path: ``viewshed`` on ``gaussian_bump(1024, 1024)`` at
   the JAX bench's viewpoint, the call users make; one float32 screen
   launch, one float64 launch per level-2 slab, each on the culled route
   after its pre-pass, and no twin call; equal at every cell to the
   float64-only route, and on a 256^2 crop to the pairwise oracle;
15. timing (informational): the viewshed's warm wall time and phases; at
   the 1024^2 plan the screen's culled route (with its pre-pass), the
   pre-pass alone, the first port by name and the twin in turns, and the
   culled route's counts (pairs evaluated, (warp, chunk) pairs culled,
   chunks staged), from which its bound is counted; every re-evaluation
   route forced through the module's thresholds;
16. stacked surface kernel B0 vs its first port, the surface kernel and
   the twin: plane k = ``which[k]`` for all four products, ("hillshade",
   "slope") and one product with and without squeeze, on the route
   ``stacked_plan`` names (TMA, or phased where TMA refuses), on the
   phased route and the first port by name, at the small shapes, odd
   H * W (257x1025), an aligned ragged 263x516 and 40x119, from an
   aligned base and one 4 bytes off: every route equal to the surface
   kernel bit for bit, within the surface tolerance of the twin, each
   launch counted on its route (``cuda_surface.STACKED_TMA_LAUNCHES``,
   ``STACKED_PHASED_LAUNCHES``, ``STACKED_SIMPLE_LAUNCHES``);
17. surface family path: ``surface_stacked`` with all four products on
   the 16384^2 DEM, the stacked entry users call: one stacked launch, on
   its TMA route, and no other, equal to the surface kernel and to B0's
   first port at every cell and within the twin's tolerance; at 16383^2
   the phased route equal to both; a numpy DEM given to ``slope`` with no
   device set runs on the card; at 16384^2 and 16383^2 B0 on its plan,
   its first port by name, the surface kernel with four products and
   the twin timed in turns; B0's tiles and ring stages on each route
   timed in turns;
18. stream probes: the copy and add kernels against their twins, bit for
   bit (aligned and unaligned, and at mismatched alignments of their
   inputs and output: the bulk route and the scalar route); then
   ``measure_stream`` at 16384^2, the
   tool users run: kernel, twin and library times, GB/s and the measured
   stream roof;
19. geodesic slope and aspect on a 3601^2 SRTM 1-arc-second tile (45-46 N,
   7-8 E, 1/3600 degree spacing, float32 elevations) on the card: NaN
   ring, ranges, a 512^2 crop against the CPU (NaN masks equal, rtol
   1e-6; aspect also within the bearing error that 1e-9 of float64
   gradient noise makes, which matters only near the summit), warm times
   and peak memory;
20. cast shadows: ``hillshade(shadows=True)`` at SHADOW_N^2 (1024 steps,
   sun at azimuth 225, altitude 10), one warm-up and two timed calls; a
   1024^2 crop north-east of the summit (about half in shadow) on the card
   against the CPU: lit mask equal at every cell, shade within rtol 1e-6 /
   atol 1e-6;
21. stencil probes and the fused jump-flood group vs twins: every
   instantiation of the stencil-probe template (the ports of the TPU
   probes B8c-f) against its twin at 300x70 and 257x1025 with NaN cells
   (copy equal to its input; grad, slope, separable within the surface
   tolerance; every nine-read slope, interior and ring_branch included,
   equal to the surface kernel bit for bit, bare on the cells it writes);
   the staged form (B8c) at every tile at those shapes and at an aligned
   ragged 263x516, its slope equal to the surface kernel bit for bit, NaN
   ring included, each launch on the route its plan names (cp.async at
   the first two, TMA at the third); the staged separable form (B8d's
   redesign) at every tile at the same shapes, from an aligned base and
   one 4 bytes off, equal to the first-port separable form bit for bit
   and within the surface tolerance of its twin, each launch counted on
   the route its plan names (``cuda_stencil_probe.SEP_TMA_LAUNCHES``,
   ``SEP_ASYNC_LAUNCHES``); B8e's and B8f's redesigns, the staged form
   with edges interior (the interior walk, then the edge bands), bare (the
   walk alone) and ring_branch (the full walk with a per-cell ring test),
   at every tile at those shapes, at 45x300 (clamped tiles) and at 40x70
   (no interior), from an aligned base and one 4 bytes off: interior and
   ring_branch equal to the surface kernel bit for bit, NaN ring
   included, bare on ``staged_interior_extent``, each launch counted on
   the route its plan names (``INTERIOR_TMA_LAUNCHES``/
   ``INTERIOR_ASYNC_LAUNCHES``, ``RING_TMA_LAUNCHES``/
   ``RING_ASYNC_LAUNCHES``, ``EDGE_LAUNCHES``);
   the fused group (B8g) against the round kernel launched once per
   stride, bit for bit, in both state forms at every metric, for
   proximity's tail group, (64,) and (2, 1), on each of its routes: the
   plan's single-buffered one (cp.async at the first two shapes, TMA at
   263x516) and the first port (double) by name;
22. probes at full size: ``python -m xrspatial_torch.tools.exp_stencil2``,
   ``exp_separable_horn``, ``exp_padfree_stencil`` and ``exp_seam_cost``
   at 16384^2, the tools users run (each kernel checked against its twin
   before it is timed; every leg's ms, GB/s and share of the measured
   roof; every staged launch of ``exp_stencil2`` and every staged
   separable launch of ``exp_separable_horn`` on the TMA route;
   ``exp_separable_horn`` times the staged separable form and B8c's
   staged slope at each tile in turns with the first ports; every
   interior-walk and ring_branch launch of ``exp_padfree_stencil`` and
   ``exp_seam_cost`` on the TMA route, and at least one edge-band launch
   of ``exp_padfree_stencil``);
   ``exp_jfa_fixed`` at its 4096^2 (the JAX probe's groups that
   fit, against the round kernel); then the fused group on proximity's
   16384^2 packed state after its first 9 rounds (targets ``dem > 900``):
   the tail group (16, 8, 4, 2, 1, 2, 1) in one single-buffered launch
   against the round kernel's seven, bit for bit, and the group's routes
   and the seven launches timed in turns, the twin once;
23. the A5/A6 paths, torch ops and no kernel of ours, each result on the
   card and held against numpy on the host (on the middle sixteenth of
   the rows, the summit's, where a whole raster would take too long), each
   timed with CUDA events beside its peak allocated memory and, for
   elementwise work, its byte bound: the DataArray shim at 16384^2 (``a +
   b``, ``a * 2``, ``a > 900``, ``where``, ``fillna`` bit for bit;
   ``mean``/``std``/``min``/``max`` with ``skipna`` on the DEM with a NaN
   patch and without on a NaN-free raster, against a float64 oracle at
   rtol 1e-5; ``isel``/``sel`` crops, ``astype``, ``concat``); the ten
   multispectral indices at 16384^2 (bands ``|dem|/1000 + 0.1``,
   ``|dem|/800 + 0.2`` and ``|dem|/1200 + 0.05``, ``bench.py:357-362``),
   each equal to its numpy float32 formula bit for bit (ebbi within 2
   ulps), ``true_color`` within 1, ``ndvi`` at 8192^2 (the bench leg); the
   local functions on 4 variables and a reference at 16384^2 against
   numpy (mean and std rtol 1e-6), ``combine`` at 2048^2; classify:
   ``quantile(k=5)`` at 4096^2 (the bench leg) and 16384^2, its order
   statistics against ``np.partition`` and its bins bit for bit through
   the same float32 formula; the classes of percentiles, equal_interval,
   std_mean, box_plot, head_tail_breaks, binary and reclassify at
   16384^2, and of maximum_breaks and natural_breaks (20,000 samples,
   k=5) at 4096^2, against ``np.searchsorted``; the Jenks DP's seconds on
   the card and on the CPU, its breaks equal to the CPU run's or of the
   same float64 within-class variance within rtol 1e-5;
24. A7, zonal (torch ops, no kernel of ours; no launch counted) on
   ``gaussian_bump`` with zones ``floor(dem / 100)`` in int32:
   ``zonal_stats``' 7 stats (``bench.py:376-378``) at 4096^2, the JAX
   bench's leg, and at 16384^2, against ``bench.py:218-241``'s float64
   oracle (by bincount; the count after its float32 rounding, min and max
   against a masked reduction of each zone); majority at 4096^2 on the
   DEM in whole metres against numpy; ``zonal_crosstab`` count at 16384^2
   (categories ``floor(dem / 250)``) against numpy's bincount;
   ``regions`` at 4096^2 equal to ``scipy.ndimage.label``'s regions at
   every cell, its propagation steps printed, and once at 16384^2;
   ``zonal_apply`` (a host function), ``trim`` and ``crop`` at 16384^2;
   each path's ms and peak allocated memory;
25. A11, XDraw: the scan kernel X1 (``csrc/xdraw.cu``) on its banded
   route against its twin and its first port by name, bit for bit, at
   17x1, 1x23, 300x70, 70x300 and 263x516 with NaN cells, the viewpoint at
   every corner and inside, and at 4096^2 and 16384^2 at the JAX bench's
   viewpoint; ``viewshed`` at 4096^2 (x = y = 100, observer 100,
   ``bench.py:343-344``) and at 16384^2: one launch each of X1 on the
   banded route and of the cell kernels X3 (``xdraw_fields_kernel``) and
   X4 (``xdraw_epilogue_kernel``, ``csrc/xdraw_cells.cu``), no twin call,
   no other kernel, float32 on the card; at both sizes X3 against
   ``_xdraw_fields``' slope and X4 against ``_xdraw_epilogue``'s angles,
   the torch passes on the card, bit for bit; at 4096^2 equal to the
   CPU's visibility at every cell; agreement with ``exact=True`` at
   1024^2 at least 0.985; warm ms of the call, X1 and its first port in
   turns, the twin, X3 and X4 each in turns with its torch passes at
   16384^2; the banded kernel on one lane (a 1 x N row), whose ms a step
   times the longest walk is X1's chain bound;
26. A9 and A12: the bump kernel X2 (``csrc/bump.cu``) on its rounds route
   against its twin bit for bit at spreads 0, 1 and 3 (600 bumps on
   23x17: duplicate locations, every edge and corner, non-integer
   heights), its rounds and walk printed; ``bump`` at 4096^2 and its
   default count (1,677,721 bumps, spread 1): one X2 launch, no twin
   call, float64 on the card, the rounds' and the walk's bumps adding up
   to every bump; X2 on those bumps at spreads 1 and 3 equal to its first
   port by name, both timed in turns (CUDA events); on the first 262,144
   of those bumps X2 equal to the twin bit for bit, X2 and its first port
   in turns, the twin by host clock (~30 us a bump); X2 alone at 16384^2
   on bump()'s 26,843,545 bumps, its rounds and walk printed;
   ``generate_terrain`` at 4096^2 (the JAX bench's leg), cold and warm,
   equal to the CPU's bit for bit, and at 16384^2: the host hashing's seconds, cold and warm ms, peak memory, min 0, max
   at most zfactor, the water share; ``terrain_pipeline`` on that
   terrain (one B1 and one B2 launch); ``perlin`` at 4096^2 (equal to
   the CPU's) and 16384^2, in [0, 1]; ``a_star_search`` on the 4096^2
   terrain with water barred and both ends snapped, on the native route,
   equal to the CPU's; ``polygonize`` of the 1024^2 terrain classified by
   the kilometre, equal to the CPU's; ``diagnose`` on a raster on the
   card, the CPU's report; one JSON line ``{"a9_a12_paths": {...}}``;
27. A13, the mesh branches on meshes of one card (``make_raster_mesh(2,
   2, devices=[cuda:0] * 4)``; the times measure the halo machinery's
   overhead beside the unsharded call, not scaling): ``terrain_pipeline``
   at 16384^2 in place (12 B1 and 12 B2 launches: each tile on the route
   its plan names, each block's two bands on TMA, their rows padded to 16
   bytes), ``proximity`` of ``dem > 900`` at
   16384^2 and 4096^2 (B6 once a block for every stride up to 256, with
   the block's origin, on the route ``round_plan`` names for the extended
   block; the larger strides as torch ops), MANHATTAN ``allocation`` at
   4096^2 (the scan transform, no kernel), ``focal_stats`` on the annulus
   (in place: three B5 launches a block, TMA), ``quantile(k=5)`` at
   16384^2 (no kernel),
   ``terrain_pipeline`` at 16383x16384 (y held whole by distribute, cut
   into tiles of 8192 and 8191 rows) and on a 1x4 mesh; each result split
   over the mesh on the card and equal to the unsharded call bit for bit,
   its warm ms (CUDA events) and peak allocated memory beside the
   unsharded call's; where more than one card is visible, the same
   paths on a mesh of every card (their halo strips peer copies, timed
   by the host clock between synchronisations of every card); one JSON
   line ``{"a13_mesh_paths": {...}}``;
28. A13b on meshes of one card: X1's strip route (``xdraw_banded_kernel``
   on a strip, one cooperative launch a strip a window of L steps) against the strip
   twin on the card at 4096^2, bit for bit, on a 2x2 mesh whose strips are
   narrower than L, the viewpoint on strips' edge lanes; ``viewshed(exact=False)`` at 16384^2 at the JAX bench's
   viewpoint on 2x2 and 1x4 meshes, equal to the unsharded call bit for
   bit, only strip launches and one launch each of X3 and X4 a block
   inside the call (``cuda_xdraw.XDRAW_STRIP_LAUNCHES``, ``cuda_xdraw_cells.
   FIELDS_LAUNCHES``/``EPILOGUE_LAUNCHES``, no single-card X1), warm ms
   and peak memory
   beside the unsharded call's; the strip route at every L of
   ``XDRAW_STRIP_STEPS``, in turns; then every op the JAX package leaves
   to GSPMD on the 2x2 mesh against the unsharded call, no kernel
   launched: the indices, ``true_color``, the local tools, the
   classifiers, ``zonal_stats`` (zones ``floor(dem / 100)``),
   ``zonal_crosstab``, ``trim``, ``crop`` and ``hillshade(shadows=True)``
   at 16384^2, ``regions`` and ``natural_breaks`` at 4096^2, the host
   functions (which warn and gather) ``maximum_breaks`` and
   ``zonal_apply`` at 4096^2,
   ``polygonize`` at 512^2, ``combine`` at 1024^2, geodesic slope on a
   3600^2 tile; bit for bit but ``zonal_stats``' sums (rtol 1e-12) and
   the breaks of ``std_mean`` and ``head_tail_breaks`` (rtol 1e-6, classes
   equal off them); where more than one card is visible, the viewshed
   and the ops on a mesh of every card; one JSON line
   ``{"a13b_mesh_paths": {...}}``.

The line before the last is a JSON object describing each kernel, with the
least time the card could take for the same work (``bound_ms``: the larger
of the bytes over 3.35 TB/s and the float operations, counted from the
sources, over 67 TFLOP/s, X2's float64 ones over 34; for the screen, the work its culled route does
on this run's data, with the plan's whole pair count beside it as
``plan_bound_ms``) and the same bound at the stream roof measured in
phase 18 (``measured_roof_bound_ms``, and its share of ``ms``), and
the design its timed launch ran (``design``: the staged route and tile of
the surface, focal and pipeline kernels, the screen's culled share, the
stream kernels' bulk rings, the jump-flood round's per-stride routes, the
group's window, B0's route and tile, B8d's staged separable form, B8e's
and B8f's interior walk) and, for the redesigned kernels that keep their
first port by name (surface, focal, pipeline, screen, jump-flood round and
group, the stacked surface kernel B0, the stencil probes B8c-f, X1 and
X2), that port's time in turns
(``first_port_ms``), X1's chain bound (``chain_bound_ms``), X2 on all of
``bump(4096, 4096)``'s bumps (``all_bumps_ms``,
``all_bumps_first_port_ms``), each entry with the card's name and power
limit (``card``); the last line is ``{"ok": true, "device": {...}}``.  Without
a CUDA device the script exits 1 before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import warnings

import numpy as np

N = 16384  # the main path's DEM edge (float32)
SMALL_SHAPES = ((70, 300), (1, 1000), (2, 5), (1025, 2049), (2048, 2048))
SURFACE_TOL = dict(rtol=1e-4, atol=5e-5)
FOCAL_TOL = dict(rtol=1e-5, atol=1e-5)
ALL_STATS = ("mean", "max", "min", "range", "std", "var", "sum")
PIPELINE_STATS = ("mean", "max", "min", "std")
PIPELINE_SURFACE = ("slope", "hillshade")
PRODUCTS_ALL = ("slope", "aspect", "curvature", "hillshade")
JFA_SHAPES = ((70, 300), (2, 5), (1025, 2049), (2048, 2048), (1, 1000))
GC_RTOL = 1e-4      # great circle: libdevice and torch trig differ by ulps
PROX_TOL = dict(rtol=1e-5, atol=1e-5)
ROUNDS_AT_N = 16    # 8192 ... 1, then the JFA+2 rounds 2, 1
BRUTE_CELLS = 1024
FUNCS = ("proximity", "allocation", "direction")
HALO_SHAPES = SMALL_SHAPES + ((300, 70), (263, 516))
OPS_N = 1024            # the torch-op paths against the CPU
OPS_TOL = dict(rtol=1e-5, atol=1e-5)
Z_THRESHOLDS = (1.65, 1.96, 2.58)
VS_N = 1024             # the exact viewshed's raster edge (bench.py:398-417)
VS_VIEW = (505, 515, 2.0)   # its x, y and observer_elev
VS_CROP = 256           # the crop held against the pairwise oracle
STACK_ORDERS = (("slope", "aspect", "curvature", "hillshade"),
                ("hillshade", "slope"), ("slope",))
GEO_N = 3601            # one SRTM 1-arc-second tile, 1/3600 degree apart
GEO_LAT, GEO_LON = 45.0, 7.0    # its south-west corner
GEO_CROP = 512          # the crop held against the CPU
GEO_RTOL = 1e-6
GEO_GRAD_NOISE = 1e-9   # float64 noise of the fitted gradient (m per m)
SHADOW_N = N            # cast shadows' raster edge (1024 steps)
SHADOW_SUN = (225, 10)  # azimuth, altitude: the bump's lee side is steeper
SHADOW_CROP = 1024      # the crop held against the CPU, north-east of the
                        # summit: about half of it in shadow
SHADOW_TOL = dict(rtol=1e-6, atol=1e-6)


class SmokeFailure(Exception):
    pass


def gaussian_bump(ny: int, nx: int, device):
    """Synthetic DEM: a Gaussian hill with ripples (bench.py's, in torch)."""
    import torch
    y = torch.linspace(-1.0, 1.0, ny, dtype=torch.float32,
                       device=device)[:, None]
    x = torch.linspace(-1.0, 1.0, nx, dtype=torch.float32,
                       device=device)[None, :]
    z = 1000.0 * torch.exp(-(x * x + y * y) * 4.0)
    return z + 20.0 * torch.sin(x * 40.0) * torch.cos(y * 40.0)


def compare(got, ref, rtol, atol, circular=None):
    """Compare two float tensors on their device.

    Returns ``(n_bad, max_abs_err, n_wrapped)``: cells outside
    ``atol + rtol*|ref|`` (a NaN-mask mismatch or an unequal infinity
    counts as bad), the largest difference where both are not NaN, and,
    with ``circular`` (a period), the cells that pass only as a circular
    difference.
    """
    import torch
    nan_g, nan_r = torch.isnan(got), torch.isnan(ref)
    both = ~(nan_g | nan_r)
    same = got == ref  # equal infinities included
    diff = torch.where(both & ~same, (got - ref).abs(), 0.0)
    limit = atol + rtol * ref.abs()
    finite = torch.isfinite(got) & torch.isfinite(ref)
    n_wrapped = 0
    if circular is not None:
        cdiff = torch.minimum(diff, (circular - diff).abs())
        n_wrapped = int(((diff > limit) & (cdiff <= limit) & both).sum())
        diff = cdiff
    bad = (nan_g != nan_r) | (both & ~same & (~finite | (diff > limit)))
    return int(bad.sum()), float(diff.max()) if diff.numel() else 0.0, \
        n_wrapped


def check(name, got, ref, tol, circular=None):
    n_bad, err, wrapped = compare(got, ref, circular=circular, **tol)
    note = f" wrapped_cells={wrapped}" if circular is not None else ""
    print(f"  {name}: max_abs_diff={err:.3e} bad_cells={n_bad}{note}")
    if n_bad:
        atol = tol["atol"] if isinstance(tol["atol"], float) else "per cell"
        raise SmokeFailure(f"{name}: {n_bad} cells outside rtol "
                           f"{tol['rtol']} / atol {atol}")
    return err


def test_raster(shape, seed):
    """Random float32 raster with NaN patches, on the host."""
    rng = np.random.default_rng(seed)
    h, w = shape
    a = (rng.random(shape) * 100).astype(np.float32)
    a[h // 3:h // 3 + max(1, h // 20), w // 3:w // 3 + max(1, w // 15)] = \
        np.nan
    a[rng.integers(0, h, 3), rng.integers(0, w, 3)] = np.nan
    return a


def cuda_time_ms(fn, reps):
    """Mean device time of `fn` over `reps` runs, from CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def paired_ms(kernel_fn, plain_fn, reps_kernel, reps_plain):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    plain = [cuda_time_ms(plain_fn, reps_plain)]
    kern = [cuda_time_ms(kernel_fn, reps_kernel),
            cuda_time_ms(kernel_fn, reps_kernel)]
    plain.append(cuda_time_ms(plain_fn, reps_plain))
    return sum(kern) / 2, sum(plain) / 2


# -- the surface kernel B1 and the fused pipeline B4: routes -----------------

# the product masks B1's routes are held to each other at: each product
# alone, the main path's pair and all four
SURFACE_MASKS = (("slope",), ("aspect",), ("curvature",), ("hillshade",),
                 PIPELINE_SURFACE, ("slope", "aspect", "curvature",
                                    "hillshade"))
SURFACE_SHAPES = SMALL_SHAPES + ((300, 70), (263, 516))


def surface_route_launches():
    """surface_kernel's (B1's) launches by route."""
    from xrspatial_torch.kernels import cuda_surface
    return {"tma": cuda_surface.STAGED_TMA_LAUNCHES,
            "async": cuda_surface.STAGED_ASYNC_LAUNCHES,
            "simple": cuda_surface.SIMPLE_LAUNCHES}


def pipeline_route_launches():
    """pipeline_kernel's (B4's) launches by route."""
    from xrspatial_torch.kernels import cuda_pipeline
    return {"tma": cuda_pipeline.TMA_LAUNCHES,
            "async": cuda_pipeline.ASYNC_LAUNCHES,
            "simple": cuda_pipeline.SIMPLE_LAUNCHES}


def launched_since(routes, before):
    """Launches by route since `before` (a reading of `routes`)."""
    return {k: v - before[k] for k, v in routes().items()}


def unaligned(x):
    """A contiguous copy of `x` whose base is 4 bytes past a 16-byte
    boundary: the staged kernels take cp.async from it."""
    import torch
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def surface_raster(shape, seed):
    """test_raster with +-inf cells and a flat 6x6 block (aspect -1)."""
    host = test_raster(shape, seed)
    h, w = shape
    host[h // 2, w // 2] = np.inf
    host[h - 1, 0] = -np.inf
    host[(2 * h) // 3:(2 * h) // 3 + 6, w // 5:w // 5 + 6] = 40.0
    return host


def check_surface_routes(dev):
    """Phase 3b: B1's staged kernel on both routes against its first port
    by name, bit for bit, every mask, at the small shapes, a thin 300x70
    and an aligned ragged 263x516; each launch counted on the route its
    plan names (TMA from an aligned base where w % 4 == 0, cp.async from
    a base 4 bytes off and where w % 4 != 0); every tile at each shape.
    Returns the largest difference from the twin."""
    import torch
    from xrspatial_torch.kernels import cuda_surface
    from xrspatial_torch.kernels.surface import (SURFACE_TILES, surface_multi,
                                                 surface_plan)
    print("== surface kernel B1: staged routes vs first port and twin on the "
          "card")
    args = (2.0, 3.0, 300.0, 40.0)
    err = 0.0
    taken = {"tma": 0, "async": 0}
    for k, shape in enumerate(SURFACE_SHAPES):
        x = torch.from_numpy(surface_raster(shape, seed=150 + k)).to(dev)
        twin = surface_multi(x, *args)
        flat = int((twin["aspect"] == -1.0).sum())
        for label, xx in (("aligned", x), ("base+4", unaligned(x))):
            for which in SURFACE_MASKS:
                route = surface_plan(*shape, xx.data_ptr()).route
                before = surface_route_launches()
                got = cuda_surface.surface_cuda(xx, which, *args)
                n = launched_since(surface_route_launches, before)
                if n != {"tma": int(route == "tma"),
                         "async": int(route == "async"), "simple": 0}:
                    raise SmokeFailure(f"surface {shape} {label} {which}: "
                                       f"planned {route}, launches {n}")
                taken[route] += 1
                first = cuda_surface.surface_cuda(xx, which, *args,
                                                  route="simple")
                tag = f"surface {shape} {label} {'+'.join(which)} ({route})"
                for p, g, f in zip(which, got, first):
                    if not same_bits(g, f):
                        raise SmokeFailure(f"{tag} {p}: the staged route "
                                           f"differs from the first port")
                    err = max(err, check(
                        f"{tag} {p} vs twin", g, twin[p], SURFACE_TOL,
                        circular=360.0 if p == "aspect" else None))
        for tile in SURFACE_TILES:
            got = cuda_surface.surface_cuda(x, PRODUCTS_ALL, *args, tile=tile)
            first = cuda_surface.surface_cuda(x, PRODUCTS_ALL, *args,
                                              route="simple")
            if not all(same_bits(g, f) for g, f in zip(got, first)):
                raise SmokeFailure(f"surface {shape} tile {tile}: the staged "
                                   f"route differs from the first port")
        print(f"  surface {shape}: staged routes and tiles {SURFACE_TILES} "
              f"equal to the first port bit for bit, every mask ({flat} flat "
              f"cells of aspect -1)")
        torch.cuda.synchronize()
    print(f"  routes taken {taken}")
    if not all(taken.values()):
        raise SmokeFailure(f"surface: a route was never planned: {taken}")
    return err


def surface_tiles_path(dem, card):
    """Phase 5b, B1: its staged kernel at each tile against its first port
    by name at N^2 (slope + hillshade), bit for bit, then timed in turns
    (first port, each tile, each tile again, first port); at (N-1)^2 its
    cp.async route against the first port, bit for bit and in turns.
    Returns the first port's ms at N^2."""
    import torch
    from xrspatial_torch.kernels import cuda_surface
    from xrspatial_torch.kernels.surface import SURFACE_TILE, SURFACE_TILES
    first = cuda_surface.surface_cuda(dem, PIPELINE_SURFACE, route="simple")
    for tile in SURFACE_TILES:
        before = surface_route_launches()
        got = cuda_surface.surface_cuda(dem, PIPELINE_SURFACE, tile=tile)
        if launched_since(surface_route_launches, before) != {
                "tma": 1, "async": 0, "simple": 0}:
            raise SmokeFailure(f"surface_kernel at {N}^2, tile {tile}: not "
                               f"one TMA launch")
        if not all(same_bits(g, f) for g, f in zip(got, first)):
            raise SmokeFailure(f"surface_kernel at {N}^2, tile {tile}: the "
                               f"staged route differs from the first port")
        del got
    del first
    torch.cuda.synchronize()
    print(f"  surface_kernel at {N}x{N}: the staged route at every tile "
          f"equal to the first port bit for bit, on TMA")
    legs = {"first port": lambda: cuda_surface.surface_cuda(
        dem, PIPELINE_SURFACE, route="simple")}
    for tile in SURFACE_TILES:
        legs[f"staged {tile[0]}x{tile[1]}"] = (
            lambda t=tile: cuda_surface.surface_cuda(dem, PIPELINE_SURFACE,
                                                     tile=t))
    times = {k: [] for k in legs}
    for k in (*legs, *reversed(legs)):
        times[k].append(cuda_time_ms(legs[k], 20))
    t = {k: sum(v) / len(v) for k, v in times.items()}
    print(f"  surface_kernel, slope + hillshade at {N}x{N}, in turns: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())
          + f" (the plan's tile {SURFACE_TILE[0]}x{SURFACE_TILE[1]}), {card}")
    # w % 4 != 0: the plan's cp.async route
    odd = dem[:N - 1, :N - 1].contiguous()
    before = surface_route_launches()
    staged = cuda_surface.surface_cuda(odd, PIPELINE_SURFACE)
    first = cuda_surface.surface_cuda(odd, PIPELINE_SURFACE, route="simple")
    if launched_since(surface_route_launches, before) != {
            "tma": 0, "async": 1, "simple": 1} \
            or not all(same_bits(g, f) for g, f in zip(staged, first)):
        raise SmokeFailure(f"surface_kernel at {N - 1}^2: not on cp.async, "
                           f"or differs from the first port")
    del staged, first
    odd_ms = paired_ms(
        lambda: cuda_surface.surface_cuda(odd, PIPELINE_SURFACE),
        lambda: cuda_surface.surface_cuda(odd, PIPELINE_SURFACE,
                                          route="simple"), 20, 20)
    print(f"  surface_kernel, slope + hillshade at {N - 1}x{N - 1}, in "
          f"turns: staged (async) {odd_ms[0]:.4f} ms, first port "
          f"{odd_ms[1]:.4f} ms, equal bit for bit, {card}")
    del odd
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return t["first port"]


# -- the jump-flood phases ---------------------------------------------------

def jfa_axes(kind, h, w, rng):
    """(ys, xs) float32 coordinate vectors of one kind, on the host."""
    if kind == "affine":          # packed state where both dims exceed 1
        ys, xs = np.arange(h)[::-1] * 0.5, np.arange(w) * 0.5
    elif kind == "nonaffine":     # monotone, not affine: coordinate state
        ys = np.sort(rng.uniform(-50, 50, h))[::-1]
        xs = np.sort(rng.uniform(-50, 50, w))
    else:                         # lon/lat, as bench.py's great-circle grid
        ys, xs = np.linspace(75, -75, h), np.linspace(-170, 170, w)
    return (np.ascontiguousarray(ys, dtype=np.float32),
            np.ascontiguousarray(xs, dtype=np.float32))


def jfa_initial(form, mask, values, xs, ys):
    """The round-0 state jump_flood builds, as a list of planes."""
    import torch
    from xrspatial_torch.kernels.jfa_rounds import PACK_BITS
    h, w = mask.shape
    val = None if values is None else torch.where(mask, values, 0.0)
    if form == "packed":
        iy = torch.arange(h, dtype=torch.int32, device=mask.device)[:, None]
        ix = torch.arange(w, dtype=torch.int32, device=mask.device)[None, :]
        return [torch.where(mask, (iy << PACK_BITS) | ix, -1), val]
    return [torch.where(mask, xs[None, :], np.inf),
            torch.where(mask, ys[:, None], np.inf), val]


def jfa_route(route, form, state, k, with_val):
    """`route` by name where it can take the round, else "simple"; None
    ("plan") leaves the choice to round_plan."""
    from xrspatial_torch.kernels.jfa_plan import round_plan
    if route is None:
        return None
    h, w = state.shape
    try:
        round_plan(h, w, k, form, with_val, route=route)
        return route
    except ValueError:
        return "simple"


def jfa_schedule(use_kernel, form, init, xs, ys, metric, steps, route=None):
    """Run jump_flood's whole stride schedule through the round kernel (on
    the plan's routes, or `route` by name where it can take a round) or
    through its twins; returns the final planes and each cell's key."""
    from xrspatial_torch.kernels import cuda_jfa, jfa_rounds
    from xrspatial_torch.kernels.jfa import _stride_schedule
    h, w = init[0].shape
    strides = [int(k) for k in _stride_schedule(max(h, w))]
    if form == "packed":
        state, val = init
        best = None
        for n, k in enumerate(strides):
            if use_kernel:
                state, val, best = cuda_jfa.round_packed_cuda(
                    state, val, k, metric, steps,
                    emit_best=n == len(strides) - 1,
                    route=jfa_route(route, form, state, k, val is not None))
            else:
                state, val, best = jfa_rounds.round_packed(
                    state, val, k, metric, steps)
        return {"state": state, "value": val, "best": best}
    tx, ty, val = init
    for k in strides:
        if use_kernel:
            tx, ty, val = cuda_jfa.round_coords_cuda(
                tx, ty, val, xs, ys, k, metric,
                route=jfa_route(route, form, tx, k, val is not None))
        else:
            tx, ty, val = jfa_rounds.round_coords(tx, ty, val, xs, ys, k,
                                                  metric)
    best = jfa_rounds.coords_key(xs[None, :], ys[:, None], tx, ty, metric)
    return {"tx": tx, "ty": ty, "value": val, "best": best}


JFA_ROUTES = (None, "staged", "vector", "simple")   # None: the plan's


def jfa_route_launches():
    from xrspatial_torch.kernels import cuda_jfa
    return {"staged": cuda_jfa.STAGED_LAUNCHES,
            "vector": cuda_jfa.VECTOR_LAUNCHES,
            "simple": cuda_jfa.SIMPLE_LAUNCHES}


# (label, metric, axes, value channel): 0 euclidean, 1 great circle,
# 2 manhattan
JFA_MODES = (("euclidean", 0, "affine", False),
             ("euclidean non-affine +values", 0, "nonaffine", True),
             ("manhattan", 2, "affine", False),
             ("great circle", 1, "lonlat", False),
             ("allocation +values", 0, "affine", True))


def check_jfa_rounds(dev):
    """Phase 6: the round kernel against its twins, whole schedules, on
    the plan's routes and on each route by name (simple where it cannot
    take a stride)."""
    import torch
    from xrspatial_torch.kernels.jfa import packed_state_plan
    print("== jump-flood round kernel vs twins on the card, every route")
    counts = dict.fromkeys(("staged", "vector", "simple"), 0)
    for si, shape in enumerate(JFA_SHAPES):
        for layout in (("targets", "none") if si == 0 else ("targets",)):
            rng = np.random.default_rng(200 + si)
            mask_np = rng.random(shape) < 0.01
            mask_np[rng.integers(shape[0]), rng.integers(shape[1])] = True
            if layout == "none":
                mask_np[:] = False
            mask = torch.from_numpy(mask_np).to(dev)
            values = torch.from_numpy(
                rng.uniform(1, 9, shape).astype(np.float32)).to(dev)
            for label, metric, kind, with_val in JFA_MODES:
                ys_np, xs_np = jfa_axes(kind, *shape, rng)
                plan = packed_state_plan(xs_np, ys_np, metric)
                form = "packed" if plan is not None else "coords"
                xs = torch.from_numpy(xs_np).to(dev)
                ys = torch.from_numpy(ys_np).to(dev)
                init = jfa_initial(form, mask, values if with_val else None,
                                   xs, ys)
                steps = plan[0] if plan is not None else None
                ref = jfa_schedule(False, form, init, xs, ys, metric, steps)
                for route in JFA_ROUTES:
                    before = jfa_route_launches()
                    got = jfa_schedule(True, form, init, xs, ys, metric,
                                       steps, route)
                    torch.cuda.synchronize()
                    for r, n in jfa_route_launches().items():
                        counts[r] += n - before[r]
                    name = (f"jfa {shape} {layout} {label} ({form}, "
                            f"{route or 'plan'})")
                    check_jfa_planes(name, got, ref, metric)
        torch.cuda.synchronize()
    print(f"  launches by route over phase 6: {counts}")
    if not all(counts.values()):
        raise SmokeFailure(f"a route of jfa_round never ran: {counts}")


def check_jfa_planes(name, got, ref, metric):
    """Every plane of `got` equal to `ref`'s (great circle: the distances
    within GC_RTOL)."""
    import torch
    from xrspatial_torch.kernels.jfa import _metric_finalize
    if metric == 1:
        moved = int(((got["tx"] != ref["tx"])
                     | (got["ty"] != ref["ty"])).sum())
        gd = _metric_finalize(got["best"], metric)
        rd = _metric_finalize(ref["best"], metric)
        check(f"{name} distance, {moved} cells chose another target", gd,
              rd, dict(rtol=GC_RTOL, atol=0.0))
        return
    for plane, g in got.items():
        r = ref[plane]
        if (g is None) != (r is None):
            raise SmokeFailure(f"{name} {plane}: one side has no plane")
        if g is not None and not torch.equal(g, r):
            n_bad = int((g != r).sum())
            raise SmokeFailure(f"{name} {plane}: {n_bad} cells differ from "
                               f"the twin")
    print(f"  {name}: bit for bit")


@contextlib.contextmanager
def rounds_on(route):
    """Swap the rounds jump_flood runs for a CUDA tensor: "twin" sends them
    to the twins (counted in the returned dict), "kernel" leaves them on
    the kernel and makes any twin call fail."""
    from xrspatial_torch.kernels import jfa, jfa_rounds
    saved = (jfa._round_packed, jfa._round_coords, jfa_rounds.round_packed,
             jfa_rounds.round_coords)
    calls = {"twin": 0}

    def twin_packed(state, value, k, metric, steps, emit_best):
        calls["twin"] += 1
        s, v, best = saved[2](state, value, k, metric, steps)
        return s, v, best if emit_best else None

    def twin_coords(*args):
        calls["twin"] += 1
        return saved[3](*args)

    def refuse(*args, **kwargs):
        raise SmokeFailure("a twin ran on the kernel path")

    if route == "twin":
        jfa._round_packed, jfa._round_coords = twin_packed, twin_coords
    else:
        jfa_rounds.round_packed = jfa_rounds.round_coords = refuse
    try:
        yield calls
    finally:
        (jfa._round_packed, jfa._round_coords, jfa_rounds.round_packed,
         jfa_rounds.round_coords) = saved


def brute_force_check(outs, dem, cells, ys, xs):
    """Exhaustive search on sampled cells, chunked over every target: the
    distance is the least one within 1e-5, and the allocated value and
    the direction are those of a target at that distance."""
    import torch
    from xrspatial_torch.proximity import _compass_direction
    tgt = dem > 900
    t_iy, t_ix = torch.nonzero(tgt, as_tuple=True)
    t_val = dem[t_iy, t_ix]
    t_y, t_x = ys[t_iy], xs[t_ix]
    c_iy, c_ix = cells
    py, px = ys[c_iy][:, None], xs[c_ix][:, None]
    n = c_iy.numel()
    chunk = 1 << 18
    best = torch.full((n,), np.inf, device=dem.device)
    for a in range(0, t_y.numel(), chunk):
        dx = px - t_x[None, a:a + chunk]
        dy = py - t_y[None, a:a + chunk]
        best = torch.minimum(best, (dx * dx + dy * dy).min(dim=1).values)
    prox = outs["proximity"][c_iy, c_ix]
    err = (prox - torch.sqrt(best)).abs()
    bad = int((err > PROX_TOL["atol"] + PROX_TOL["rtol"] * prox).sum())
    print(f"  brute force, {n} cells x {t_y.numel()} targets: proximity "
          f"max_abs_diff={float(err.max()):.3e} bad_cells={bad}")
    if bad:
        raise SmokeFailure(f"proximity differs from exhaustive search at "
                           f"{bad} sampled cells")
    # targets within the tolerance of the least distance
    thr = (torch.sqrt(best) * (1 + PROX_TOL["rtol"]) + PROX_TOL["atol"]) ** 2
    alloc_ok = torch.zeros(n, dtype=torch.bool, device=dem.device)
    dir_ok = torch.zeros_like(alloc_ok)
    alloc = outs["allocation"][c_iy, c_ix]
    direc = outs["direction"][c_iy, c_ix]
    for a in range(0, t_y.numel(), chunk):
        dx = px - t_x[None, a:a + chunk]
        dy = py - t_y[None, a:a + chunk]
        ci, tj = torch.nonzero(dx * dx + dy * dy <= thr[:, None],
                               as_tuple=True)
        tj = tj + a
        alloc_ok[ci[t_val[tj] == alloc[ci]]] = True
        d = _compass_direction(px[ci, 0].double(), t_x[tj].double(),
                               py[ci, 0].double(), t_y[tj].double())
        dir_ok[ci[(d - direc[ci]).abs() <= 1e-5 * direc[ci].abs()]] = True
    for label, ok in (("allocation", alloc_ok), ("direction", dir_ok)):
        n_bad = int((~ok).sum())
        print(f"  brute force: {label} bad_cells={n_bad}")
        if n_bad:
            raise SmokeFailure(f"{label}: {n_bad} sampled cells hold no "
                               f"nearest target's value")


def proximity_path(dem, dev, card):
    """Phases 7 and 8: the proximity family at N^2 on the card."""
    import torch
    import xrspatial_torch as xt
    from xrspatial_torch.kernels import cuda_jfa
    from xrspatial_torch.kernels.jfa import _stride_schedule, packed_state_plan
    from xrspatial_torch.kernels.jfa_plan import round_plan
    print(f"== proximity path: {N}x{N}, targets dem > 900")
    ys_np = np.arange(N, dtype=float)[::-1].copy()
    xs_np = np.arange(N, dtype=float)
    coords = {"y": ys_np, "x": xs_np}
    tgt = (dem > 900).to(torch.float32)
    inputs = {"proximity": tgt, "allocation": torch.where(dem > 900, dem, 0.0),
              "direction": tgt}
    print(f"  {int(tgt.sum())} target cells "
          f"({float(tgt.mean()) * 100:.2f}%)")
    aggs = {f: xt.DataArray(v, dims=("y", "x"), coords=coords)
            for f, v in inputs.items()}
    outs, launches, first_ms, by_route = {}, {}, {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with rounds_on("kernel"):
        for f, agg in aggs.items():
            cuda_jfa.LAUNCHES = 0
            cuda_jfa.STAGED_LAUNCHES = cuda_jfa.VECTOR_LAUNCHES = 0
            cuda_jfa.SIMPLE_LAUNCHES = 0
            t0 = time.perf_counter()
            out = getattr(xt, f)(agg).data
            torch.cuda.synchronize()
            first_ms[f] = (time.perf_counter() - t0) * 1e3
            launches[f] = cuda_jfa.LAUNCHES
            by_route[f] = jfa_route_launches()
            if out.device.type != "cuda" or tuple(out.shape) != (N, N) \
                    or out.dtype != torch.float32:
                raise SmokeFailure(f"{f}: {tuple(out.shape)} {out.dtype} on "
                                   f"{out.device}")
            outs[f] = out
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"  launches {launches}, first calls (host clock, ms) "
          f"{ {k: round(v, 1) for k, v in first_ms.items()} }, peak "
          f"allocated {peak_gib:.2f} GiB")
    print(f"  round launches by route: {by_route}")
    if any(n != ROUNDS_AT_N for n in launches.values()):
        raise SmokeFailure(f"expected {ROUNDS_AT_N} round launches per call, "
                           f"got {launches}")
    for f in FUNCS:
        want = {r: 0 for r in ("staged", "vector", "simple")}
        for k in _stride_schedule(N):
            want[round_plan(N, N, int(k), "packed",
                            f == "allocation").route] += 1
        if by_route[f] != want:
            raise SmokeFailure(f"{f}: round launches by route {by_route[f]}, "
                               f"the plan names {want}")
    prox, alloc, direc = (outs[f] for f in FUNCS)
    on_target = tgt != 0
    if not (bool(torch.isfinite(prox).all()) and bool((prox >= 0).all())
            and bool((prox[on_target] == 0).all())
            and bool((prox[~on_target] > 0).all())):
        raise SmokeFailure("proximity: not finite, negative, or not 0 "
                           "exactly at the targets")
    if not (bool((alloc > 900).all()) and bool((alloc <= 1021).all())):
        raise SmokeFailure("allocation: values outside the targets' range")
    if not (bool((direc >= 0).all()) and bool((direc <= 360).all())
            and bool((direc[on_target] == 0).all())):
        raise SmokeFailure("direction: outside [0, 360] or not 0 at the "
                           "targets")

    print("  full-size agreement with the twin path")
    max_err = 0.0
    with rounds_on("twin") as calls:
        for f, agg in aggs.items():
            ref = getattr(xt, f)(agg).data
            max_err = max(max_err, check(f"{f} kernel vs twin", outs[f], ref,
                                         dict(rtol=0.0, atol=0.0)))
            del ref
    if calls["twin"] != 3 * ROUNDS_AT_N:
        raise SmokeFailure(f"the twin path ran {calls['twin']} rounds")
    gen = torch.Generator(device=dev).manual_seed(7)
    c_iy = torch.randint(0, N, (BRUTE_CELLS,), generator=gen, device=dev)
    c_ix = torch.randint(0, N, (BRUTE_CELLS,), generator=gen, device=dev)
    c_iy[:4] = torch.tensor([0, 0, N - 1, N - 1], device=dev)
    c_ix[:4] = torch.tensor([0, N - 1, 0, N - 1], device=dev)
    brute_force_check(outs, dem, (c_iy, c_ix),
                      torch.from_numpy(ys_np.astype(np.float32)).to(dev),
                      torch.from_numpy(xs_np.astype(np.float32)).to(dev))
    del outs, prox, alloc, direc
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    print(f"== timing: proximity path at {N}x{N} on {card}")
    ms = {}
    for f, reps in (("proximity", 5), ("allocation", 3), ("direction", 3)):
        ms[f] = cuda_time_ms(lambda f=f: getattr(xt, f)(aggs[f]), reps)
        print(f"  {f} warm: {ms[f]:.3f} ms ({N * N / 1e3 / ms[f]:.1f} "
              f"Mpix/s), {card}")
    plan = packed_state_plan(xs_np, ys_np, 0)
    xs = torch.from_numpy(xs_np.astype(np.float32)).to(dev)
    ys = torch.from_numpy(ys_np.astype(np.float32)).to(dev)
    init = jfa_initial("packed", tgt != 0, None, xs, ys)
    rounds = paired_ms(
        lambda: jfa_schedule(True, "packed", init, xs, ys, 0, plan[0]),
        lambda: jfa_schedule(False, "packed", init, xs, ys, 0, plan[0]),
        5, 1)
    on_plan, simple = paired_ms(
        lambda: jfa_schedule(True, "packed", init, xs, ys, 0, plan[0]),
        lambda: jfa_schedule(True, "packed", init, xs, ys, 0, plan[0],
                             "simple"), 5, 5)
    print(f"  jfa_round, {ROUNDS_AT_N} rounds of one proximity call: on the "
          f"plan {rounds[0]:.3f} ms ({rounds[0] / ROUNDS_AT_N:.3f} ms a "
          f"round), twin {rounds[1]:.3f} ms; in turns with the first port: "
          f"plan {on_plan:.3f} ms, simple by name {simple:.3f} ms, {card}")
    table = stride_table(init[0], plan[0], card)
    del init, aggs, inputs, tgt
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return launches["proximity"], max_err, rounds, {
        "plan_ms": on_plan, "simple_ms": simple, "table": table}


def stride_table(state, steps, card, reps=3):
    """Phase 8's table: one round of every stride of the N^2 schedule on
    every route that can take it (the vector route in both row orders
    where the plan takes k-phase order), timed in turns (the legs of a
    stride in order, then reversed); returns {k: {leg: ms}} and prints
    whether the plan's route is ever slower than simple by name."""
    from xrspatial_torch.kernels import cuda_jfa
    from xrspatial_torch.kernels.jfa import _stride_schedule
    from xrspatial_torch.kernels.jfa_plan import round_plan
    h, w = state.shape
    table, slower = {}, []
    print(f"  jfa_round by stride and route (ms, in turns), {card}:")
    for k in dict.fromkeys(int(k) for k in _stride_schedule(N)):
        legs = {}
        for route in ("staged", "vector", "simple"):
            try:
                p = round_plan(h, w, k, "packed", False, route=route)
            except ValueError:
                continue
            legs[route] = dict(route=route)
            if route == "vector":
                legs["vector " + ("rows" if p.phased else "k-phase")] = \
                    dict(route=route, phased=not p.phased)
        times = {}
        for name in [*legs, *reversed(legs)]:
            kw = legs[name]
            times.setdefault(name, []).append(cuda_time_ms(
                lambda kw=kw: cuda_jfa.round_packed_cuda(state, None, k, 0,
                                                         steps, **kw), reps))
        times = {n: sum(v) / len(v) for n, v in times.items()}
        chosen = round_plan(h, w, k, "packed", False)
        table[k] = times
        print(f"    k={k}: " + ", ".join(f"{n} {t:.4f}"
                                          for n, t in times.items())
              + f"; plan: {chosen.route}"
              + (" k-phase" if chosen.phased else ""))
        if times[chosen.route] > times["simple"]:
            slower.append(k)
    print(f"  strides where the plan's route is slower than simple by name: "
          f"{slower or 'none'}")
    return table


# -- the halo and pipeline kernels, the fused and annulus paths --------------

def halo_footprints():
    """The footprints focal_stats sends to the halo kernel on the card."""
    from xrspatial_torch.convolution import annulus_kernel
    rng = np.random.default_rng(300)
    irregular = (rng.random((81, 61)) < 0.15).astype(float)  # ~740 ones
    irregular[0, 7] = 1                                       # ry = 40
    sparse = np.zeros((1001, 1001))              # no window fits a block
    sparse[[0, 0, 500, 1000, 1000], [0, 1000, 500, 0, 1000]] = 1
    return {"annulus_40_38": annulus_kernel(1, 1, 40, 38),
            "row_1x601": np.ones((1, 601)), "col_67x1": np.ones((67, 1)),
            "irregular_81x61": irregular, "sparse_1001": sparse}


HALO_ROUTES = ("tma", "async", "ring")


def halo_route_launches():
    from xrspatial_torch.kernels import cuda_window
    return {"tma": cuda_window.HALO_TMA_LAUNCHES,
            "async": cuda_window.HALO_ASYNC_LAUNCHES,
            "ring": cuda_window.HALO_RING_LAUNCHES}


def tiled_route_launches():
    """focal_kernel's (B2's) launches by route."""
    from xrspatial_torch.kernels import cuda_window
    return {"tma": cuda_window.TMA_LAUNCHES,
            "async": cuda_window.ASYNC_LAUNCHES,
            "simple": cuda_window.SIMPLE_LAUNCHES}


# B2's footprints at the tiled radii's corners, checked at N^2: the main
# path's plus, a 3x3, the widest row (rx = 256) and the tallest column
# (ry = 32)
TILED_FOOTPRINTS = {"plus": None, "3x3": (3, 3), "1x513": (1, 513),
                    "65x1": (65, 1)}


def tiled_focal_path(dem, card):
    """Phase 5, B2: its staged route against its first port by name, bit
    for bit, at N^2 on the plus (and on the DEM with a nodata cell in every
    tile), 3x3, 1x513 and 65x1; the staged route, the first port and B5's
    staged kernel by name on the plus (the yardstick leg: the template B2
    now instantiates) timed in turns, the other footprints' two routes
    once each.  Returns the first port's ms on the plus."""
    import torch
    from xrspatial_torch.convolution import circle_kernel
    from xrspatial_torch.kernels import cuda_window
    from xrspatial_torch.kernels.focal_halo import halo_plan, register_class
    from xrspatial_torch.kernels.window import kernel_offsets
    feet = {k: kernel_offsets(circle_kernel(1, 1, 1.5) if v is None
                              else np.ones(v))
            for k, v in TILED_FOOTPRINTS.items()}
    plus = feet["plus"]
    holed = dem.clone()
    holed[::32, 64::128] = float("nan")
    for kname, offsets in feet.items():
        for label, x in (("", dem), (", nodata", holed)):
            if label and kname != "plus":
                continue
            plan = halo_plan(N, N, offsets, x.data_ptr())
            before = tiled_route_launches()
            got = cuda_window.focal_stats_cuda(x, offsets, PIPELINE_STATS)
            counted = {k: v - before[k]
                       for k, v in tiled_route_launches().items()}
            first = cuda_window.focal_stats_cuda(x, offsets, PIPELINE_STATS,
                                                 route="simple")
            torch.cuda.synchronize()
            if counted != {"tma": 1, "async": 0, "simple": 0} \
                    or plan.route != "tma":
                raise SmokeFailure(f"focal_kernel {kname}{label}: planned "
                                   f"{plan.route}, launches {counted}")
            if not same_bits(got, first):
                raise SmokeFailure(f"focal_kernel {kname}{label} at {N}^2: "
                                   f"the staged route differs from the "
                                   f"first port")
            print(f"  focal_kernel {kname}{label} ({len(offsets)} offsets) "
                  f"at {N}x{N}: staged ({plan.route}, tile {plan.tile[0]}x"
                  f"{plan.tile[1]}, {register_class(plan)} blocks an SM) "
                  f"equal to the first port bit for bit")
            del got, first
    legs = {
        "staged": (lambda: cuda_window.focal_stats_cuda(
            dem, plus, PIPELINE_STATS), 20),
        "staged, nodata": (lambda: cuda_window.focal_stats_cuda(
            holed, plus, PIPELINE_STATS), 20),
        "first port": (lambda: cuda_window.focal_stats_cuda(
            dem, plus, PIPELINE_STATS, route="simple"), 10),
        "B5 by name": (lambda: cuda_window.focal_stats_halo_cuda(
            dem, plus, PIPELINE_STATS), 20)}
    times = {k: [] for k in legs}
    for k in (*legs, *reversed(legs)):
        fn, reps = legs[k]
        times[k].append(cuda_time_ms(fn, reps))
    t = {k: sum(v) / len(v) for k, v in times.items()}
    print(f"  focal_kernel on the plus at {N}x{N}, in turns: staged "
          f"{t['staged']:.4f} ms (nodata in every tile {t['staged, nodata']:.4f}"
          f"), first port by name {t['first port']:.4f} ms, B5's staged "
          f"kernel by name {t['B5 by name']:.4f} ms, {card}")
    for kname in ("3x3", "1x513", "65x1"):
        offsets = feet[kname]
        reps = 1 if kname == "1x513" else 5
        pair = paired_ms(
            lambda: cuda_window.focal_stats_cuda(dem, offsets,
                                                 PIPELINE_STATS),
            lambda: cuda_window.focal_stats_cuda(dem, offsets,
                                                 PIPELINE_STATS,
                                                 route="simple"),
            reps, reps)
        print(f"  focal_kernel {kname} at {N}x{N}, in turns: staged "
              f"{pair[0]:.4f} ms, first port by name {pair[1]:.4f} ms, {card}")
    del holed
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return t["first port"]


def same_bits(a, b):
    """Equal bit for bit, every NaN as NaN."""
    import torch
    nan_a = torch.isnan(a)
    return torch.equal(nan_a, torch.isnan(b)) and torch.equal(
        torch.where(nan_a, 0.0, a).view(torch.int32),
        torch.where(nan_a, 0.0, b).view(torch.int32))


def check_halo_and_pipeline(dev):
    """Phase 9: the halo kernel and the pipeline kernel against their
    twins; the halo kernel's planned route also against its ring route,
    the pipeline kernel also against the split kernels."""
    import torch
    from xrspatial_torch.focal import _route
    from xrspatial_torch.kernels import cuda_window
    from xrspatial_torch.kernels.focal_halo import halo_plan
    from xrspatial_torch.kernels.window import kernel_offsets, window_stats
    print("== halo focal kernel: planned route vs ring route and twin on the "
          "card")
    feet = {k: kernel_offsets(v) for k, v in halo_footprints().items()}
    for kname, offsets in feet.items():
        if len(offsets) > 1024 or _route(offsets) != "halo":
            raise SmokeFailure(f"{kname}: not a halo-kernel footprint")
    err = 0.0
    taken = dict.fromkeys(HALO_ROUTES, 0)
    for k, shape in enumerate(HALO_SHAPES):
        host = test_raster(shape, seed=400 + k)
        host[shape[0] // 2, shape[1] // 2] = np.inf
        host[0, shape[1] - 1] = -np.inf
        x = torch.from_numpy(host).to(dev)
        for kname, offsets in feet.items():
            route = halo_plan(*shape, offsets, x.data_ptr()).route
            before = halo_route_launches()
            got = cuda_window.focal_stats_halo_cuda(x, offsets, ALL_STATS)
            torch.cuda.synchronize()
            counted = {r: n - before[r]
                       for r, n in halo_route_launches().items()}
            if counted != {r: int(r == route) for r in HALO_ROUTES}:
                raise SmokeFailure(f"halo {shape} {kname}: plan route "
                                   f"{route}, launches counted {counted}")
            taken[route] += 1
            ring = cuda_window.focal_stats_halo_cuda(x, offsets, ALL_STATS,
                                                     route="ring")
            if not same_bits(got, ring):
                raise SmokeFailure(f"halo {shape} {kname}: the {route} route "
                                   f"differs from the ring route")
            ref = window_stats(x, offsets, ALL_STATS)
            err = max(err, *(check(f"halo {shape} {kname} {route} {s}",
                                   got[i], ref[s], FOCAL_TOL)
                             for i, s in enumerate(ALL_STATS)))
            del got, ring, ref
        torch.cuda.synchronize()
    print(f"  planned routes taken {taken}, each equal to the ring route bit "
          f"for bit")
    if not all(taken.values()):
        raise SmokeFailure(f"halo: a route was never planned: {taken}")
    pipeline_checks(dev)
    return err


# the fused pipeline's footprints: the main path's plus, a radius-2
# circle, a 3x3, a 1x3 row and a 3x1 column (ry = 0, rx = 0: the window's
# radii are clamped to 1), and the fused gate's largest, 65x129 (ry = 32,
# rx = 64; 8385 offsets, so only at the three smallest-celled shapes)
PIPELINE_FOOTPRINTS = {"plus": (1.5,), "r2": (2.5,), "3x3": (3, 3),
                       "1x3": (1, 3), "3x1": (3, 1), "gate_65x129": (65, 129)}
GATE_SHAPES = ((300, 70), (263, 516), (70, 300))


def pipeline_checks(dev):
    """Phase 9b: the fused pipeline kernel B4 on the route its plan names
    against its first port by name and against the split kernels (staged
    B1 + staged B2), bit for bit, and against its twin, at the small
    shapes, a thin 300x70 and an aligned ragged 263x516, each from an
    aligned base and one 4 bytes off (TMA and cp.async)."""
    import torch
    from xrspatial_torch.convolution import circle_kernel
    from xrspatial_torch.kernels import cuda_pipeline, cuda_surface
    from xrspatial_torch.kernels import cuda_window
    from xrspatial_torch.kernels.pipeline import (pipeline_multi,
                                                  pipeline_plan,
                                                  pipeline_supported)
    from xrspatial_torch.kernels.window import kernel_offsets
    print("== pipeline kernel B4: staged routes vs first port, split kernels "
          "and twin on the card")
    feet = {k: kernel_offsets(circle_kernel(1, 1, v[0]) if len(v) == 1
                              else np.ones(v))
            for k, v in PIPELINE_FOOTPRINTS.items()}
    for kname, offsets in feet.items():
        if not pipeline_supported(offsets):
            raise SmokeFailure(f"{kname}: not a footprint the fused gate "
                               f"accepts")
    cases = ((PIPELINE_SURFACE, PIPELINE_STATS), (PRODUCTS_ALL, ALL_STATS))
    args = (2.0, 3.0, 300.0, 40.0)
    taken = {"tma": 0, "async": 0}
    twin_diff = 0.0
    for k, shape in enumerate(HALO_SHAPES):
        x = torch.from_numpy(surface_raster(shape, seed=500 + k)).to(dev)
        for kname, offsets in feet.items():
            if kname == "gate_65x129" and shape not in GATE_SHAPES:
                continue
            for label, xx in (("aligned", x), ("base+4", unaligned(x))):
                route = pipeline_plan(*shape, offsets, xx.data_ptr()).route
                for which, stats in cases:
                    tag = (f"pipeline {shape} {kname} {label} "
                           f"{len(which)} products ({route})")
                    before = pipeline_route_launches()
                    got = cuda_pipeline.pipeline_cuda(xx, offsets, stats,
                                                      which, *args)
                    n = launched_since(pipeline_route_launches, before)
                    if n != {"tma": int(route == "tma"),
                             "async": int(route == "async"), "simple": 0}:
                        raise SmokeFailure(f"{tag}: launches {n}")
                    taken[route] += 1
                    first = cuda_pipeline.pipeline_cuda(
                        xx, offsets, stats, which, *args, route="simple")
                    split = (*cuda_surface.surface_cuda(xx, which, *args),
                             cuda_window.focal_stats_cuda(xx, offsets,
                                                          stats))
                    for j, (g, f, sp) in enumerate(zip(got, first, split)):
                        part = which[j] if j < len(which) else "focal"
                        if not same_bits(g, f):
                            raise SmokeFailure(f"{tag} {part}: differs from "
                                               f"the first port")
                        if not same_bits(g, sp):
                            raise SmokeFailure(f"{tag} {part}: differs from "
                                               f"the split kernels")
                    # the twin's focal half takes the conv path above 1024
                    # offsets (global-mean centred variance): bits only
                    if len(offsets) <= 1024 and label == "aligned":
                        twin = pipeline_multi(xx, offsets, stats, which,
                                              *args)
                        for j, (g, t) in enumerate(zip(got, twin)):
                            part = which[j] if j < len(which) else "focal"
                            twin_diff = max(twin_diff, check(
                                f"{tag} {part} vs twin", g, t,
                                FOCAL_TOL if part == "focal"
                                else SURFACE_TOL,
                                circular=360.0 if part == "aspect"
                                else None))
                    del got, first, split
        torch.cuda.synchronize()
        print(f"  pipeline {shape}: every footprint, both bases, equal to "
              f"the first port and to the split kernels bit for bit")
    print(f"  routes taken {taken}; largest difference from the twin "
          f"{twin_diff:.3e}")
    if not all(taken.values()):
        raise SmokeFailure(f"pipeline: a route was never planned: {taken}")


@contextlib.contextmanager
def fused_pipeline(on: bool):
    """XRSPATIAL_FUSED_PIPELINE set to "1" or "0" inside the block."""
    import os
    saved = os.environ.get("XRSPATIAL_FUSED_PIPELINE")
    os.environ["XRSPATIAL_FUSED_PIPELINE"] = "1" if on else "0"
    try:
        yield
    finally:
        if saved is None:
            del os.environ["XRSPATIAL_FUSED_PIPELINE"]
        else:
            os.environ["XRSPATIAL_FUSED_PIPELINE"] = saved


def reset_launches():
    from xrspatial_torch.kernels import cuda_jfa, cuda_pipeline, cuda_screen
    from xrspatial_torch.kernels import cuda_stream, cuda_surface, cuda_window
    from xrspatial_torch.kernels import cuda_jfa_group, cuda_stencil_probe
    from xrspatial_torch.kernels import cuda_bump, cuda_xdraw
    from xrspatial_torch.kernels import cuda_xdraw_cells
    cuda_xdraw.XDRAW_LAUNCHES = cuda_bump.BUMP_LAUNCHES = 0
    cuda_xdraw_cells.FIELDS_LAUNCHES = cuda_xdraw_cells.EPILOGUE_LAUNCHES = 0
    cuda_xdraw.XDRAW_SIMPLE_LAUNCHES = cuda_bump.BUMP_SIMPLE_LAUNCHES = 0
    cuda_xdraw.XDRAW_STRIP_LAUNCHES = 0
    cuda_surface.LAUNCHES = cuda_window.LAUNCHES = 0
    cuda_surface.STAGED_TMA_LAUNCHES = cuda_surface.STAGED_ASYNC_LAUNCHES = 0
    cuda_surface.SIMPLE_LAUNCHES = 0
    cuda_pipeline.TMA_LAUNCHES = cuda_pipeline.ASYNC_LAUNCHES = 0
    cuda_pipeline.SIMPLE_LAUNCHES = 0
    cuda_window.TMA_LAUNCHES = cuda_window.ASYNC_LAUNCHES = 0
    cuda_window.SIMPLE_LAUNCHES = 0
    cuda_window.HALO_LAUNCHES = cuda_pipeline.LAUNCHES = 0
    cuda_window.HALO_TMA_LAUNCHES = cuda_window.HALO_ASYNC_LAUNCHES = 0
    cuda_window.HALO_RING_LAUNCHES = 0
    cuda_jfa.LAUNCHES = 0
    cuda_jfa.STAGED_LAUNCHES = cuda_jfa.VECTOR_LAUNCHES = 0
    cuda_jfa.SIMPLE_LAUNCHES = 0
    cuda_screen.LAUNCHES = cuda_screen.F64_LAUNCHES = 0
    cuda_screen.CULLED_LAUNCHES = cuda_screen.SIMPLE_LAUNCHES = 0
    cuda_screen.BOUNDS_LAUNCHES = 0
    cuda_surface.STACKED_LAUNCHES = cuda_surface.STACKED_TMA_LAUNCHES = 0
    cuda_surface.STACKED_PHASED_LAUNCHES = 0
    cuda_surface.STACKED_SIMPLE_LAUNCHES = 0
    cuda_stream.COPY_LAUNCHES = cuda_stream.ADD_LAUNCHES = 0
    cuda_stencil_probe.LAUNCHES = cuda_stencil_probe.EDGE_LAUNCHES = 0
    cuda_stencil_probe.TMA_LAUNCHES = cuda_stencil_probe.ASYNC_LAUNCHES = 0
    cuda_stencil_probe.SEP_TMA_LAUNCHES = 0
    cuda_stencil_probe.SEP_ASYNC_LAUNCHES = 0
    cuda_stencil_probe.INTERIOR_TMA_LAUNCHES = 0
    cuda_stencil_probe.INTERIOR_ASYNC_LAUNCHES = 0
    cuda_stencil_probe.RING_TMA_LAUNCHES = 0
    cuda_stencil_probe.RING_ASYNC_LAUNCHES = 0
    cuda_jfa_group.LAUNCHES = 0
    cuda_jfa_group.SINGLE_LAUNCHES = cuda_jfa_group.DOUBLE_LAUNCHES = 0


def read_launches():
    from xrspatial_torch.kernels import cuda_jfa, cuda_pipeline, cuda_screen
    from xrspatial_torch.kernels import cuda_stream, cuda_surface, cuda_window
    from xrspatial_torch.kernels import cuda_jfa_group, cuda_stencil_probe
    from xrspatial_torch.kernels import cuda_bump, cuda_xdraw
    from xrspatial_torch.kernels import cuda_xdraw_cells
    return {"surface_kernel": cuda_surface.LAUNCHES,
            "focal_kernel": cuda_window.LAUNCHES,
            "focal_halo_kernel": cuda_window.HALO_LAUNCHES,
            "focal_halo_tma": cuda_window.HALO_TMA_LAUNCHES,
            "focal_halo_async": cuda_window.HALO_ASYNC_LAUNCHES,
            "focal_halo_ring": cuda_window.HALO_RING_LAUNCHES,
            "pipeline_kernel": cuda_pipeline.LAUNCHES,
            "jfa_round": cuda_jfa.LAUNCHES,
            "screen_hilo": cuda_screen.LAUNCHES,
            "surface_stacked_kernel": cuda_surface.STACKED_LAUNCHES,
            "surface_stacked_tma": cuda_surface.STACKED_TMA_LAUNCHES,
            "surface_stacked_phased": cuda_surface.STACKED_PHASED_LAUNCHES,
            "surface_stacked_simple": cuda_surface.STACKED_SIMPLE_LAUNCHES,
            "stream_copy": cuda_stream.COPY_LAUNCHES,
            "stream_add": cuda_stream.ADD_LAUNCHES,
            "stencil_probe": cuda_stencil_probe.LAUNCHES,
            "stencil_edge": cuda_stencil_probe.EDGE_LAUNCHES,
            "stencil_staged_tma": cuda_stencil_probe.TMA_LAUNCHES,
            "stencil_staged_async": cuda_stencil_probe.ASYNC_LAUNCHES,
            "stencil_sep_tma": cuda_stencil_probe.SEP_TMA_LAUNCHES,
            "stencil_sep_async": cuda_stencil_probe.SEP_ASYNC_LAUNCHES,
            "stencil_interior_tma": cuda_stencil_probe.INTERIOR_TMA_LAUNCHES,
            "stencil_interior_async":
                cuda_stencil_probe.INTERIOR_ASYNC_LAUNCHES,
            "stencil_ring_tma": cuda_stencil_probe.RING_TMA_LAUNCHES,
            "stencil_ring_async": cuda_stencil_probe.RING_ASYNC_LAUNCHES,
            "jfa_group": cuda_jfa_group.LAUNCHES,
            "xdraw_scan": cuda_xdraw.XDRAW_LAUNCHES,
            "xdraw_simple": cuda_xdraw.XDRAW_SIMPLE_LAUNCHES,
            "xdraw_strip": cuda_xdraw.XDRAW_STRIP_LAUNCHES,
            "xdraw_fields": cuda_xdraw_cells.FIELDS_LAUNCHES,
            "xdraw_epilogue": cuda_xdraw_cells.EPILOGUE_LAUNCHES,
            "bump_scan": cuda_bump.BUMP_LAUNCHES,
            "bump_simple": cuda_bump.BUMP_SIMPLE_LAUNCHES}


def only(launches, name, n=1):
    """Whether `launches` counts `n` launches of `name` and no other."""
    return launches == {k: n if k == name else 0 for k in launches}


def fused_path(dem, agg, card):
    """Phase 10: terrain_pipeline's fused branch at N^2 on the card."""
    import torch
    from xrspatial_torch import terrain_pipeline
    from xrspatial_torch.convolution import circle_kernel
    from xrspatial_torch.kernels import cuda_surface, cuda_window
    from xrspatial_torch.kernels.cuda_pipeline import pipeline_cuda
    from xrspatial_torch.kernels.pipeline import pipeline_multi
    from xrspatial_torch.kernels.window import kernel_offsets
    print(f"== fused path: terrain_pipeline with XRSPATIAL_FUSED_PIPELINE=1, "
          f"{N}x{N}")
    kw = dict(surface=PIPELINE_SURFACE, stats_funcs=PIPELINE_STATS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with fused_pipeline(True):
        reset_launches()
        t0 = time.perf_counter()
        ds = terrain_pipeline(agg, **kw)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        launches = read_launches()
        routes = pipeline_route_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"  first call {first_ms:.1f} ms (host clock), launches "
          f"{launches}, pipeline_kernel by route {routes}, peak allocated "
          f"{peak_gib:.2f} GiB")
    if not only(launches, "pipeline_kernel") or routes != {
            "tma": 1, "async": 0, "simple": 0}:
        raise SmokeFailure(f"fused path: expected one pipeline launch on its "
                           f"TMA route and no other, got {launches}, "
                           f"{routes}")
    ring = torch.ones((N, N), dtype=torch.bool, device=dem.device)
    ring[1:-1, 1:-1] = False
    for p in PIPELINE_SURFACE:
        t = ds[f"dem-{p}"].data
        if t.device.type != "cuda" or tuple(t.shape) != (N, N):
            raise SmokeFailure(f"fused {p}: {tuple(t.shape)} on {t.device}")
        if not torch.equal(torch.isnan(t), ring):
            raise SmokeFailure(f"fused {p}: NaN cells are not exactly the "
                               f"1-cell ring")
    fs = ds["focal_stats"].data
    if tuple(fs.shape) != (len(PIPELINE_STATS), N, N) \
            or not bool(torch.isfinite(fs).all()):
        raise SmokeFailure(f"fused focal_stats: {tuple(fs.shape)}, or "
                           f"non-finite values on a finite DEM")
    del ring
    print("  full-size agreement with the split path (equality expected)")
    with fused_pipeline(False):
        split = terrain_pipeline(agg, **kw)
    diff = max(check(f"fused vs split {k}", ds[k].data, split[k].data,
                     SURFACE_TOL if k != "focal_stats" else FOCAL_TOL)
               for k in (*(f"dem-{p}" for p in PIPELINE_SURFACE),
                         "focal_stats"))
    print(f"  fused vs split: largest difference {diff:.3e}"
          + (" (equal)" if diff == 0.0 else ""))
    del split
    print("  full-size agreement with the fused twin")
    offsets = kernel_offsets(circle_kernel(1, 1, 1.5))
    twin = pipeline_multi(dem, offsets, PIPELINE_STATS, PIPELINE_SURFACE)
    max_err = max(check(f"pipeline kernel vs twin {label}", got, ref,
                        FOCAL_TOL if label == "focal" else SURFACE_TOL)
                  for label, got, ref in zip(
                      (*PIPELINE_SURFACE, "focal"),
                      (*(ds[f"dem-{p}"].data for p in PIPELINE_SURFACE), fs),
                      twin))
    del twin, ds, fs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    print(f"== timing: fused path at {N}x{N} on {card}")

    def run(on):
        with fused_pipeline(on):
            terrain_pipeline(agg, **kw)

    fused_ms, split_ms = paired_ms(lambda: run(True), lambda: run(False),
                                   10, 10)
    print(f"  terrain_pipeline warm, in turns: fused {fused_ms:.3f} ms "
          f"({N * N / 1e3 / fused_ms:.1f} Mpix/s), split {split_ms:.3f} ms "
          f"({N * N / 1e3 / split_ms:.1f} Mpix/s), {card}")
    ms = paired_ms(
        lambda: pipeline_cuda(dem, offsets, PIPELINE_STATS, PIPELINE_SURFACE),
        lambda: pipeline_multi(dem, offsets, PIPELINE_STATS,
                               PIPELINE_SURFACE), 20, 5)
    print(f"  pipeline_kernel: kernel {ms[0]:.3f} ms, twin {ms[1]:.3f} ms, "
          f"{card}")
    staged = pipeline_cuda(dem, offsets, PIPELINE_STATS, PIPELINE_SURFACE)
    first = pipeline_cuda(dem, offsets, PIPELINE_STATS, PIPELINE_SURFACE,
                          route="simple")
    if not all(same_bits(g, f) for g, f in zip(staged, first)):
        raise SmokeFailure(f"pipeline_kernel at {N}^2: the staged route "
                           f"differs from the first port")
    del staged, first
    print(f"  pipeline_kernel at {N}x{N}: the staged route equal to the "
          f"first port bit for bit")

    def split_kernels():
        cuda_surface.surface_cuda(dem, PIPELINE_SURFACE)
        cuda_window.focal_stats_cuda(dem, offsets, PIPELINE_STATS)

    legs = {
        "staged": lambda: pipeline_cuda(dem, offsets, PIPELINE_STATS,
                                        PIPELINE_SURFACE),
        "first port": lambda: pipeline_cuda(dem, offsets, PIPELINE_STATS,
                                            PIPELINE_SURFACE,
                                            route="simple"),
        "split B1 + B2": split_kernels}
    times = {k: [] for k in legs}
    for k in (*legs, *reversed(legs)):
        times[k].append(cuda_time_ms(legs[k], 10))
    t = {k: sum(v) / len(v) for k, v in times.items()}
    print(f"  pipeline_kernel, slope + hillshade + 4 stats at {N}x{N}, in "
          f"turns: staged {t['staged']:.4f} ms, first port by name "
          f"{t['first port']:.4f} ms, the split kernels (staged B1 + staged "
          f"B2) {t['split B1 + B2']:.4f} ms: "
          f"{'fused' if t['staged'] < t['split B1 + B2'] else 'split'} "
          f"wins, {card}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return launches["pipeline_kernel"], max_err, ms, t["first port"]


def annulus_path(dem, agg, card):
    """Phase 11: focal_stats over the 512-offset annulus at N^2."""
    import torch
    from xrspatial_torch import focal_stats
    from xrspatial_torch.kernels import cuda_window
    from xrspatial_torch.kernels.focal_halo import halo_plan
    from xrspatial_torch.kernels.window import kernel_offsets, window_stats
    kernel = halo_footprints()["annulus_40_38"]
    offsets = kernel_offsets(kernel)
    plan = halo_plan(N, N, offsets, dem.data_ptr())
    print(f"== annulus focal path: focal_stats, annulus_kernel(1, 1, 40, 38) "
          f"({len(offsets)} offsets), {N}x{N}; plan {plan}")
    if plan.route != "tma":
        raise SmokeFailure(f"annulus path: planned on {plan.route}, not TMA")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = focal_stats(agg, kernel, list(PIPELINE_STATS)).data
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"  first call {first_ms:.1f} ms (host clock), launches "
          f"{launches}, peak allocated {peak_gib:.2f} GiB")
    if launches != {k: int(k in ("focal_halo_kernel", "focal_halo_tma"))
                    for k in launches}:
        raise SmokeFailure(f"annulus path: expected one halo launch on the "
                           f"TMA route and no other, got {launches}")
    if out.device.type != "cuda" or tuple(out.shape) != (
            len(PIPELINE_STATS), N, N) or not bool(torch.isfinite(out).all()):
        raise SmokeFailure(f"annulus focal_stats: {tuple(out.shape)} on "
                           f"{out.device}, or non-finite values")
    mean, smax, smin, std = out
    if not (bool((smin <= mean + 1e-3).all())
            and bool((mean <= smax + 1e-3).all()) and bool((std >= 0).all())):
        raise SmokeFailure("annulus stats out of order")
    del mean, smax, smin, std
    print("  full-size agreement with the twin path and the ring route")
    ref = window_stats(dem, offsets, PIPELINE_STATS)
    max_err = max(check(f"annulus {s}", out[i], ref[s], FOCAL_TOL)
                  for i, s in enumerate(PIPELINE_STATS))
    del ref
    ring = cuda_window.focal_stats_halo_cuda(dem, offsets, PIPELINE_STATS,
                                             route="ring")
    if not same_bits(out, ring):
        raise SmokeFailure("annulus path: the TMA route differs from the "
                           "ring route")
    del ring, out
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"== timing: annulus focal path at {N}x{N} on {card}")
    # the DEM with a nodata cell in every tile: every window holds a NaN,
    # so no block takes the NaN-free branch
    holed = dem.clone()
    holed[::plan.tile[0], plan.tile[1] // 2::plan.tile[1]] = float("nan")
    staged = cuda_window.focal_stats_halo_cuda(holed, offsets, PIPELINE_STATS)
    ring = cuda_window.focal_stats_halo_cuda(holed, offsets, PIPELINE_STATS,
                                             route="ring")
    if not same_bits(staged, ring):
        raise SmokeFailure("annulus with nodata in every tile: the TMA route "
                           "differs from the ring route")
    print("  with a nodata cell in every tile: the TMA route equal to the "
          "ring route bit for bit")
    del staged, ring
    legs = {
        "staged": (lambda: cuda_window.focal_stats_halo_cuda(
            dem, offsets, PIPELINE_STATS), 5),
        "staged, nodata": (lambda: cuda_window.focal_stats_halo_cuda(
            holed, offsets, PIPELINE_STATS), 5),
        "ring": (lambda: cuda_window.focal_stats_halo_cuda(
            dem, offsets, PIPELINE_STATS, route="ring"), 2),
        "tiled": (lambda: cuda_window.focal_stats_cuda(
            dem, offsets, PIPELINE_STATS, route="simple"), 2),
        "twin": (lambda: window_stats(dem, offsets, PIPELINE_STATS), 1)}
    times = {k: [] for k in legs}
    for k in (*legs, *reversed(legs)):
        fn, reps = legs[k]
        times[k].append(cuda_time_ms(fn, reps))
    t = {k: sum(v) / len(v) for k, v in times.items()}
    print(f"  focal_halo_kernel, in turns: staged ({plan.route}, tile "
          f"{plan.tile[0]}x{plan.tile[1]}) {t['staged']:.3f} ms (with a "
          f"nodata cell in every tile: {t['staged, nodata']:.3f} ms), ring "
          f"route by name {t['ring']:.3f} ms, focal_kernel's first port by "
          f"name on the same footprint {t['tiled']:.3f} ms, twin "
          f"{t['twin']:.3f} ms; "
          f"staged {t['ring'] / t['staged']:.2f}x the ring's speed, "
          f"{t['tiled'] / t['staged']:.2f}x the tiled kernel's, {card}")
    del holed
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return launches["focal_halo_kernel"], max_err, (t["staged"], t["twin"])


def torch_op_paths(dev, card):
    """Phase 12: the torch-op paths on the card against the CPU, under
    PyTorch's default TF32 flags; the conv path timed at N^2."""
    import torch
    import torch.nn.functional as F
    import xrspatial_torch as xt
    from xrspatial_torch import focal
    from xrspatial_torch.convolution import (circle_kernel, convolution_2d,
                                             convolve_2d)
    from xrspatial_torch.kernels import window
    from xrspatial_torch.kernels.window import _conv2d, kernel_offsets
    cudnn = torch.backends.cudnn
    flags = (f"cudnn.conv.fp32_precision={cudnn.conv.fp32_precision}"
             if hasattr(cudnn, "conv") and hasattr(cudnn.conv,
                                                    "fp32_precision")
             else f"cudnn.allow_tf32={cudnn.allow_tf32}")
    print(f"== torch-op paths, card vs CPU at {OPS_N}x{OPS_N}, PyTorch's "
          f"flags as they are: cudnn.enabled={cudnn.enabled}, {flags}")
    dem = gaussian_bump(OPS_N, OPS_N, "cpu")
    dem[100:140, 300:360] = np.nan
    host = xt.DataArray(dem, dims=("y", "x"), attrs={"res": (1.0, 1.0)})
    card_agg = xt.DataArray(dem.to(dev), dims=("y", "x"),
                            attrs={"res": (1.0, 1.0)})
    big = circle_kernel(1, 1, 20)
    n_big = len(kernel_offsets(big))
    stats = ["mean", "sum", "max", "min", "std", "var"]
    got = xt.focal_stats(card_agg, big, stats).data
    ref = xt.focal_stats(host, big, stats).data.to(dev)
    # The conv path centres on c, the raster's nanmean: mean = S/n + c and
    # sum = S + n*c cancel where a window's mean is near 0, so their rtol
    # 1e-5 also applies to |c| (and n*|c|); var = Q/n - (S/n)^2 cancels
    # where the window's mean is far from c, so its rtol 1e-5 applies to
    # Q/n = (mean - c)^2 + var, and std's to the root of that
    # (|sqrt(a) - sqrt(b)| <= sqrt(|a - b|)).  S and Q are the centred sum
    # and sum of squares; min and max are exact.
    c = float(torch.nanmean(dem))
    q = (ref[stats.index("mean")] - c) ** 2 + ref[stats.index("var")]
    tols = {"mean": dict(rtol=1e-5, atol=1e-5 * abs(c)),
            "sum": dict(rtol=1e-5, atol=1e-5 * abs(c) * n_big),
            "max": OPS_TOL, "min": OPS_TOL,
            "var": dict(rtol=1e-5, atol=1e-5 * q),
            "std": dict(rtol=1e-5, atol=torch.sqrt(1e-5 * q))}
    print(f"  conv path: global mean c = {c:.3f}")
    for i, s in enumerate(stats):
        check(f"conv path ({n_big} offsets) {s}", got[i], ref[i], tols[s])
    # control: the same check with the port's float32 scope taken out, so
    # that cuDNN runs under PyTorch's default flags (informational)
    saved = window._cudnn_full_fp32
    window._cudnn_full_fp32 = contextlib.nullcontext
    try:
        loose = xt.focal_stats(card_agg, big, stats).data
    finally:
        window._cudnn_full_fp32 = saved
    misses = {s: compare(loose[i], ref[i], **tols[s])[0]
              for i, s in enumerate(stats)}
    print(f"  control, the port's float32 scope taken out: cells outside the "
          f"same tolerances {misses} (informational)")
    del loose
    weighted = np.outer([1, 4, 6, 4, 1], [1, 4, 6, 4, 1]) / 256.0
    check("convolution_2d 5x5 weighted", convolution_2d(card_agg,
                                                         weighted).data,
          convolution_2d(host, weighted).data.to(dev), OPS_TOL)
    check("mean, 2 passes", xt.mean(card_agg, passes=2).data,
          xt.mean(host, passes=2).data.to(dev), OPS_TOL)
    k1 = circle_kernel(1, 1, 1.5)
    hot = focal.hotspots(card_agg, k1).data
    hot_ref = focal.hotspots(host, k1).data
    # z on the CPU; classes may differ only within 1e-5 of a threshold
    d = dem.double()
    conv = convolve_2d(dem, k1 / k1.sum()).double()
    m = torch.nanmean(d)
    z = ((conv - m) / torch.sqrt(torch.nanmean((d - m) ** 2))).abs()
    near = torch.zeros_like(z, dtype=torch.bool)
    for t in Z_THRESHOLDS:
        near |= (z - t).abs() <= 1e-5
    differ = hot.cpu() != hot_ref
    n_bad = int((differ & ~near).sum())
    print(f"  hotspots: {int(differ.sum())} cells differ, {int(near.sum())} "
          f"cells within 1e-5 of a threshold, bad_cells={n_bad}; classes "
          f"{sorted(int(v) for v in torch.unique(hot_ref))}")
    if hot.dtype != torch.int8 or n_bad:
        raise SmokeFailure(f"hotspots: {n_bad} cells in another class than "
                           f"on the CPU")
    del got, ref, hot, hot_ref
    print(f"== timing: conv path at {N}x{N} on {card}")
    dem_n = gaussian_bump(N, N, dev)
    agg_n = xt.DataArray(dem_n, dims=("y", "x"), attrs={"res": (1.0, 1.0)})
    conv_ms = cuda_time_ms(
        lambda: xt.focal_stats(agg_n, big, list(PIPELINE_STATS)), 2)
    mask = torch.from_numpy((big == 1).astype(np.float32)).to(dev)
    padded = F.pad(dem_n, (20, 20, 20, 20))
    one_conv = cuda_time_ms(lambda: _conv2d(padded, mask), 2)
    one_pool = cuda_time_ms(lambda: F.max_pool2d(padded[None, None], (1, 41),
                                                 stride=1), 2)
    print(f"  focal_stats over circle_kernel(1, 1, 20) ({n_big} offsets, "
          f"the conv path): {conv_ms:.3f} ms; one 41x41 float32 cuDNN "
          f"convolution {one_conv:.3f} ms (3 a call), one (1, 41) max pool "
          f"{one_pool:.3f} ms (82 a call), {card}")
    del dem_n, agg_n, padded
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# -- the exact viewshed --------------------------------------------------------

def vs_cases(dev):
    """The screen-check shapes: label -> (float64 host raster, (row, col),
    observer_elev, target_elev, ew_res, ns_res).  The last is the plan of
    the main path's call."""
    import torch

    def ridge(shape, seed, n_nan):
        rng = np.random.default_rng(seed)
        data = rng.random(shape) * 60.0
        data[shape[0] // 3, :] += 100.0
        data[np.unravel_index(rng.integers(0, data.size, n_nan), shape)] = \
            np.nan
        return data

    bench = gaussian_bump(VS_N, VS_N, dev).to("cpu", torch.float64).numpy()
    x, y, oe = VS_VIEW
    return {"48x64": (ridge((48, 64), 601, 20), (10, 10), 3.0, 0.5, 1.5,
                      -1.0),
            "64x48 corner": (ridge((64, 48), 602, 20), (0, 0), 3.0, 0.5, 1.5,
                             -1.0),
            "96x112 NaN cells": (ridge((96, 112), 603, 200), (50, 30), 3.0,
                                 0.5, 1.0, -1.0),
            "300x70": (ridge((300, 70), 604, 20), (200, 60), 2.0, 0.0, 1.0,
                       -1.0),
            "257x1025": (ridge((257, 1025), 605, 50), (100, 700), 2.0, 0.0,
                         1.0, -1.0),
            f"{VS_N}x{VS_N} bench plan": (bench, (VS_N - 1 - y, x), oe, 0.0,
                                          1.0, -1.0)}


def check_screen(dev):
    """Phase 13: the interval-screen kernel against its twin, on the same
    expanded stacks, at both levels: the culled route (the default) and the
    first port by name, bit for bit in hi and lo, and the culled route's
    pre-pass against its twin."""
    import torch
    from xrspatial_torch.kernels import cuda_screen, screen
    from xrspatial_torch.kernels import viewshed_exact as ve
    print("== interval-screen kernel vs twin on the card (float32 level 1, "
          "float64 level 2; the culled route and the first port by name)")
    err = 0.0
    for label, (data, (vr, vc), oe, te, ew, ns) in vs_cases(dev).items():
        for level in (1, 2):
            args = ve.screen_inputs(data, vr, vc, oe, te, ew, ns, level=level,
                                    device=dev)
            before = (cuda_screen.CULLED_LAUNCHES,
                      cuda_screen.SIMPLE_LAUNCHES)
            stats = torch.zeros(4, dtype=torch.int64, device=dev)
            got = cuda_screen.screen_hilo_cuda(*args, stats=stats)
            first = cuda_screen.screen_hilo_cuda(*args, route="simple")
            ref = screen.screen_hilo(*args)
            torch.cuda.synchronize()
            if (cuda_screen.CULLED_LAUNCHES - before[0],
                    cuda_screen.SIMPLE_LAUNCHES - before[1]) != (1, 1):
                raise SmokeFailure(f"screen {label} level {level}: launches "
                                   f"not counted on their routes")
            for route, pair in (("culled", got), ("simple", first)):
                for name, g, r in zip(("hi", "lo"), pair, ref):
                    if g.dtype != r.dtype or not torch.equal(g, r):
                        n_bad = int((g != r).sum())
                        raise SmokeFailure(
                            f"screen {label} level {level} {name}, route "
                            f"{route}: {n_bad} targets differ from the twin")
                    fin = torch.isfinite(r)
                    if bool(fin.any()):
                        err = max(err, float((g - r)[fin].abs().max()))
            if not torch.equal(cuda_screen.chunk_bounds_cuda(args[0],
                                                             args[1]),
                               screen.chunk_bounds(args[0], args[1])):
                raise SmokeFailure(f"screen {label} level {level}: the "
                                   f"pre-pass differs from its twin")
            A, C, Es, NBs, B = args[7:]
            pairs, kept, culled, staged = stats.tolist()
            print(f"  screen {label} level {level} ({got[0].dtype}): A={A} "
                  f"C={C} B={B} Lg={args[0][1].shape[0]} E={Es} NB={NBs}: "
                  f"culled and first port bit for bit; {culled} of "
                  f"{kept + culled} (warp, chunk) pairs culled, {pairs} pairs "
                  f"evaluated, {staged} chunks staged")
            del args, got, first, ref
        torch.cuda.synchronize()
    return err


@contextlib.contextmanager
def screen_on_kernel():
    """Make any call of the screen's twin fail inside the block."""
    from xrspatial_torch.kernels import screen
    saved = screen.screen_hilo

    def refuse(*args, **kwargs):
        raise SmokeFailure("the screen's twin ran on the kernel path")

    screen.screen_hilo = refuse
    try:
        yield
    finally:
        screen.screen_hilo = saved


@contextlib.contextmanager
def env_set(**values):
    """Environment variables set inside the block."""
    import os
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def vs_raster(dev):
    """The JAX bench's exact-viewshed raster, on the card."""
    import xrspatial_torch as xt
    coords = {"y": np.arange(VS_N, dtype=float)[::-1].copy(),
              "x": np.arange(VS_N, dtype=float)}
    return xt.DataArray(gaussian_bump(VS_N, VS_N, dev), dims=("y", "x"),
                        coords=coords, attrs={"res": (1.0, 1.0)}, name="deme")


def viewshed_path(dev):
    """Phase 14: the exact viewshed at VS_N^2 on the card, the call the JAX
    package's bench makes; one float32 screen launch, one float64 launch per
    level-2 slab, no twin call; equal to the float64-only route at every
    cell, and the pairwise oracle on a 256^2 crop."""
    import torch
    import xrspatial_torch as xt
    from xrspatial_torch.kernels import cuda_screen
    from xrspatial_torch.kernels import viewshed as kv
    from xrspatial_torch.kernels import viewshed_exact as ve
    x, y, oe = VS_VIEW
    vr, vc = VS_N - 1 - y, x
    print(f"== exact viewshed path: viewshed on gaussian_bump({VS_N}, {VS_N}), "
          f"x={x}, y={y} (row {vr}, col {vc}), observer_elev={oe}, default "
          f"exact")
    agg = vs_raster(dev)
    torch.cuda.synchronize()
    with screen_on_kernel():
        reset_launches()
        t0 = time.perf_counter()
        out = xt.viewshed(agg, x=x, y=y, observer_elev=oe).data
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = read_launches()
        f64 = cuda_screen.F64_LAUNCHES
        culled = (cuda_screen.CULLED_LAUNCHES, cuda_screen.BOUNDS_LAUNCHES)
    call = dict(ve.LAST_CALL)
    print(f"  first call {first_s:.3f} s (host clock), launches {launches} "
          f"({f64} float64), level-1 ambiguous {call['amb1']}, level-2 "
          f"ambiguous {call['amb2']}, route {call['route']}, level-2 slabs "
          f"{call['slabs']}")
    if not only(launches, "screen_hilo", 1 + call["slabs"]) \
            or f64 != call["slabs"] \
            or culled != (1 + call["slabs"],) * 2:
        raise SmokeFailure(f"viewshed: expected one float32 screen launch and "
                           f"{call['slabs']} float64 ones, each on the culled "
                           f"route after its pre-pass, got {launches} ({f64} "
                           f"float64; culled and pre-pass {culled})")
    if out.device.type != "cuda" or out.dtype != torch.float64 \
            or tuple(out.shape) != (VS_N, VS_N):
        raise SmokeFailure(f"viewshed: {tuple(out.shape)} {out.dtype} on "
                           f"{out.device}")
    if float(out[vr, vc]) != 180.0:
        raise SmokeFailure(f"viewshed: {float(out[vr, vc])} at the viewpoint")
    if not bool(((out == -1) | ((out >= 0) & (out <= 180))).all()):
        raise SmokeFailure("viewshed: values outside -1 and [0, 180]")
    print(f"  {int((out > -1).sum())} of {VS_N * VS_N} cells visible")
    with env_set(XRSPATIAL_VS_NO_SCREEN="1"):
        t0 = time.perf_counter()
        ref = xt.viewshed(agg, x=x, y=y, observer_elev=oe).data
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
    if not torch.equal(out, ref):
        raise SmokeFailure(f"viewshed: {int((out != ref).sum())} cells differ "
                           f"from the float64-only route")
    print(f"  equal at every cell to the float64-only route "
          f"(XRSPATIAL_VS_NO_SCREEN=1, {ref_s:.3f} s)")
    del ref
    r0, c0 = vr - VS_CROP // 2, vc - VS_CROP // 2
    crop = agg.data[r0:r0 + VS_CROP, c0:c0 + VS_CROP].contiguous()
    cagg = xt.DataArray(crop, dims=("y", "x"), coords={
        "y": np.arange(VS_CROP, dtype=float)[::-1].copy(),
        "x": np.arange(VS_CROP, dtype=float)})
    cr, cc = VS_CROP // 2 - 28, VS_CROP // 2 + 22   # its own viewpoint
    got = xt.viewshed(cagg, x=cc, y=VS_CROP - 1 - cr, observer_elev=oe).data
    t0 = time.perf_counter()
    pw = kv.viewshed_grid(crop, cr, cc, oe, 0.0, 1.0, -1.0)
    torch.cuda.synchronize()
    pw_s = time.perf_counter() - t0
    if pw.device.type != "cuda" or not torch.equal(got, pw):
        raise SmokeFailure(f"viewshed {VS_CROP}^2 crop: differs from the "
                           f"pairwise oracle on {pw.device}")
    print(f"  {VS_CROP}x{VS_CROP} crop (rows {r0}.., cols {c0}.., viewpoint "
          f"{cr}, {cc}): equal at every cell to the pairwise oracle "
          f"viewshed_grid on the card ({pw_s:.3f} s)")
    del crop, got, pw
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return launches["screen_hilo"], call, out


def screen_pair_counts(args):
    """(pairs the screen evaluates, pairs that pass its maybe or sure test)
    for screen inputs `args`, over the twin's windows."""
    import torch
    from xrspatial_torch.kernels.screen import F13
    glob, stacks, al, klo, khi, it, rows, A, C, Es, NBs, B = args
    G, T = A // B, B * C
    f = {k: i for i, k in enumerate(F13)}
    starts = rows.tolist()
    total = covered = 0
    for g in range(G):
        sl = slice(g * T, (g + 1) * T)
        a, kl, kh, i = (v[sl, None] for v in (al, klo, khi, it))
        segs = [glob]
        for t, ((stk, idx), E, NB) in enumerate(zip(stacks, Es, NBs)):
            nb = min(NB, idx.shape[0])
            r = max(0, min(starts[g][t], idx.shape[0] - nb))
            segs.append((stk[r:r + nb].transpose(0, 1).reshape(len(F13), -1),
                         idx[r:r + nb].reshape(-1)))
        for fld, idx in segs:
            other = idx[None] != i
            maybe = ((a > fld[f["a0w"]]) & (a < fld[f["a2w"]])
                     & (fld[f["key"]] < kh) & other)
            sure = ((a > fld[f["a0n"]]) & (a < fld[f["a2n"]])
                    & (fld[f["key"]] < kl) & other)
            covered += int((maybe | sure).sum())
            total += T * idx.numel()
    return total, covered


def screen_bytes(args):
    """Bytes the screen must move: every input read once (targets, rows,
    the whole tables), the two outputs written once."""
    glob, stacks, al, klo, khi, it, rows, *_ = args
    tensors = [al, klo, khi, it, rows, *glob] + [t for st in stacks
                                                 for t in st]
    return (sum(t.numel() * t.element_size() for t in tensors)
            + 2 * al.numel() * al.element_size())


def prepass_bytes(args):
    """Bytes the culled route's pre-pass moves: the a0w and a2w rows of
    every table read, two bounds a 128-candidate chunk written."""
    from xrspatial_torch.kernels.screen import CHUNK
    glob, stacks = args[0], args[1]
    cands = glob[1].numel() + sum(idx.numel() for _, idx in stacks)
    return (2 * cands + 2 * cands // CHUNK) * glob[0].element_size()


def viewshed_timing(dev, card, out):
    """Phase 15: the exact viewshed's warm wall time and phases, the screen
    kernel against its twin at the main path's plan, and every re-evaluation
    route forced through the module's thresholds."""
    import torch
    import xrspatial_torch as xt
    from xrspatial_torch.kernels import cuda_screen, screen
    from xrspatial_torch.kernels import viewshed_exact as ve
    x, y, oe = VS_VIEW
    print(f"== timing: exact viewshed at {VS_N}x{VS_N} on {card}")
    agg = vs_raster(dev)

    def call():
        o = xt.viewshed(agg, x=x, y=y, observer_elev=oe).data
        torch.cuda.synchronize()
        return o

    call()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        call()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"  viewshed warm (host clock around a synchronised call, 3 calls): "
          f"mean {sum(walls) / 3:.3f} ms, each "
          f"{', '.join(f'{w:.3f}' for w in walls)} ms, {card}")
    from torch.profiler import ProfilerActivity, profile
    from xrspatial_torch import tracing
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        call()
    print("  phases (host ms of each viewshed_exact span, one call under "
          "torch.profiler):")
    for s in sorted(tracing.spans(), key=lambda s: s.t0):
        if s.name.startswith("viewshed_exact."):
            print(f"    {s.name}: {(s.t1 - s.t0) * 1e3:.3f} ms")
    vr, vc = VS_N - 1 - y, x
    data = agg.data.to(torch.float64).cpu().numpy()
    args = ve.screen_inputs(data, vr, vc, oe, 0.0, 1.0, -1.0, level=1,
                            device=dev)
    legs = {"culled": (lambda: cuda_screen.screen_hilo_cuda(*args), 10),
            "pre-pass": (lambda: cuda_screen.chunk_bounds_cuda(args[0],
                                                               args[1]), 10),
            "simple": (lambda: cuda_screen.screen_hilo_cuda(
                *args, route="simple"), 10),
            "twin": (lambda: screen.screen_hilo(*args), 1)}
    times = {k: [] for k in legs}
    for k in (*legs, *reversed(legs)):
        fn, reps = legs[k]
        times[k].append(cuda_time_ms(fn, reps))
    t = {k: sum(v) / len(v) for k, v in times.items()}
    ms = (t["culled"], t["twin"])
    stats = torch.zeros(4, dtype=torch.int64, device=dev)
    cuda_screen.screen_hilo_cuda(*args, stats=stats)
    evaluated, kept, culled, staged = stats.tolist()
    share = culled / (kept + culled)
    pairs, covered = screen_pair_counts(args)
    nbytes, pre_nbytes = screen_bytes(args), prepass_bytes(args)
    print(f"  screen_hilo at the {VS_N}^2 plan (float32), in turns: culled "
          f"route {t['culled']:.4f} ms (its pre-pass alone "
          f"{t['pre-pass']:.4f} ms), first port by name {t['simple']:.4f} ms, "
          f"twin {t['twin']:.3f} ms, {card}; {pairs} pairs in the plan "
          f"({pairs / t['culled'] / 1e6:.1f} Gpairs/s on the culled route, "
          f"{pairs / t['simple'] / 1e6:.1f} on the first port), {covered} pass "
          f"the maybe or sure test; the culled route evaluated {evaluated} "
          f"pairs ({evaluated / pairs:.4f} of the plan's) and culled {culled} "
          f"of {kept + culled} (warp, chunk) pairs ({share:.4f}), staging "
          f"{staged} chunks; {nbytes} bytes of inputs and outputs, "
          f"{pre_nbytes} more for the pre-pass")
    timing = {"simple_ms": t["simple"], "prepass_ms": t["pre-pass"],
              "evaluated": evaluated, "culled_share": share}
    del args
    routes = (("default", {}),
              ("level-2 re-screen", {"_L2_MIN_AMB": 0}),
              ("level-2 re-screen in slabs of 2", {"_L2_MIN_AMB": 0,
                                                   "_L2_SLAB": 2}),
              ("safety valve", {"_VALVE_MIN_AMB": 0, "_VALVE_FRAC": 0.0}))
    for label, patch in routes:
        saved = {k: getattr(ve, k) for k in patch}
        for k, v in patch.items():
            setattr(ve, k, v)
        try:
            reset_launches()
            t0 = time.perf_counter()
            o = call()
            wall = (time.perf_counter() - t0) * 1e3
            launches = read_launches()["screen_hilo"]
            f64 = cuda_screen.F64_LAUNCHES
        finally:
            for k, v in saved.items():
                setattr(ve, k, v)
        if not torch.equal(o, out):
            raise SmokeFailure(f"viewshed, route {label}: differs from the "
                               f"default route")
        print(f"  route {label} {patch}: {wall:.3f} ms (host clock), "
              f"{ve.LAST_CALL}, screen launches {launches} ({f64} float64), "
              f"equal to the default at every cell, {card}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return ms, timing, pairs, covered, evaluated, nbytes, pre_nbytes


# -- the surface family: stacked kernel, stream probes, geodesic, shadows ----

# B0's extra shapes: odd H * W (every plane at its own phase), an aligned
# ragged width (TMA), and w = 119 (a second tile for the last span)
STACKED_SHAPES = SMALL_SHAPES + ((257, 1025), (263, 516), (40, 119))


def stacked_route_launches():
    """B0's launches by route."""
    from xrspatial_torch.kernels import cuda_surface
    return {"tma": cuda_surface.STACKED_TMA_LAUNCHES,
            "phased": cuda_surface.STACKED_PHASED_LAUNCHES,
            "simple": cuda_surface.STACKED_SIMPLE_LAUNCHES}


def check_stacked(dev):
    """Phase 16: B0 on the route its plan names, on the phased route and
    its first port by name, against B1 and each other bit for bit and the
    twin within the surface tolerance, at the small shapes, odd H * W, an
    aligned ragged 263x516 and w = 119, from an aligned base and one 4
    bytes off, in several orders; each launch counted on its route."""
    import torch
    from xrspatial_torch.kernels import cuda_surface
    from xrspatial_torch.kernels.surface import (stacked_plan,
                                                 surface_multi_stacked)
    print("== stacked surface kernel B0: routes vs first port, surface "
          "kernel and twin on the card")
    err = 0.0
    planned = {"tma": 0, "phased": 0}
    cases = [(w, False) for w in STACK_ORDERS] + [(("slope",), True)]
    args = (2.0, 3.0, 300.0, 40.0)
    for k, shape in enumerate(STACKED_SHAPES):
        x0 = torch.from_numpy(surface_raster(shape, seed=700 + k)).to(dev)
        for label, x in (("aligned", x0), ("base+4", unaligned(x0))):
            for which, squeeze in cases:
                twin = surface_multi_stacked(x, *args, which=which,
                                             squeeze=squeeze)
                split = cuda_surface.surface_cuda(x, which, *args)
                want = shape if squeeze else (len(which), *shape)
                plan = stacked_plan(*shape, x.data_ptr()).route
                planned[plan] += 1
                tag = f"stacked {shape} {label} {'+'.join(which)}" + (
                    " squeezed" if squeeze else "")
                outs = {}
                for route in (None, "phased", "simple"):
                    before = stacked_route_launches()
                    got = cuda_surface.surface_stacked_cuda(
                        x, which, *args, squeeze=squeeze, route=route)
                    n = launched_since(stacked_route_launches, before)
                    ran = plan if route is None else route
                    if n != {r: int(r == ran) for r in n}:
                        raise SmokeFailure(f"{tag}: route {route} (plan "
                                           f"{plan}), launches {n}")
                    if tuple(got.shape) != want:
                        raise SmokeFailure(f"{tag}: shape {tuple(got.shape)}"
                                           f", expected {want}")
                    outs[ran if route else "plan"] = got[None] \
                        if squeeze else got
                planes = outs["plan"]
                for j, p in enumerate(which):
                    for ran, got in outs.items():
                        if not same_bits(got[j], split[j]):
                            raise SmokeFailure(f"{tag} {p}: route {ran} "
                                               f"differs from the surface "
                                               f"kernel")
                    err = max(err, check(
                        f"{tag} {p} ({plan}; = phased, first port, surface "
                        f"kernel)", planes[j],
                        (twin[None] if squeeze else twin)[j], SURFACE_TOL,
                        circular=360.0 if p == "aspect" else None))
        torch.cuda.synchronize()
    print(f"  routes planned {planned}; launches by route "
          f"{stacked_route_launches()}")
    if not all(planned.values()):
        raise SmokeFailure(f"stacked: a route was never planned: {planned}")
    return err


def stacked_sweep(dem, odd, card):
    """Phase 17b: B0's tiles and ring stages on each route, all four
    products, in turns: TMA at N^2, phased at (N-1)^2 and by name at N^2.
    Returns {label: ms}."""
    from xrspatial_torch.kernels import cuda_surface
    from xrspatial_torch.kernels.surface import PRODUCTS, STACKED_TILES
    legs = {}
    for route, x, n in (("tma", dem, N), ("phased", odd, N - 1)):
        for tile in STACKED_TILES[route]:
            for stages in (2, 3, 4):
                if stages > 2 and tile[0] == 64:
                    continue     # two blocks an SM at most: not the plan's
                legs[f"{route} {tile[0]}x{tile[1]} {stages} stages at "
                     f"{n}^2"] = (
                    lambda r=route, x=x, t=tile, s=stages:
                    cuda_surface.surface_stacked_cuda(
                        x, PRODUCTS, route=r, tile=t, stages=s))
    legs[f"phased 64x120 2 stages at {N}^2 (by name)"] = (
        lambda: cuda_surface.surface_stacked_cuda(dem, PRODUCTS,
                                                  route="phased"))
    times = {k: [] for k in legs}
    for k in (*legs, *reversed(legs)):
        times[k].append(cuda_time_ms(legs[k], 20))
    t = {k: sum(v) / len(v) for k, v in times.items()}
    for k, v in t.items():
        print(f"  B0 sweep, 4 products: {k}: {v:.4f} ms, {card}")
    return t


def surface_family_path(dem, card):
    """Phase 17: ``surface_stacked`` on the N^2 DEM on the card; B0's
    routes against its first port, B1 and the twin at N^2 and (N-1)^2; a
    numpy DEM through ``slope`` with no device set; timings.  Returns
    (launches, max difference from the twin, (ms, twin ms), first port
    ms, the plan at N^2)."""
    import torch
    import xrspatial_torch as xt
    from xrspatial_torch.kernels import cuda_surface
    from xrspatial_torch.kernels.surface import (PRODUCTS, stacked_plan,
                                                 surface_multi,
                                                 surface_multi_stacked,
                                                 surface_stacked)
    print(f"== surface family path: surface_stacked, all four products, "
          f"{N}x{N}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = surface_stacked(dem, 1.0, 1.0, 225.0, 25.0, which=PRODUCTS)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"  first call {first_ms:.1f} ms (host clock), launches "
          f"{launches}, peak allocated {peak_gib:.2f} GiB")
    if launches != {k: int(k in ("surface_stacked_kernel",
                                 "surface_stacked_tma"))
                    for k in launches}:
        raise SmokeFailure(f"surface_stacked: expected one stacked launch on "
                           f"its TMA route and no other, got {launches}")
    if out.device.type != "cuda" or tuple(out.shape) != (4, N, N):
        raise SmokeFailure(f"surface_stacked: {tuple(out.shape)} on "
                           f"{out.device}")
    ring = torch.ones((N, N), dtype=torch.bool, device=dem.device)
    ring[1:-1, 1:-1] = False
    for k, p in enumerate(PRODUCTS):
        if not torch.equal(torch.isnan(out[k]), ring):
            raise SmokeFailure(f"stacked {p}: NaN cells are not exactly the "
                               f"1-cell ring")
    del ring
    split = cuda_surface.surface_cuda(dem, PRODUCTS)
    first = cuda_surface.surface_stacked_cuda(dem, PRODUCTS, route="simple")
    for k, p in enumerate(PRODUCTS):
        if not (same_bits(out[k], split[k]) and same_bits(out[k], first[k])):
            raise SmokeFailure(f"stacked {p}: differs from the surface "
                               f"kernel or B0's first port at {N}x{N}")
    del split, first
    print("  equal at every cell to the surface kernel and to B0's first "
          "port on the same products")
    twin = surface_multi(dem, 1.0, 1.0, 225.0, 25.0, PRODUCTS)
    max_err = max(check(f"stacked {p} vs twin", out[k], twin[p], SURFACE_TOL,
                        circular=360.0 if p == "aspect" else None)
                  for k, p in enumerate(PRODUCTS))
    del twin, out
    # w % 4 != 0: the phased route, against the first port and B1
    odd = dem[:N - 1, :N - 1].contiguous()
    before = stacked_route_launches()
    got = cuda_surface.surface_stacked_cuda(odd, PRODUCTS)
    first = cuda_surface.surface_stacked_cuda(odd, PRODUCTS, route="simple")
    split = cuda_surface.surface_cuda(odd, PRODUCTS)
    if launched_since(stacked_route_launches, before) != {
            "tma": 0, "phased": 1, "simple": 1} or not all(
            same_bits(got[k], first[k]) and same_bits(got[k], split[k])
            for k in range(4)):
        raise SmokeFailure(f"stacked at {N - 1}^2: not on the phased route, "
                           f"or differs from the first port or B1")
    del got, first, split
    print(f"  at {N - 1}x{N - 1}: the phased route equal to B0's first port "
          f"and to the surface kernel bit for bit")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    host = gaussian_bump(2048, 2048, "cpu").numpy()
    before = cuda_surface.LAUNCHES
    got = xt.slope(xt.DataArray(host, dims=("y", "x"),
                                attrs={"res": (1.0, 1.0)})).data
    torch.cuda.synchronize()
    if got.device.type != "cuda" or cuda_surface.LAUNCHES != before + 1:
        raise SmokeFailure(f"slope of a numpy DEM ran on {got.device} with "
                           f"{cuda_surface.LAUNCHES - before} launches")
    print(f"  slope of a 2048x2048 numpy DEM, no device set "
          f"(default_device() = {xt.default_device()}): ran on {got.device}, "
          f"one surface kernel launch")
    del got

    print(f"== timing: surface family at {N}x{N}, {N - 1}x{N - 1} and "
          f"{N}x{N + 4} on {card}")
    # N + 4 columns: w % 4 == 0, but every other row starts 16 bytes off a
    # 32-byte sector, so a 128-cell row segment splits two sectors with
    # its neighbours
    wide = gaussian_bump(N, N + 4, dem.device)
    ms = {}
    for n, x in ((N, dem), (N - 1, odd), (N + 4, wide)):
        legs = {
            "B0 (plan)": lambda x=x: cuda_surface.surface_stacked_cuda(
                x, PRODUCTS),
            "B0 first port": lambda x=x: cuda_surface.surface_stacked_cuda(
                x, PRODUCTS, route="simple"),
            "B1, 4 products": lambda x=x: cuda_surface.surface_cuda(
                x, PRODUCTS),
            "twin": lambda x=x: surface_multi_stacked(
                x, 1.0, 1.0, 225.0, 25.0, which=PRODUCTS)}
        if n == N + 4:
            del legs["twin"]
            legs["B0 phased (by name)"] = \
                lambda x=x: cuda_surface.surface_stacked_cuda(
                    x, PRODUCTS, route="phased")
        times = {k: [] for k in legs}
        for k in (*legs, *reversed(legs)):
            times[k].append(cuda_time_ms(legs[k], 3 if k == "twin" else 20))
        ms[n] = {k: sum(v) / len(v) for k, v in times.items()}
        plan = stacked_plan(*x.shape, x.data_ptr())
        print(f"  {x.shape[0]}x{x.shape[1]}, 4 products, in turns: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in ms[n].items())
              + f" (the plan: {plan.route}, tile {plan.tile[0]}x"
                f"{plan.tile[1]}, {plan.stages} stages), {card}")
    stacked_sweep(dem, odd, card)
    del odd, wide
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return (launches["surface_stacked_kernel"], max_err,
            (ms[N]["B0 (plan)"], ms[N]["twin"]), ms[N]["B0 first port"],
            stacked_plan(N, N, dem.data_ptr()))


def check_stream(dev):
    """Phase 18a: the stream kernels against their twins, bit for bit,
    on aligned and unaligned buffers, and at offsets of 0-3 values of
    every pointer from the others' alignment: mismatched ones take the
    scalar route, the others a scalar head and tail around bulk
    copies."""
    import torch
    from xrspatial_torch.kernels import cuda_stream, stream
    print("== stream probes vs twins on the card")
    gen = torch.Generator(device=dev).manual_seed(11)

    def bits(t):
        return t.view(torch.int32)

    for n in (1, 3, 1000, 4096 * 257 + 3, N * 64):
        base = torch.randn(n + 4, generator=gen, device=dev) * 1e3
        other = torch.randn(n + 4, generator=gen, device=dev)
        base[n // 2] = np.nan
        other[0] = -np.inf
        for label, x, y in (("aligned", base[:n], other[:n]),
                            ("unaligned", base[1:n + 1], other[1:n + 1])):
            if not (torch.equal(bits(cuda_stream.stream_copy_cuda(x)),
                                bits(stream.stream_copy(x)))
                    and torch.equal(bits(cuda_stream.stream_add_cuda(x, y)),
                                    bits(stream.stream_add(x, y)))):
                raise SmokeFailure(f"stream {n} {label}: differs from the "
                                   f"twin")
        dest = torch.empty(n + 4, device=dev)
        for xo in range(4):
            x = base[xo:xo + n]
            for yo in range(4):
                got = cuda_stream.stream_copy_cuda(x, out=dest[yo:yo + n])
                if not torch.equal(bits(got), bits(stream.stream_copy(x))):
                    raise SmokeFailure(f"stream copy {n} at offsets {xo}, "
                                       f"{yo}: differs from the twin")
                y = other[yo:yo + n]
                for zo in range(4):
                    got = cuda_stream.stream_add_cuda(x, y,
                                                      out=dest[zo:zo + n])
                    if not torch.equal(bits(got),
                                       bits(stream.stream_add(x, y))):
                        raise SmokeFailure(f"stream add {n} at offsets {xo}, "
                                           f"{yo}, {zo}: differs from the "
                                           f"twin")
        print(f"  n={n}: copy and add equal to the twins bit for bit, "
              f"aligned and unaligned, and at offsets 0-3 of every pointer")
    torch.cuda.synchronize()


def stream_path(card):
    """Phase 18b: ``measure_stream`` at N^2, the tool users run."""
    import io
    import torch
    from xrspatial_torch.tools import measure_stream
    print(f"== stream probes: python -m xrspatial_torch.tools.measure_stream "
          f"{N}")
    torch.cuda.synchronize()
    reset_launches()
    buf = io.StringIO()
    res = measure_stream.measure(N, out=buf)
    torch.cuda.synchronize()
    launches = read_launches()
    for line in buf.getvalue().splitlines():
        print("  " + line)
    if not launches["stream_copy"] or not launches["stream_add"] or any(
            v for k, v in launches.items()
            if k not in ("stream_copy", "stream_add")):
        raise SmokeFailure(f"measure_stream: launches {launches}")
    print(f"  launches {launches}")
    torch.cuda.empty_cache()
    return res, launches


def geodesic_tile(dev):
    """An SRTM 1-arc-second tile's shape and coordinates (rows north to
    south), with gaussian_bump elevations on the card."""
    import xrspatial_torch as xt
    lat = GEO_LAT + 1.0 - np.arange(GEO_N) / 3600.0
    lon = GEO_LON + np.arange(GEO_N) / 3600.0
    return xt.DataArray(gaussian_bump(GEO_N, GEO_N, dev), dims=("y", "x"),
                        coords={"y": lat, "x": lon}, name="srtm")


def geodesic_path(dev, card):
    """Phase 19: geodesic slope and aspect on one SRTM tile on the card."""
    import torch
    import xrspatial_torch as xt
    print(f"== geodesic path: slope and aspect, method='geodesic', "
          f"{GEO_N}x{GEO_N} (lat {GEO_LAT}-{GEO_LAT + 1} N, lon "
          f"{GEO_LON}-{GEO_LON + 1} E, 1/3600 degree)")
    agg = geodesic_tile(dev)
    ring = torch.ones((GEO_N, GEO_N), dtype=torch.bool, device=dev)
    ring[1:-1, 1:-1] = False
    peaks, ms = {}, {}
    for op in ("slope", "aspect"):
        fn = getattr(xt, op)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        out = fn(agg, method="geodesic").data
        torch.cuda.synchronize()
        peaks[op] = torch.cuda.max_memory_allocated() / 2**30
        if any(read_launches().values()):
            raise SmokeFailure(f"geodesic {op}: launched a kernel")
        if out.device.type != "cuda" or out.dtype != torch.float32 \
                or tuple(out.shape) != (GEO_N, GEO_N):
            raise SmokeFailure(f"geodesic {op}: {tuple(out.shape)} "
                               f"{out.dtype} on {out.device}")
        if not torch.equal(torch.isnan(out), ring):
            raise SmokeFailure(f"geodesic {op}: NaN cells are not exactly "
                               f"the 1-cell ring")
        inner = out[1:-1, 1:-1]
        # a float64 bearing just below 360 rounds to 360.0 in float32
        ok = ((inner >= 0) & (inner < 90)) if op == "slope" else (
            (inner == -1) | ((inner >= 0) & (inner <= 360)))
        if not bool(ok.all()):
            raise SmokeFailure(f"geodesic {op}: values outside its range")
        print(f"  {op}: range [{float(inner.min()):.4f}, "
              f"{float(inner.max()):.4f}], peak allocated "
              f"{peaks[op]:.2f} GiB")
        del out, inner
        ms[op] = cuda_time_ms(lambda fn=fn: fn(agg, method="geodesic"), 3)
    del ring
    r0 = c0 = (GEO_N - GEO_CROP) // 2
    crop = agg.data[r0:r0 + GEO_CROP, c0:c0 + GEO_CROP].contiguous()
    coords = {"y": agg["y"].data[r0:r0 + GEO_CROP],
              "x": agg["x"].data[c0:c0 + GEO_CROP]}
    tol = dict(rtol=GEO_RTOL, atol=0.0)
    for op in ("slope", "aspect"):
        fn = getattr(xt, op)
        card_out = fn(xt.DataArray(crop, dims=("y", "x"), coords=coords),
                      method="geodesic").data
        cpu_out = fn(xt.DataArray(crop.cpu(), dims=("y", "x"),
                                  coords=coords), method="geodesic").data
        check(f"geodesic {op} {GEO_CROP}^2 crop, card vs CPU", card_out,
              cpu_out.to(dev), tol,
              circular=360.0 if op == "aspect" else None)
        if op == "slope":
            # the bearing of a gradient g moves by up to noise / |g| radians
            # when the fit's gradient moves by its float64 noise: near a
            # summit the card's and the CPU's float64 trig part by more
            # than rtol
            grad = torch.tan(torch.deg2rad(cpu_out.double()))
            tol = dict(rtol=GEO_RTOL, atol=torch.nan_to_num(
                np.degrees(GEO_GRAD_NOISE) / grad, nan=0.0).float().to(dev))
    print(f"== timing: geodesic at {GEO_N}x{GEO_N} on {card}")
    print(f"  warm (3 calls): slope {ms['slope']:.3f} ms, aspect "
          f"{ms['aspect']:.3f} ms ({GEO_N * GEO_N / 1e3 / ms['slope']:.1f} "
          f"Mpix/s slope); peak allocated slope {peaks['slope']:.2f} GiB, "
          f"aspect {peaks['aspect']:.2f} GiB, {card}")
    del agg, crop
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def shadows_path(dev, card):
    """Phase 20: hillshade with cast shadows at SHADOW_N^2 on the card."""
    import torch
    import xrspatial_torch as xt
    from xrspatial_torch.kernels import shadows
    az, alt = SHADOW_SUN
    print(f"== shadows path: hillshade(shadows=True), {SHADOW_N}x{SHADOW_N}, "
          f"azimuth {az}, altitude {alt}")
    dem = gaussian_bump(SHADOW_N, SHADOW_N, dev)
    agg = xt.DataArray(dem, dims=("y", "x"), attrs={"res": (1.0, 1.0)})
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = xt.hillshade(agg, az, alt, shadows=True).data
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if any(read_launches().values()):
        raise SmokeFailure("shadows: launched a kernel")
    if out.device.type != "cuda" or tuple(out.shape) != (SHADOW_N, SHADOW_N) \
            or not bool(torch.isfinite(out).all()) \
            or not bool(((out >= 0) & (out <= 1)).all()):
        raise SmokeFailure(f"shadows: {tuple(out.shape)} on {out.device}, or "
                           f"values outside [0, 1]")
    print(f"  peak allocated {peak_gib:.2f} GiB")
    del out
    r0 = SHADOW_N // 2 - SHADOW_N // 16 - SHADOW_CROP // 2
    c0 = SHADOW_N // 2 + SHADOW_N // 16 - SHADOW_CROP // 2
    crop = dem[r0:r0 + SHADOW_CROP, c0:c0 + SHADOW_CROP].contiguous()
    t0 = time.perf_counter()
    lit_cpu = shadows.shadow_mask(crop.cpu(), az, alt, 1.0, 1.0)
    shade_cpu = xt.hillshade(xt.DataArray(crop.cpu(), dims=("y", "x"),
                                          attrs={"res": (1.0, 1.0)}),
                             az, alt, shadows=True).data
    cpu_s = time.perf_counter() - t0
    lit_card = shadows.shadow_mask(crop, az, alt, 1.0, 1.0)
    shade_card = xt.hillshade(xt.DataArray(crop, dims=("y", "x"),
                                           attrs={"res": (1.0, 1.0)}),
                              az, alt, shadows=True).data
    n_diff = int((lit_card.cpu() != lit_cpu).sum())
    print(f"  {SHADOW_CROP}^2 crop: {int((~lit_cpu).sum())} cells in shadow "
          f"on the CPU, lit mask differs at {n_diff} cells (CPU "
          f"{cpu_s:.1f} s)")
    if n_diff:
        raise SmokeFailure(f"shadows crop: the lit mask differs from the CPU "
                           f"at {n_diff} cells")
    check("shadows crop shade, card vs CPU", shade_card, shade_cpu.to(dev),
          SHADOW_TOL)
    phase_s = time.perf_counter() - t_phase
    print(f"== timing: shadows at {SHADOW_N}x{SHADOW_N} on {card}")
    print(f"  hillshade(shadows=True) (host clock around a synchronised "
          f"call): warm-up {walls[0]:.3f} s, then {walls[1]:.3f} s and "
          f"{walls[2]:.3f} s; the phase {phase_s:.1f} s, {card}")
    del dem, agg, crop
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# -- the stencil probes (B8c-f) and the fused jump-flood group (B8g) ---------

PROBE_SHAPES = ((300, 70), (257, 1025))
STAGED_RAGGED = (263, 516)           # ragged, but TMA's pitch rule holds
PROBE_TILE = (64, 128)               # the tile B8c-f's rows report (B1's)
GROUP_TAIL = (16, 8, 4, 2, 1, 2, 1)   # the last rounds of proximity at N
JFA_FIXED_N = 4096                   # the JAX probe's raster edge
GROUPS = {"tail": GROUP_TAIL, "64": (64,), "2_1": (2, 1)}
# (label, metric, axes): the round kernel's metrics in each state form
GROUP_MODES = {"packed": (("euclidean", 0, "affine"),
                          ("manhattan", 2, "affine")),
               "coords": (("euclidean", 0, "nonaffine"),
                          ("great circle", 1, "lonlat"),
                          ("manhattan", 2, "nonaffine"))}
# which port of a TPU probe each kernels-line row reports: (tool, leg of
# the kernel, leg of the twin, leg of the library call or None, the
# launch counters of its kernel, leg of its first port or None)
PROBE_ROWS = {
    "stencil_probe_b8c": ("exp_stencil2", "C copy staged 32x248",
                          "G twin copy", "A Tensor.copy_",
                          ("stencil_staged_tma", "stencil_staged_async"),
                          "C copy nine 32x8"),
    "stencil_probe_b8d": ("exp_separable_horn", "separable_staged 64x128",
                          "twin separable", None,
                          ("stencil_sep_tma", "stencil_sep_async"),
                          "separable 32x8"),
    "stencil_probe_b8e": ("exp_padfree_stencil", "interior staged 64x128",
                          "twin", None,
                          ("stencil_interior_tma", "stencil_interior_async",
                           "stencil_edge"), "interior 32x8"),
    "stencil_probe_b8f": ("exp_seam_cost", "bare staged 64x128", "twin",
                          None,
                          ("stencil_interior_tma", "stencil_interior_async",
                           "stencil_ring_tma", "stencil_ring_async"),
                          "bare")}
# B8e's and B8f's staged forms, checked in phase 21: the edges, and the
# shapes beside PROBE_SHAPES and STAGED_RAGGED (45x300: clamped tiles on
# TMA; 40x70: no interior)
STAGED_EDGES = ("interior", "bare", "ring_branch")
EDGE_SHAPES = ((45, 300), (40, 70))


def check_stencil_probes(dev):
    """Phase 21a: every stencil-probe instantiation against its twin and
    the surface kernel.  Returns {row: largest difference from the twin}
    over the instantiations each row's TPU probe has."""
    import torch
    from xrspatial_torch.kernels import cuda_stencil_probe, cuda_surface
    from xrspatial_torch.kernels.stencil_probe import (BLOCKS, MODES,
                                                       STAGED_FORMS, TILES,
                                                       VARIANTS, bare_extent,
                                                       interior_extent,
                                                       staged_plan,
                                                       stencil_twin)
    print("== stencil-probe kernels vs twins and the surface kernel on the "
          "card")
    # the instantiations of each row's TPU probe: (mode, form, edges) ->
    # whether the row has it
    rows = {"stencil_probe_b8c": lambda m, f, e: f == "staged",
            "stencil_probe_b8d": lambda m, f, e: m == "slope" and e == "ring",
            "stencil_probe_b8e": lambda m, f, e: e == "interior",
            "stencil_probe_b8f": lambda m, f, e: f == "nine" and m == "slope"
            and e in ("ring", "bare")}
    errs = dict.fromkeys(rows, 0.0)
    for k, shape in enumerate(PROBE_SHAPES):
        x = torch.from_numpy(test_raster(shape, seed=800 + k)).to(dev)
        b1 = cuda_surface.surface_cuda(x, ("slope",))[0]
        for mode, form, edges in VARIANTS:
            for block in BLOCKS if form not in STAGED_FORMS else ():
                got = cuda_stencil_probe.stencil_probe_cuda(x, mode, form,
                                                            edges, block)
                ref = stencil_twin(x, mode, form, edges, block)
                r0, r1, c0, c1 = interior_extent(*shape, block) \
                    if edges == "bare" else (0, shape[0], 0, shape[1])
                g, r, b = (t[r0:r1, c0:c1] for t in (got, ref, b1))
                tag = f"stencil {shape} {mode} {form} {edges} " \
                      f"{block[0]}x{block[1]}"
                if mode == "copy":
                    if not torch.equal(got.view(torch.int32),
                                       x.view(torch.int32)):
                        raise SmokeFailure(f"{tag}: differs from its input")
                    print(f"  {tag}: equal to its input bit for bit")
                    continue
                err = check(f"{tag} vs twin", g, r, SURFACE_TOL)
                if form == "nine" and mode == "slope":
                    if not (torch.equal(torch.isnan(g), torch.isnan(b))
                            and torch.equal(torch.nan_to_num(g),
                                            torch.nan_to_num(b))):
                        raise SmokeFailure(f"{tag}: differs from the "
                                           f"surface kernel")
                    print(f"  {tag}: equal to the surface kernel bit for "
                          f"bit")
                for row, has in rows.items():
                    if has(mode, form, edges):
                        errs[row] = max(errs[row], err)
        torch.cuda.synchronize()
    for k, shape in enumerate(PROBE_SHAPES + (STAGED_RAGGED,)):
        x = torch.from_numpy(test_raster(shape, seed=850 + k)).to(dev)
        b1 = cuda_surface.surface_cuda(x, ("slope",))[0]
        for tile in TILES:
            route = staged_plan(*shape, tile, x.data_ptr()).route
            for mode in MODES:
                tag = f"stencil {shape} {mode} staged {tile[0]}x{tile[1]}"
                before = (cuda_stencil_probe.TMA_LAUNCHES,
                          cuda_stencil_probe.ASYNC_LAUNCHES)
                got = cuda_stencil_probe.stencil_probe_cuda(
                    x, mode, "staged", block=tile)
                counted = (cuda_stencil_probe.TMA_LAUNCHES - before[0],
                           cuda_stencil_probe.ASYNC_LAUNCHES - before[1])
                if counted != ((1, 0) if route == "tma" else (0, 1)):
                    raise SmokeFailure(f"{tag}: planned route {route}, "
                                       f"launches (tma, async) {counted}")
                if mode == "copy":
                    if not torch.equal(got.view(torch.int32),
                                       x.view(torch.int32)):
                        raise SmokeFailure(f"{tag}: differs from its input")
                    print(f"  {tag}, {route}: equal to its input bit for bit")
                    continue
                ref = stencil_twin(x, mode, "staged", block=tile)
                err = check(f"{tag} vs twin", got, ref, SURFACE_TOL)
                errs["stencil_probe_b8c"] = max(errs["stencil_probe_b8c"],
                                                err)
                if mode == "slope":
                    if not (torch.equal(torch.isnan(got), torch.isnan(b1))
                            and torch.equal(torch.nan_to_num(got),
                                            torch.nan_to_num(b1))):
                        raise SmokeFailure(f"{tag}: differs from the "
                                           f"surface kernel")
                    print(f"  {tag}, {route}: equal to the surface kernel "
                          f"bit for bit, NaN ring included")
        # B8d's staged separable form against its first port, both routes
        for label, xx in (("aligned", x), ("base+4", unaligned(x))):
            first = cuda_stencil_probe.stencil_probe_cuda(xx, "slope",
                                                          "separable")
            ref = stencil_twin(xx, "slope", "separable")
            for tile in TILES:
                route = staged_plan(*shape, tile, xx.data_ptr()).route
                tag = (f"stencil {shape} {label} slope separable_staged "
                       f"{tile[0]}x{tile[1]}")
                before = (cuda_stencil_probe.SEP_TMA_LAUNCHES,
                          cuda_stencil_probe.SEP_ASYNC_LAUNCHES)
                got = cuda_stencil_probe.stencil_probe_cuda(
                    xx, "slope", "separable_staged", block=tile)
                counted = (cuda_stencil_probe.SEP_TMA_LAUNCHES - before[0],
                           cuda_stencil_probe.SEP_ASYNC_LAUNCHES - before[1])
                if counted != ((1, 0) if route == "tma" else (0, 1)):
                    raise SmokeFailure(f"{tag}: planned route {route}, "
                                       f"launches (tma, async) {counted}")
                if not same_bits(got, first):
                    raise SmokeFailure(f"{tag}: differs from the first-port "
                                       f"separable form")
                errs["stencil_probe_b8d"] = max(
                    errs["stencil_probe_b8d"],
                    check(f"{tag} vs twin ({route}; = first port)", got, ref,
                          SURFACE_TOL))
        torch.cuda.synchronize()
    for k, shape in enumerate(PROBE_SHAPES + (STAGED_RAGGED,) + EDGE_SHAPES):
        x = torch.from_numpy(test_raster(shape, seed=870 + k)).to(dev)
        b1 = cuda_surface.surface_cuda(x, ("slope",))[0]
        for label, xx in (("aligned", x), ("base+4", unaligned(x))):
            for tile, edges in ((t, e) for t in TILES for e in STAGED_EDGES):
                row, got, route = check_staged_edges(xx, tile, edges)
                tag = (f"stencil {shape} {label} slope staged {edges} "
                       f"{tile[0]}x{tile[1]}, {route}")
                r0, r1, c0, c1 = bare_extent(*shape, "staged", tile)
                if edges != "bare":
                    r0, r1, c0, c1 = 0, shape[0], 0, shape[1]
                g, b = got[r0:r1, c0:c1], b1[r0:r1, c0:c1]
                if not same_bits(g, b):
                    raise SmokeFailure(f"{tag}: differs from the surface "
                                       f"kernel")
                errs[row] = max(errs[row], check(
                    f"{tag} vs twin (= surface kernel)", g,
                    stencil_twin(xx, "slope", "staged", edges,
                                 tile)[r0:r1, c0:c1], SURFACE_TOL))
        torch.cuda.synchronize()
    return errs


def check_staged_edges(x, tile, edges):
    """One launch set of B8e's or B8f's staged form on `x`, counted on the
    route its plan names: (kernels-line row, result, route)."""
    from xrspatial_torch.kernels import cuda_stencil_probe as csp
    from xrspatial_torch.kernels.stencil_probe import staged_plan
    walk = "full" if edges == "ring_branch" else "interior"
    plan = staged_plan(*x.shape, tile, x.data_ptr(), walk=walk)
    tma, ran = plan.route == "tma", plan.tiles > 0
    names = ("INTERIOR_TMA_LAUNCHES", "INTERIOR_ASYNC_LAUNCHES",
             "RING_TMA_LAUNCHES", "RING_ASYNC_LAUNCHES", "EDGE_LAUNCHES",
             "TMA_LAUNCHES", "ASYNC_LAUNCHES", "LAUNCHES")
    want = {"interior": (tma and ran, ran and not tma, 0, 0, 1),
            "bare": (tma and ran, ran and not tma, 0, 0, 0),
            "ring_branch": (0, 0, tma, not tma, 0)}[edges] + (0, 0, 0)
    before = [getattr(csp, n) for n in names]
    got = csp.stencil_probe_cuda(x, "slope", "staged", edges, tile)
    counted = tuple(getattr(csp, n) - b for n, b in zip(names, before))
    if counted != tuple(map(int, want)):
        raise SmokeFailure(f"staged {edges} {tile} at {tuple(x.shape)}: "
                           f"planned route {plan.route}, {plan.tiles} tiles; "
                           f"launches {dict(zip(names, counted))}")
    row = "stencil_probe_b8f" if edges != "interior" else "stencil_probe_b8e"
    return row, got, plan.route


def group_case(dev, form, metric, axes, shape, rng):
    """(state planes, run of the group kernel, run of the round kernel
    once per stride) for one check of the fused group."""
    import torch
    from xrspatial_torch.kernels import cuda_jfa, cuda_jfa_group
    from xrspatial_torch.kernels.jfa import packed_state_plan
    mask = torch.from_numpy(rng.random(shape) < 0.01).to(dev)
    ys_np, xs_np = jfa_axes(axes, *shape, rng)
    xs = torch.from_numpy(xs_np).to(dev)
    ys = torch.from_numpy(ys_np).to(dev)
    if form == "packed":
        steps = packed_state_plan(xs_np, ys_np, metric)[0]
        state = jfa_initial("packed", mask, None, xs, ys)[0]
        for k in (64, 32):           # targets spread before the group
            state, _, _ = cuda_jfa.round_packed_cuda(state, None, k, metric,
                                                     steps)

        def rounds(ks):
            s = state
            for k in ks:
                s, _, _ = cuda_jfa.round_packed_cuda(s, None, k, metric,
                                                     steps)
            return (s,)
        return (lambda ks, **kw: (cuda_jfa_group.group_packed_cuda(
            state, ks, metric, steps, **kw),), rounds)
    tx, ty, _ = jfa_initial("coords", mask, None, xs, ys)
    for k in (64, 32):
        tx, ty, _ = cuda_jfa.round_coords_cuda(tx, ty, None, xs, ys, k,
                                               metric)

    def rounds(ks):
        a, b = tx, ty
        for k in ks:
            a, b, _ = cuda_jfa.round_coords_cuda(a, b, None, xs, ys, k,
                                                 metric)
        return a, b
    return (lambda ks, **kw: cuda_jfa_group.group_coords_cuda(
        tx, ty, xs, ys, ks, metric, **kw), rounds)


# the group's routes, checked in phase 21 and timed in phase 22: the
# plan's (single-buffered) and the first port by name
GROUP_ROUTES = ("single", "double")


def check_jfa_group(dev):
    """Phase 21b: the fused group on each of its routes against the round
    kernel launched once per stride, bit for bit, every state form and
    metric."""
    import torch
    from xrspatial_torch.kernels.jfa_group import window_plan
    print("== fused jump-flood group vs the round kernel on the card")
    for si, shape in enumerate(PROBE_SHAPES + (STAGED_RAGGED,)):
        rng = np.random.default_rng(900 + si)
        for form, modes in GROUP_MODES.items():
            for label, metric, axes in modes:
                fused, rounds = group_case(dev, form, metric, axes, shape,
                                           rng)
                for gname, ks in GROUPS.items():
                    ref = rounds(ks)
                    for route in GROUP_ROUTES:
                        tag = f"jfa_group {shape} {form} {label} {ks} {route}"
                        try:
                            plan = window_plan(ks, form, route, shape[1])
                        except ValueError as exc:
                            print(f"  {tag}: not run, {exc}")
                            continue
                        got = fused(ks, route=route)
                        torch.cuda.synchronize()
                        n_bad = sum(int((g != r).sum())
                                    for g, r in zip(got, ref))
                        if n_bad:
                            raise SmokeFailure(f"{tag}: {n_bad} cells differ "
                                               f"from the round kernel")
                        print(f"  {tag}: T = {plan.tile}, "
                              f"{plan.stage or 'plain loads'}, "
                              f"{plan.shared_bytes} bytes of shared memory, "
                              f"equal to {len(ks)} round launches bit for "
                              f"bit")
        torch.cuda.synchronize()


def stencil_probes_path(roof_gb_s, card):
    """Phase 22a: the four stencil tools at N^2; returns {row: (launches,
    max difference from the twin, (ms, twin ms), library ms, first port
    ms)}."""
    import importlib
    import io
    import torch
    rows = {}
    for row, (tool, leg, twin_leg, lib_leg, counters, first_leg) in \
            PROBE_ROWS.items():
        mod = importlib.import_module(f"xrspatial_torch.tools.{tool}")
        print(f"== stencil probe: python -m xrspatial_torch.tools.{tool} {N}")
        torch.cuda.synchronize()
        reset_launches()
        buf = io.StringIO()
        try:
            res = mod.measure(N, out=buf)
            torch.cuda.synchronize()
        finally:
            for line in buf.getvalue().splitlines():
                print("  " + line)
        launches = read_launches()
        if not launches["stencil_probe"] or (
                tool == "exp_padfree_stencil"
                and not launches["stencil_edge"]):
            raise SmokeFailure(f"{tool}: launches {launches}")
        # at N^2 (w % 4 == 0, an aligned base) every staged window is a
        # TMA load
        if tool == "exp_stencil2" and (not launches["stencil_staged_tma"]
                                       or launches["stencil_staged_async"]):
            raise SmokeFailure(f"{tool}: the staged legs did not all take "
                               f"TMA: launches {launches}")
        if tool == "exp_separable_horn" and (
                not launches["stencil_sep_tma"]
                or launches["stencil_sep_async"]
                or launches["stencil_staged_async"]):
            raise SmokeFailure(f"{tool}: the staged separable legs did not "
                               f"all take TMA: launches {launches}")
        # B8e's and B8f's interior walk, and B8f's ring_branch, on TMA
        if tool in ("exp_padfree_stencil", "exp_seam_cost") and (
                not launches["stencil_interior_tma"]
                or launches["stencil_interior_async"]
                or launches["stencil_ring_async"]
                or launches["stencil_staged_async"]
                or (tool == "exp_seam_cost"
                    and not launches["stencil_ring_tma"])):
            raise SmokeFailure(f"{tool}: the staged legs did not all take "
                               f"TMA: launches {launches}")
        print(f"  launches {launches}")
        for name, data in res["inputs"].items():
            for label, r in data["legs"].items():
                print(f"  {name} {label}: {r['ms']:.4f} ms, "
                      f"{r['gb_s']:.1f} GB/s, {r['gb_s'] / roof_gb_s * 100:.1f}"
                      f"% of the measured roof, {card}")
        legs = res["inputs"]["gaussian_bump"]["legs"]
        err = max(max(d["checks"].values()) for d in res["inputs"].values())
        rows[row] = (sum(launches[c] for c in counters), err,
                     (legs[leg]["ms"], legs[twin_leg]["ms"]),
                     legs[lib_leg]["ms"] if lib_leg else None,
                     legs[first_leg]["ms"] if first_leg else None)
        torch.cuda.empty_cache()
    return rows


def jfa_group_path(dev, card):
    """Phase 22b: the JAX probe's groups through the tool users run, then
    the fused tail group on proximity's N^2 packed state after its first
    rounds, against the round kernel's launches."""
    import io
    import torch
    from xrspatial_torch.kernels import cuda_jfa, cuda_jfa_group
    from xrspatial_torch.kernels.jfa import _stride_schedule, packed_state_plan
    from xrspatial_torch.kernels.jfa_group import (TAIL, group_packed_twin,
                                                   window_plan)
    from xrspatial_torch.tools import exp_jfa_fixed
    print(f"== fused jump-flood group: python -m "
          f"xrspatial_torch.tools.exp_jfa_fixed {JFA_FIXED_N}")
    reset_launches()
    buf = io.StringIO()
    try:
        exp_jfa_fixed.measure(JFA_FIXED_N, out=buf)
        torch.cuda.synchronize()
    finally:
        for line in buf.getvalue().splitlines():
            print("  " + line)
    launches = read_launches()
    print(f"  launches {launches}")
    if not launches["jfa_group"]:
        raise SmokeFailure(f"exp_jfa_fixed: launches {launches}")
    dem = gaussian_bump(N, N, dev)
    schedule = [int(k) for k in _stride_schedule(N)]
    if tuple(schedule[-len(TAIL):]) != TAIL:
        raise SmokeFailure(f"the schedule at {N} ends {schedule}, not {TAIL}")
    head = schedule[:-len(TAIL)]
    print(f"== fused jump-flood group: proximity's {N}x{N} packed state "
          f"(targets dem > 900) after rounds {head}, then the tail {TAIL}")
    xs_np = np.arange(N, dtype=np.float32)
    ys_np = np.arange(N, dtype=np.float32)[::-1].copy()
    steps = packed_state_plan(xs_np, ys_np, 0)[0]
    state = jfa_initial("packed", dem > 900, None, None, None)[0]
    del dem
    for k in head:
        state, _, _ = cuda_jfa.round_packed_cuda(state, None, k, 0, steps)

    def rounds():
        s = state
        for k in TAIL:
            s, _, _ = cuda_jfa.round_packed_cuda(s, None, k, 0, steps)
        return s

    torch.cuda.synchronize()
    reset_launches()
    got = cuda_jfa_group.group_packed_cuda(state, TAIL, 0, steps)
    torch.cuda.synchronize()
    launches = read_launches()
    if not only(launches, "jfa_group"):
        raise SmokeFailure(f"fused group: launches {launches}")
    if cuda_jfa_group.SINGLE_LAUNCHES != 1:
        raise SmokeFailure("fused group: the launch was not single-buffered")
    ref = rounds()
    n_bad = int((got != ref).sum())
    plan = window_plan(TAIL, "packed", w=N)
    print(f"  one launch, {plan.route}, staged by {plan.stage}, T = "
          f"{plan.tile}, H = {plan.halo}, "
          f"{plan.shared_bytes} bytes of shared memory; {n_bad} cells differ "
          f"from the round kernel's {len(TAIL)} launches; "
          f"{int((got < 0).sum())} cells without a target")
    if n_bad:
        raise SmokeFailure(f"fused group: {n_bad} cells differ from the "
                           f"round kernel")
    if not torch.equal(cuda_jfa_group.group_packed_cuda(
            state, TAIL, 0, steps, "double"), got):
        raise SmokeFailure("fused group: the first port differs")
    if not torch.equal(group_packed_twin(state, TAIL, 0, steps), got):
        raise SmokeFailure("fused group: differs from the twin")
    del got, ref
    print(f"== timing: fused jump-flood group at {N}x{N} on {card}")
    legs = {route: lambda route=route: cuda_jfa_group.group_packed_cuda(
        state, TAIL, 0, steps, route) for route in GROUP_ROUTES}
    legs[f"{len(TAIL)} round launches"] = rounds
    times = {}
    for name in [*legs, *reversed(legs)]:
        times.setdefault(name, []).append(cuda_time_ms(legs[name], 10))
    times = {n: sum(v) / len(v) for n, v in times.items()}
    twin = cuda_time_ms(lambda: group_packed_twin(state, TAIL, 0, steps), 1)
    print(f"  jfa_group, tail {TAIL}, in turns: "
          + ", ".join(f"{n} {t:.3f} ms" for n, t in times.items())
          + f"; twin {twin:.3f} ms, {card}")
    del state
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return launches["jfa_group"], (times["single"], twin), times


# -- phase 23: the A5/A6 paths (torch ops, no kernel) -----------------------

A5_N = N               # the A5/A6 paths' raster edge
NDVI_N = 8192          # the JAX bench's ndvi leg (bench.py:357-368)
QUANTILE_N = 4096      # the JAX bench's quantile leg (bench.py:370-371)
COMBINE_N = 2048       # combine's ids come from np.unique on the host
JENKS_N = 4096
JENKS_SAMPLE = 20000   # natural_breaks' default num_sample
JENKS_K = 5
A5_RTOL = 1e-5          # reductions against the float64 oracle
LOCAL_RTOL = 1e-6       # local mean and std against numpy float32
JENKS_RTOL = 1e-5       # within-class variance, card against CPU
F32 = np.float32


def _guard_np(den, num):
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(den == 0, F32(np.nan),
                        num / np.where(den == 0, F32(1), den))


# index -> (bands in call order, the formula in numpy float32, each op
# rounded apart); the bands are nir, red and a third band standing for
# blue, green, swir1/swir2 and tir.  Each index equals its formula bit for
# bit, but ebbi: a float32 sqrt 1 ulp off (torch's on the CPU is, in about
# 0.6% of values) moves it by up to 2 ulps
MS_ULPS = {"ebbi": 2}
MS_INDICES = {
    "arvi": (("nir", "red", "third"), lambda n, r, b: _guard_np(
        n + F32(2) * r + b, n - F32(2) * r + b)),
    "evi": (("nir", "red", "third"), lambda n, r, b: F32(2.5) * _guard_np(
        n + F32(6) * r - F32(7.5) * b + F32(1), n - r)),
    "gci": (("nir", "third"), lambda n, g: np.where(
        g == 0, F32(np.nan), n / np.where(g == 0, F32(1), g) - F32(1))),
    "nbr": (("nir", "third"), lambda a, b: _guard_np(a + b, a - b)),
    "nbr2": (("red", "third"), lambda a, b: _guard_np(a + b, a - b)),
    "ndvi": (("nir", "red"), lambda a, b: _guard_np(a + b, a - b)),
    "ndmi": (("nir", "third"), lambda a, b: _guard_np(a + b, a - b)),
    "savi": (("nir", "red"), lambda n, r: _guard_np(
        (n + r + F32(1)) * F32(2), n - r)),
    "sipi": (("nir", "red", "third"), lambda n, r, b: _guard_np(
        n - r, n - b)),
    "ebbi": (("red", "nir", "third"), lambda r, s, t: _guard_np(
        F32(10) * np.sqrt(s + t), s - r)),
}


def pct_plan(n, pct):
    """``jnp.nanpercentile``'s ranks and weights for `n` finite values as
    XLA evaluates them: ``q * ((counts - 1) * 0.01)`` in float32, ranks
    clamped in integers."""
    c = F32(n)
    t = np.asarray(pct, dtype=F32) * ((c - F32(1)) * F32(0.01))
    lo, hi = np.floor(t), np.ceil(t)
    ranks = [np.minimum(np.maximum(F32(0), np.minimum(r, c - F32(1)))
                        .astype(np.int64), n - 1) for r in (lo, hi)]
    return ranks, F32(1) - (t - lo), t - lo


def partitioned(finite, pcts):
    """`finite` partitioned by ``np.partition`` at every rank that the
    percentile lists `pcts` read."""
    kth = np.unique(np.concatenate([r for p in pcts
                                    for r in pct_plan(finite.size, p)[0]]))
    return np.partition(finite, kth)


def np_percentiles(part, n, pct):
    """The percentiles `pct` from the order statistics in `part`, with
    XLA's ``fma(high, high_weight, low * low_weight)`` in float64 rounded
    once; also (low, high)."""
    (rlo, rhi), lw, hw = pct_plan(n, pct)
    low, high = part[rlo], part[rhi]
    return (high.astype(np.float64) * hw.astype(np.float64)
            + (low * lw).astype(np.float64)).astype(F32), (low, high)


def np_classes(x, bins, new_values=None):
    """``_bin``'s classes in numpy: the count of bins below each value,
    NaN past the last bin and where the value is not finite."""
    bins = np.asarray(bins).astype(F32)
    nv = (np.arange(bins.size) if new_values is None
          else np.asarray(new_values)).astype(F32)
    idx = np.searchsorted(np.sort(bins), x, side="left")
    ok = np.isfinite(x) & (idx < bins.size)
    return np.where(ok, nv[np.minimum(idx, bins.size - 1)], F32(np.nan))


def check_classes(label, got, x, bins, new_values=None, near=0.0):
    """The card's classes on host rows `x` against ``np_classes``; where
    the bins came from float32 sums, cells within `near` of a bin may fall
    either side."""
    expected = np_classes(x, bins, new_values)
    differ = ~((got == expected) | (np.isnan(got) & np.isnan(expected)))
    if near > 0 and differ.any():
        gap = np.min(np.abs(x[differ][:, None].astype(np.float64)
                            - np.asarray(bins, np.float64)), axis=-1)
        differ[differ] = gap > near
    n_bad = int(differ.sum())
    print(f"  {label}: classes against np.searchsorted on {x.size} cells, "
          f"bad_cells={n_bad}")
    if n_bad:
        raise SmokeFailure(f"{label}: {n_bad} cells in another class than "
                           f"np.searchsorted gives")


def edge_patch(edge):
    """A NaN patch of a classify raster: rows and columns off its centre."""
    return (slice(edge // 4, edge // 4 + edge // 40),
            slice(edge // 2, edge // 2 + edge // 14))


def within_class_variance(values, bins):
    """Float64 sum of the squared deviations from each class's mean."""
    values = np.sort(values.astype(np.float64))
    idx = np.searchsorted(np.asarray(bins, np.float64), values, side="left")
    return sum(float(((values[idx == c] - values[idx == c].mean()) ** 2)
                     .sum()) for c in np.unique(idx))


def a5_a6_paths(dev, card, roof_bytes_s):
    """Phase 23: the A5/A6 paths (the DataArray shim's methods,
    multispectral, local, classify), torch ops on the card, each against
    numpy on the host; returns the rows of its table."""
    import torch
    import xrspatial_torch as xt
    from xrspatial_torch import classify, local, multispectral
    t_phase = time.perf_counter()
    rows = []
    # the rows held against numpy on the host: the middle sixteenth, the
    # summit's; NaN patches, crops and sampled cells lie in or near them
    lo, hi = A5_N * 15 // 32, A5_N * 17 // 32
    band = hi - lo
    patch = (slice(lo + band // 4, lo + band // 4 + band // 8),
             slice(A5_N // 64, A5_N // 16))

    def run(label, fn, reps, nbytes=None, edge=A5_N):
        """The first call (its result); then a warm-up call and `reps`
        calls timed with CUDA events, or, with `reps` 0, the first call
        timed alone (paths whose time is host numpy); peak allocated over
        all of them."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        if reps:
            fn()
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
        ms = start.elapsed_time(end) / max(reps, 1)
        peak = torch.cuda.max_memory_allocated() / 2**30
        row = {"path": label, "edge": edge, "ms": ms, "peak_gib": peak,
               "card": card}
        note = ""
        if nbytes is not None:
            row["bytes"] = nbytes
            row["bound_ms"] = nbytes / HBM_BYTES_S * 1e3
            row["roof_bound_ms"] = nbytes / roof_bytes_s * 1e3
            note = (f", bound {row['bound_ms']:.3f} ms ("
                    f"{row['bound_ms'] / ms * 100:.1f}%), at the measured "
                    f"roof {row['roof_bound_ms']:.3f} ms ("
                    f"{row['roof_bound_ms'] / ms * 100:.1f}%)")
        print(f"  {label} at {edge}^2: {ms:.3f} ms{' (one call)' * (not reps)}"
              f"{note}, peak allocated {peak:.2f} GiB, {card}")
        rows.append(row)
        data = out.data if isinstance(out, xt.DataArray) else out
        if isinstance(data, torch.Tensor) and data.device.type != "cuda":
            raise SmokeFailure(f"{label}: the result is on {data.device}")
        return out

    def host(t):
        return t.detach().cpu().numpy()

    def same(x, y):
        """Equal tensors, NaN equal to NaN."""
        return x.shape == y.shape and bool(
            ((x == y) | (torch.isnan(x) & torch.isnan(y))).all())

    def equal(label, got, expected, rtol=0.0):
        ok = np.isnan(got) == np.isnan(expected)
        fin = ok & ~np.isnan(expected)
        if rtol:
            err = np.abs(got[fin].astype(np.float64) - expected[fin])
            ok[fin] = err <= rtol * np.abs(expected[fin].astype(np.float64))
        else:
            ok[fin] = got[fin] == expected[fin]
        n_bad = int((~ok).sum())
        print(f"  {label}: {'rtol ' + str(rtol) if rtol else 'bit for bit'}"
              f" on {expected.size} cells, bad_cells={n_bad}")
        if n_bad:
            raise SmokeFailure(f"{label}: {n_bad} cells differ from numpy")

    cell = A5_N * A5_N * 4
    coords = {"y": np.arange(A5_N, dtype=np.float64)[::-1].copy(),
              "x": np.arange(A5_N, dtype=np.float64)}

    # -- the shim ---------------------------------------------------------------
    print(f"== A5/A6 paths: the DataArray shim at {A5_N}x{A5_N} on {card}")
    dem = gaussian_bump(A5_N, A5_N, dev)
    dem[patch] = float("nan")
    a = xt.DataArray(dem, dims=("y", "x"), coords=coords, name="dem",
                     attrs={"res": (1.0, 1.0)})
    b = xt.DataArray(gaussian_bump(A5_N, A5_N, dev).flip(1) * 0.5 + 10.0,
                     dims=("y", "x"), coords=coords)
    ha, hb = host(a.data[lo:hi]), host(b.data[lo:hi])
    dem_host = host(dem)                   # read again by classify below
    for label, fn, nbytes, ref in (
            ("a + b", lambda: a + b, 3 * cell, ha + hb),
            ("a * 2", lambda: a * 2, 2 * cell, ha * F32(2)),
            ("a > 900", lambda: a > 900, cell + cell // 4, ha > 900),
            ("a.where(a > 900)", lambda: a.where(a > 900), 2 * cell,
             np.where(ha > 900, ha, F32(np.nan))),
            ("a.fillna(0)", lambda: a.fillna(0.0), 2 * cell,
             np.where(np.isnan(ha), F32(0), ha))):
        out = run(f"shim {label}", fn, 5, nbytes)
        got = host(out.data[lo:hi])
        if got.dtype == np.bool_:
            got, ref = got.astype(F32), ref.astype(F32)
        equal(f"shim {label}", got, ref)
        if out.dims != ("y", "x") or list(out.coords) != ["y", "x"]:
            raise SmokeFailure(f"shim {label}: dims {out.dims}, coords "
                               f"{list(out.coords)}")
    del out
    host64 = dem_host.astype(np.float64)
    # skipna on the DEM with its NaN patch, the plain reductions on b
    b64 = host(b.data).astype(np.float64)
    oracle = {("mean", True): np.nanmean, ("std", True): np.nanstd,
              ("min", True): np.nanmin, ("max", True): np.nanmax,
              ("mean", False): np.mean, ("std", False): np.std,
              ("min", False): np.min, ("max", False): np.max}
    for (name, skipna), fn in oracle.items():
        x = a if skipna else b
        out = run(f"shim {name}(skipna={skipna})",
                  lambda: getattr(x, name)(skipna=skipna), 3, cell)
        got, ref = float(out.data), float(fn(host64 if skipna else b64))
        ok = (np.isnan(got) and np.isnan(ref)) or \
            abs(got - ref) <= A5_RTOL * abs(ref)
        print(f"    {got!r} against the float64 oracle {ref!r}")
        if out.data.shape != () or not ok:
            raise SmokeFailure(f"shim {name}(skipna={skipna}): {got} "
                               f"against {ref}, rtol {A5_RTOL}")
    del host64, b64
    r0, c0, side = A5_N // 2 - A5_N // 8, 100, A5_N // 4
    crop = run("shim isel crop", lambda: a.isel(y=slice(r0, r0 + side),
                                                x=slice(3, 3 + side)), 5)
    # y descends: the slice runs from the larger coordinate to the smaller
    sel = run("shim sel crop (descending y)", lambda: a.sel(
        y=slice(A5_N - 1.0 - r0, float(A5_N - r0 - side)),
        x=slice(float(c0), float(c0 + side - 1))), 5)
    as64 = run("shim astype(float64)", lambda: a.astype(np.float64), 3,
               cell * 3)
    cat = run("shim concat along a new dim", lambda: xt.concat([a, b], "t"),
              3, cell * 4)
    if not (same(crop.data, dem[r0:r0 + side, 3:3 + side])
            and same(sel.data, dem[r0:r0 + side, c0:c0 + side])
            and float(sel.coords["y"].values[0]) == A5_N - 1.0 - r0
            and as64.data.dtype == torch.float64
            and same(as64.data, dem.double())
            and cat.dims == ("t", "y", "x")
            and same(cat.data, torch.stack([dem, b.data]))):
        raise SmokeFailure("shim crops, astype or concat differ from the "
                           "tensor ops they stand for")
    print("  isel/sel crops, astype and concat equal to the tensor ops")
    del crop, sel, as64, cat, b

    # -- multispectral -------------------------------------------------------
    print(f"== A5/A6 paths: multispectral at {A5_N}x{A5_N} on {card} "
          f"({time.perf_counter() - t_phase:.1f} s into the phase)")
    mag = gaussian_bump(A5_N, A5_N, dev).abs()
    bands = {"red": mag / 1000 + 0.1, "nir": mag / 800 + 0.2,
             "third": mag / 1200 + 0.05}
    del mag
    bands["nir"][lo + band // 2:lo + band // 2 + band // 40,
                 A5_N * 3 // 8:A5_N * 3 // 8 + A5_N // 50] = float("nan")
    aggs = {k: xt.DataArray(v, dims=("y", "x"), coords=coords, name=k)
            for k, v in bands.items()}
    hband = {k: host(v[lo:hi]) for k, v in bands.items()}
    for name, (which, formula) in MS_INDICES.items():
        fn = getattr(multispectral, name)
        out = run(name, lambda: fn(*(aggs[k] for k in which)), 10,
                  (len(which) + 1) * cell)
        got = host(out.data[lo:hi])
        expected = formula(*(hband[k] for k in which))
        fin = ~np.isnan(expected)
        ulps = np.abs(got[fin].view(np.int32).astype(np.int64)
                      - expected[fin].view(np.int32))
        most = int(ulps.max()) if ulps.size else 0
        print(f"  {name}: within {most} ulps of the numpy float32 formula "
              f"(limit {MS_ULPS.get(name, 0)}) on {expected.size} cells")
        if not np.array_equal(np.isnan(got), ~fin) \
                or most > MS_ULPS.get(name, 0):
            raise SmokeFailure(f"{name}: {most} ulps from numpy, or another "
                               f"NaN mask")
    out = run("true_color", lambda: multispectral.true_color(
        aggs["red"], aggs["nir"], aggs["third"]), 5, 3 * cell + cell)
    got = host(out.data[lo:hi])
    expected = []
    for k in ("red", "nir", "third"):
        whole = host(bands[k])
        mn, mx = np.nanmin(whole), np.nanmax(whole)
        norm = (hband[k] - mn) / (mx - mn)
        norm = F32(1) / (F32(1) + np.exp(F32(10) * (F32(0.125) - norm)))
        expected.append(np.clip(np.nan_to_num(norm * F32(255)), 0, 255)
                        .astype(np.uint8))
    red = hband["red"]
    expected.append(np.where(np.isnan(red) | (red <= 1), 0, 255)
                    .astype(np.uint8))
    diff = np.abs(got.astype(int) - np.stack(expected, -1).astype(int))
    print(f"  true_color: uint8 within {int(diff.max())} of numpy on "
          f"{got.size} values (atol 1)")
    if out.data.dtype != torch.uint8 or diff.max() > 1:
        raise SmokeFailure("true_color differs from numpy by more than 1")
    del out
    red8 = aggs["red"].data[:NDVI_N, :NDVI_N].contiguous()
    nir8 = aggs["nir"].data[:NDVI_N, :NDVI_N].contiguous()
    ndvi8 = run("ndvi (the bench leg)", lambda: multispectral.ndvi(
        xt.DataArray(nir8, dims=("y", "x")),
        xt.DataArray(red8, dims=("y", "x"))), 20,
        3 * NDVI_N * NDVI_N * 4, NDVI_N)
    equal("ndvi (the bench leg)", host(ndvi8.data),
          MS_INDICES["ndvi"][1](host(nir8), host(red8)))
    del ndvi8, red8, nir8, aggs, bands, hband

    # -- local ------------------------------------------------------------------
    print(f"== A5/A6 paths: local at {A5_N}x{A5_N} on {card} "
          f"({time.perf_counter() - t_phase:.1f} s into the phase)")
    g = gaussian_bump(A5_N, A5_N, dev)
    variables = {"v0": torch.round(g / 50), "v1": torch.round((1000 - g) / 50),
                 "v2": torch.round(g.flip(1) / 50),
                 "v3": torch.round(g.flip(0) / 50),
                 "ref": torch.floor(g / 250) - 1}   # -1 ... 3: wraps too
    variables["v1"][lo + band // 2:lo + band // 2 + band // 20,
                    A5_N // 5:A5_N // 5 + A5_N // 40] = float("nan")
    del g
    ds = xt.Dataset({k: xt.DataArray(v, dims=("y", "x"))
                     for k, v in variables.items()})
    data_vars = ["v0", "v1", "v2", "v3"]
    cube = np.stack([host(variables[k][lo:hi]) for k in data_vars])
    ref = host(variables["ref"][lo:hi])
    nan_any = np.isnan(cube).any(axis=0)
    with np.errstate(invalid="ignore"):
        numpy_local = {
            "max": cube.max(axis=0), "min": cube.min(axis=0),
            "sum": cube.sum(axis=0), "mean": cube.mean(axis=0),
            "median": np.median(cube, axis=0), "std": cube.std(axis=0)}
    for func, expected in numpy_local.items():
        out = run(f"cell_stats {func}", lambda: local.cell_stats(
            ds, data_vars, func), 2, 5 * cell)
        equal(f"cell_stats {func}", host(out.data[lo:hi]), expected,
              LOCAL_RTOL if func in ("mean", "std") else 0.0)
    for func, op in (("lesser_frequency", np.greater),
                     ("equal_frequency", np.equal),
                     ("greater_frequency", np.less)):
        out = run(func, lambda: getattr(local, func)(ds, "ref"), 2,
                  6 * cell)
        with np.errstate(invalid="ignore"):
            count = op(ref[None], cube).sum(axis=0).astype(F32)
        equal(func, host(out.data[lo:hi]),
              np.where(nan_any, F32(np.nan), count))
    for func, arg in (("lowest_position", np.argmin),
                      ("highest_position", np.argmax)):
        out = run(func, lambda: getattr(local, func)(ds, data_vars), 2,
                  5 * cell)
        pos = (arg(np.where(np.isnan(cube), 0, cube), axis=0) + 1)
        equal(func, host(out.data[lo:hi]),
              np.where(nan_any, F32(np.nan), pos.astype(F32)))
    s = np.sort(cube, axis=0)
    v = cube.shape[0]
    idx = ref.astype(np.int64) - 1
    is_new = np.concatenate([np.ones_like(s[:1], bool), s[1:] != s[:-1]])
    n_unique = is_new.sum(axis=0)
    eff = np.where(idx < 0, n_unique + idx, idx)
    pick = is_new & (np.cumsum(is_new, axis=0) - 1 == eff[None])
    pop = np.where(n_unique == 1, s[0], np.where(pick, s, 0).sum(axis=0))
    pop = np.where((idx >= n_unique) & (n_unique != 1), np.nan, pop)
    pop = np.where(nan_any | (n_unique >= v), np.nan, pop).astype(F32)
    eff = np.where(idx < 0, v + idx, idx)
    rank = np.take_along_axis(s, np.clip(eff, 0, v - 1)[None], 0)[0]
    rank = np.where(nan_any | (idx >= v) | (eff < 0), np.nan, rank)
    for func, expected in (("popularity", pop), ("rank", rank.astype(F32))):
        out = run(func, lambda: getattr(local, func)(ds, "ref"), 2, 6 * cell)
        equal(func, host(out.data[lo:hi]), expected)
    del out, ds, variables, cube, s
    g2 = gaussian_bump(COMBINE_N, COMBINE_N, dev)
    ds2 = xt.Dataset({f"v{i}": xt.DataArray(torch.round(t / 100),
                                            dims=("y", "x"))
                      for i, t in enumerate((g2, g2.flip(0), g2.t()))})
    out = run("combine", lambda: local.combine(ds2), 0, None, COMBINE_N)
    ids = host(out.data).ravel()
    vals = np.stack([host(ds2[k].data).ravel() for k in ds2], axis=1)
    key = out.attrs["key"]
    uniq, first = np.unique(ids, return_index=True)
    sample = np.random.default_rng(23).integers(0, ids.size, 1000)
    if (out.data.dtype != torch.float64 or list(uniq) != list(
            range(1, len(key) + 1)) or not (np.diff(first) > 0).all()
            or any(key[int(ids[i])] != tuple(vals[i].tolist())
                   for i in sample)):
        raise SmokeFailure("combine: ids are not 1..n in first-occurrence "
                           "order with their combinations as keys")
    print(f"  combine: {len(key)} ids in first-occurrence order, keys "
          f"equal to the cells' values on 1000 sampled cells")
    del out, ds2, g2

    # -- classify ---------------------------------------------------------------
    print(f"== A5/A6 paths: classify on {card} "
          f"({time.perf_counter() - t_phase:.1f} s into the phase)")
    quintiles, quartiles = [20, 40, 60, 80, 100], [25, 50, 75, 100]
    for edge, raster in ((QUANTILE_N, None), (A5_N, dem)):
        if raster is None:
            raster = gaussian_bump(edge, edge, dev)
            raster[edge_patch(edge)] = float("nan")
        agg = xt.DataArray(raster, dims=("y", "x"))
        label = f"quantile(k=5){' (the bench leg)' * (edge == QUANTILE_N)}"
        out = run(label, lambda: classify.quantile(agg, k=5), 2, 2 * edge
                  * edge * 4, edge)
        values = host(raster) if edge != A5_N else dem_host
        finite = values[np.isfinite(values)]
        # one partition for every rank read below (quartiles for
        # percentiles and box_plot)
        part = partitioned(finite, [quintiles, quartiles])
        pct, (low, high) = np_percentiles(part, finite.size, quintiles)
        got_bins = classify._quantile_bins(raster, 5)
        print(f"    {finite.size} finite cells (float32 count "
              f"{F32(finite.size):.0f}); order statistics by np.partition "
              f"{low.tolist()} / {high.tolist()}")
        if not np.array_equal(got_bins, np.unique(pct)):
            raise SmokeFailure(f"{label}: bins {got_bins.tolist()} against "
                               f"numpy's {np.unique(pct).tolist()}")
        print(f"  {label}: bins equal to numpy's bit for bit")
        rows_x = values[lo:hi] if edge == A5_N else values
        rows_got = host(out.data[lo:hi] if edge == A5_N else out.data)
        check_classes(label, rows_got, rows_x, got_bins)
    del out, values, dem_host
    x = host(dem[lo:hi])
    mn, mx = float(finite.min()), float(finite.max())
    q = np_percentiles(part, finite.size, quartiles)[0]
    out = run("percentiles", lambda: classify.percentiles(agg), 2, 2 * cell)
    check_classes("percentiles", host(out.data[lo:hi]), x, np.unique(q))
    width = (mx - mn) / 5
    cuts = np.arange(mn + width, mx + width, width)[:5]
    cuts[-1] = mx
    out = run("equal_interval", lambda: classify.equal_interval(agg), 2,
              2 * cell)
    check_classes("equal_interval", host(out.data[lo:hi]), x, cuts)
    d64 = dem.double()
    m, sd = float(torch.nanmean(d64)), float(torch.sqrt(torch.nanmean(
        (d64 - torch.nanmean(d64)) ** 2)))
    out = run("std_mean", lambda: classify.std_mean(agg), 2, 2 * cell)
    check_classes("std_mean", host(out.data[lo:hi]), x, np.unique(
        [m - 2 * sd, m - sd, m + sd, m + 2 * sd, mx]),
        near=1e-5 * (abs(m) + sd))
    q1, q2, q3 = (float(v) for v in np_percentiles(part, finite.size,
                                                   [25, 50, 75])[0])
    iqr = q3 - q1
    bins = np.unique([q1 - 1.5 * iqr, q1, q2, q3, q3 + 1.5 * iqr, mx])
    bins = bins[bins <= mx]
    out = run("box_plot", lambda: classify.box_plot(agg), 2, 2 * cell)
    check_classes("box_plot", host(out.data[lo:hi]), x, bins)
    mask = torch.isfinite(d64)
    ht_bins, total = [], int(mask.sum())
    while total > 1:                    # head/tail breaks in float64
        mean_v = float(d64[mask].mean())
        ht_bins.append(mean_v)
        head = mask & (d64 > mean_v)
        n_head = int(head.sum())
        if n_head == 0 or n_head / total > 0.40:
            break
        mask, total = head, n_head
    del d64, mask, head
    out = run("head_tail_breaks", lambda: classify.head_tail_breaks(agg), 2,
              2 * cell)
    check_classes("head_tail_breaks", host(out.data[lo:hi]), x,
                  ht_bins + [mx], near=1e-5 * abs(mx))
    members = [float(x[band // 20, A5_N // 20]),
               float(x[band // 2, A5_N * 3 // 10]), 500.25]
    out = run("binary", lambda: classify.binary(agg, members), 2, 2 * cell)
    expected = np.where(np.isfinite(x), np.isin(x, np.asarray(
        members, F32)).astype(F32), F32(np.nan))
    equal("binary", host(out.data[lo:hi]), expected)
    out = run("reclassify", lambda: classify.reclassify(
        agg, [200, 500, 800, 1100], [1, 2, 3, 4]), 2, 2 * cell)
    check_classes("reclassify", host(out.data[lo:hi]), x,
                  [200, 500, 800, 1100], [1, 2, 3, 4])
    del out, agg, finite, part, x, dem

    print(f"  ({time.perf_counter() - t_phase:.1f} s into the phase)")
    g4 = gaussian_bump(JENKS_N, JENKS_N, dev)
    g4[edge_patch(JENKS_N)] = float("nan")
    agg4 = xt.DataArray(g4, dims=("y", "x"))
    values = host(g4).ravel()
    uv = np.unique(values[np.isfinite(values)])
    diffs = np.diff(uv)
    top = np.sort(np.argsort(diffs, kind="stable")[-(JENKS_K - 1):])
    mb_bins = np.append((uv[top] + uv[top + 1]) / 2.0, float(uv[-1]))
    out = run("maximum_breaks", lambda: classify.maximum_breaks(agg4), 0,
              2 * JENKS_N * JENKS_N * 4, JENKS_N)
    check_classes("maximum_breaks", host(out.data), values.reshape(
        JENKS_N, JENKS_N), mb_bins)
    # the public call, with its DP (``classify._run_jenks``: the sample's
    # sort and upload, the DP on the card, the matrix's read-back and the
    # backtrack) timed inside it and its sample and breaks kept
    dp = {}
    run_jenks = classify._run_jenks

    def timed_jenks(sample, n_classes, device):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        breaks = run_jenks(sample, n_classes, device)
        dp.update(s=time.perf_counter() - t0, sample=sample, breaks=breaks)
        return breaks

    classify._run_jenks = timed_jenks
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = classify.natural_breaks(agg4, num_sample=JENKS_SAMPLE,
                                      k=JENKS_K)
        torch.cuda.synchronize()
        nb_s = time.perf_counter() - t0
    finally:
        classify._run_jenks = run_jenks
    sample, card_breaks = dp["sample"], dp["breaks"]
    t0 = time.perf_counter()
    cpu_breaks = classify._run_jenks(sample, JENKS_K, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    var_card = within_class_variance(sample, card_breaks[1:])
    var_cpu = within_class_variance(sample, cpu_breaks[1:])
    same = np.array_equal(card_breaks, cpu_breaks)
    rows.append({"path": "natural_breaks", "edge": JENKS_N,
                 "ms": nb_s * 1e3, "dp_s": dp["s"], "dp_cpu_s": cpu_s,
                 "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                 "card": card})
    print(f"  natural_breaks(num_sample={JENKS_SAMPLE}, k={JENKS_K}) at "
          f"{JENKS_N}^2: {nb_s:.3f} s (host clock, one call), of which the "
          f"Jenks DP on {sample.size} samples {dp['s']:.3f} s; the same DP "
          f"on the CPU {cpu_s:.3f} s; breaks {'equal' if same else 'differ'}"
          f": card {card_breaks[1:].tolist()}, CPU "
          f"{cpu_breaks[1:].tolist()}; within-class variance {var_card!r} "
          f"against {var_cpu!r}, {card}")
    if not same and abs(var_card - var_cpu) > JENKS_RTOL * abs(var_cpu):
        raise SmokeFailure("natural_breaks: the card's breaks reach another "
                           "within-class variance than the CPU's")
    nb_bins = card_breaks[1:].copy()
    nb_bins[-1] = float(np.nanmax(values))
    check_classes("natural_breaks", host(out.data), values.reshape(
        JENKS_N, JENKS_N), nb_bins, np.arange(np.unique(sample).size))
    del out, agg4, g4
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"  phase 23: {time.perf_counter() - t_phase:.1f} s, {card}")
    print(json.dumps({"a5_a6_paths": rows}))
    return rows


# -- phases 24 and 25: A7 (zonal, torch ops) and A11 (XDraw, kernel X1) ------

ZONAL_N = 4096          # the JAX bench's zonal_stats leg (bench.py:373-380)
ZONAL_STATS = ["mean", "max", "min", "sum", "std", "var", "count"]
ZONAL_RTOL = 1e-5       # bench.py:236-239: mean, sum and std (std atol 1e-3)
ZONAL_STD_ATOL = 1e-3
XDRAW_N = 4096          # the JAX bench's viewshed leg (bench.py:343-344)
XDRAW_VIEW = (100.0, 100.0, 100.0)  # its x, y and observer_elev
XDRAW_SHAPES = ((17, 1), (1, 23), (300, 70), (70, 300), (263, 516))
XDRAW_EXACT_N = 1024    # the exact route's ceiling: agreement measured there
XDRAW_AGREE = 0.985     # tests/test_viewshed.py:346
XDRAW_ANGLE_RTOL = 1e-6
# float operations per cone cell of the scan (xdraw.cu: the minor offset
# and its abs, the division, 1 - wsec, two products, the sum, the max)
XDRAW_OPS = 8
# float operations per cell of the cell kernels (xdraw_cells.cu): cell_at's
# 2 differences, 4 products, sum, square root and floor (9); the fields add
# the height's difference, the division and the distance's test; the
# epilogue adds the window's 2 abs, 2 max and min, wsec's division, the
# interpolation's difference, 2 products and sum, the ring's test, the
# target's sum, difference, division and test, the visibility test, diff
# and its test, and on a visible cell a division, atanf (counted as one), 2
# products and a sum
XFIELDS_OPS = 12
XEPILOGUE_OPS = 32
# X1's bands and chunks timed beside the plan's
XDRAW_SWEEP = ((32, 16), (32, 32), (64, 16), (64, 32), (128, 32), (256, 32),
               (512, 16))


def timed_run(fn, reps):
    """(the first call's result, ms, peak allocated GiB): with `reps`, a
    warm-up call and `reps` calls timed with CUDA events; with 0, the
    first call timed alone (host-bound paths)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    if reps:
        fn()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
    return (out, start.elapsed_time(end) / max(reps, 1),
            torch.cuda.max_memory_allocated() / 2**30)


def bump_raster(n, dev):
    """gaussian_bump(n, n) as a DataArray with the JAX bench's coordinates
    (y descending, x ascending, 1 apart)."""
    import xrspatial_torch as xt
    coords = {"y": np.arange(n, dtype=np.float64)[::-1].copy(),
              "x": np.arange(n, dtype=np.float64)}
    return xt.DataArray(gaussian_bump(n, n, dev), dims=("y", "x"),
                        coords=coords, attrs={"res": (1.0, 1.0)})


def zonal_oracle(zones, values):
    """bench.py:218-241's float64 oracle, by bincount: (zones present,
    count, sum, mean, std, var) of float32 values over int zones."""
    z = zones.ravel().astype(np.int64)
    zmin = int(z.min())
    b = z - zmin
    v = values.ravel().astype(np.float64)
    cnt = np.bincount(b)
    present = cnt > 0
    ssum = np.bincount(b, weights=v)[present]
    ssq = np.bincount(b, weights=v * v)[present]
    cnt = cnt[present]
    mean = ssum / cnt
    var = np.maximum(ssq / cnt - mean * mean, 0.0)
    return np.nonzero(present)[0] + zmin, cnt, ssum, mean, np.sqrt(var), var


def check_zonal_stats(label, cols, zones_t, values_t):
    """The 7 stats' columns against the float64 oracle (count after the
    float32 rounding the package reports), min and max against a masked
    reduction of each zone on the card."""
    zones, values = zones_t.cpu().numpy(), values_t.cpu().numpy()
    uz, cnt, ssum, mean, std, var = zonal_oracle(zones, values)
    bad = []
    if not np.array_equal(np.asarray(cols["zone"]), uz):
        bad.append("zone")
    if not np.array_equal(np.asarray(cols["count"]),
                          cnt.astype(np.float32).astype(np.float64)):
        bad.append("count")
    for k, ref, atol in (("mean", mean, 0), ("sum", ssum, 0),
                         ("std", std, ZONAL_STD_ATOL),
                         ("var", var, ZONAL_STD_ATOL * std.max())):
        if not np.allclose(cols[k], ref, rtol=ZONAL_RTOL, atol=atol):
            bad.append(k)
    lo = np.array([float(values_t[zones_t == z].min()) for z in uz])
    hi = np.array([float(values_t[zones_t == z].max()) for z in uz])
    if not (np.array_equal(cols["min"], lo)
            and np.array_equal(cols["max"], hi)):
        bad.append("min/max")
    print(f"  {label}: {len(uz)} zones, the largest {int(cnt.max())} cells; "
          f"against the float64 oracle: "
          f"{'equal within tolerance' if not bad else 'BAD ' + str(bad)}")
    if bad:
        raise SmokeFailure(f"{label}: {bad} differ from the oracle")


def scipy_regions(zones):
    """Scan-order region ids of an integer raster from scipy.ndimage.label
    (4-connected), one value at a time."""
    from scipy import ndimage
    ids = np.zeros(zones.shape, dtype=np.int64)
    base = 0
    for v in np.unique(zones):
        lbl, n = ndimage.label(zones == v)
        ids[lbl > 0] = lbl[lbl > 0] + base
        base += n
    _, first, inverse = np.unique(ids.ravel(), return_index=True,
                                  return_inverse=True)
    rank = np.empty(first.size, dtype=np.int64)
    rank[np.argsort(first)] = np.arange(first.size)
    return (rank[inverse] + 1).reshape(zones.shape), base


def regions_counted(raster):
    """(regions(raster), ms of the one call, peak GiB, propagation steps)."""
    import xrspatial_torch as xt
    from xrspatial_torch import zonal
    steps = []
    propagate = zonal._label_propagate

    def counted(data, n8):
        labels, k = propagate(data, n8)
        steps.append(k)
        return labels, k

    zonal._label_propagate = counted
    try:
        out, ms, peak = timed_run(lambda: xt.regions(raster), 0)
    finally:
        zonal._label_propagate = propagate
    return out, ms, peak, steps[0]


def zonal_path(dev, card):
    """Phase 24: A7 (zonal), torch ops and no kernel of ours, on the card:
    zonal_stats' 7 stats at 4096^2 (the JAX bench's leg) and N^2 against
    the float64 oracle, majority at 4096^2, crosstab count at N^2,
    regions at 4096^2 against scipy (and timed once at N^2), apply, trim
    and crop at N^2.  Returns its rows."""
    import torch
    import xrspatial_torch as xt
    from xrspatial_torch import zonal
    t_phase = time.perf_counter()
    print(f"== A7 zonal at {ZONAL_N}^2 and {N}^2 on {card}")
    rows = []

    def row(label, edge, ms, peak, reps, **extra):
        rows.append({"path": label, "edge": edge, "ms": ms, "peak_gib": peak,
                     "card": card, **extra})
        print(f"  {label} at {edge}^2: {ms:.3f} ms"
              f"{' (one call)' * (not reps)}, peak allocated {peak:.2f} GiB"
              f"{''.join(f', {k} {v}' for k, v in extra.items())}, {card}")

    def rasters(n):
        values = bump_raster(n, dev)
        zones = xt.DataArray(torch.floor(values.data / 100.0).to(torch.int32),
                             dims=("y", "x"), coords=values.coords)
        return values, zones

    def stats_leg(n, values, zones):
        reset_launches()
        cols, ms, peak = timed_run(
            lambda: xt.zonal_stats(zones, values, stats_funcs=ZONAL_STATS), 3)
        launched = {k: v for k, v in read_launches().items() if v}
        if launched:
            raise SmokeFailure(f"zonal_stats launched kernels: {launched}")
        row("zonal_stats (7 stats)", n, ms, peak, 3)
        check_zonal_stats(f"zonal_stats at {n}^2", cols, zones.data,
                          values.data)

    # 4096^2: the JAX bench's leg, majority, regions against scipy
    values, zones = rasters(ZONAL_N)
    stats_leg(ZONAL_N, values, zones)
    metres = xt.DataArray(torch.round(values.data), dims=("y", "x"))
    cols, ms, peak = timed_run(
        lambda: xt.zonal_stats(zones, metres, stats_funcs=["majority"]), 3)
    row("zonal_stats majority (whole metres)", ZONAL_N, ms, peak, 3)
    zh, vh = zones.data.cpu().numpy(), metres.data.cpu().numpy()
    ref = []
    for z in np.unique(zh):
        u, c = np.unique(vh[zh == z].astype(np.float64), return_counts=True)
        ref.append(u[np.argmax(c)])
    if not np.array_equal(np.asarray(cols["majority"]), ref):
        raise SmokeFailure("majority differs from numpy's")
    print(f"  majority equal to numpy's per-zone np.unique in {len(ref)} "
          f"zones")
    out, ms, peak, steps = regions_counted(
        xt.DataArray(zones.data.to(torch.float32), dims=("y", "x")))
    ref, nreg = scipy_regions(zh)
    if not np.array_equal(out.data.cpu().numpy(), ref):
        raise SmokeFailure("regions differ from scipy.ndimage.label")
    row("regions (4 neighbours)", ZONAL_N, ms, peak, 0, steps=steps,
        regions=nreg)
    print(f"  regions equal to scipy.ndimage.label's {nreg} regions at every "
          f"cell, in {steps} propagation steps")
    del values, zones, metres, out, zh, vh, ref

    # N^2: the stats, the extremes' lanes against one lane a zone,
    # crosstab, regions once, apply, trim, crop
    values, zones = rasters(N)
    stats_leg(N, values, zones)
    lanes = zonal._EXTREME_LANES
    turns = {}
    for k in (lanes, 1, 1, lanes):
        zonal._EXTREME_LANES = k
        try:
            turns.setdefault(k, []).append(timed_run(lambda: xt.zonal_stats(
                zones, values, stats_funcs=["min", "max"]), 1)[1])
        finally:
            zonal._EXTREME_LANES = lanes
    print(f"  min and max at {N}^2 in turns: {lanes} lanes a zone "
          f"{turns[lanes]} ms, one lane {turns[1]} ms, {card}")
    rows.append({"path": "min/max lanes a zone", "edge": N, "card": card,
                 "ms_by_lanes": {str(k): v for k, v in turns.items()}})
    cats = xt.DataArray(torch.floor(values.data / 250.0), dims=("y", "x"))
    cols, ms, peak = timed_run(lambda: xt.zonal_crosstab(zones, cats), 3)
    row("zonal_crosstab count (floor(dem / 250))", N, ms, peak, 3)
    zh, ch = zones.data.cpu().numpy(), cats.data.cpu().numpy()
    uz, uc = np.unique(zh), np.unique(ch)
    ref = np.bincount(np.searchsorted(uz, zh.ravel()) * uc.size
                      + np.searchsorted(uc, ch.ravel()),
                      minlength=uz.size * uc.size).reshape(uz.size, uc.size)
    got = np.stack([np.asarray(cols[c]) for c in uc], axis=1)
    if not (np.array_equal(np.asarray(cols["zone"]), uz)
            and np.array_equal(got, ref.astype(np.float32))):
        raise SmokeFailure("crosstab counts differ from numpy's")
    print(f"  crosstab: {uz.size} zones x {uc.size} categories equal to "
          f"numpy's bincount (float32)")
    del cols, cats, ch
    out, ms, peak, steps = regions_counted(
        xt.DataArray(zones.data.to(torch.float32), dims=("y", "x")))
    row("regions (4 neighbours)", N, ms, peak, 0, steps=steps,
        regions=int(torch.nan_to_num(out.data).max()))
    del out
    torch.cuda.empty_cache()

    # apply: a host function on every cell outside zone 0
    target = xt.DataArray(values.data.clone(), dims=("y", "x"))
    _, ms, peak = timed_run(
        lambda: xt.zonal_apply(zones, target, lambda x: x * 2), 0)
    mid = slice(N * 15 // 32, N * 17 // 32)
    want = torch.where(zones.data[mid] != 0, values.data[mid] * 2,
                       values.data[mid])
    if target.data.device.type != "cuda" or not torch.equal(
            target.data[mid], want):
        raise SmokeFailure("zonal_apply: wrong values or not on the card")
    row("zonal_apply (x * 2, host function)", N, ms, peak, 0)
    del target, want

    def extent(mask):
        r, c = np.nonzero(mask.any(1))[0], np.nonzero(mask.any(0))[0]
        return r[0], r[-1] + 1, c[0], c[-1] + 1

    for label, fn, mask in (
            ("trim (values -1, 0)", lambda: xt.trim(zones, values=(-1, 0)),
             ~np.isin(zh, (-1, 0))),
            ("crop (zone 5)", lambda: xt.crop(zones, values, zones_ids=(5,)),
             zh == 5)):
        out, ms, peak = timed_run(fn, 3)
        r0, r1, c0, c1 = extent(mask)
        if out.shape != (r1 - r0, c1 - c0) or out.data.device.type != "cuda":
            raise SmokeFailure(f"{label}: {out.shape} on {out.data.device}, "
                               f"expected {(r1 - r0, c1 - c0)} on the card")
        row(label, N, ms, peak, 3,
            extent=[int(r0), int(r1), int(c0), int(c1)])
    del zh, values, zones, out
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"  phase 24: {time.perf_counter() - t_phase:.1f} s, {card}")
    print(json.dumps({"a7_zonal_paths": rows}))
    return rows


def xdraw_cone_reads(h, w, vp_row, vp_col):
    """Slope cells X1 reads: every cell of each half-plane's ray cone."""
    import torch
    dy = torch.arange(h, dtype=torch.float64)[:, None] - vp_row
    dx = torch.arange(w, dtype=torch.float64)[None, :] - vp_col
    return int(((dx > 0) & (dy.abs() <= dx)).sum()
               + ((dx < 0) & (dy.abs() <= -dx)).sum()
               + ((dy > 0) & (dx.abs() <= dy)).sum()
               + ((dy < 0) & (dx.abs() <= -dy)).sum())


def xdraw_cells(data, vp, oe, m, timed):
    """X3 and X4 (``csrc/xdraw_cells.cu``) on `data` seen from `vp` at
    observer height `oe` (target 0, cells 1 apart, north up) against their
    plain versions, the torch passes ``_xdraw_fields`` and
    ``_xdraw_epilogue`` on the card, bit for bit, the epilogue on X1's
    field `m`.  With `timed`, each kernel and its torch passes in turns
    (plain, kernel, kernel, plain): {name: (kernel ms, plain ms)}; else
    {}."""
    from xrspatial_torch.kernels import cuda_xdraw_cells as xc
    from xrspatial_torch.kernels import viewshed as kv
    n = data.shape[0]
    geo = (oe, 0.0, 1.0, -1.0)
    dy, dx, safe, slope, tgt, vpe = kv._xdraw_fields(data, *vp, *geo)

    def fields():
        return xc.xdraw_fields_cuda(data, *vp, oe, 1.0, -1.0)

    def epilogue():
        return xc.xdraw_epilogue_cuda(m, data, *vp, *geo)

    def epilogue_plain():
        return kv._xdraw_epilogue(m, data, dy, dx, safe, tgt, vpe, 0.0)

    if not same_bits(fields(), slope):
        raise SmokeFailure(f"X3 at {n}^2 differs from _xdraw_fields")
    del slope
    if not same_bits(epilogue(), epilogue_plain()):
        raise SmokeFailure(f"X4 at {n}^2 differs from _xdraw_epilogue")
    if not timed:
        return {}
    return {"xdraw_fields": paired_ms(
                fields, lambda: kv._xdraw_fields(data, *vp, *geo), 20, 3),
            "xdraw_epilogue": paired_ms(epilogue, epilogue_plain, 20, 3)}


def xdraw_path(dev, card):
    """Phase 25: A11, the XDraw viewshed, its scan kernel X1 and its cell
    kernels X3 and X4.  Returns (X1 launches in the N^2 call, X1 ms, twin
    ms, (bytes, operations) of the function, the first port's ms in turns,
    X1's chain bound ms, {X3's and X4's name: (launches in the N^2 call,
    (kernel ms, torch passes' ms), (bytes, operations))})."""
    import torch
    import xrspatial_torch as xt
    from xrspatial_torch.kernels import cuda_xdraw, viewshed as kv
    t_phase = time.perf_counter()
    print(f"== A11 XDraw: X1 (csrc/xdraw.cu, banded) against its twin and "
          f"its first port, then viewshed at {XDRAW_N}^2 and {N}^2 on {card}")
    for shape in XDRAW_SHAPES:
        h, w = shape
        host = test_raster(shape, seed=h * w)
        for vp in ((0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1),
                   (h // 3, w // 2)):
            slope = kv._xdraw_fields(torch.from_numpy(host).to(dev), *vp,
                                     2.0, 0.0, 1.0, -1.0)[3]
            before = cuda_xdraw.XDRAW_LAUNCHES
            simple = cuda_xdraw.XDRAW_SIMPLE_LAUNCHES
            got = cuda_xdraw.xdraw_scan_cuda(slope, *vp)
            if cuda_xdraw.XDRAW_LAUNCHES != before + 1 \
                    or cuda_xdraw.XDRAW_SIMPLE_LAUNCHES != simple:
                raise SmokeFailure("xdraw_scan_cuda did not count its "
                                   "banded launch")
            if not same_bits(got, kv.xdraw_scan_twin(slope, *vp)):
                raise SmokeFailure(f"X1 {shape} vp {vp}: differs from its "
                                   f"twin")
            if not same_bits(got, cuda_xdraw.xdraw_scan_cuda(
                    slope, *vp, route="simple")):
                raise SmokeFailure(f"X1 {shape} vp {vp}: differs from its "
                                   f"first port")
    torch.cuda.synchronize()
    print(f"  X1 equal to its twin and its first port bit for bit at "
          f"{list(XDRAW_SHAPES)}, the viewpoint at every corner and inside")

    x, y, oe = XDRAW_VIEW
    twin = kv.xdraw_scan_twin
    timings = {}
    for n in (XDRAW_N, N):
        agg = bump_raster(n, dev)
        vp = (n - 1 - int(y), int(x))
        plan = kv.xdraw_plan(n, n, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        slope = kv._xdraw_fields(agg.data, *vp, oe, 0.0, 1.0, -1.0)[3]
        got = cuda_xdraw.xdraw_scan_cuda(slope, *vp)
        t0 = time.perf_counter()
        ref = twin(slope, *vp)
        torch.cuda.synchronize()
        twin_ms = (time.perf_counter() - t0) * 1e3
        if not same_bits(got, ref):
            raise SmokeFailure(f"X1 at {n}^2 differs from its twin")
        del ref
        if not same_bits(got, cuda_xdraw.xdraw_scan_cuda(slope, *vp,
                                                         route="simple")):
            raise SmokeFailure(f"X1 at {n}^2 differs from its first port")
        print(f"  X1 equal to its twin and its first port bit for bit at "
              f"{n}^2 (viewpoint {vp}; bands of {plan.band} lanes, chunks "
              f"of {plan.chunk} steps, {plan.blocks} blocks of "
              f"{plan.threads} threads); the twin {twin_ms:.1f} ms (one "
              f"call, host clock)")
        cells_ms = xdraw_cells(agg.data, vp, oe, got, n == N)
        print(f"  X3 equal to _xdraw_fields' slope and X4 to "
              f"_xdraw_epilogue's angles bit for bit at {n}^2" + "".join(
                  f"; {k} {k_ms:.3f} ms, its torch passes {p_ms:.3f} ms in "
                  f"turns" for k, (k_ms, p_ms) in cells_ms.items())
              + f", {card}")
        del got

        def refuse(*a):
            raise SmokeFailure("the XDraw path called the twin on the card")

        kv.xdraw_scan_twin = refuse
        try:
            reset_launches()
            out = xt.viewshed(agg, x=x, y=y, observer_elev=oe)
            torch.cuda.synchronize()
            launched = {k: v for k, v in read_launches().items() if v}
            x1 = cuda_xdraw.XDRAW_LAUNCHES
        finally:
            kv.xdraw_scan_twin = twin
        vis = out.data
        if launched != {"xdraw_scan": 1, "xdraw_fields": 1,
                        "xdraw_epilogue": 1} or vis.dtype != torch.float32 \
                or vis.device.type != "cuda" or tuple(vis.shape) != (n, n):
            raise SmokeFailure(f"viewshed at {n}^2: launches {launched} (one "
                               f"each of X1, X3 and X4 expected), "
                               f"{vis.dtype} {tuple(vis.shape)} on "
                               f"{vis.device}")
        if float(vis[vp]) != 180.0 or not bool(
                ((vis == -1) | ((vis >= 0) & (vis <= 180))).all()):
            raise SmokeFailure(f"viewshed at {n}^2: values out of range")
        share = float((vis > -1).double().mean())
        print(f"  viewshed at {n}^2 (x={x}, y={y}, observer_elev={oe}): one "
              f"launch each of X1 on the banded route, X3 and X4, no twin "
              f"call, no other kernel; float32 on the card, {share:.4f} of "
              f"the cells visible")
        if n == XDRAW_N:
            cpu = xt.DataArray(agg.data.cpu(), dims=("y", "x"),
                               coords=agg.coords)
            ref = xt.viewshed(cpu, x=x, y=y, observer_elev=oe).data
            g = vis.cpu()
            both = (g > -1) & (ref > -1)
            if not torch.equal(g == -1, ref == -1) or not torch.allclose(
                    g[both], ref[both], rtol=XDRAW_ANGLE_RTOL, atol=0):
                raise SmokeFailure("viewshed at 4096^2: the card differs "
                                   "from the CPU")
            print(f"  equal to the CPU's visibility at every cell, angles "
                  f"within rtol {XDRAW_ANGLE_RTOL}")
            del cpu, ref, g, both
        del out, vis
        t_call = timed_run(lambda: xt.viewshed(agg, x=x, y=y,
                                               observer_elev=oe), 3)
        # the banded kernel and the first port in turns: new, old, old, new
        legs = {"banded": [], "simple": []}
        for route in ("banded", "simple", "simple", "banded"):
            legs[route].append(timed_run(
                lambda: cuda_xdraw.xdraw_scan_cuda(slope, *vp, route=route),
                5)[1])
        x1_ms, first_ms = (sum(v) / len(v) for v in legs.values())
        # the plan's band and chunk beside others, in turns
        sweep = {}
        ref = cuda_xdraw.xdraw_scan_cuda(slope, *vp)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        fits = [(b, c) for b, c in XDRAW_SWEEP
                if (p := kv.xdraw_plan(n, n, band=b, chunk=c)).blocks
                <= sms * p.per_sm]
        for band, chunk in fits + fits[::-1]:
            got, ms_, _ = timed_run(
                lambda: cuda_xdraw.xdraw_scan_cuda(
                    slope, *vp, band=band, chunk=chunk), 3)
            if not same_bits(got, ref):
                raise SmokeFailure(f"X1 at {n}^2 in bands of {band} and "
                                   f"chunks of {chunk}: differs from "
                                   f"the plan's")
            sweep.setdefault(f"{band}x{chunk}", []).append(ms_)
            del got
        del ref
        print(f"  X1 at {n}^2 by band x chunk, in turns: " + "; ".join(
            f"{k} {', '.join(f'{v:.3f}' for v in vs)} ms"
            for k, vs in sweep.items()) + f", {card}")
        # the chain alone: the banded kernel on one lane, row 0 of the
        # raster seen from its first cell, n - 1 dependent steps
        row = kv._xdraw_fields(agg.data[:1].contiguous(), 0, 0, oe, 0.0,
                               1.0, -1.0)[3]
        lane_ms = timed_run(lambda: cuda_xdraw.xdraw_scan_cuda(row, 0, 0),
                            5)[1]
        step_us = lane_ms * 1e3 / (n - 1)
        # the longest half-plane's walk
        steps = max(n - 1 - vp[1], vp[1], n - 1 - vp[0], vp[0])
        timings[n] = {"viewshed_ms": t_call[1], "x1_ms": x1_ms,
                      "cells_ms": cells_ms,
                      "x1_legs_ms": legs["banded"],
                      "first_port_ms": first_ms,
                      "first_port_legs_ms": legs["simple"],
                      "x1_launches": x1, "twin_ms": twin_ms,
                      "peak_gib": t_call[2], "one_lane_ms": lane_ms,
                      "step_us": step_us, "chain_steps": steps,
                      "chain_bound_ms": steps * step_us / 1e3,
                      "cone_reads": xdraw_cone_reads(n, n, *vp), "vp": vp,
                      "plan": plan._asdict(), "sweep_ms": sweep}
        print(f"  at {n}^2: viewshed warm {t_call[1]:.3f} ms (peak "
              f"{t_call[2]:.2f} GiB); X1 banded {x1_ms:.3f} ms "
              f"({', '.join(f'{v:.3f}' for v in legs['banded'])}), its first "
              f"port (with its transpose) {first_ms:.3f} ms "
              f"({', '.join(f'{v:.3f}' for v in legs['simple'])}) in turns; "
              f"one lane of {n - 1} steps {lane_ms:.3f} ms ({step_us:.4f} us "
              f"a step), so {steps} steps take at least "
              f"{steps * step_us / 1e3:.3f} ms; the twin {twin_ms:.1f} ms, "
              f"{card}")
        del agg, slope, row, t_call
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # the exact route against XDraw at the ceiling
    agg = bump_raster(XDRAW_EXACT_N, dev)
    kw = dict(x=x, y=y, observer_elev=oe)
    exact = xt.viewshed(agg, exact=True, **kw).data
    los = xt.viewshed(agg, exact=False, **kw).data
    agree = float(((exact > -1) == (los > -1)).double().mean())
    print(f"  at {XDRAW_EXACT_N}^2: XDraw agrees with the exact predicate "
          f"on {agree:.5f} of the cells (at least {XDRAW_AGREE})")
    if agree < XDRAW_AGREE:
        raise SmokeFailure(f"XDraw agrees with the exact route on only "
                           f"{agree}")
    print(f"  phase 25: {time.perf_counter() - t_phase:.1f} s, {card}")
    print(json.dumps({"a11_xdraw": {str(k): v for k, v in timings.items()}}))
    # the function's bytes: each cone cell of the slope field read once,
    # the field written once
    t = timings[N]
    work = (4 * (t["cone_reads"] + N * N), XDRAW_OPS * t["cone_reads"])
    # X3 reads the DEM and writes the slope; X4 reads the DEM and X1's
    # field (its neighbours from L1 and L2) and writes the angles
    cells = {"xdraw_fields": (1, t["cells_ms"]["xdraw_fields"],
                              (8 * N * N, XFIELDS_OPS * N * N)),
             "xdraw_epilogue": (1, t["cells_ms"]["xdraw_epilogue"],
                                (12 * N * N, XEPILOGUE_OPS * N * N))}
    return (t["x1_launches"], t["x1_ms"], t["twin_ms"], work,
            t["first_port_ms"], t["chain_bound_ms"], cells)


# -- phase 26: A9 (synthesis, with the bump kernel X2) and A12 (host modules) -

TERRAIN_N = 4096        # the JAX bench's generate_terrain leg (bench.py:382-391)
BUMP_N = 4096           # X2 timed on a BUMP_N^2 map at bump()'s default count
BUMP_SEED = 26
BUMP_SPREADS = (0, 1, 3)
BUMP_TWIN_BUMPS = 2 ** 18   # the bumps the twin walks, and X2 beside it
BUMP_FIRST_PORT_SPREADS = (1, 3)    # X2 against its first port on all bumps
BUMP_BIG_N = 16384          # X2 alone at bump()'s default count
POLY_N = 1024           # polygonize's classified terrain
POLY_CLASS_M = 1000.0   # its classes: floor(elevation / 1000 m)
# float64 operations of X2 (bump.cu): the centre's sum a bump, then a
# product and a sum a ring cell inside the raster
X2_OPS_CENTRE, X2_OPS_RING_CELL = 1, 2


def bump_case(spread, seed):
    """(shape, (N, 2) int32 locations (x, y), (N,) float64 heights): 600
    bumps on 23x17 with duplicates forced, a bump on every corner and
    edge, non-integer and negative heights."""
    rng = np.random.default_rng(seed)
    h, w = 17, 23
    locs = np.stack([rng.integers(0, w, 600), rng.integers(0, h, 600)], 1)
    locs[:10] = [[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1], [5, 0],
                 [0, 7], [w - 1, 9], [11, h - 1], [5, 0], [5, 0]]
    heights = rng.random(600) * 7.3 - 1.1
    return (h, w), locs.astype(np.int32), heights


def bump_counts():
    """X2's counters: (rounds, bumps done in them, bumps walked after them,
    first-port launches)."""
    from xrspatial_torch.kernels import cuda_bump
    return (cuda_bump.BUMP_ROUNDS, cuda_bump.BUMP_ROUND_BUMPS,
            cuda_bump.BUMP_TAIL_BUMPS, cuda_bump.BUMP_SIMPLE_LAUNCHES)


def counted(fn):
    """fn()'s result and the change of X2's counters over it."""
    before = bump_counts()
    out = fn()
    return out, tuple(a - b for a, b in zip(bump_counts(), before))


def check_bump(dev):
    """X2 against its twin on the card, bit for bit, at every spread."""
    import torch
    from xrspatial_torch.kernels import cuda_bump
    from xrspatial_torch.kernels.bump import bump_scan_twin
    for spread in BUMP_SPREADS:
        shape, locs, heights = bump_case(spread, seed=100 + spread)
        args = (torch.from_numpy(locs).to(dev),
                torch.from_numpy(heights).to(dev), spread)
        before = cuda_bump.BUMP_LAUNCHES
        got, (rounds, done, tail, simple) = counted(
            lambda: cuda_bump.bump_scan_cuda(
                torch.zeros(shape, dtype=torch.float64, device=dev), *args))
        torch.cuda.synchronize()
        if cuda_bump.BUMP_LAUNCHES != before + 1 or simple \
                or done + tail != len(locs):
            raise SmokeFailure("bump_scan_cuda did not count its launch, "
                               "its rounds and its walk")
        ref = bump_scan_twin(torch.zeros(shape, dtype=torch.float64,
                                         device=dev), *args)
        if not same_bits(got, ref):
            raise SmokeFailure(f"X2 at spread {spread} differs from its "
                               f"twin")
        print(f"  X2 equal to its twin bit for bit at spread {spread} (600 "
              f"bumps on 23x17: duplicates, every edge and corner, "
              f"non-integer heights): {rounds} rounds took {done} bumps, "
              f"the walk {tail}")


def bump_inputs(n, dev):
    """bump(n, n)'s locations and heights at BUMP_SEED, as bump() draws
    them: (N, 2) int32 and (N,) float64 on `dev`."""
    import torch
    count = n * n // 10
    np.random.seed(BUMP_SEED)
    locs = np.empty((count, 2), dtype=np.uint16)
    locs[:, 0] = np.random.choice(range(n), count)
    locs[:, 1] = np.random.choice(range(n), count)
    return (torch.from_numpy(locs.astype(np.int32)).to(dev),
            torch.ones(count, dtype=torch.float64, device=dev))


def x2_ring_cells(locs, n, spread):
    """The ring cells inside the n x n map over all bumps: the sums and
    products X2 does beyond the centres."""
    from xrspatial_torch.kernels.bump import ring_offsets
    oy, ox, _ = ring_offsets(spread)
    x, y = locs[:, 0].long(), locs[:, 1].long()
    total = 0
    for dy, dx in zip(oy.tolist(), ox.tolist()):
        total += int((((y + dy) >= 0) & ((y + dy) < n)
                      & ((x + dx) >= 0) & ((x + dx) < n)).sum())
    return total


def bump_path(dev, card):
    """The bump map: X2 against its twin, then bump() at BUMP_N^2 and the
    default count, spread 1; X2 against its first port by name on all
    those bumps at spreads 1 and 3, both timed in turns; X2 and its first
    port on the first BUMP_TWIN_BUMPS bumps beside the twin; X2 on
    bump(BUMP_BIG_N, BUMP_BIG_N)'s bumps.  Returns a dict of the kernels
    line's numbers and phase 26's X2 rows."""
    import torch
    import xrspatial_torch as xt
    from xrspatial_torch.kernels import bump as kb
    from xrspatial_torch.kernels import cuda_bump
    check_bump(dev)
    twin = kb.bump_scan_twin

    def refuse(*a):
        raise SmokeFailure("bump() called the twin on the card")

    kb.bump_scan_twin = refuse
    try:
        reset_launches()
        np.random.seed(BUMP_SEED)
        t0 = time.perf_counter()
        out, (rounds, done, tail, simple) = counted(
            lambda: xt.bump(BUMP_N, BUMP_N))
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        launched = {k: v for k, v in read_launches().items() if v}
    finally:
        kb.bump_scan_twin = twin
    count = BUMP_N * BUMP_N // 10
    m = out.data
    if launched != {"bump_scan": 1} or simple or done + tail != count \
            or m.dtype != torch.float64 or m.device.type != "cuda" \
            or tuple(m.shape) != (BUMP_N, BUMP_N):
        raise SmokeFailure(f"bump at {BUMP_N}^2: launches {launched}, "
                           f"{simple} on the first port, {done} + {tail} "
                           f"bumps, {m.dtype} {tuple(m.shape)} on "
                           f"{m.device}")
    locs, heights = bump_inputs(BUMP_N, dev)
    print(f"  bump({BUMP_N}, {BUMP_N}): {count} bumps, spread 1, one X2 "
          f"launch on the rounds route ({rounds} rounds took {done} bumps, "
          f"the walk {tail}), no twin call, float64 on the card; the call "
          f"{call_s * 1e3:.1f} ms (host clock, the RNG draws and the "
          f"counters' read included)")
    rows = {"bump_call": {"bumps": count, "rounds": rounds,
                          "round_bumps": done, "tail_bumps": tail,
                          "call_ms": call_s * 1e3}}

    # all the bumps: the rounds against the first port by name, bit for
    # bit, each spread timed in turns (rounds, first port, first port,
    # rounds)
    scratch = torch.zeros_like(m)
    for spread in BUMP_FIRST_PORT_SPREADS:
        first = torch.zeros_like(m)
        cuda_bump.bump_scan_cuda(first, locs, heights, spread,
                                 route="simple")
        got, (rounds, done, tail, _) = counted(
            lambda: cuda_bump.bump_scan_cuda(
                torch.zeros_like(m), locs, heights, spread))
        if not same_bits(got, first):
            raise SmokeFailure(f"X2 at {BUMP_N}^2, spread {spread}: the "
                               f"rounds differ from the first port")
        if spread == 1 and not same_bits(got, m):
            raise SmokeFailure("X2 on bump()'s inputs differs from bump()")
        del got, first
        legs, new_ms, old_ms, call_ms = x2_in_turns(scratch, locs, heights,
                                                    spread)
        rows[f"all_bumps_spread{spread}"] = {
            "bumps": count, "rounds": rounds, "round_bumps": done,
            "tail_bumps": tail, "ms": new_ms, "call_ms": call_ms,
            "legs_ms": legs["rounds"], "first_port_ms": old_ms,
            "first_port_legs_ms": legs["simple"]}
        print(f"  X2 equal to its first port bit for bit on all {count} "
              f"bumps at spread {spread}: {rounds} rounds took {done} "
              f"bumps, the walk {tail}; in turns X2 {new_ms:.3f} ms "
              f"(device ms, call ms: {legs['rounds']}), the first port "
              f"{old_ms:.3f} ms ({legs['simple']}), {old_ms / new_ms:.0f}x; "
              f"the call with its check of the locations {call_ms:.3f} ms, "
              f"{card}")

    # the twin walks a prefix of the same bumps (at ~30 us a bump on the
    # card, all of them would take a minute); X2 and its first port on the
    # same prefix
    p_locs, p_heights = locs[:BUMP_TWIN_BUMPS], heights[:BUMP_TWIN_BUMPS]
    got, (rounds, done, tail, _) = counted(
        lambda: cuda_bump.bump_scan_cuda(torch.zeros_like(m), p_locs,
                                         p_heights, 1))
    _, pre_ms, pre_first_ms, pre_call_ms = x2_in_turns(scratch, p_locs,
                                                       p_heights, 1)
    ring = x2_ring_cells(p_locs, BUMP_N, 1)
    ref = torch.zeros_like(m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    twin(ref, p_locs, p_heights, 1)
    torch.cuda.synchronize()
    twin_ms = (time.perf_counter() - t0) * 1e3
    if not same_bits(ref, got):
        raise SmokeFailure(f"X2 at {BUMP_N}^2 differs from its twin")
    n = len(p_locs)
    print(f"  X2 equal to its twin bit for bit at {BUMP_N}^2 on the first "
          f"{n} bumps ({ring} ring cells inside the map; {rounds} rounds "
          f"took {done}, the walk {tail}): X2 {pre_ms:.3f} ms (the call "
          f"{pre_call_ms:.3f}), its first port {pre_first_ms:.3f} ms in "
          f"turns, the twin {twin_ms:.1f} ms "
          f"on the card ({twin_ms * 1e3 / n:.2f} us a bump, host clock), "
          f"{card}")
    rows["prefix"] = {"bumps": n, "rounds": rounds, "round_bumps": done,
                      "tail_bumps": tail, "ms": pre_ms,
                      "call_ms": pre_call_ms, "first_port_ms": pre_first_ms,
                      "twin_ms": twin_ms}
    del out, m, scratch, ref, got, locs, heights
    torch.cuda.empty_cache()

    # BUMP_BIG_N^2 at bump()'s default count: the rounds route only (the
    # first port would walk for ~24 s)
    big_locs, big_heights = bump_inputs(BUMP_BIG_N, dev)
    big = torch.zeros((BUMP_BIG_N, BUMP_BIG_N), dtype=torch.float64,
                      device=dev)
    _, (rounds, done, tail, _) = counted(
        lambda: cuda_bump.bump_scan_cuda(big, big_locs, big_heights, 1))
    big_ms = [x2_timed(big, big_locs, big_heights, 1, "rounds")
              for _ in range(2)]           # (device ms, call ms) each
    if done + tail != len(big_locs) or not bool(torch.isfinite(big).all()) \
            or float(big.sum()) <= 0.0:
        raise SmokeFailure(f"X2 at {BUMP_BIG_N}^2: {done} + {tail} bumps "
                           f"of {len(big_locs)}, or a map that is not "
                           f"finite and positive")
    rows[f"bump_{BUMP_BIG_N}"] = {"bumps": len(big_locs), "rounds": rounds,
                                  "round_bumps": done, "tail_bumps": tail,
                                  "ms": big_ms}
    print(f"  X2 at {BUMP_BIG_N}^2 on bump()'s {len(big_locs)} bumps, "
          f"spread 1: {rounds} rounds took {done} bumps, the walk {tail}; "
          f"(device ms, call ms) {big_ms}, {card}")
    del big, big_locs, big_heights
    torch.cuda.empty_cache()
    # the function's bytes on the prefix: the locations (int32 pairs) and
    # heights read once, the map written once; its operations, float64
    work = (n * (8 + 8) + BUMP_N * BUMP_N * 8,
            X2_OPS_CENTRE * n + X2_OPS_RING_CELL * ring)
    return {"launches": launched["bump_scan"], "ms": pre_ms,
            "twin_ms": twin_ms, "work": work, "first_port_ms": pre_first_ms,
            "rows": rows}


def x2_in_turns(out, locs, heights, spread):
    """X2 and its first port in turns (rounds, first port, first port,
    rounds): ({route: [(device ms, call ms)]}, X2's mean device ms, the
    first port's, X2's mean call ms)."""
    legs = {"rounds": [], "simple": []}
    for route in ("rounds", "simple", "simple", "rounds"):
        legs[route].append(x2_timed(out, locs, heights, spread, route))
    new_ms, old_ms = (sum(d for d, _ in v) / len(v) for v in legs.values())
    call_ms = sum(c for _, c in legs["rounds"]) / len(legs["rounds"])
    return legs, new_ms, old_ms, call_ms


def x2_timed(out, locs, heights, spread, route):
    """One X2 call on `route` adding `locs`/`heights` to `out` zeroed
    before it: (the kernel's device ms from torch.profiler's CUDA trace,
    or the call's ms when the trace holds no device time; the call's ms
    from CUDA events, the wrapper's check of the locations and its read
    of the rounds' counters, host round trips both, included).  `out`
    holds the result."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from xrspatial_torch.kernels import cuda_bump
    name = "bump_rounds_kernel" if route == "rounds" else "bump_scan_kernel"
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out.zero_()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        cuda_bump.bump_scan_cuda(out, locs, heights, spread, route=route)
        end.record()
        end.synchronize()
    call_ms = start.elapsed_time(end)
    us = sum(getattr(e, "device_time_total", 0) or 0
             for e in prof.key_averages() if name in e.key)
    return (us / 1e3 if us else call_ms), call_ms


def synthesis_path(dev, card):
    """generate_terrain at TERRAIN_N^2 and N^2, terrain_pipeline on the
    latter, perlin at TERRAIN_N^2 and N^2.  Returns the TERRAIN_N^2
    terrain (a DataArray on the card)."""
    import torch
    import xrspatial_torch as xt
    from xrspatial_torch import terrain as tt
    from xrspatial_torch.kernels import cuda_surface, cuda_window
    rows = {}
    blank = xt.DataArray(torch.zeros((TERRAIN_N, TERRAIN_N), device=dev),
                         dims=("y", "x"))
    tt._transport.cache_clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    terrain = xt.generate_terrain(blank)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    _, warm_ms, peak = timed_run(lambda: xt.generate_terrain(blank), 3)
    t0 = time.perf_counter()
    ref = xt.generate_terrain(xt.DataArray(
        torch.zeros((TERRAIN_N, TERRAIN_N)), dims=("y", "x"))).data
    cpu_s = time.perf_counter() - t0
    if terrain.data.device.type != "cuda" or not same_bits(
            terrain.data.cpu(), ref):
        raise SmokeFailure(f"generate_terrain at {TERRAIN_N}^2: the card "
                           f"differs from the CPU")
    rows["generate_terrain_4096"] = {"cold_ms": cold_ms, "warm_ms": warm_ms,
                                     "peak_gib": peak, "cpu_s": cpu_s}
    print(f"  generate_terrain at {TERRAIN_N}^2 (the JAX bench's leg): cold "
          f"{cold_ms:.1f} ms (host clock: hashing, upload, 16 octaves), "
          f"warm {warm_ms:.3f} ms (CUDA events, peak {peak:.2f} GiB); equal "
          f"to the CPU's bit for bit (the CPU call {cpu_s:.1f} s), {card}")
    del ref

    # N^2: the cold call, its host hashing timed inside it
    hashing = []
    hash_tables = tt.terrain_tables

    def timed_tables(*args):
        t0 = time.perf_counter()
        out = hash_tables(*args)
        hashing.append((time.perf_counter() - t0, out[0].nbytes / 2**20))
        return out

    big = xt.DataArray(torch.zeros((N, N), device=dev), dims=("y", "x"))
    tt.terrain_tables = timed_tables
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dem = xt.generate_terrain(big)
        torch.cuda.synchronize()
        big_cold_ms = (time.perf_counter() - t0) * 1e3
    finally:
        tt.terrain_tables = hash_tables
    (hash_s, table_mb), = hashing
    _, big_ms, big_peak = timed_run(lambda: xt.generate_terrain(big), 2)
    d = dem.data
    zmin, zmax = float(d.min()), float(d.max())
    water = float((d == 0).double().mean())
    if d.dtype != torch.float32 or zmin != 0.0 or not 0 < zmax <= 4000.0 \
            or not bool(torch.isfinite(d).all()) or not 0 < water < 1:
        raise SmokeFailure(f"generate_terrain at {N}^2: {d.dtype}, min "
                           f"{zmin}, max {zmax}, water share {water}")
    rows["generate_terrain_16384"] = {
        "hash_s": hash_s, "table_mib": table_mb, "cold_ms": big_cold_ms,
        "warm_ms": big_ms, "peak_gib": big_peak, "water_share": water,
        "max_m": zmax}
    print(f"  generate_terrain at {N}^2: host hashing {hash_s:.2f} s "
          f"({table_mb:.0f} MiB of tables), cold {big_cold_ms:.1f} ms, warm "
          f"{big_ms:.3f} ms (peak {big_peak:.2f} GiB); min 0, max "
          f"{zmax:.1f} <= 4000, water {water:.4f} of the cells, {card}")

    # the synthesised DEM through B1 and B2
    reset_launches()
    with fused_pipeline(False):
        ds = xt.terrain_pipeline(dem, surface=PIPELINE_SURFACE,
                                 stats_funcs=PIPELINE_STATS)
    torch.cuda.synchronize()
    launched = {k: v for k, v in read_launches().items() if v}
    if launched != {"surface_kernel": 1, "focal_kernel": 1}:
        raise SmokeFailure(f"terrain_pipeline on the terrain: {launched}")
    slope = ds["terrain-slope"].data
    inner = slope[1:-1, 1:-1]
    if not (bool((inner >= 0).all()) and bool((inner < 90).all())
            and bool(torch.isfinite(ds["focal_stats"].data).all())):
        raise SmokeFailure("terrain_pipeline on the terrain: out of range")
    print(f"  terrain_pipeline on the {N}^2 terrain: one B1 and one B2 "
          f"launch, slope in [0, 90), focal stats finite")
    del ds, slope, inner, dem, d
    tt._transport.cache_clear()
    torch.cuda.empty_cache()

    # perlin
    for n in (TERRAIN_N, N):
        agg = xt.DataArray(torch.zeros((n, n), device=dev), dims=("y", "x"))
        out, ms, peak = timed_run(lambda: xt.perlin(agg), 3)
        p = out.data
        if float(p.min()) != 0.0 or float(p.max()) != 1.0 \
                or p.dtype != torch.float32:
            raise SmokeFailure(f"perlin at {n}^2 outside [0, 1]")
        note = ""
        if n == TERRAIN_N:
            cpu = xt.perlin(xt.DataArray(torch.zeros((n, n)),
                                         dims=("y", "x"))).data
            if not same_bits(p.cpu(), cpu):
                raise SmokeFailure(f"perlin at {n}^2: the card differs "
                                   f"from the CPU")
            note = "; equal to the CPU's bit for bit"
        rows[f"perlin_{n}"] = {"ms": ms, "peak_gib": peak}
        print(f"  perlin at {n}^2: {ms:.3f} ms (peak {peak:.2f} GiB), min 0, "
              f"max 1{note}, {card}")
        del out, p
    torch.cuda.empty_cache()
    return terrain, rows


def host_modules_path(terrain, card):
    """A12 on the card's rasters: a_star_search on the TERRAIN_N^2 terrain
    (water the barrier), polygonize of a classified POLY_N^2 terrain,
    diagnose; each against the same call on the CPU."""
    import torch
    import xrspatial_torch as xt
    from xrspatial_torch import pathfinding
    from xrspatial_torch.experimental import polygonize
    rows = {}
    xs, ys = terrain["x"].values, terrain["y"].values
    # from the middle of the west edge to the south-east corner (y
    # ascends), both snapped onto land
    kw = dict(start=(ys[TERRAIN_N // 2], xs[0]), goal=(ys[-1], xs[-1]),
              barriers=[0], snap_start=True, snap_goal=True)
    before = pathfinding.NATIVE_CALLS
    t0 = time.perf_counter()
    path = xt.a_star_search(terrain, **kw)
    torch.cuda.synchronize()
    astar_s = time.perf_counter() - t0
    cpu_terrain = xt.DataArray(terrain.data.cpu(), dims=terrain.dims,
                               coords=terrain.coords, attrs=terrain.attrs)
    ref = xt.a_star_search(cpu_terrain, **kw)
    if pathfinding.NATIVE_CALLS != before + 2:
        raise SmokeFailure("a_star_search did not run the native route")
    got = path.data
    cells = int(torch.isfinite(got).sum())
    if got.device.type != "cuda" or got.dtype != torch.float64 \
            or not same_bits(got.cpu(), ref.data) or cells < TERRAIN_N // 2:
        raise SmokeFailure(f"a_star_search: {cells} path cells on "
                           f"{got.device}, or unlike the CPU's")
    cost = float(got[torch.isfinite(got)].max())
    rows["a_star_search"] = {"s": astar_s, "path_cells": cells,
                             "cost": cost}
    print(f"  a_star_search on the {TERRAIN_N}^2 terrain (water barred, "
          f"ends snapped): native route, {cells} path cells, cost "
          f"{cost:.3f}, {astar_s:.2f} s (host clock, the copy to the host "
          f"included); equal to the CPU's")
    del path, got, ref, cpu_terrain

    small = xt.generate_terrain(xt.DataArray(
        torch.zeros((POLY_N, POLY_N), device=terrain.data.device),
        dims=("y", "x")))
    classes = torch.floor(small.data / POLY_CLASS_M)
    t0 = time.perf_counter()
    col, polys = polygonize(xt.DataArray(classes))
    poly_s = time.perf_counter() - t0
    col_ref, polys_ref = polygonize(xt.DataArray(classes.cpu()))
    same = col == col_ref and len(polys) == len(polys_ref) and all(
        len(a) == len(b) and all(np.array_equal(r, s) for r, s in zip(a, b))
        for a, b in zip(polys, polys_ref))
    if not same or not col:
        raise SmokeFailure("polygonize: the card's raster gives other "
                           "polygons than the CPU's")
    rings = sum(len(p) for p in polys)
    rows["polygonize"] = {"s": poly_s, "polygons": len(col), "rings": rings}
    print(f"  polygonize of the classified {POLY_N}^2 terrain: {len(col)} "
          f"polygons, {rings} rings, {poly_s:.2f} s (host); equal to the "
          f"CPU's")

    geo = {"y": np.linspace(45.0, 44.0, POLY_N),
           "x": np.linspace(7.0, 8.0, POLY_N)}
    dem = xt.DataArray(small.data, dims=("y", "x"), coords=geo)
    report = xt.diagnose(dem)
    ref = xt.diagnose(xt.DataArray(small.data.cpu(), dims=("y", "x"),
                                   coords=geo))
    if str(report) != str(ref) or not report.has_warnings:
        raise SmokeFailure(f"diagnose on the card: {report}")
    print(f"  diagnose on the card's raster (degrees over metres): "
          f"{report.issues[0].code}, the CPU's report")
    return rows


def a9_a12_paths(dev, card):
    """Phase 26: A9 and A12.  Returns bump_path's numbers."""
    import torch
    t_phase = time.perf_counter()
    print(f"== A9/A12: X2 (csrc/bump.cu, rounds) against its twin and its "
          f"first port, bump at {BUMP_N}^2 and {BUMP_BIG_N}^2, "
          f"generate_terrain, perlin, a_star_search, polygonize, diagnose "
          f"on {card}")
    x2 = bump_path(dev, card)
    terrain, rows = synthesis_path(dev, card)
    rows.update(host_modules_path(terrain, card))
    del terrain
    torch.cuda.empty_cache()
    rows["x2"] = x2["rows"]
    print(f"  phase 26: {time.perf_counter() - t_phase:.1f} s, {card}")
    print(json.dumps({"a9_a12_paths": rows}))
    return x2


# -- phase 27: A13, the mesh on one card -------------------------------------

MESH_N = N                  # the mesh's main raster edge
MESH_PROX_NS = (N, 4096)    # proximity's edges on the 2 x 2 mesh
# the uneven case: 16383 rows do not divide 2, so distribute holds y whole
# on every block and the stencils cut it into tiles of 8192 and 8191 rows
# (a 16383^2 raster would divide neither axis: every block would hold all
# of it and the one-device path would run, as in the JAX package)
MESH_UNEVEN = (N - 1, N)
MESH_QUANTILE_K = 5
MESH_REPS = 3


def mesh_blocks_equal(out, ref):
    """Each block of the mesh result `out` equals its window of the
    unsharded `ref`, bit for bit."""
    for i, row in enumerate(out.blocks):
        for j, blk in enumerate(row):
            (y0, y1), (x0, x1) = out.extent(0, i), out.extent(1, j)
            if not same_bits(blk.to(ref.device), ref[out.index_of(
                    slice(y0, y1), slice(x0, x1))]):
                return False
    return True


def mesh_timed(fn, mesh):
    """(warm ms, peak allocated GiB) of `fn` on `mesh`: CUDA events on one
    card; on several cards the host clock between synchronisations of
    every card (an event times one card's stream) and the largest peak
    of any card."""
    import torch
    cards = sorted({d.index or 0 for row in mesh.devices for d in row})
    if len(cards) == 1:
        _, ms, gib = timed_run(fn, MESH_REPS)
        return ms, gib

    def sync():
        for c in cards:
            torch.cuda.synchronize(c)
    fn()
    sync()
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    t0 = time.perf_counter()
    for _ in range(MESH_REPS):
        fn()
    sync()
    return ((time.perf_counter() - t0) * 1e3 / MESH_REPS,
            max(torch.cuda.max_memory_allocated(c) for c in cards) / 2**30)


def mesh_name(mesh):
    cards = len({d for row in mesh.devices for d in row})
    return (f"{mesh.shape['y']}x{mesh.shape['x']} mesh of "
            f"{'one card' if cards == 1 else f'{cards} cards'}")


def mesh_checked(label, out, ref, mesh):
    """Raise unless `out` is a ShardedRaster on `mesh` with every block on
    the card, equal to `ref` bit for bit."""
    from xrspatial_torch.parallel import get_raster_mesh
    if get_raster_mesh(out) is not mesh:
        raise SmokeFailure(f"mesh {label}: the result is {type(out)}, not "
                           f"split over the mesh")
    if any(b.device.type != "cuda" for row in out.blocks for b in row):
        raise SmokeFailure(f"mesh {label}: a block is off the card")
    if tuple(out.shape) != tuple(ref.shape) or not mesh_blocks_equal(out,
                                                                     ref):
        raise SmokeFailure(f"mesh {label}: differs from the unsharded call")


def mesh_dem(shape, dev, mesh):
    """The gaussian bump of `shape` as a DataArray on the card and as one
    split over `mesh` (the same numbers)."""
    from xrspatial_torch import DataArray
    from xrspatial_torch.parallel import distribute
    dem = gaussian_bump(*shape, dev)
    coords = {"y": np.arange(shape[0], dtype=float)[::-1].copy(),
              "x": np.arange(shape[1], dtype=float)}

    def agg(payload):
        return DataArray(payload, dims=("y", "x"), coords=coords,
                         name="dem", attrs={"res": (1.0, 1.0)})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # a replicated axis
        split = distribute(dem, mesh)
    return agg(dem), agg(split)


def mesh_routes(split, mesh):
    """B1's (and B2's) launches by route for one radius-1 stencil on the
    mesh raster `split`: in place, each tile on the route its plan names
    and its two bands on TMA (their rows padded to 16 bytes); else one
    launch a block on TMA, on the extended blocks."""
    from xrspatial_torch.kernels.surface import surface_plan
    from xrspatial_torch.parallel.halo import HaloSpec, inplace_fits, tiles
    t = tiles(split)
    want = {"tma": 0, "async": 0, "simple": 0}
    if not inplace_fits(t, HaloSpec(1, 1)):
        want["tma"] = mesh.size
        return want
    for row in t.blocks:
        for b in row:
            want[surface_plan(*b.shape, b.data_ptr()).route] += 1
            want["tma"] += 2
    return want


def mesh_pipeline(label, shape, mesh, dev, card, rows):
    """terrain_pipeline on `mesh` against the unsharded call: in place,
    a surface and a focal launch on each tile and on each of its two
    bands, each on its staged route (``mesh_routes``)."""
    import torch
    from xrspatial_torch import terrain_pipeline
    whole, split = mesh_dem(shape, dev, mesh)

    def call(a):
        with fused_pipeline(False):
            return terrain_pipeline(a, surface=PIPELINE_SURFACE,
                                    stats_funcs=PIPELINE_STATS)
    ref, one_ms, one_gib = timed_run(lambda: call(whole), MESH_REPS)
    routes = mesh_routes(split.data, mesh)
    n = sum(routes.values())
    reset_launches()
    first = call(split)
    torch.cuda.synchronize()
    launches = read_launches()
    surf, focal = surface_route_launches(), tiled_route_launches()
    want = {k: n if k in ("surface_kernel", "focal_kernel") else 0
            for k in launches}
    if launches != want or surf != routes or focal != routes:
        raise SmokeFailure(f"mesh {label}: expected {n} surface and {n} "
                           f"focal launches, by route {routes}, got "
                           f"{launches}, surface {surf}, focal {focal}")
    for p in PIPELINE_SURFACE:
        mesh_checked(f"{label} {p}", first[f"dem-{p}"].data,
                     ref[f"dem-{p}"].data, mesh)
    mesh_checked(f"{label} focal_stats", first["focal_stats"].data,
                 ref["focal_stats"].data, mesh)
    shapes = [b.shape for row in first["focal_stats"].data.blocks
              for b in row]
    del first, ref
    torch.cuda.empty_cache()
    ms, gib = mesh_timed(lambda: call(split), mesh)
    tiles = sorted({tuple(t[-2:]) for t in shapes})
    routes = {k: v for k, v in routes.items() if v}
    print(f"  {label}: terrain_pipeline on a {mesh_name(mesh)}: "
          f"{ms:.3f} ms warm, peak "
          f"{gib:.2f} GiB; unsharded {one_ms:.3f} ms, peak {one_gib:.2f} GiB; "
          f"tiles {tiles}, B1/B2 on {routes}, equal bit for bit; {card}")
    rows[label] = {"op": "terrain_pipeline", "shape": list(shape),
                   "mesh": mesh_name(mesh), "ms": ms,
                   "unsharded_ms": one_ms, "peak_gib": gib,
                   "unsharded_peak_gib": one_gib,
                   "launches": {k: v for k, v in launches.items() if v},
                   "card": card}
    del whole, split
    torch.cuda.empty_cache()


def mesh_jfa_want(shape, mesh):
    """B6's launches by route on `mesh`: one a block for each stride up to
    256, on the route round_plan names for the extended block."""
    from xrspatial_torch.kernels.jfa import _stride_schedule
    from xrspatial_torch.kernels.jfa_plan import round_plan
    from xrspatial_torch.parallel.halo import tile_size
    from xrspatial_torch.parallel.jfa_sharded import SMALL_STRIDE_MAX
    ty = tile_size(shape[0], mesh.shape["y"])
    tx = tile_size(shape[1], mesh.shape["x"])
    want = {"staged": 0, "vector": 0, "simple": 0}
    small = [int(k) for k in _stride_schedule(max(shape))
             if k <= SMALL_STRIDE_MAX]
    for k in small:
        plan = round_plan(ty + 2 * k, -(-(tx + 2 * k) // 4) * 4, k, "packed",
                          False)
        want[plan.route] += mesh.size
    return want, len(_stride_schedule(max(shape))) - len(small)


def mesh_proximity(n, mesh, dev, card, rows):
    """proximity on the mesh against the unsharded call."""
    import torch
    import xrspatial_torch as xt
    from xrspatial_torch.kernels import cuda_jfa
    whole, split = mesh_dem((n, n), dev, mesh)
    whole.data = (whole.data > 900).to(torch.float32)
    split.data = split.data.map_blocks(lambda b: (b > 900).to(torch.float32))
    ref, one_ms, one_gib = timed_run(lambda: xt.proximity(whole), MESH_REPS)
    reset_launches()
    first = xt.proximity(split)
    torch.cuda.synchronize()
    launches, by_route = read_launches(), jfa_route_launches()
    want, torch_rounds = mesh_jfa_want((n, n), mesh)
    if launches != {k: cuda_jfa.LAUNCHES if k == "jfa_round" else 0
                    for k in launches} or by_route != want:
        raise SmokeFailure(f"mesh proximity {n}: launches {launches}, by "
                           f"route {by_route}, expected {want}")
    mesh_checked(f"proximity {n}", first.data, ref.data, mesh)
    del first, ref
    torch.cuda.empty_cache()
    ms, gib = mesh_timed(lambda: xt.proximity(split), mesh)
    print(f"  proximity {n}^2 on a {mesh_name(mesh)}: {ms:.3f} ms warm, peak "
          f"{gib:.2f} GiB; unsharded {one_ms:.3f} ms, peak {one_gib:.2f} "
          f"GiB; B6 launches by route {by_route} (4 a stride <= 256, each "
          f"with its block's origin) and {torch_rounds} torch-op rounds "
          f"above 256, equal bit for bit; {card}")
    rows[f"proximity_{n}"] = {
        "op": "proximity", "shape": [n, n], "mesh": mesh_name(mesh), "ms": ms,
        "unsharded_ms": one_ms, "peak_gib": gib, "unsharded_peak_gib":
            one_gib, "jfa_round_by_route": by_route,
        "torch_op_rounds": torch_rounds, "card": card}
    del whole, split
    torch.cuda.empty_cache()


def mesh_manhattan(n, mesh, dev, card, rows):
    """MANHATTAN allocation on the mesh: the scan transform, its scans
    carried from tile to tile (torch ops, no kernel)."""
    import torch
    import xrspatial_torch as xt
    whole, split = mesh_dem((n, n), dev, mesh)
    whole.data = torch.where(whole.data > 900, whole.data, 0.0)
    split.data = split.data.map_blocks(
        lambda b: torch.where(b > 900, b, 0.0))

    def call(a):
        return xt.allocation(a, distance_metric="MANHATTAN")
    ref, one_ms, one_gib = timed_run(lambda: call(whole), MESH_REPS)
    reset_launches()
    first = call(split)
    torch.cuda.synchronize()
    if any(read_launches().values()):
        raise SmokeFailure(f"mesh MANHATTAN launched a kernel: "
                           f"{read_launches()}")
    mesh_checked(f"MANHATTAN allocation {n}", first.data, ref.data, mesh)
    del first, ref
    torch.cuda.empty_cache()
    ms, gib = mesh_timed(lambda: call(split), mesh)
    print(f"  MANHATTAN allocation {n}^2 on a {mesh_name(mesh)}: {ms:.3f} ms "
          f"warm, "
          f"peak {gib:.2f} GiB; unsharded {one_ms:.3f} ms, peak "
          f"{one_gib:.2f} GiB; the scans carried across tiles, equal bit "
          f"for bit; {card}")
    rows[f"manhattan_{n}"] = {
        "op": "allocation MANHATTAN", "shape": [n, n], "mesh": mesh_name(mesh),
        "ms": ms, "unsharded_ms": one_ms, "peak_gib": gib,
        "unsharded_peak_gib": one_gib, "card": card}
    del whole, split
    torch.cuda.empty_cache()


def mesh_annulus(mesh, dev, card, rows):
    """focal_stats over the 512-offset annulus: one halo launch a block,
    and one on each of its two bands where the tiles hold the radius 40
    four times over (in place)."""
    import torch
    from xrspatial_torch.focal import focal_stats
    from xrspatial_torch.parallel.halo import HaloSpec, inplace_fits, tiles
    whole, split = mesh_dem((MESH_N, MESH_N), dev, mesh)
    kern = halo_footprints()["annulus_40_38"]
    ref, one_ms, one_gib = timed_run(
        lambda: focal_stats(whole, kern, stats_funcs=list(PIPELINE_STATS)),
        MESH_REPS)
    n = mesh.size * (3 if inplace_fits(tiles(split.data), HaloSpec(40, 40))
                     else 1)
    reset_launches()
    first = focal_stats(split, kern, stats_funcs=list(PIPELINE_STATS))
    torch.cuda.synchronize()
    launches = read_launches()
    want = {k: n if k in ("focal_halo_kernel", "focal_halo_tma")
            else 0 for k in launches}
    if launches != want:
        raise SmokeFailure(f"mesh annulus: expected {n} halo launches on "
                           f"TMA, got {launches}")
    mesh_checked("annulus focal_stats", first.data, ref.data, mesh)
    del first, ref
    torch.cuda.empty_cache()
    ms, gib = mesh_timed(
        lambda: focal_stats(split, kern, stats_funcs=list(PIPELINE_STATS)),
        mesh)
    print(f"  annulus focal_stats {MESH_N}^2 on a {mesh_name(mesh)}: "
          f"{ms:.3f} ms "
          f"warm, peak {gib:.2f} GiB; unsharded {one_ms:.3f} ms, peak "
          f"{one_gib:.2f} GiB; {n} B5 launches on TMA, equal bit for bit; "
          f"{card}")
    rows["annulus"] = {"op": "focal_stats annulus 40/38", "shape":
                       [MESH_N, MESH_N], "mesh": mesh_name(mesh), "ms": ms,
                       "unsharded_ms": one_ms, "peak_gib": gib,
                       "unsharded_peak_gib": one_gib, "card": card}
    del whole, split
    torch.cuda.empty_cache()


def mesh_quantile(mesh, dev, card, rows):
    """quantile on the mesh: per-block sorts, counts summed, no gather."""
    import torch
    import xrspatial_torch as xt
    whole, split = mesh_dem((MESH_N, MESH_N), dev, mesh)
    ref, one_ms, one_gib = timed_run(
        lambda: xt.quantile(whole, k=MESH_QUANTILE_K), MESH_REPS)
    reset_launches()
    first = xt.quantile(split, k=MESH_QUANTILE_K)
    torch.cuda.synchronize()
    if any(read_launches().values()):
        raise SmokeFailure(f"mesh quantile launched a kernel: "
                           f"{read_launches()}")
    mesh_checked("quantile", first.data, ref.data, mesh)
    del first, ref
    torch.cuda.empty_cache()
    ms, gib = mesh_timed(lambda: xt.quantile(split, k=MESH_QUANTILE_K), mesh)
    print(f"  quantile(k={MESH_QUANTILE_K}) {MESH_N}^2 on a "
          f"{mesh_name(mesh)}: "
          f"{ms:.3f} ms warm, peak {gib:.2f} GiB; unsharded {one_ms:.3f} ms, "
          f"peak {one_gib:.2f} GiB; equal bit for bit; {card}")
    rows["quantile"] = {"op": f"quantile k={MESH_QUANTILE_K}", "shape":
                        [MESH_N, MESH_N], "mesh": mesh_name(mesh), "ms": ms,
                        "unsharded_ms": one_ms, "peak_gib": gib,
                        "unsharded_peak_gib": one_gib, "card": card}
    del whole, split
    torch.cuda.empty_cache()


def mesh_paths(dev, card):
    """Phase 27: A13, the mesh branches on a mesh of one card."""
    import torch
    from xrspatial_torch.parallel import make_raster_mesh
    t_phase = time.perf_counter()
    print(f"== A13: the mesh branches on 2x2 and 1x4 meshes of one card "
          f"({card}); the times measure the halo machinery's overhead "
          f"beside the unsharded call, not scaling")
    rows = {}
    mesh = make_raster_mesh(2, 2, devices=[dev] * 4)
    mesh_pipeline("pipeline_2x2", (MESH_N, MESH_N), mesh, dev, card, rows)
    for n in MESH_PROX_NS:
        mesh_proximity(n, mesh, dev, card, rows)
    mesh_manhattan(MESH_PROX_NS[-1], mesh, dev, card, rows)
    mesh_annulus(mesh, dev, card, rows)
    mesh_quantile(mesh, dev, card, rows)
    mesh_pipeline("pipeline_uneven_2x2", MESH_UNEVEN, mesh, dev, card, rows)
    mesh_pipeline("pipeline_1x4", (MESH_N, MESH_N),
                  make_raster_mesh(1, 4, devices=[dev] * 4), dev, card, rows)
    cards = torch.cuda.device_count()
    if cards > 1:
        # every visible card, square-ish: the halo strips are peer copies
        many, sub = make_raster_mesh(), {}
        mesh_pipeline("pipeline", (MESH_N, MESH_N), many, dev, card, sub)
        mesh_proximity(MESH_PROX_NS[-1], many, dev, card, sub)
        mesh_manhattan(MESH_PROX_NS[-1], many, dev, card, sub)
        mesh_annulus(many, dev, card, sub)
        mesh_quantile(many, dev, card, sub)
        rows["distinct_cards"] = sub
    else:
        print("  the mesh of distinct cards was not run: one card visible")
        rows["distinct_cards"] = "not run: one card visible"
    print(f"  phase 27: {time.perf_counter() - t_phase:.1f} s, {card}")
    print(json.dumps({"a13_mesh_paths": rows}))


# -- phase 28: A13b, the XDraw viewshed on a mesh and the GSPMD ops --------

A13B_N = N                  # the mesh viewshed's and the ops' raster edge
STRIP_N = 4096              # the strip route against its twin on the card
# (mesh, viewpoint, step window L): on a 2x2 mesh, strips of 1024 lanes
# narrower than L, the viewpoint on the first lane of the second row strip
# and of the third column strip (the twin takes ~14 s a case on the card)
STRIP_CASES = (((2, 2), (1024, 2048), 2048),)
XDRAW_STRIP_STEPS = (64, 256, 1024, 4096)   # the step windows L swept
A13B_HOST_N = 4096          # the host functions' edge (maximum_breaks,
#                             zonal_apply) and natural_breaks', as phase
#                             23's
A13B_GEO_N = 3600           # one SRTM tile less a row and a column, so
#                             that 2x2 splits it; the unsharded geodesic
#                             fit at 16384^2 would need ~300 GB
A13B_REGIONS_N = 4096       # regions' rings cross every block
A13B_POLY_N = 512           # polygonize and combine run in host numpy:
A13B_COMBINE_N = 1024       # ~5 s a call at 1024^2 and 2048^2
A13B_REPS = 2
A13B_BREAK_RTOL = 1e-6
A13B_SUM_RTOL = 1e-12


def strip_halo_reads(h, w, vp, parts, steps):
    """Slope cells the strip route reads beyond the cone's: each strip's
    halo lanes' cone cells, once a strip (the halo is recomputed, not
    exchanged)."""
    from xrspatial_torch.kernels.viewshed import strip_halos
    total = 0
    for n, vp_lane, major, vp_major in ((h, vp[0], w, vp[1]),
                                        (w, vp[1], h, vp[0])):
        s = -(-n // parts)
        for p, (lo, hi) in enumerate(strip_halos(n, parts, vp_lane, steps)):
            lanes = list(range(p * s - lo, p * s)) + list(
                range(p * s + s, p * s + s + hi))
            for lane in lanes:
                d = max(abs(lane - vp_lane), 1)
                # forward and reverse: steps with k - vpm >= d
                total += max(0, major - 1 - vp_major - d + 1)
                total += max(0, vp_major - d + 1)
    return total


def check_strip_route(dev, card):
    """The strip route (kernel) against the strip twin, both on the card,
    at STRIP_N^2: a 2x2 mesh whose strips are narrower than L, the
    viewpoint on strips' edge lanes.  Returns (twin ms, kernel ms) of the
    first case, each one call."""
    import torch
    from xrspatial_torch.kernels import cuda_xdraw, viewshed as kv
    from xrspatial_torch.parallel import distribute, make_raster_mesh
    n = STRIP_N
    dem = gaussian_bump(n, n, dev)
    times = None
    for (ny, nx), vp, steps in STRIP_CASES:
        mesh = make_raster_mesh(ny, nx, devices=[dev] * (ny * nx))
        slope = kv._xdraw_fields(dem, *vp, XDRAW_VIEW[2], 0.0, 1.0, -1.0)[3]
        split = distribute(slope, mesh)
        reset_launches()
        got, k_ms, _ = timed_run(
            lambda: kv.xdraw_mesh_max_slope(split, *vp, steps=steps), 0)
        launched = {k: v for k, v in read_launches().items() if v}
        plan = kv.xdraw_strip_plan(n, n, *vp, mesh.size, steps=steps)
        if set(launched) != {"xdraw_strip"}:
            raise SmokeFailure(f"strip route at {n}^2: launches {launched}")
        real = kv._strip_on_card
        kv._strip_on_card = lambda t: False      # the twin, on the card
        try:
            ref, t_ms, _ = timed_run(
                lambda: kv.xdraw_mesh_max_slope(split, *vp, steps=steps), 0)
        finally:
            kv._strip_on_card = real
        if cuda_xdraw.XDRAW_STRIP_LAUNCHES != launched["xdraw_strip"] \
                or not mesh_blocks_equal(got, ref.gather()):
            raise SmokeFailure(f"strip route at {n}^2 on {ny}x{nx}, vp {vp},"
                               f" L {plan.steps}: differs from its twin")
        if not same_bits(got.gather(), cuda_xdraw.xdraw_scan_cuda(slope,
                                                                   *vp)):
            raise SmokeFailure(f"strip route at {n}^2 on {ny}x{nx}: differs "
                               f"from the unsharded X1")
        s = -(-n // mesh.size)
        print(f"  strip route at {n}^2 on a {ny}x{nx} mesh of one card, "
              f"viewpoint {vp}, L {plan.steps} (strips of {s} lanes), bands "
              f"of {plan.band}, chunks of {plan.chunk}: "
              f"{launched['xdraw_strip']} launches, equal to the strip twin "
              f"and to the unsharded X1 bit for bit; kernel {k_ms:.3f} ms, "
              f"twin {t_ms:.1f} ms (one call each), {card}")
        if times is None:
            times = (t_ms, k_ms)
        del got, ref, split, slope
    del dem
    torch.cuda.empty_cache()
    return times


def mesh_viewshed(n, mesh, dev, card, rows, ref=None):
    """viewshed(exact=False) at n^2 on `mesh` against the unsharded call,
    bit for bit; only strip launches and one launch each of X3 and X4 a
    block inside the mesh call.  Returns (the unsharded result, the mesh
    call's strip launches)."""
    import torch
    import xrspatial_torch as xt
    x, y, oe = XDRAW_VIEW
    whole, split = mesh_dem((n, n), dev, mesh)
    kw = dict(x=x, y=y, observer_elev=oe, exact=False)
    one_ms = one_gib = None
    if ref is None:
        ref, one_ms, one_gib = timed_run(lambda: xt.viewshed(whole, **kw).data,
                                         A13B_REPS)
    reset_launches()
    out = xt.viewshed(split, **kw)
    torch.cuda.synchronize()
    launched = {k: v for k, v in read_launches().items() if v}
    if set(launched) != {"xdraw_strip", "xdraw_fields", "xdraw_epilogue"} \
            or launched["xdraw_fields"] != mesh.size \
            or launched["xdraw_epilogue"] != mesh.size:
        raise SmokeFailure(f"mesh viewshed at {n}^2: launches {launched} (no "
                           f"X1 single-card launch allowed, one X3 and one "
                           f"X4 a block)")
    mesh_checked(f"viewshed {n}", out.data, ref, mesh)
    del out
    torch.cuda.empty_cache()
    ms, gib = mesh_timed(lambda: xt.viewshed(split, **kw), mesh)
    label = f"viewshed_{mesh.shape['y']}x{mesh.shape['x']}"
    print(f"  viewshed(exact=False) {n}^2 on a {mesh_name(mesh)}: {ms:.3f} ms "
          f"warm, peak {gib:.2f} GiB"
          + (f"; unsharded {one_ms:.3f} ms, peak {one_gib:.2f} GiB"
             if one_ms is not None else "")
          + f"; {launched['xdraw_strip']} strip launches, 0 X1, "
          f"{mesh.size} each of X3 and X4, equal bit for bit; {card}")
    rows[label] = {"op": "viewshed exact=False", "shape": [n, n],
                   "mesh": mesh_name(mesh), "ms": ms, "peak_gib": gib,
                   "unsharded_ms": one_ms, "unsharded_peak_gib": one_gib,
                   "strip_launches": launched["xdraw_strip"],
                   "x1_launches": 0,
                   "cell_launches": launched["xdraw_fields"], "card": card}
    del split, whole
    torch.cuda.empty_cache()
    return ref, launched["xdraw_strip"]


def strip_sweep(n, mesh, dev, card):
    """xdraw_mesh_max_slope at n^2 on `mesh` for each step window of
    XDRAW_STRIP_STEPS, in turns (forward, then backward), each equal to
    the plan's bit for bit.  Returns ({L: [ms, ms]}, the plan's L ms,
    (bytes, operations) of the function, the halo lanes' cone reads at
    the plan's L)."""
    import torch
    from xrspatial_torch.kernels import viewshed as kv
    from xrspatial_torch.parallel import distribute
    vp = (n - 1 - int(XDRAW_VIEW[1]), int(XDRAW_VIEW[0]))
    slope = kv._xdraw_fields(gaussian_bump(n, n, dev), *vp, XDRAW_VIEW[2],
                             0.0, 1.0, -1.0)[3]
    split = distribute(slope, mesh)
    del slope
    ref = kv.xdraw_mesh_max_slope(split, *vp)
    plan = kv.xdraw_strip_plan(n, n, *vp, mesh.size)
    sweep = {}
    order = sorted(set(XDRAW_STRIP_STEPS) | {plan.steps})
    for steps in order + order[::-1]:
        got, ms, _ = timed_run(
            lambda: kv.xdraw_mesh_max_slope(split, *vp, steps=steps), 1)
        if not all(same_bits(a, b) for ra, rb in zip(got.blocks, ref.blocks)
                   for a, b in zip(ra, rb)):
            raise SmokeFailure(f"strip route at L {steps}: differs from the "
                               f"plan's L")
        sweep.setdefault(steps, []).append(ms)
        del got
    print(f"  strip route at {n}^2 on a {mesh_name(mesh)} by step window L "
          f"(windows x strips launches), in turns: " + "; ".join(
              f"L {k} ({-(-n // k) * mesh.size}) "
              + ", ".join(f"{v:.3f}" for v in vs) + " ms"
              for k, vs in sweep.items())
          + f"; the plan takes L {plan.steps}, bands of {plan.band}, chunks "
          f"of {plan.chunk}; {card}")
    # the bound counts what the function needs, X1's: each cone cell read
    # once, the field written once; the halo lanes' reads are the design's
    # overhead, reported beside it
    cone = xdraw_cone_reads(n, n, *vp)
    halo = strip_halo_reads(n, n, vp, mesh.size, plan.steps)
    work = (4 * (cone + n * n), XDRAW_OPS * cone)
    del split, ref
    torch.cuda.empty_cache()
    return sweep, sum(sweep[plan.steps]) / len(sweep[plan.steps]), work, \
        halo


def a13b_ops(n, mesh, dev, card, rows):
    """Every op the JAX package leaves to GSPMD, on `mesh` against the
    unsharded call: elementwise, extremes, counts, labels and stencils bit
    for bit; zonal_stats' float sums within rtol 1e-12; std_mean's and
    head_tail_breaks' breaks within rtol 1e-6 (classes equal off them);
    no kernel launched; results on the mesh (trim and crop: a window on
    the first block's card; the host functions warn)."""
    import torch
    import xrspatial_torch as xt
    from xrspatial_torch import classify, local, multispectral
    from xrspatial_torch.experimental.polygonize import polygonize
    from xrspatial_torch.parallel import distribute
    g = torch.Generator(device=dev).manual_seed(28)

    def pair(t, coords=None):
        """(unsharded, split) DataArrays of tensor `t`."""
        h, w = t.shape[-2:]
        coords = coords or {"y": np.arange(h, dtype=float)[::-1].copy(),
                            "x": np.arange(w, dtype=float)}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            s = distribute(t, mesh)
        return (xt.DataArray(t, dims=("y", "x"), coords=coords),
                xt.DataArray(s, dims=("y", "x"), coords=coords))

    cards = sorted({d.index or 0 for row in mesh.devices for d in row})

    def synced(out):
        """`out` once every card of the mesh finished (an event times one
        card's stream)."""
        for c in cards:
            torch.cuda.synchronize(c)
        return out

    def leg(label, call, args_whole, args_split, check, edge, host=False):
        ref, one_ms, one_gib = timed_run(lambda: call(*args_whole), 0)
        reset_launches()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always", UserWarning)
            got, ms, gib = timed_run(lambda: synced(call(*args_split)), 0)
        launched = {k: v for k, v in read_launches().items() if v}
        if launched:
            raise SmokeFailure(f"{label} on the mesh launched {launched}")
        gathers = any("HOST" in str(w.message) for w in caught)
        if gathers != host:
            raise SmokeFailure(f"{label} on the mesh: gathered to the host "
                               f"{gathers}, expected {host}")
        note = check(got, ref)
        print(f"  {label} {edge}^2 on a {mesh_name(mesh)}: {ms:.1f} ms, peak "
              f"{gib:.2f} GiB; unsharded {one_ms:.1f} ms, peak "
              f"{one_gib:.2f} GiB; {note}; {card}")
        rows[label] = {"op": label, "shape": [edge, edge],
                       "mesh": mesh_name(mesh), "ms": ms, "peak_gib": gib,
                       "unsharded_ms": one_ms, "unsharded_peak_gib": one_gib,
                       "check": note, "card": card}
        del got, ref
        torch.cuda.empty_cache()

    def same(got, ref):
        data = got.data if isinstance(got, xt.DataArray) else got
        r = ref.data if isinstance(ref, xt.DataArray) else ref
        if isinstance(data, torch.Tensor):
            if not same_bits(data, r):
                raise SmokeFailure("differs from the unsharded call")
            return "one tensor, equal bit for bit"
        mesh_checked("op", data, r, mesh)
        return "equal bit for bit"

    def frame(got, ref):
        for col in ref.columns:
            a, b = got[col].to_numpy(float), ref[col].to_numpy(float)
            tol = A13B_SUM_RTOL if col in ("sum", "mean", "var", "std") \
                else 0.0
            if not np.allclose(a, b, rtol=tol, atol=0.0, equal_nan=True):
                raise SmokeFailure(f"column {col} differs")
        return "counts, min, max, majority equal, sums within rtol 1e-12"

    dem = gaussian_bump(n, n, dev)
    band2 = torch.rand((n, n), generator=g, device=dev) * 4000.0
    whole, split = pair(dem)
    b_whole, b_split = pair(band2)
    leg("ndvi", xt.ndvi, (whole, b_whole), (split, b_split), same, n)
    rgb = [pair(dem), pair(band2), pair(dem.flip(0))]
    leg("true_color", lambda *a: multispectral.true_color(*a).data,
        [p[0] for p in rgb], [p[1] for p in rgb],
        lambda got, ref: (mesh_checked("true_color", got, ref, mesh)
                          or "equal bit for bit, (y, x, band) blocks"), n)
    del rgb
    ds_whole = xt.Dataset({"a": whole, "b": b_whole,
                           "c": pair(dem.t().contiguous())[0],
                           "ref": pair(torch.floor(band2 / 1000.0))[0]})
    ds_split = xt.Dataset({"a": split, "b": b_split,
                           "c": pair(dem.t().contiguous())[1],
                           "ref": pair(torch.floor(band2 / 1000.0))[1]})
    for label, call in (
            ("cell_stats median", lambda d: local.cell_stats(
                d, ["a", "b", "c"], func="median")),
            ("cell_stats std", lambda d: local.cell_stats(
                d, ["a", "b", "c"], func="std")),
            ("lesser_frequency", lambda d: local.lesser_frequency(d, "ref")),
            ("highest_position", lambda d: local.highest_position(
                d, ["a", "b", "c"])),
            ("popularity", lambda d: local.popularity(d, "ref")),
            ("rank", lambda d: local.rank(d, "ref"))):
        leg(label, call, (ds_whole,), (ds_split,), same, n)
    del ds_whole, ds_split
    for label, call in (
            ("binary", lambda a: xt.binary(a, [100.0, 500.0])),
            ("reclassify", lambda a: xt.reclassify(a, [200.0, 600.0, 1e4],
                                                   [1.0, 2.0, 3.0])),
            ("equal_interval", lambda a: xt.equal_interval(a)),
            ("std_mean", xt.std_mean),
            ("head_tail_breaks", xt.head_tail_breaks)):
        check = same
        if label in ("std_mean", "head_tail_breaks"):
            def check(got, ref, call=call):
                return breaks_check(got, ref, call, whole, split, mesh)
        leg(label, call, (whole,), (split,), check, n)
    zones_t = torch.floor(dem / 100.0).to(torch.int32)
    z_whole, z_split = pair(zones_t)
    stats = ["mean", "max", "min", "sum", "std", "var", "count", "majority"]
    leg("zonal_stats", lambda z, v: xt.zonal_stats(z, v, stats_funcs=stats),
        (z_whole, whole), (z_split, split), frame, n)
    cats_whole, cats_split = pair(torch.floor(band2 / 500.0))
    leg("zonal_crosstab", xt.zonal_crosstab, (z_whole, cats_whole),
        (z_split, cats_split),
        lambda got, ref: frame(got, ref) and "counts equal", n)
    del cats_whole, cats_split
    leg("trim", lambda a: xt.trim(a, values=(0.0,)),
        (pair(torch.where(dem > 900, dem, 0.0))[0],),
        (pair(torch.where(dem > 900, dem, 0.0))[1],), same, n)
    leg("crop", lambda z, v: xt.crop(z, v, [9]), (z_whole, whole),
        (z_split, split), same, n)
    leg("hillshade shadows", lambda a: xt.hillshade(
        a, azimuth=SHADOW_SUN[0], angle_altitude=SHADOW_SUN[1],
        shadows=True), (whole,), (split,), same, n)
    del whole, split, b_whole, b_split, z_whole, z_split, zones_t, band2, dem
    torch.cuda.empty_cache()

    # the ones that do not fit 16384^2 or that run on the host
    r = A13B_REGIONS_N
    z_whole, z_split = pair(torch.floor(gaussian_bump(r, r, dev) / 100.0))
    leg("regions", xt.regions, (z_whole,), (z_split,), same, r)
    hn = A13B_HOST_N
    h_whole, h_split = pair(torch.round(gaussian_bump(hn, hn, dev)))
    leg("maximum_breaks", xt.maximum_breaks, (h_whole,), (h_split,), same, hn,
        host=True)
    # the fixed-seed shuffle of every cell's index takes ~25 s on the host
    # at 16384^2, in both calls alike
    leg("natural_breaks", xt.natural_breaks, (h_whole,), (h_split,), same,
        hn)
    hz_whole, hz_split = pair(torch.floor(h_whole.data / 100.0).to(
        torch.int32))

    def applied(z, v):
        xt.zonal_apply(z, v, lambda a: a * 2.0)
        return v.data
    leg("zonal_apply", applied, (hz_whole, pair(h_whole.data.clone())[0]),
        (hz_split, pair(h_whole.data.clone())[1]), same, hn, host=True)
    pn = A13B_POLY_N
    p_whole, p_split = pair(torch.floor(gaussian_bump(pn, pn, dev)
                                        / POLY_CLASS_M))

    def poly_check(got, ref):
        if got[0] != ref[0] or len(got[1]) != len(ref[1]) or any(
                not np.array_equal(a, b) for pa, pb in zip(got[1], ref[1])
                for a, b in zip(pa, pb)):
            raise SmokeFailure("polygonize differs from the unsharded call")
        return f"{len(ref[0])} polygons equal"
    leg("polygonize", polygonize, (p_whole,), (p_split,), poly_check, pn,
        host=True)
    cn = A13B_COMBINE_N
    c = gaussian_bump(cn, cn, dev)
    cw = xt.Dataset({"a": pair(torch.floor(c / 200.0))[0],
                     "b": pair(torch.floor(c.t() / 300.0))[0]})
    cs = xt.Dataset({"a": pair(torch.floor(c / 200.0))[1],
                     "b": pair(torch.floor(c.t() / 300.0))[1]})
    leg("combine", lambda d: local.combine(d).data, (cw,), (cs,),
        lambda got, ref: same(got, ref) and "ids equal", cn, host=True)
    gn = A13B_GEO_N
    lat = GEO_LAT + 1.0 - np.arange(gn) / 3600.0
    lon = GEO_LON + np.arange(gn) / 3600.0
    g_whole, g_split = pair(gaussian_bump(gn, gn, dev),
                            {"y": lat, "x": lon})
    leg("geodesic slope", lambda a: xt.slope(a, method="geodesic"),
        (g_whole,), (g_split,), same, gn)
    del g_whole, g_split
    torch.cuda.empty_cache()


def breaks_check(got, ref, call, whole, split, mesh):
    """std_mean / head_tail_breaks: the breaks within rtol 1e-6 of the
    unsharded call's, the classes equal at every cell farther than that
    from a break."""
    import torch
    from xrspatial_torch import classify
    seen = []
    real = classify._bin

    def spy(data, bins, new_values):
        seen.append(np.asarray(bins, dtype=np.float64))
        return real(data, bins, new_values)
    classify._bin = spy
    try:
        call(whole)
        call(split)
    finally:
        classify._bin = real
    ref_bins, bins = seen[0], seen[1]
    if ref_bins.shape != bins.shape or not np.allclose(
            bins, ref_bins, rtol=A13B_BREAK_RTOL, atol=0.0):
        raise SmokeFailure(f"breaks {bins} differ from {ref_bins}")
    data = whole.data
    near = torch.zeros(data.shape, dtype=torch.bool, device=data.device)
    for b in ref_bins:
        near |= (data - b).abs() <= A13B_BREAK_RTOL * abs(b)
    far = ~near
    g = got.data.gather(data.device)
    r = ref.data
    if not same_bits(torch.where(far, g, 0.0), torch.where(far, r, 0.0)):
        raise SmokeFailure("classes differ away from the breaks")
    return (f"breaks within rtol {A13B_BREAK_RTOL} (largest "
            f"{float(np.max(np.abs(bins - ref_bins) / np.abs(ref_bins))):.2e})"
            f", classes equal off {int(near.sum())} near-break cells")


def a13b_paths(dev, card):
    """Phase 28: A13b on the card.  Returns the strip route's kernels-line
    numbers: (launches in the 2x2 mesh viewshed, plan-L ms at A13B_N^2,
    twin ms at STRIP_N^2, (bytes, ops) at A13B_N^2, kernel ms at
    STRIP_N^2, the halo lanes' cone reads at A13B_N^2)."""
    import torch
    from xrspatial_torch.parallel import make_raster_mesh
    t_phase = time.perf_counter()
    print(f"== A13b: X1's strip route, the XDraw viewshed on 2x2 and 1x4 "
          f"meshes of one card, the GSPMD ops, {card}")
    twin_ms, strip_kernel_ms = check_strip_route(dev, card)
    rows = {}
    two = make_raster_mesh(2, 2, devices=[dev] * 4)
    ref, launches = mesh_viewshed(A13B_N, two, dev, card, rows)
    mesh_viewshed(A13B_N, make_raster_mesh(1, 4, devices=[dev] * 4), dev,
                  card, rows, ref)
    sweep, strip_ms, work, halo = strip_sweep(A13B_N, two, dev, card)
    rows["strip_sweep_ms"] = {str(k): v for k, v in sweep.items()}
    rows["strip_halo_reads"] = halo
    a13b_ops(A13B_N, two, dev, card, rows)
    cards = torch.cuda.device_count()
    if cards > 1:
        many, sub = make_raster_mesh(), {}
        ref_many, _ = mesh_viewshed(A13B_N, many, dev, card, sub, ref)
        del ref_many
        a13b_ops(A13B_N, many, dev, card, sub)
        sub["peak_gib_by_card"] = [torch.cuda.max_memory_allocated(c) / 2**30
                                   for c in range(cards)]
        rows["distinct_cards"] = sub
    else:
        print("  the mesh of distinct cards was not run: one card visible")
        rows["distinct_cards"] = "not run: one card visible"
    del ref
    torch.cuda.empty_cache()
    print(f"  phase 28: {time.perf_counter() - t_phase:.1f} s, {card}")
    print(json.dumps({"a13b_mesh_paths": rows}))
    return launches, strip_ms, twin_ms, work, strip_kernel_ms, halo


# -- the least time of each kernel ------------------------------------------

HBM_BYTES_S = 3.35e12      # H100 SXM device memory rate
F32_FLOP_S = 67e12         # H100 SXM float32 outside the tensor cores
F64_FLOP_S = 34e12         # H100 SXM float64 outside the tensor cores
# float operations per cell, counted from the CUDA sources: the main
# path's slope + hillshade (surface_cell.cuh: 2 x 7 for the Sobel sums, 10
# for slope, 17 for hillshade); all four products add 9 for aspect and 13
# for curvature; per footprint offset 5 in the first focal pass and 4 in
# the second, 9 in the epilogue (focal_cell.cuh); per candidate of a
# jump-flood round 8 (two conversions, four products, a sum and the
# comparison; jfa.cu), 9 candidates a round; one add per value of the
# stream add (stream.cu)
SURFACE_OPS = 41
SURFACE_ALL_OPS = 63
FOCAL_OPS_PER_OFFSET, FOCAL_OPS = 9, 9
JFA_OPS_PER_CANDIDATE, JFA_CANDIDATES = 8, 9
# per screen pair: the 6 float comparisons of the cover and key tests; per
# pair that passes one, 11 more (the subtract, the sign test, the product
# and sum, the clip, each band and its max; screen.cu).  The culled route
# makes the 3 of the wide cover and kt_hi on each pair it evaluates, and
# the narrow cover's 3 and the 11 on each that passes
SCREEN_OPS, SCREEN_OPS_COVERED = 6, 11
SCREEN_WIDE_OPS, SCREEN_NARROW_OPS = 3, 3
# slope alone (surface_cell.cuh, stencil_probe.cu): 2 x 7 for the Sobel
# sums, 10 for slope; a fused jump-flood group: 8 per candidate, 8
# candidates a round
SLOPE_OPS = 24
# the staged separable slope (stencil_probe.cu, quad<kSepSlope>): per 4
# cells 6 smooths (a product and 2 sums) and 6 differences, then per cell
# 1 for sx and 3 for sy, 10 for slope: (6 * 4 + 4 * 14) / 4
SEP_STAGED_OPS = 20
GROUP_OPS_PER_ROUND = 8 * 8


def bound(nbytes, ops, bytes_s=HBM_BYTES_S, flop_s=F32_FLOP_S):
    """(least ms, "bytes" or "operations") for work of `nbytes` bytes and
    `ops` operations on an H100 SXM moving `bytes_s` bytes and doing
    `flop_s` operations (float32 unless given) a second."""
    t_bytes = nbytes / bytes_s * 1e3
    t_ops = ops / flop_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def screen_plan_work(screen_counts):
    """(bytes, float operations) of the screen on the plan's every pair,
    the work of its first port and of the twin."""
    pairs, covered, _, nbytes, _ = screen_counts
    return nbytes, SCREEN_OPS * pairs + SCREEN_OPS_COVERED * covered


def kernel_work(n_offsets_main, n_offsets_annulus, screen_counts):
    """(bytes, float operations) of each kernel at the work its timing
    measured; for the screen, the work its culled route does on this run's
    data: the pairs of the (warp, chunk) pairs it keeps."""
    from xrspatial_torch.kernels.stencil_probe import staged_interior_extent
    cells = N * N
    plane = 4 * cells                      # one float32 or int32 plane
    focal = FOCAL_OPS_PER_OFFSET * n_offsets_main + FOCAL_OPS
    _, covered, evaluated, screen_nbytes, prepass_nbytes = screen_counts
    r0, r1, c0, c1 = staged_interior_extent(N, N, PROBE_TILE)
    return {
        # 1 read, slope and hillshade written
        "surface_kernel": (3 * plane, SURFACE_OPS * cells),
        # 1 read, 4 stats written
        "focal_kernel": (5 * plane, focal * cells),
        # 1 read, 2 products and 4 stats written
        "pipeline_kernel": (7 * plane, (SURFACE_OPS + focal) * cells),
        "focal_halo_kernel": (
            5 * plane,
            (FOCAL_OPS_PER_OFFSET * n_offsets_annulus + FOCAL_OPS) * cells),
        # 16 rounds, each reading its state and writing the next; the last
        # also writes the best key
        "jfa_round": (
            ROUNDS_AT_N * 2 * plane + plane,
            ROUNDS_AT_N * JFA_CANDIDATES * JFA_OPS_PER_CANDIDATE * cells),
        "screen_hilo": (screen_nbytes + prepass_nbytes,
                        SCREEN_WIDE_OPS * evaluated
                        + (SCREEN_NARROW_OPS + SCREEN_OPS_COVERED) * covered),
        # 1 read, all four products written
        "surface_stacked_kernel": (5 * plane, SURFACE_ALL_OPS * cells),
        "stream_copy": (2 * plane, 0),
        "stream_add": (3 * plane, cells),
        # each stencil probe reads the plane and writes it; copy computes
        # nothing
        "stencil_probe_b8c": (2 * plane, 0),
        "stencil_probe_b8d": (2 * plane, SEP_STAGED_OPS * cells),
        "stencil_probe_b8e": (2 * plane, SLOPE_OPS * cells),
        # bare writes the interior walk's cells and reads them with their
        # halo
        "stencil_probe_b8f": (4 * ((r1 - r0 + 2) * (c1 - c0 + 2)
                                   + (r1 - r0) * (c1 - c0)),
                              SLOPE_OPS * (r1 - r0) * (c1 - c0)),
        # the tail group reads the state once and writes it once
        "jfa_group": (2 * plane, len(GROUP_TAIL) * GROUP_OPS_PER_ROUND
                      * cells),
    }


def kernel_bounds(work, roof_bytes_s):
    """Each kernel's bound at the nominal rate and at the measured stream
    roof: {name: ((ms, by), (ms, by))}.  A work entry is (bytes,
    operations), or (bytes, operations, operations a second) where they
    are not float32."""
    out = {}
    for k, (b, ops, *rate) in work.items():
        flop_s = rate[0] if rate else F32_FLOP_S
        out[k] = (bound(b, ops, flop_s=flop_s),
                  bound(b, ops, roof_bytes_s, flop_s))
    return out


def jfa_design():
    """The routes round_plan gives proximity's N^2 schedule."""
    from xrspatial_torch.kernels.jfa import _stride_schedule
    from xrspatial_torch.kernels.jfa_plan import round_plan
    parts = []
    for k in _stride_schedule(N):
        p = round_plan(N, N, int(k), "packed", False)
        name = p.route + (f" ({p.stage})" if p.stage else "") + \
            (" k-phase" if p.phased else "")
        if parts and parts[-1][0] == name:
            parts[-1][1].append(int(k))
        else:
            parts.append((name, [int(k)]))
    return "per-stride plan: " + "; ".join(
        f"{name} at k={','.join(map(str, ks))}" for name, ks in parts) + (
        "; on a mesh (phase 27) one launch a block for each stride up to "
        "256, on the block extended by a k-wide halo, the block's origin "
        "passed so that the packed keys see global indices")


def group_design():
    from xrspatial_torch.kernels.jfa_group import (SINGLE_THREADS, TAIL,
                                                   window_plan)
    p = window_plan(TAIL, "packed", w=N)
    return (f"{p.route}-buffered window staged by {p.stage}, T={p.tile}, "
            f"{SINGLE_THREADS} threads, flat regions")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card and has no CPU mode", file=sys.stderr)
        return 1

    from xrspatial_torch import DataArray, terrain_pipeline
    from xrspatial_torch.convolution import circle_kernel
    from xrspatial_torch.kernels import _cuda, cuda_surface, cuda_window
    from xrspatial_torch.kernels.focal_halo import halo_plan, register_class
    from xrspatial_torch.kernels.pipeline import pipeline_plan
    from xrspatial_torch.kernels.surface import (PRODUCTS,
                                                 SURFACE_BLOCKS_PER_SM,
                                                 SURFACE_TILE, surface_multi,
                                                 surface_plan)
    from xrspatial_torch.kernels.window import kernel_offsets, window_stats

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip()
    print(f"== device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{kind}, {torch.cuda.device_count()} visible")
    print(card)

    # -- build -------------------------------------------------------------
    t0 = time.perf_counter()
    path, log = _cuda.build()
    _cuda.library()
    print(f"== build: {time.perf_counter() - t0:.1f} s -> {path.name}")
    for line in log.splitlines():
        if any(k in line for k in ("registers", "spill", "Compiling entry")):
            print("  ptxas:", line.strip().removeprefix("ptxas info    : "))

    # -- kernels against their twins, small and ragged shapes ---------------
    print("== kernels vs twins on the card")
    kernels = {"r1": circle_kernel(1, 1, 1.5), "r2": circle_kernel(1, 1, 2.5)}
    for k, shape in enumerate(SMALL_SHAPES):
        host = test_raster(shape, seed=100 + k)
        x = torch.from_numpy(host).to(dev)
        got = cuda_surface.surface_cuda(x, PRODUCTS, 2.0, 3.0, 225.0, 25.0)
        ref = surface_multi(x, 2.0, 3.0, 225.0, 25.0, PRODUCTS)
        for p, g in zip(PRODUCTS, got):
            # aspect jumps from 0 to 360 at angle 90: compared circularly
            check(f"surface {shape} {p}", g, ref[p], SURFACE_TOL,
                  circular=360.0 if p == "aspect" else None)
        host[shape[0] // 2, shape[1] // 2] = np.inf
        host[0, shape[1] - 1] = -np.inf
        x = torch.from_numpy(host).to(dev)
        for kname, kern in kernels.items():
            offsets = kernel_offsets(kern)
            got = cuda_window.focal_stats_cuda(x, offsets, ALL_STATS)
            ref = window_stats(x, offsets, ALL_STATS)
            for i, s in enumerate(ALL_STATS):
                check(f"focal {shape} {kname} {s}", got[i], ref[s], FOCAL_TOL)
            if not same_bits(got, cuda_window.focal_stats_cuda(
                    x, offsets, ALL_STATS, route="simple")):
                raise SmokeFailure(f"focal {shape} {kname}: the staged route "
                                   f"differs from the first port")
        torch.cuda.synchronize()
    print(f"  focal_kernel's staged route equal to its first port bit for "
          f"bit at every shape; launches by route {tiled_route_launches()}")
    surface_small_err = check_surface_routes(dev)

    # -- the main path -------------------------------------------------------
    print(f"== main path: terrain_pipeline on a {N}x{N} float32 DEM")
    dem = gaussian_bump(N, N, dev)
    agg = DataArray(dem, dims=("y", "x"), name="dem",
                    attrs={"res": (1.0, 1.0)})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with fused_pipeline(False):
        ds = terrain_pipeline(agg, surface=PIPELINE_SURFACE,
                              stats_funcs=PIPELINE_STATS)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    every = read_launches()
    launches = {"surface_kernel": cuda_surface.LAUNCHES,
                "focal_kernel": cuda_window.LAUNCHES}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"  first call {first_s * 1e3:.1f} ms (host clock), launches "
          f"{launches}, surface_kernel by route {surface_route_launches()}, "
          f"focal_kernel by route {tiled_route_launches()}, peak "
          f"allocated {peak_gib:.2f} GiB")
    on_tma = {"tma": 1, "async": 0, "simple": 0}
    if every != {k: int(k in ("surface_kernel", "focal_kernel"))
                 for k in every} or tiled_route_launches() != on_tma \
            or surface_route_launches() != on_tma:
        raise SmokeFailure(f"expected one launch of each kernel, each on "
                           f"its staged TMA route, got {every}, surface "
                           f"{surface_route_launches()}, focal "
                           f"{tiled_route_launches()}")

    slope = ds["dem-slope"].data
    hill = ds["dem-hillshade"].data
    fs = ds["focal_stats"].data
    for label, t, shape in (("slope", slope, (N, N)),
                            ("hillshade", hill, (N, N)),
                            ("focal_stats", fs, (len(PIPELINE_STATS), N, N))):
        if t.device.type != "cuda" or tuple(t.shape) != shape:
            raise SmokeFailure(f"{label}: {tuple(t.shape)} on {t.device}, "
                               f"expected {shape} on cuda")
    ring = torch.ones((N, N), dtype=torch.bool, device=dev)
    ring[1:-1, 1:-1] = False
    for label, t in (("slope", slope), ("hillshade", hill)):
        if not torch.equal(torch.isnan(t), ring):
            raise SmokeFailure(f"{label}: NaN cells are not exactly the "
                               f"1-cell ring")
    if not bool(torch.isfinite(fs).all()):
        raise SmokeFailure("focal_stats: non-finite values on a finite DEM")
    inner = (slope[1:-1, 1:-1], hill[1:-1, 1:-1])
    if not (bool((inner[0] >= 0).all()) and bool((inner[0] < 90).all())
            and bool((inner[1] >= 0).all()) and bool((inner[1] <= 1).all())):
        raise SmokeFailure("slope or hillshade outside its range")
    mean, smax, smin, std = fs
    if not (bool((smin <= mean + 1e-3).all())
            and bool((mean <= smax + 1e-3).all())
            and bool((std >= 0).all())):
        raise SmokeFailure("focal stats out of order (min <= mean <= max, "
                           "std >= 0)")
    del inner, mean, smax, smin, std, ring

    print("  full-size agreement with the twins")
    max_err = {}
    ref = surface_multi(dem, 1.0, 1.0, 225.0, 25.0, PIPELINE_SURFACE)
    max_err["surface_kernel"] = max(
        surface_small_err,
        *(check(f"surface {p}", ds[f"dem-{p}"].data, ref[p], SURFACE_TOL)
          for p in PIPELINE_SURFACE))
    del ref
    offsets = kernel_offsets(circle_kernel(1, 1, 1.5))
    ref = window_stats(dem, offsets, PIPELINE_STATS)
    max_err["focal_kernel"] = max(
        check(f"focal {s}", fs[i], ref[s], FOCAL_TOL)
        for i, s in enumerate(PIPELINE_STATS))
    del ref, ds, slope, hill, fs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # -- timing (informational) ---------------------------------------------
    print(f"== timing at {N}x{N} on {card}")

    def pipeline():
        with fused_pipeline(False):
            terrain_pipeline(agg, surface=PIPELINE_SURFACE,
                             stats_funcs=PIPELINE_STATS)

    pipe_ms = cuda_time_ms(pipeline, 10)
    print(f"  terrain_pipeline warm: {pipe_ms:.3f} ms "
          f"({N * N / 1e3 / pipe_ms:.1f} Mpix/s), {card}")
    ms = {}
    ms["surface_kernel"] = paired_ms(
        lambda: cuda_surface.surface_cuda(dem, PIPELINE_SURFACE),
        lambda: surface_multi(dem, 1.0, 1.0, 225.0, 25.0, PIPELINE_SURFACE),
        20, 5)
    ms["focal_kernel"] = paired_ms(
        lambda: cuda_window.focal_stats_cuda(dem, offsets, PIPELINE_STATS),
        lambda: window_stats(dem, offsets, PIPELINE_STATS), 20, 5)
    for k, (kern_ms, plain_ms) in ms.items():
        print(f"  {k}: kernel {kern_ms:.3f} ms, twin {plain_ms:.3f} ms, "
              f"{card}")
    first_port_ms = {"focal_kernel": tiled_focal_path(dem, card),
                     "surface_kernel": surface_tiles_path(dem, card)}
    print(f"  peak allocated by the main-path call: {peak_gib:.2f} GiB, "
          f"{card}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # -- the proximity family ------------------------------------------------
    check_jfa_rounds(dev)
    launches["jfa_round"], max_err["jfa_round"], ms["jfa_round"], \
        jfa_timing = proximity_path(dem, dev, card)

    # -- the halo and pipeline kernels, the fused and annulus paths ----------
    halo_small_err = check_halo_and_pipeline(dev)
    launches["pipeline_kernel"], max_err["pipeline_kernel"], \
        ms["pipeline_kernel"], first_port_ms["pipeline_kernel"] = fused_path(
            dem, agg, card)
    launches["focal_halo_kernel"], max_err["focal_halo_kernel"], \
        ms["focal_halo_kernel"] = annulus_path(dem, agg, card)
    max_err["focal_halo_kernel"] = max(max_err["focal_halo_kernel"],
                                       halo_small_err)
    torch_op_paths(dev, card)

    # -- the exact viewshed ----------------------------------------------------
    screen_err = check_screen(dev)
    launches["screen_hilo"], _, vs_out = viewshed_path(dev)
    ms["screen_hilo"], screen_timing, *screen_counts = viewshed_timing(
        dev, card, vs_out)
    max_err["screen_hilo"] = screen_err
    del vs_out

    # -- the surface family ---------------------------------------------------
    stacked_err = check_stacked(dev)
    (launches["surface_stacked_kernel"], max_err["surface_stacked_kernel"],
     ms["surface_stacked_kernel"], first_port_ms["surface_stacked_kernel"],
     stacked) = surface_family_path(dem, card)
    max_err["surface_stacked_kernel"] = max(
        max_err["surface_stacked_kernel"], stacked_err)
    del dem, agg
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    check_stream(dev)
    probes, stream_launches = stream_path(card)
    library_ms = {}
    for k, probe in (("stream_copy", "copy"), ("stream_add", "add")):
        row = probes[probe]
        launches[k] = stream_launches[k]
        max_err[k] = 0.0                   # equal to the twin bit for bit
        ms[k] = (row["kernel"]["ms"], row["twin"]["ms"])
        library_ms[k] = row["library"]["ms"]
    geodesic_path(dev, card)
    shadows_path(dev, card)

    # -- the stencil probes and the fused jump-flood group --------------------
    probe_errs = check_stencil_probes(dev)
    check_jfa_group(dev)
    for k, (n, err, row_ms, lib, first) in stencil_probes_path(
            probes["roof_gb_s"], card).items():
        launches[k], ms[k] = n, row_ms
        max_err[k] = max(err, probe_errs[k])
        library_ms[k] = lib
        if first is not None:
            first_port_ms[k] = first
    launches["jfa_group"], ms["jfa_group"], group_times = jfa_group_path(
        dev, card)
    max_err["jfa_group"] = 0.0             # equal to the rounds bit for bit

    # -- the A5/A6 paths: torch ops, no kernel ----------------------------------
    a5_a6_paths(dev, card, probes["roof_gb_s"] * 1e9)

    # -- A7 and A11: zonal (torch ops), the XDraw viewshed (X1) -----------------
    zonal_path(dev, card)
    (launches["xdraw_scan"], x1_ms, x1_twin_ms, x1_work,
     first_port_ms["xdraw_scan"], x1_chain_ms, x_cells) = xdraw_path(dev,
                                                                     card)
    for k, (n_k, ms_k, _) in x_cells.items():
        launches[k], ms[k] = n_k, ms_k
        max_err[k] = 0.0                   # equal to the torch passes' bits
    ms["xdraw_scan"] = (x1_ms, x1_twin_ms)
    max_err["xdraw_scan"] = 0.0            # equal to the twin bit for bit

    # -- A9 and A12: synthesis (X2), the host modules ---------------------------
    x2 = a9_a12_paths(dev, card)
    launches["bump_scan"] = x2["launches"]
    ms["bump_scan"] = (x2["ms"], x2["twin_ms"])
    first_port_ms["bump_scan"] = x2["first_port_ms"]
    x2_work = x2["work"]
    max_err["bump_scan"] = 0.0             # equal to the twin bit for bit

    # -- A13: the mesh branches on one card -------------------------------------
    mesh_paths(dev, card)

    # -- A13b: X1's strip route, the XDraw viewshed and the ops on a mesh -------
    (launches["xdraw_strip"], strip_ms, strip_twin_ms, strip_work,
     strip_4096_ms, strip_halo) = a13b_paths(dev, card)
    ms["xdraw_strip"] = (strip_ms, strip_twin_ms)
    max_err["xdraw_strip"] = 0.0           # equal to the twin bit for bit

    work = kernel_work(
        len(offsets), len(kernel_offsets(halo_footprints()["annulus_40_38"])),
        screen_counts)
    work["xdraw_scan"] = x1_work
    work.update((k, w_k) for k, (_, _, w_k) in x_cells.items())
    work["bump_scan"] = (*x2_work, F64_FLOP_S)
    work["xdraw_strip"] = strip_work
    roof = probes["roof_gb_s"] * 1e9
    bounds = kernel_bounds(work, roof)
    print(f"== bounds: nominal {HBM_BYTES_S / 1e12:.2f} TB/s, measured stream "
          f"roof {roof / 1e12:.4f} TB/s ({roof / HBM_BYTES_S * 100:.1f}%), "
          f"{card}")
    for k, ((b_ms, b_by), (r_ms, r_by)) in bounds.items():
        print(f"  {k}: {work[k][0] / 1e9:.3f} GB, kernel {ms[k][0]:.3f} ms; "
              f"bound {b_ms:.3f} ms ({b_by}, {b_ms / ms[k][0] * 100:.1f}% "
              f"of it), at the measured roof {r_ms:.3f} ms ({r_by}, "
              f"{r_ms / ms[k][0] * 100:.1f}%)")
    plan_ms, plan_by = bound(*screen_plan_work(screen_counts))
    print(f"  screen_hilo on the plan's every pair (the first port's work): "
          f"bound {plan_ms:.3f} ms ({plan_by}, "
          f"{plan_ms / ms['screen_hilo'][0] * 100:.1f}% of the culled route's "
          f"time)")
    sources = {"surface_kernel": (
        "xrspatial_torch/csrc/surface.cu",
        "xrspatial_tpu/kernels/pallas_surface2.py:178"),
        "focal_kernel": (
        "xrspatial_torch/csrc/focal.cu",
        "xrspatial_tpu/kernels/pallas_window2.py:160"),
        "jfa_round": (
        "xrspatial_torch/csrc/jfa.cu",
        "xrspatial_tpu/kernels/pallas_jfa.py:194"),
        "focal_halo_kernel": (
        "xrspatial_torch/csrc/focal_halo.cu",
        "xrspatial_tpu/kernels/pallas_window.py:110"),
        "pipeline_kernel": (
        "xrspatial_torch/csrc/focal_halo.cu",
        "xrspatial_tpu/kernels/pallas_pipeline.py:82"),
        "screen_hilo": (
        "xrspatial_torch/csrc/screen.cu",
        "xrspatial_tpu/kernels/pallas_screen.py:99"),
        "surface_stacked_kernel": (
        "xrspatial_torch/csrc/surface.cu",
        "xrspatial_tpu/kernels/pallas_surface.py:200"),
        "stream_copy": (
        "xrspatial_torch/csrc/stream.cu",
        "tools/measure_stream.py:42"),
        "stream_add": (
        "xrspatial_torch/csrc/stream.cu",
        "tools/measure_stream.py:59"),
        "stencil_probe_b8c": (
        "xrspatial_torch/csrc/stencil_probe.cu",
        "tools/exp_stencil2.py:56"),
        "stencil_probe_b8d": (
        "xrspatial_torch/csrc/stencil_probe.cu",
        "tools/exp_separable_horn.py:54"),
        "stencil_probe_b8e": (
        "xrspatial_torch/csrc/stencil_probe.cu",
        "tools/exp_padfree_stencil.py:42"),
        "stencil_probe_b8f": (
        "xrspatial_torch/csrc/stencil_probe.cu",
        "tools/exp_seam_cost.py:34"),
        "jfa_group": (
        "xrspatial_torch/csrc/jfa_group.cu",
        "tools/exp_jfa_fixed.py:38"),
        # no Pallas kernel: the JAX package's XLA scan
        "xdraw_scan": (
        "xrspatial_torch/csrc/xdraw.cu",
        "xrspatial_tpu/kernels/viewshed.py:771"),
        # no Pallas kernel: XLA's elementwise passes around the scan
        "xdraw_fields": (
        "xrspatial_torch/csrc/xdraw_cells.cu",
        "xrspatial_tpu/kernels/viewshed.py:836"),
        "xdraw_epilogue": (
        "xrspatial_torch/csrc/xdraw_cells.cu",
        "xrspatial_tpu/kernels/viewshed.py:926"),
        # no Pallas kernel: the JAX package's lax.scan over the bumps
        "bump_scan": (
        "xrspatial_torch/csrc/bump.cu",
        "xrspatial_tpu/bump.py:25"),
        # no Pallas kernel: the scan of the JAX package's banded
        # distributed XDraw, a lax.scan inside shard_map
        "xdraw_strip": (
        "xrspatial_torch/csrc/xdraw.cu",
        "xrspatial_tpu/kernels/viewshed.py:998")}
    # the design each redesigned kernel's timed launch ran
    halo = halo_plan(N, N, kernel_offsets(halo_footprints()["annulus_40_38"]),
                     0)
    tiled = halo_plan(N, N, offsets, 0)
    surf = surface_plan(N, N, 0)
    fused = pipeline_plan(N, N, offsets, 0)
    designs = {
        "surface_kernel": f"staged window ring by {surf.route}, tile "
                          f"{SURFACE_TILE[0]}x{SURFACE_TILE[1]}, "
                          f"{surf.stages} stages, persistent blocks "
                          f"({SURFACE_BLOCKS_PER_SM} an SM), 4 cells a "
                          f"thread, 16-byte stores",
        "pipeline_kernel": f"B2's staged window by {fused.route} with a "
                           f"surface epilogue, tile {fused.tile[0]}x"
                           f"{fused.tile[1]}, 2 x 4 cells a thread, 16-byte "
                           f"stores, {register_class(fused)} blocks an SM",
        "focal_halo_kernel": f"staged window by {halo.route}, tile "
                             f"{halo.tile[0]}x{halo.tile[1]}, row runs, 4 "
                             f"cells a thread, {register_class(halo)} blocks "
                             f"an SM",
        "focal_kernel": f"staged template: window by {tiled.route}, tile "
                        f"{tiled.tile[0]}x{tiled.tile[1]}, 4 cells a "
                        f"thread, 16-byte stores, {register_class(tiled)} "
                        f"blocks an SM",
        "screen_hilo": f"culled: {screen_timing['culled_share']:.4f} of "
                       f"(warp, chunk) pairs culled, 4 targets a thread, "
                       f"chunks by bulk copy",
        "stream_copy": "bulk-async ring",
        "stream_add": "one-shot grid, 4 float4 pairs a thread, streaming",
        "stencil_probe_b8c": "staged window by TMA, 32x248",
        "stencil_probe_b8d": "separable arithmetic (6 column smooths and "
                             "differences a quad) on the staged window by "
                             "TMA, 64x128, 16-byte stores",
        "stencil_probe_b8e": "staged window ring by TMA on the interior "
                             "walk (windows inside the raster, last tiles "
                             "pulled back), 64x128, no bounds test, 16-byte "
                             "stores; the edge bands by a second launch",
        "stencil_probe_b8f": "bare: the staged interior walk alone by TMA, "
                             "64x128, the cells outside [1, h-1) x [4, w-4) "
                             "unwritten",
        "surface_stacked_kernel": f"B1's staged window ring by "
                                  f"{stacked.route}, tile {stacked.tile[0]}x"
                                  f"{stacked.tile[1]}, {stacked.stages} "
                                  f"stages, persistent blocks, 4 products as "
                                  f"planes of one buffer, 16-byte stores "
                                  f"(where TMA refuses: the phased route, "
                                  f"16-byte row-body copies, 32-byte-aligned "
                                  f"plane spans)",
        "jfa_round": jfa_design(),
        "jfa_group": group_design(),
        "xdraw_scan": "banded: 4 half-planes x bands of lanes, one block a "
                      "band, one lane a thread, K-step chunks with a K-lane "
                      "halo toward the viewpoint, carries handed on at "
                      "chunk ends through per-chunk slots and flags, slope "
                      "tiles staged by cp.async, coalesced row writes, one "
                      "cooperative launch (plan in the a11_xdraw line); "
                      "first_port_ms with its transpose",
        "xdraw_fields": "X3: 4 cells of a row a thread, each cell's "
                        "geometry in registers from its (row, col), 16-byte "
                        "loads and streaming stores; plain_ms the torch "
                        "passes of _xdraw_fields, in turns",
        "xdraw_epilogue": "X4: 4 cells of a row a thread, X1's field read "
                          "as two 6-cell row windows (own row and one step "
                          "toward the viewpoint) from L1 and L2, the angle "
                          "skipped on hidden cells, 16-byte streaming "
                          "stores; plain_ms the torch passes of "
                          "_xdraw_epilogue, in turns",
        "xdraw_strip": "X1's strip route on a 2x2 mesh of one card: "
                       "strips of lanes over the flattened mesh (east and "
                       "west on rows, south and north on columns), one "
                       "cooperative launch a strip a window of L steps "
                       "(the banded kernel's bands, chunks and slots from a "
                       "carry-in row), L halo lanes toward the viewpoint, "
                       "halo carries copied between windows; ms at "
                       f"{A13B_N}^2 (layouts and exchanges included), "
                       f"plain_ms the strip twin on the card at {STRIP_N}^2 "
                       f"(one call; the kernel {strip_4096_ms:.3f} ms "
                       "there), the bound X1's (each cone cell read once, "
                       "the field written once), halo_reads the halo "
                       "lanes' redundant cone reads, the design's "
                       "overhead, outside the bound",
        "bump_scan": "rounds: claim (64-bit atomicMax of round << 32 | "
                     "~index), test and apply, pack, while a round makes at "
                     "least 12 bumps ready, then one block walks the rest "
                     "in order; one cooperative launch; ms, plain_ms, "
                     "first_port_ms and the bound on the first 262,144 of "
                     "bump(4096, 4096)'s 1,677,721 bumps (all_bumps_* on "
                     "all of them)"}
    # the first ports, kept by name, timed in turns with the redesigns
    first_port_ms.update(jfa_round=jfa_timing["simple_ms"],
                         jfa_group=group_times["double"],
                         screen_hilo=screen_timing["simple_ms"])
    # Tensor.copy_ and torch.add compute the stream probes' functions and
    # the copy mode of B8c's; no single PyTorch call computes any of the
    # others
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "design": designs.get(k, "first port"),
         "card": card,
         "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": max_err[k],
         "ms": ms[k][0], "plain_ms": ms[k][1], "bound_ms": bounds[k][0][0],
         "bound_by": bounds[k][0][1], "library_ms": library_ms.get(k),
         "measured_roof_bound_ms": bounds[k][1][0],
         "measured_roof_share": bounds[k][1][0] / ms[k][0],
         **({"first_port_ms": first_port_ms[k]} if k in first_port_ms
            else {}),
         **({"plan_bound_ms": plan_ms, "plan_bound_by": plan_by}
            if k == "screen_hilo" else {}),
         **({"chain_bound_ms": x1_chain_ms} if k == "xdraw_scan" else {}),
         **({"halo_reads": strip_halo} if k == "xdraw_strip" else {}),
         **({"all_bumps_ms": x2["rows"]["all_bumps_spread1"]["ms"],
             "all_bumps_first_port_ms":
                 x2["rows"]["all_bumps_spread1"]["first_port_ms"]}
            if k == "bump_scan" else {})}
        for k, (src, rep) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
