"""Bytes and float operations of one ``terrain_pipeline`` job.

The op's own work, whatever computes it: the DEM read once and each
output plane written once (float32), and per cell the operations of the
cell formulas (counted from the CUDA sources' cell code): 2 x 7 for the
Sobel sums that every surface product shares, 10 for slope, 17 for
hillshade, 9 for aspect, 13 for curvature; for the four focal statistics
(mean, max, min, std) 9 per footprint cell (5 in the first pass, 4 in
the second) and 9 in the epilogue.  Halo copies, extended blocks and
data read twice fall outside it.
"""

import torch

SOBEL_OPS = 14
PRODUCT_OPS = {"slope": 10, "hillshade": 17, "aspect": 9, "curvature": 13}
STATS = {"mean", "max", "min", "std"}
FOCAL_OPS_PER_CELL, FOCAL_EPILOGUE_OPS = 9, 9


def work(shape, args) -> tuple:
    """(bytes, operations) of one job on a raster of `shape`, with the
    reference's arguments `args` (its footprint as a 0/1 array)."""
    cells = int(shape[0]) * int(shape[1])
    products = list(args.get("surface", ("slope", "hillshade")))
    stats = list(args.get("stats_funcs", sorted(STATS)))
    kernel = args.get("kernel")
    offsets = int((torch.as_tensor(kernel) != 0).sum()) \
        if kernel is not None else 5
    if stats and set(stats) != STATS:
        raise NotImplementedError(f"operations counted for {sorted(STATS)} "
                                  f"together, not {stats}")
    ops = sum(PRODUCT_OPS[p] for p in products)
    ops += SOBEL_OPS if products else 0
    ops += FOCAL_OPS_PER_CELL * offsets + FOCAL_EPILOGUE_OPS if stats else 0
    return 4 * cells * (1 + len(products) + len(stats)), ops * cells
