"""Bytes and float operations of one ``viewshed`` job (XDraw), and the
least work of its scan kernel X1.

The op's own work, whatever computes it: the DEM read once and the
angles written once (float32, 8 bytes a cell), and per cell the
operations of the cell formulas: 11 for the fields (the two offsets
scaled, the distance's squares, sum and root, the cell's and the
target's slope), 8 for the scan's step (the interpolation's two products,
difference and sum, the weight, two maxima and the cone's test) and 12
for the epilogue (the inward interpolation's weight, products and sum,
the visibility test, the height difference and the angle).

``x1(cells)`` is what any scan kernel must move: the slope plane read
once and the field written once, 8 bytes a cell, and the step's 8
operations a cell.
"""

FIELD_OPS, SCAN_OPS, EPILOGUE_OPS = 11, 8, 12


def work(shape, args) -> tuple:
    """(bytes, operations) of one job on a raster of `shape`."""
    cells = int(shape[0]) * int(shape[1])
    return 8 * cells, (FIELD_OPS + SCAN_OPS + EPILOGUE_OPS) * cells


def x1(cells: int) -> tuple:
    """(bytes, operations) that X1's scans of `cells` cells must do."""
    return 8 * int(cells), SCAN_OPS * int(cells)
