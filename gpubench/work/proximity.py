"""Bytes and float operations of one ``proximity`` job, and the least
work of the jump flood's rounds.

The op's own work, whatever computes it: the raster read once and the
distances written once (float32, 8 bytes a cell); per cell a comparison
a target value and the distance to its nearest target (two differences,
two squares, a sum and a root).

``rounds(cells)`` is what any nearest-target transform must move: the
seed state (the targets' int32 indices) read once, the nearest target's
state and its float32 key written once, 12 bytes a cell; and the key
(two differences, two squares, a sum) a cell.
"""

DISTANCE_OPS = 6
KEY_OPS = 5


def work(shape, args) -> tuple:
    """(bytes, operations) of one job on a raster of `shape`."""
    cells = int(shape[0]) * int(shape[1])
    compares = max(1, len(args.get("target_values", [])))
    return 8 * cells, (compares + DISTANCE_OPS) * cells


def rounds(cells: int) -> tuple:
    """(bytes, operations) that the rounds of `cells` cells must do."""
    return 12 * int(cells), KEY_OPS * int(cells)
