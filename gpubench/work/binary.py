"""Bytes and float operations of one ``classify.binary`` job: the raster
read once and the classes written once (float32, 8 bytes a cell); per
cell a comparison a value and the finite test."""


def work(shape, args) -> tuple:
    """(bytes, operations) of one job on a raster of `shape`."""
    cells = int(shape[0]) * int(shape[1])
    return 8 * cells, (len(args.get("values", [])) + 1) * cells
