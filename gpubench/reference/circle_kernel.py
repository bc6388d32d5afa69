"""Plain reference of ``circle_kernel(cellsize_x, cellsize_y, radius)``.

The footprint of cells within `radius` of the centre: half-widths
``int(radius / cellsize)`` along each axis and the cells of the ellipse
``(x / a)^2 + (y / b)^2 <= 1``, tested cross-multiplied in whole numbers.
`radius` is a number of metres.
"""

import torch


def run(cellsize_x, cellsize_y, radius) -> torch.Tensor:
    a = int(float(radius) / cellsize_x)
    b = int(float(radius) / cellsize_y)
    x = torch.arange(-a, a + 1, dtype=torch.int64)[None, :]
    y = torch.arange(-b, b + 1, dtype=torch.int64)[:, None]
    return (x * b) ** 2 + (y * a) ** 2 <= (a * b) ** 2
