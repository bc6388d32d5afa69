"""Kernel builders.

Counterpart of ``xrspatial_tpu/convolution.py``: distance-string parsing,
cellsize-in-meters and the circle/annulus/custom kernel builders are host
code and return the same numpy arrays as the JAX package.  The direct
convolution (``convolve_2d``, ``convolution_2d``) is a cuDNN / CPU
cross-correlation in full float32 (``kernels/window.py::convolve2d``), as
the JAX package leaves it to XLA; on a mesh, over the tiles
(``run_stencil``).
"""

from __future__ import annotations

import re

import numpy as np

from .kernels.dispatch import run_stencil
from .kernels.window import convolve2d
from .utils import get_dataarray_resolution, raster_payload, wrap_like

__all__ = [
    "convolve_2d", "convolution_2d", "circle_kernel", "annulus_kernel",
    "custom_kernel", "calc_cellsize",
]

DEFAULT_UNIT = 'meter'
METER = 1
FOOT = 0.3048
KILOMETER = 1000
MILE = 1609.344
UNITS = {'meter': METER, 'meters': METER, 'm': METER,
         'feet': FOOT, 'foot': FOOT, 'ft': FOOT,
         'miles': MILE, 'mls': MILE, 'ml': MILE,
         'kilometer': KILOMETER, 'kilometers': KILOMETER, 'km': KILOMETER}


def _is_numeric(s) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def _to_meters(d, unit):
    return d * UNITS[unit]


def _get_distance(distance_str: str) -> float:
    """Parse '5', '5 km', '3.2 miles', ... into meters."""
    splits = [x for x in re.split(r'(-?\d*\.?\d+)', distance_str) if x != '']
    if len(splits) not in (1, 2):
        raise ValueError("Invalid distance.")
    unit = splits[1] if len(splits) == 2 else DEFAULT_UNIT
    number = splits[0]
    if not _is_numeric(number):
        raise ValueError("Distance should be a positive numeric value.\n")
    distance = float(number)
    if distance <= 0:
        raise ValueError("Distance should be a positive.\n")
    unit = unit.lower().replace(' ', '')
    if unit not in UNITS:
        raise ValueError(
            "Distance unit should be one of the following: \n"
            "meter (meter, meters, m),\n"
            "kilometer (kilometer, kilometers, km),\n"
            "foot (foot, feet, ft),\n"
            "mile (mile, miles, ml, mls)")
    return _to_meters(distance, unit)


def calc_cellsize(raster) -> tuple:
    """Cell size of a raster in meters, honoring a ``unit`` attr."""
    unit = raster.attrs.get('unit', DEFAULT_UNIT)
    cellsize_x, cellsize_y = get_dataarray_resolution(raster)
    return _to_meters(cellsize_x, unit), np.abs(_to_meters(cellsize_y, unit))


def _ellipse_kernel(half_w: int, half_h: int) -> np.ndarray:
    x = np.linspace(-half_w, half_w, 2 * half_w + 1)
    y = np.linspace(-half_h, half_h, 2 * half_h + 1)[:, None]
    # (x/a)^2 + (y/b)^2 <= 1, cross-multiplied to avoid rounding
    ellipse = (x * half_h) ** 2 + (y * half_w) ** 2 <= (half_w * half_h) ** 2
    return ellipse.astype(float)


def circle_kernel(cellsize_x, cellsize_y, radius) -> np.ndarray:
    """Circular 0/1 kernel with the given cell sizes and radius
    (radius accepts distance strings, e.g. '2 km')."""
    r = _get_distance(str(radius))
    return _ellipse_kernel(int(r / cellsize_x), int(r / cellsize_y))


def annulus_kernel(cellsize_x, cellsize_y, outer_radius,
                   inner_radius) -> np.ndarray:
    """Ring-shaped 0/1 kernel between inner and outer radii."""
    kernel_outer = circle_kernel(cellsize_x, cellsize_y, outer_radius)
    kernel_inner = circle_kernel(cellsize_x, cellsize_y, inner_radius)
    pad = np.array(kernel_outer.shape) - np.array(kernel_inner.shape)
    padded_inner = np.pad(kernel_inner,
                          pad_width=((pad[0] // 2, pad[0] // 2),
                                     (pad[1] // 2, pad[1] // 2)),
                          mode='constant', constant_values=0)
    return kernel_outer - padded_inner


def custom_kernel(kernel) -> np.ndarray:
    """Validate a custom kernel (numpy array, odd dimensions)."""
    if not isinstance(kernel, np.ndarray):
        raise ValueError(
            "Received a custom kernel that is not a Numpy array.",
            "The kernel received was of type {} and needs to be "
            "of type `ndarray`".format(type(kernel)))
    rows, cols = kernel.shape
    if rows % 2 == 0 or cols % 2 == 0:
        raise ValueError(
            "Received custom kernel with improper dimensions.",
            "A custom kernel needs to have an odd shape, the supplied kernel "
            "has {} rows and {} columns.".format(rows, cols))
    return kernel


def convolve_2d(data, kernel):
    """Raw array-in/array-out 2D convolution (NaN ring of kernel radius).

    `data` is a tensor (any device) or an array; the result is a float32
    tensor on `data`'s device.  A raster split over a mesh runs on each
    tile with the kernel's halo (``kernels/dispatch.py::run_stencil``: in
    place with the tile's ring from bands, or on the extended block) and
    gives one split over the same mesh.
    """
    kernel = np.asarray(kernel)
    radius = ((kernel.shape[0] - 1) // 2, (kernel.shape[1] - 1) // 2)
    return run_stencil(convolve2d, radius, raster_payload(data), kernel)


def convolution_2d(agg, kernel, name='convolution_2d'):
    """2D convolution of each inner cell; edges are NaN-filled.

    Parameters
    ----------
    agg : DataArray
        2D input raster.
    kernel : array-like
        Impulse kernel (weights applied un-flipped, i.e. correlation,
        matching the reference kernels).
    """
    kernel = custom_kernel(np.asarray(kernel))
    out = convolve_2d(raster_payload(agg), kernel)
    return wrap_like(agg, out, name)
