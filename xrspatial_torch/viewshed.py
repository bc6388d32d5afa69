"""Viewshed: visible cells from an observer location.

Counterpart of ``xrspatial_tpu/viewshed.py``.  Rasters up to
``_EXACT_MAX_CELLS`` (1024x1024) evaluate the exact GRASS r.viewshed
visibility predicate by angle-sorted bucket evaluation
(``kernels/viewshed_exact.py``, float64 decisions behind a sound interval
screen, equal bit for bit to the pairwise oracle in ``kernels/viewshed.py``).
On a raster on the card the screen's pair evaluation runs in the CUDA
kernel ``csrc/screen.cu``; on a raster on the CPU in its torch twin.
Output: vertical angle in degrees [0, 180] for visible cells (0 = straight
up, 90 = level, 180 = the viewpoint itself), -1 for invisible cells,
float64 on the raster's device.

Larger rasters, and ``exact=False``, take the XDraw octant-scan
approximation (``kernels/viewshed.py::viewshed_grid_los``, float32): on
the card its slope fields, its four half-plane scans and its epilogue are
one launch each of the CUDA kernels of ``csrc/xdraw_cells.cu`` and
``csrc/xdraw.cu``; on the CPU torch ops and the scans' torch twin.

On a raster split over a mesh the exact predicate runs on one device,
with the JAX package's warning (the raster is gathered to its first
block's device).  The XDraw approximation runs on the mesh
(``kernels/viewshed.py::viewshed_grid_los_mesh``, the JAX package's
banded distributed scan): the half-plane scans on strips of lanes over
the flattened mesh, each window of steps one launch of the strip route
of ``csrc/xdraw.cu`` a strip on the card (the strip twin on the CPU),
and the result stays split over the input's mesh.
"""

from __future__ import annotations

import warnings
from typing import Union

import numpy as np

from .kernels.viewshed import viewshed_grid_los, viewshed_grid_los_mesh
from .kernels.viewshed_exact import viewshed_grid_exact
from .parallel.halo import get_raster_mesh
from .tracing import OFF, span
from .utils import to_torch, wrap_like
from .xrlib import DataArray

__all__ = ["viewshed"]

OBS_ELEV = 0
TARGET_ELEV = 0

# above this cell count the JAX package's default switches from the exact
# bucket evaluation to the XDraw approximation; the ceiling decides which
# output the default call returns, so it is kept as it is
_EXACT_MAX_CELLS = 1024 * 1024


def viewshed(raster: DataArray,
             x: Union[int, float],
             y: Union[int, float],
             observer_elev: float = OBS_ELEV,
             target_elev: float = TARGET_ELEV,
             exact: Union[bool, None] = None) -> DataArray:
    """Calculate the viewshed of `raster` for an observer at (x, y).

    Parameters
    ----------
    raster : DataArray
        2D elevation raster with 'x' and 'y' coordinates; its payload may
        be a tensor on the card or on the CPU, or a numpy array, which
        goes to the default device (``default_device()``, the card unless
        ``set_default_device`` says otherwise).
    x, y : observer location in coordinate space (snapped to the nearest
        cell).
    observer_elev : float
        Height of the observer above the terrain.
    target_elev : float
        Height of hypothetical targets above the terrain; a cell is
        visible if a target at that height above it can be seen.
    exact : bool, optional
        ``True`` forces the exact GRASS predicate at any size (float64);
        ``False`` forces the XDraw approximation (float32); ``None``
        (default) takes the exact predicate up to 1024x1024 cells and
        XDraw above.
    """
    height, width = raster.shape
    use_exact = (height * width <= _EXACT_MAX_CELLS
                 if exact is None else bool(exact))
    # the exact predicate keeps its own spans (viewshed_exact.*) as roots
    with _span(not use_exact, "api.viewshed"):
        with _span(not use_exact, "api.args"):
            y_coords = np.asarray(raster['y'].data)
            x_coords = np.asarray(raster['x'].data)

            if not (x_coords.min() <= x <= x_coords.max()):
                raise ValueError("x argument outside of raster x_range")
            if not (y_coords.min() <= y <= y_coords.max()):
                raise ValueError("y argument outside of raster y_range")

            y_view = int(np.argmin(np.abs(y_coords - y)))
            x_view = int(np.argmin(np.abs(x_coords - x)))

            ew_res = (x_coords[-1] - x_coords[0]) / (width - 1)
            ns_res = (y_coords[-1] - y_coords[0]) / (height - 1)
            mesh = get_raster_mesh(raster.data)
        if use_exact:
            if mesh is not None:
                # the exact bucket evaluation is host-orchestrated (no
                # distributed formulation)
                warnings.warn(
                    "viewshed(exact): input is mesh-sharded but the exact "
                    "predicate runs on ONE device (correct, not "
                    "distributed).", UserWarning, stacklevel=2)
                elev = raster.data.gather()
            else:
                elev = to_torch(raster, dtype=None)
            out = viewshed_grid_exact(elev, y_view, x_view, observer_elev,
                                      target_elev, ew_res, ns_res)
        elif mesh is not None:
            out = viewshed_grid_los_mesh(raster.data, y_view, x_view,
                                         observer_elev, target_elev, ew_res,
                                         ns_res)
        else:
            out = viewshed_grid_los(to_torch(raster), y_view, x_view,
                                    observer_elev, target_elev, ew_res,
                                    ns_res)
        with _span(not use_exact, "api.dataset"):
            return wrap_like(raster, out, raster.name)


def _span(on: bool, name: str):
    """Span `name` where `on`, else the no-op context."""
    return span(name) if on else OFF
