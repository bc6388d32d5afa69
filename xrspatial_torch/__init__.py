"""xrspatial_torch: the PyTorch / CUDA port of xrspatial_tpu.

The same public functions, DataArray-in and DataArray-out, with the same
NaN and border rules.  A raster whose tensor lies on an NVIDIA card runs
through hand-written CUDA kernels (``csrc/``), built with ``nvcc`` at the
first call; a raster on the CPU runs through the plain torch twins.  A
raster given as a numpy array goes to the card, unless
``set_default_device("cpu")`` was called.  The package imports torch and
never jax.

Every public name of ``xrspatial_tpu`` is exported, with its signature.
A raster placed on a device mesh by ``xrspatial_torch.parallel.
distribute`` runs on the mesh in every op: the stencils with halos, the
proximity family per block, the XDraw viewshed on strips of lanes (X1's
strip route), the cell-by-cell ops per block, the reductions and labels
from per-block parts; the functions that compute in host numpy gather it
with a warning, as ``np.asarray`` gathers in the JAX package.
"""

from .analytics import summarize_terrain, terrain_pipeline
from .aspect import aspect
from .bump import bump
from .classify import (binary, box_plot, equal_interval, head_tail_breaks,
                       maximum_breaks, natural_breaks, percentiles, quantile,
                       reclassify, std_mean)
from .curvature import curvature
from .diagnostics import diagnose
from .focal import focal_stats, mean
from .hillshade import hillshade
from .multispectral import arvi, evi, nbr, ndvi, savi, sipi
from .pathfinding import a_star_search
from .perlin import perlin
from .proximity import (DISTANCE_METRICS, allocation, direction,
                        euclidean_distance, great_circle_distance,
                        manhattan_distance, proximity)
from .slope import slope
from .terrain import generate_terrain
from .utils import default_device, set_default_device
from .viewshed import viewshed
from .xrlib import DataArray, Dataset, concat
from .zonal import apply as zonal_apply
from .zonal import crop, regions, suggest_zonal_canvas, trim
from .zonal import crosstab as zonal_crosstab
from .zonal import stats as zonal_stats

__all__ = ["DataArray", "Dataset", "concat", "slope", "aspect", "curvature",
           "hillshade", "focal_stats", "mean", "terrain_pipeline",
           "summarize_terrain", "proximity", "allocation", "direction",
           "euclidean_distance", "manhattan_distance",
           "great_circle_distance", "DISTANCE_METRICS", "viewshed",
           "binary", "box_plot", "equal_interval", "head_tail_breaks",
           "maximum_breaks", "natural_breaks", "percentiles", "quantile",
           "reclassify", "std_mean", "arvi", "evi", "nbr", "ndvi", "savi",
           "sipi", "zonal_stats", "zonal_crosstab", "zonal_apply", "crop",
           "regions", "suggest_zonal_canvas", "trim", "bump", "perlin",
           "generate_terrain", "a_star_search", "diagnose",
           "set_default_device", "default_device"]

__version__ = "0.1.0"


def test():
    """Run the port's test suite (``tests/test_torch_*.py``)."""
    import glob
    import os

    import pytest

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pytest.main(sorted(glob.glob(os.path.join(root, "tests",
                                              "test_torch_*.py"))))
