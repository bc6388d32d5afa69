"""Pre-flight raster sanity checks.

Counterpart of ``xrspatial_tpu/diagnostics.py``, with the same issue code
(``UNIT_MISMATCH``), severity, report fields and rendered text.  Surface
ops (slope/aspect/curvature/hillshade) silently produce garbage when the
horizontal coordinate unit disagrees with the elevation unit, the classic
case being lon/lat degrees under meter elevations.  The checks are host
heuristics over coords and attrs, plus the min and max of five sampled
windows of the raster (``utils._sample_windows_min_max``), the only part
of a tensor on the card that moves to the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from .utils import (_infer_coord_unit_type, _infer_vertical_unit_type,
                    get_dataarray_resolution)
from .xrlib import DataArray

__all__ = ["DiagnosticIssue", "DiagnosticReport", "diagnose"]


@dataclass
class DiagnosticIssue:
    """One problem a check found: a stable ``code`` for programmatic
    handling, a ``severity`` ('warning' or 'error'), and human-readable
    ``message``/``suggestion`` text."""
    code: str
    severity: str
    message: str
    suggestion: str

    def render(self) -> str:
        return (f"[{self.severity.upper()}] {self.code}: {self.message}\n"
                f"  Suggestion: {self.suggestion}")


@dataclass
class DiagnosticReport:
    """Everything ``diagnose`` learned about a raster: the issue list
    plus the unit/resolution metadata the checks inferred along the way
    (useful even when no issue fires)."""
    issues: List[DiagnosticIssue] = field(default_factory=list)
    horizontal_unit_type: Optional[str] = None
    vertical_unit_type: Optional[str] = None
    resolution: Optional[tuple] = None

    @property
    def has_issues(self) -> bool:
        return bool(self.issues)

    @property
    def has_warnings(self) -> bool:
        return any(i.severity == "warning" for i in self.issues)

    @property
    def has_errors(self) -> bool:
        return any(i.severity == "error" for i in self.issues)

    def __str__(self) -> str:
        if not self.issues:
            return "No issues detected."
        return "\n".join(i.render() for i in self.issues)


def _infer_units(agg: DataArray,
                 report: DiagnosticReport) -> Tuple[set, str]:
    """Fill the report's metadata fields and return the evidence the
    mismatch check needs: the set of inferred horizontal unit types
    (x and y, 'unknown' dropped) and the vertical unit type.  Any
    failure to infer yields empty evidence — checks then stay silent
    rather than guess."""
    try:
        csx, csy = get_dataarray_resolution(agg)
    except Exception:
        return set(), "unknown"
    report.resolution = (csx, csy)

    if len(agg.dims) < 2:
        return set(), "unknown"
    coords = []
    for dim, cs in ((agg.dims[-1], csx), (agg.dims[-2], csy)):
        try:
            coord = agg.coords[dim] if dim in agg.coords else None
        except Exception:
            coord = None
        if coord is None:
            return set(), "unknown"
        coords.append((coord, cs))

    horiz = {_infer_coord_unit_type(coord, cs)
             for coord, cs in coords} - {"unknown"}
    vert = _infer_vertical_unit_type(agg)
    report.vertical_unit_type = vert
    if horiz:
        report.horizontal_unit_type = next(iter(horiz))
    return horiz, vert


def _check_unit_mismatch(agg: DataArray, report: DiagnosticReport) -> None:
    horiz, vert = _infer_units(agg, report)
    if "degrees" in horiz and vert == "elevation":
        report.issues.append(DiagnosticIssue(
            code="UNIT_MISMATCH",
            severity="warning",
            message=(
                "Input DataArray appears to have coordinates in degrees "
                "but elevation values in a linear unit (e.g. meters/feet)."
            ),
            suggestion=(
                "Slope/aspect/curvature operations expect horizontal "
                "distances in the same units as vertical. Consider "
                "reprojecting to a projected CRS with meter-based "
                "coordinates."
            ),
        ))


# each check: (callable, tools it applies to; None = every tool)
_CHECKS: List[Tuple[Callable[[DataArray, DiagnosticReport], None],
                    Optional[set]]] = [
    (_check_unit_mismatch, {"slope", "aspect", "curvature", "hillshade"}),
]


def diagnose(agg: DataArray, tool: Optional[str] = None) -> DiagnosticReport:
    """Run the pre-flight checks against a raster.

    Parameters
    ----------
    agg : DataArray
        Raster to inspect.
    tool : str, optional
        Name of the op you intend to run (e.g. ``'slope'``).  Restricts
        the run to checks relevant to that op; ``None`` runs everything.

    Returns
    -------
    DiagnosticReport
        Issues found plus inferred unit/resolution metadata.  Printable;
        see ``has_warnings`` / ``has_errors`` for branching.
    """
    report = DiagnosticReport()
    wanted = None if tool is None else tool.lower()
    for check, tools in _CHECKS:
        if wanted is None or tools is None or wanted in tools:
            check(agg, report)
    return report
