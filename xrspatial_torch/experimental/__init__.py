"""Experimental ops (counterpart of ``xrspatial_tpu/experimental``)."""

from .polygonize import polygonize  # noqa: F401
