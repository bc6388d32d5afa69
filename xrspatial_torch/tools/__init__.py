"""Measurement tools of the port, each run as ``python -m
xrspatial_torch.tools.<name>``."""
