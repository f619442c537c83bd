"""Utilities: devices, simple gradient descent, LHS sampling, padding,
checkpoints, and the halo-catalog index helpers (``diffdesi``)."""
from . import diffdesi  # noqa: F401
