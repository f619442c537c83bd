"""Utilities: devices, simple gradient descent, LHS sampling, padding,
checkpoints, debugging and profiling helpers, and the halo-catalog index
helpers (``diffdesi``)."""
import importlib

from .util import (GradDescentResult, latin_hypercube_sampler,  # noqa: F401
                   pad_to_multiple, simple_grad_descent,
                   simple_grad_descent_scan)
from . import checkpoint, diffdesi, profiling  # noqa: F401

__all__ = [
    "debug",
    "GradDescentResult", "latin_hypercube_sampler", "pad_to_multiple",
    "scatter_nd", "simple_grad_descent", "simple_grad_descent_scan",
    "checkpoint", "diffdesi", "profiling",
]


def __getattr__(name):
    # The two names that reach parallel/, which imports this package (by
    # way of ops/cuda_build): imported at first use.
    if name == "debug":
        return importlib.import_module(".debug", __name__)
    if name == "scatter_nd":
        from ..parallel.collectives import scatter_nd
        return scatter_nd
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
