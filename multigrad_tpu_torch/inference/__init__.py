"""Inference: uncertainty for fitted models (port of
:mod:`multigrad_tpu.inference`; the Fisher matrix so far).

* :mod:`.fisher`: distributed sumstats Jacobians (per shard and per
  chunk, ``∂y_r/∂p`` sums like ``y_r``), the Gauss–Newton Fisher
  information, Laplace covariances and conditioning diagnostics.

``hmc`` and ``ensemble`` are not ported yet.
"""
from .fisher import (FisherResult, fisher_diagnostics,  # noqa: F401
                     fisher_information, laplace_covariance,
                     sumstats_jacobian)

__all__ = [
    "FisherResult", "fisher_information", "laplace_covariance",
    "fisher_diagnostics", "sumstats_jacobian",
]
