"""Binned smoothed-count sumstats, dense path (port of
:mod:`multigrad_tpu.ops.binned`).

Each particle contributes ``cdf(high) - cdf(low)`` to a bin: the mass
of a Gaussian of width ``sigma`` centred on its value.  The cdf is
evaluated at all ``B+1`` edges and differenced per particle before the
sum over particles (diff-then-sum keeps float32 precision in sparsely
populated bins).

``±inf`` values (the padding of :func:`~multigrad_tpu_torch.parallel
.collectives.scatter_nd`) are clipped to ``±1e18`` inside the counts
(:data:`~multigrad_tpu_torch.ops.erf_kernels.PAD_VALUE`): the cdf still
saturates exactly, and the gradient of a padded particle is 0, not NaN.

On a CUDA tensor the counts always go through the hand-written kernels
of :mod:`~multigrad_tpu_torch.ops.erf_kernels`; on a CPU tensor through
their plain versions.  The device decides.
"""
from __future__ import annotations

from typing import Optional

import torch

from .erf_kernels import _SQRT2, _erf_f32, erf_counts


def norm_cdf(x, mean, sigma):
    """Gaussian CDF through the f32 erf the kernels use."""
    return 0.5 * (1.0 + _erf_f32((x - mean) / (_SQRT2 * sigma)))


def binned_erf_counts(values, bin_edges, sigma,
                      chunk_size: Optional[int] = None,
                      bin_mode: str = "dense"):
    """Smoothed per-bin counts of ``values`` over ``bin_edges``, shape
    ``(len(bin_edges) - 1,)``, differentiable in all three inputs.

    ``chunk_size`` bounds the plain (CPU) path's ``(B+1, chunk)``
    working memory; the CUDA kernels stream any N.  Only
    ``bin_mode="dense"`` is ported.
    """
    if bin_mode == "fused":
        raise NotImplementedError(
            "bin_mode='fused' is not ported yet (ROADMAP Queue 1 item 2)")
    if bin_mode != "dense":
        raise ValueError(f"unknown bin_mode {bin_mode!r}; expected 'dense'")
    return erf_counts(values, bin_edges, sigma, chunk_size=chunk_size)


def binned_density(values, bin_edges, sigma, volume,
                   chunk_size: Optional[int] = None,
                   bin_mode: str = "dense"):
    """Binned number density per unit bin width — the SMF estimator:
    ``counts / volume / bin_width``."""
    counts = binned_erf_counts(values, bin_edges, sigma,
                               chunk_size=chunk_size, bin_mode=bin_mode)
    widths = torch.diff(torch.as_tensor(bin_edges, dtype=counts.dtype,
                                        device=counts.device))
    return counts / volume / widths
