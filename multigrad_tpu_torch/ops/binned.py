"""Binned smoothed-count sumstats, dense and fused paths (port of
:mod:`multigrad_tpu.ops.binned`).

Each particle contributes ``cdf(high) - cdf(low)`` to a bin: the mass
of a Gaussian of width ``sigma`` (one for all particles, or one each)
centred on its value.  The dense path evaluates the cdf at all ``B+1``
edges and differences per particle before the sum over particles
(diff-then-sum keeps float32 precision in sparsely populated bins).

The fused path (``bin_mode="fused"``) evaluates the cdf at only a static
``bin_window`` of consecutive edges around each particle and adds the
per-particle bin masses into the counts.  The float32 erf clamps its
argument to ±4, so every cdf outside ``±SAT_Z·√2·sigma`` of the value
saturates to the same constant and its differences are exact zeros:
with a window from :func:`fused_bin_window` the fused counts equal the
dense ones bin for bin.  It pays when the bins are finer than the
smoothing scale.

``±inf`` values (the padding of :func:`~multigrad_tpu_torch.parallel
.collectives.scatter_nd`) are clipped to ``±1e18`` inside the counts
(:data:`~multigrad_tpu_torch.ops.erf_kernels.PAD_VALUE`): the cdf still
saturates exactly, and the gradient of a padded particle is 0, not NaN.

On a CUDA tensor the counts always go through the hand-written kernels
of :mod:`~multigrad_tpu_torch.ops.erf_kernels` (dense) and
:mod:`~multigrad_tpu_torch.ops.fused_kernels` (fused); on a CPU tensor
through their plain versions.  The device decides.  On the card the fused
counts are one kernel launch each way, which finds the window starts,
adds the masses into bins in a fixed order and gathers the counts'
cotangent itself, so they repeat bit for bit.  The plain fused versions
use :func:`window_starts` and :func:`scatter_bin_masses` (PyTorch's
``index_add_``, as the JAX package leaves the scatter to XLA).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .erf_kernels import _SQRT2, PAD_VALUE, erf, erf_counts
from .fused_kernels import erf_counts_fused

#: |z| beyond which the float32 erf is exactly saturated (it clamps its
#: argument to [-4, 4]); the fused window half-width is
#: ``SAT_Z * √2 * sigma``.
SAT_Z = 4.0


def norm_cdf(x, mean, sigma):
    """Gaussian CDF through the f32 erf the kernels use."""
    return 0.5 * (1.0 + erf((x - mean) / (_SQRT2 * sigma)))


def fused_bin_window(bin_edges, sigma_max, sat_z: float = SAT_Z) -> int:
    """Minimal static edge window for float32-exact fused binning.

    ``bin_edges`` and ``sigma_max`` are concrete values (a tensor is read
    to the host).  Returns the number of consecutive edges ``W`` such
    that a window of ``W`` edges starting at the last edge <=
    ``value - sat_z*√2*sigma`` always covers ``value + sat_z*√2*sigma``,
    so ``bin_mode="fused"`` with it reproduces the dense path.
    ``sigma_max`` is the largest smoothing width the counts will see.
    """
    if isinstance(bin_edges, torch.Tensor):
        bin_edges = bin_edges.detach().cpu().numpy()
    edges = np.asarray(bin_edges, np.float64)
    if edges.ndim != 1 or edges.shape[0] < 2:
        raise ValueError("bin_edges must be a 1-D array of >= 2 edges")
    half = float(sat_z) * float(np.sqrt(2.0)) * float(sigma_max)
    dmin = float(np.min(np.diff(edges)))
    if dmin <= 0:
        raise ValueError("bin_edges must be strictly increasing")
    w = int(np.ceil(2.0 * half / dmin)) + 2
    return int(min(max(w, 2), edges.shape[0]))


def window_starts(values, edges, sigma, window: int):
    """Per-particle start edge of the fused window (int32, ``(N,)``): the
    last edge <= ``value - SAT_Z*√2*sigma``, clipped so that the window of
    ``window`` consecutive edges stays in range.  Not differentiable."""
    half = (SAT_Z * _SQRT2) * torch.as_tensor(
        sigma, dtype=values.dtype, device=values.device).detach()
    start = torch.searchsorted(edges.detach().contiguous(),
                               values.detach() - half, right=True) - 1
    return torch.clamp(start, 0, edges.shape[0] - window).to(torch.int32)


def slot_diagonal_sum(rows, n_out: int):
    """``out[b] = Σ_w rows[w, b - w]`` for ``b < n_out`` (terms with
    ``b - w < 0`` are 0): the per-slot sums keyed on the window start,
    reassembled into per-bin (or per-edge) sums."""
    slots = rows.shape[0]
    padded = F.pad(rows, (slots, 0))
    b = torch.arange(n_out, device=rows.device)
    w = torch.arange(slots, device=rows.device)
    return padded.gather(1, b[None, :] - w[:, None] + slots).sum(dim=0)


def window_rows(src_t, start, n_edges: int):
    """``rows[w, s] = Σ_{i: start_i = s} src_t[w, i]``, shape
    ``(W, n_edges)``, for a slot-major ``src_t`` ``(W, N)``.

    An ``index_add_`` keyed on the window start, in two levels: each of
    about √N runs of consecutive particles adds into rows of its own,
    then the runs' rows are summed.  No float32 accumulator takes more
    than about √N terms, so the sums stay close to the dense path's at
    large N, where one accumulator per (start, slot) would take a large
    share of the N terms and its rounding would grow with them.  On a
    CUDA tensor ``index_add_`` adds with atomics, so the last bits would
    vary from run to run; the fused counts on the card do not run it.
    """
    slots, n = src_t.shape
    runs = max(1, math.isqrt(n))
    length = -(-n // runs)
    runs = -(-n // length)
    key = torch.arange(n, device=src_t.device)
    key = key.div_(length, rounding_mode="floor").mul_(n_edges).add_(start)
    rows = src_t.new_zeros(slots, runs * n_edges).index_add(1, key, src_t)
    return rows.view(slots, runs, n_edges).sum(dim=1)


def scatter_bin_masses(masses, start, n_edges: int):
    """Add per-particle window masses ``(N, W-1)`` into the count vector
    ``(n_edges - 1,)``: ``counts[b] = Σ_{i,w} masses[i, w]·[start_i + w
    == b]``.

    As in the JAX package, one row-wise scatter keyed on the window start
    (:func:`window_rows`) and a ``W-1``-term diagonal reassembly
    (:func:`slot_diagonal_sum`).
    """
    return slot_diagonal_sum(window_rows(masses.t(), start, n_edges),
                             n_edges - 1)


def _bin_sums_fused(values, edges, sigma, window: int):
    """Plain fused counts, all in PyTorch ops (autograd through
    :func:`~.erf_kernels.erf`): searchsorted, the ``(N, W)`` window gather, the
    per-particle cdf differences and :func:`scatter_bin_masses` — the
    JAX package's XLA ``bin_mode="fused"`` path."""
    values = torch.clamp(values, -PAD_VALUE, PAD_VALUE)
    n_edges = edges.shape[0]
    window = int(min(window, n_edges))
    if window < 2:
        raise ValueError("bin_window must be >= 2")
    sig = torch.as_tensor(sigma, dtype=values.dtype, device=values.device)
    start = window_starts(values, edges, sig, window)
    offs = start.long()[:, None] + torch.arange(window,
                                                device=values.device)
    inv = 1.0 / (_SQRT2 * (sig[:, None] if sig.dim() else sig))
    cdf = 0.5 * (1.0 + erf((edges[offs] - values[:, None]) * inv))
    return scatter_bin_masses(torch.diff(cdf, dim=1), start, n_edges)


def binned_erf_counts(values, bin_edges, sigma,
                      chunk_size: Optional[int] = None,
                      bin_mode: str = "dense",
                      bin_window: Optional[int] = None):
    """Smoothed per-bin counts of ``values`` over ``bin_edges``, shape
    ``(len(bin_edges) - 1,)``, differentiable in all three inputs.

    ``sigma`` is a scalar or one width per particle.  ``bin_mode="dense"``
    evaluates every edge for every particle (at most 128 edges);
    ``"fused"`` only a ``bin_window``-edge window around each one (see the
    module docstring; derive the window with :func:`fused_bin_window`).
    ``chunk_size`` bounds the dense plain (CPU) path's ``(B+1, chunk)``
    working memory; the CUDA kernels stream any N.

    ``bin_mode="auto"`` resolves through the autotuner's tuning table
    (:func:`multigrad_tpu_torch.tune.resolve.resolve_op_bin_mode`): the
    tuned mode for this (rows, edges, window) shape on the values'
    device, or ``"dense"`` on a cold table.  Models resolve ``"auto"``
    themselves first, at construction; this is the standalone-op
    fallback.  ``chunk_size="auto"`` resolves only at model construction
    (:func:`~multigrad_tpu_torch.tune.resolve.resolve_auto_aux`); the op
    takes an int or None.
    """
    if chunk_size == "auto":
        raise TypeError("chunk_size='auto' resolves at model construction "
                        "(tune.resolve_auto_aux); binned_erf_counts takes "
                        "an int or None")
    if bin_mode == "auto":
        from ..tune.resolve import resolve_op_bin_mode
        values = torch.as_tensor(values)
        bin_mode, bin_window = resolve_op_bin_mode(
            values.shape[0], torch.as_tensor(bin_edges).shape[0],
            bin_window, device=values.device)
    if bin_mode not in ("dense", "fused"):
        raise ValueError(f"unknown bin_mode {bin_mode!r}; "
                         "expected 'dense', 'fused' or 'auto'")
    if bin_mode == "fused":
        if bin_window is None:
            raise ValueError(
                "bin_mode='fused' needs a static bin_window (edge count); "
                "derive it with fused_bin_window(bin_edges, sigma_max)")
        return erf_counts_fused(values, bin_edges, sigma, bin_window)
    return erf_counts(values, bin_edges, sigma, chunk_size=chunk_size)


def binned_density(values, bin_edges, sigma, volume,
                   chunk_size: Optional[int] = None,
                   bin_mode: str = "dense",
                   bin_window: Optional[int] = None):
    """Binned number density per unit bin width — the SMF estimator:
    ``counts / volume / bin_width``."""
    counts = binned_erf_counts(values, bin_edges, sigma,
                               chunk_size=chunk_size, bin_mode=bin_mode,
                               bin_window=bin_window)
    widths = torch.diff(torch.as_tensor(bin_edges, dtype=counts.dtype,
                                        device=counts.device))
    return counts / volume / widths
