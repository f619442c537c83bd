"""Ring-sharded differentiable pair counting (port of
:mod:`multigrad_tpu.ops.pairwise`).

Positions are fixed data; the per-particle weights are the differentiable
quantity (selection probabilities, occupations, completeness).  Weighted
pair counts

    DD_b = Σ_ij w_i w_j [r_ij in bin b]

are smooth in ``w`` while the bin masks are constants, so the gradient is
two masked matrix-vector products (:mod:`.pair_kernels`).

Sharding.  Each process holds a block of particles.
:func:`ring_weighted_pair_counts` returns the counts of all ordered pairs
whose first member lives on the calling process; their sum over the
processes (the all-reduce of :class:`~multigrad_tpu_torch.core.model
.OnePointModel`) is the total.  The visiting block goes around a
``torch.distributed`` ring (:func:`~multigrad_tpu_torch.parallel
.collectives.ring_shift`), whose backward is the reverse ring, so each
visiting block's weight gradient returns to the process that owns the
weights.  Pad ragged shards with weight 0: exactly neutral for every count.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..parallel.collectives import ring_shift
from ..parallel.mesh import MeshComm
from .pair_kernels import (_min_image, _pair_metrics,  # noqa: F401
                           pair_counts, pair_counts_fwd_plain)


def _block_counts(pos1, w1, pos2, w2, edges_sq, box_size, pimax):
    """Per-bin weighted ordered-pair counts between two blocks, in plain
    PyTorch: ``Σ_ij w1_i w2_j [edges_sq[b] <= sep² < edges_sq[b+1]]``
    (∧ ``|π| < pimax`` when projected), one direct mask per bin.
    Differentiable in the weights by autograd."""
    return pair_counts_fwd_plain(pos1, w1, pos2, w2, edges_sq, box_size,
                                 pimax)


def _block_counts_chunked(pos1, w1, pos2, w2, edges_sq, box_size, pimax,
                          row_chunk):
    """:func:`_block_counts`, ``row_chunk`` rows of ``pos1`` at a time (a
    ragged last block included; None picks a block of about
    ``pair_kernels.PLAIN_PAIRS`` pairs)."""
    return pair_counts_fwd_plain(pos1, w1, pos2, w2, edges_sq, box_size,
                                 pimax, row_chunk)


def _self_pair_counts(w, edges_sq):
    """Σ_i w_i² placed in the bin containing sep² = 0 (for exclusion)."""
    zero_in_bin = (edges_sq[:-1] <= 0.0) & (0.0 < edges_sq[1:])
    return zero_in_bin.to(w.dtype) * torch.sum(w * w)


def ring_weighted_pair_counts(positions, weights, bin_edges,
                              comm: Optional[MeshComm] = None,
                              box_size: Optional[float] = None,
                              pimax: Optional[float] = None,
                              exclude_self: bool = True,
                              row_chunk: Optional[int] = None):
    """Weighted ordered-pair counts of the full dataset, ring-sharded.

    Parameters
    ----------
    positions : (n_local, 3) tensor
        This process's particle positions (all of them when ``comm`` is
        None or of size 1).
    weights : (n_local,) tensor
        Differentiable per-particle weights.
    bin_edges : (B+1,) tensor
        Separation bin edges (3D ``r``, or transverse ``r_p`` when
        ``pimax`` is given), non-negative and increasing; at most 128 bins.
    comm : MeshComm, optional
        The processes to ring over.  None (or a comm of size 1) counts one
        block, all pairs, as an autocorrelation.
    box_size : float, optional
        Periodic box side; applies the minimum-image convention.
    pimax : float, optional
        Count pairs in projected bins: ``r_p`` binned by ``bin_edges`` with
        ``|π| < pimax`` (the wp(rp) estimator's DD).
    exclude_self : bool
        Remove the i == j self-pair term (nonzero only when
        ``bin_edges[0] == 0``).
    row_chunk : int, optional
        Rows per block of the plain (CPU) path, which bounds its memory at
        ``row_chunk × n_local`` pairs; the CUDA kernels ignore it.

    Returns
    -------
    counts : (B,) tensor
        This process's partial counts: ordered pairs (i local, j anywhere).
        Their sum over the processes is the total; every unordered pair is
        counted twice, the standard N(N−1) DD convention.
    """
    positions = torch.as_tensor(positions)
    edges = torch.as_tensor(bin_edges, dtype=torch.float32,
                            device=positions.device)
    edges_sq = edges * edges

    def block(p2, w2):
        return pair_counts(positions, weights, p2, w2, edges,
                           box_size=box_size, pimax=pimax,
                           row_chunk=row_chunk)

    counts = block(positions, weights)
    if comm is not None and comm.size > 1:
        # Pass the visiting block to the next process around the ring;
        # after comm.size blocks every (local, remote) pair of blocks has
        # been counted once.  The last shift would bring the local block
        # home, so it is not made.
        other_pos, other_w = positions, weights
        for _ in range(comm.size - 1):
            other_pos = ring_shift(other_pos.detach(), comm)
            other_w = ring_shift(other_w, comm)
            counts = counts + block(other_pos, other_w)
    if exclude_self:
        counts = counts - _self_pair_counts(weights, edges_sq)
    return counts


def analytic_rr_counts(total_weight, bin_edges, box_volume,
                       pimax: Optional[float] = None):
    """Expected random-random ordered-pair counts in a periodic box:
    ``W² × V_bin / V``, with the spherical shell ``4π/3 (r₂³ − r₁³)`` in 3D
    or the annulus ``π (rp₂² − rp₁²) × 2 π_max`` for projected bins."""
    edges = torch.as_tensor(bin_edges)
    if pimax is None:
        vbin = 4.0 * math.pi / 3.0 * (edges[1:] ** 3 - edges[:-1] ** 3)
    else:
        vbin = math.pi * (edges[1:] ** 2 - edges[:-1] ** 2) * 2.0 * pimax
    return total_weight ** 2 * vbin / box_volume


def wp_from_counts(dd_counts, total_weight, rp_bin_edges, pimax,
                   box_volume):
    """Projected correlation function ``wp(rp_b) = (DD_b / RR_b − 1) ×
    2 π_max`` with the analytic RR of :func:`analytic_rr_counts`."""
    rr = analytic_rr_counts(total_weight, rp_bin_edges, box_volume,
                            pimax=pimax)
    return (dd_counts / rr - 1.0) * 2.0 * pimax


def xi_from_counts(dd_counts, total_weight, bin_edges, box_volume):
    """3D two-point correlation function ξ(r) from DD counts (natural
    estimator ``DD/RR − 1`` with the analytic RR)."""
    rr = analytic_rr_counts(total_weight, bin_edges, box_volume)
    return dd_counts / rr - 1.0
