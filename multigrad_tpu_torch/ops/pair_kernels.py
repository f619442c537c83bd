"""Weighted pair counts: CUDA kernels, their plain versions, autograd.

Counterpart of the pair-count half of :mod:`multigrad_tpu.ops.pallas_kernels`
(``pair_counts_pallas``).  The forward computes the weighted ordered-pair
counts between two particle blocks

    counts_b = Σ_ij w1_i w2_j [e_b² ≤ sep²_ij < e_{b+1}²]   (∧ |π_ij| < pimax)

where sep² is the squared 3D separation, or r_p² over (x, y) with the
line-of-sight cut ``|dz| < pimax`` when ``pimax`` is given, each coordinate
difference taking the periodic minimum image ``d − box·round(d/box)`` when
``box`` is given.  Bins are direct masks (not differences of cumulative
counts).  The backward is with respect to the weights only (positions are
data):

    dJ/dw1 = G·w2,  dJ/dw2 = w1·G,  G_ij = Σ_b g_b [pair ij in bin b]

The forward also keeps its per-row bin sums ``R_bi = Σ_j w2_j [pair ij in
bin b]`` when ``w1`` needs a gradient, so that ``dJ/dw1 = Σ_b g_b R_b`` is
an O(N·B) pass and not a second sweep over the pairs.  For an
autocorrelation (``pos2 is pos1 and w2 is w1``) ``dw2 = dw1``, as
``_pair_bwd`` does; only a cross-correlation's ``dw2`` sweeps the pairs
again, with the two sides swapped.

On a CUDA tensor the hand-written kernels of ``csrc/pair_counts.cu`` run
(see :mod:`.cuda_build`); on a CPU tensor the plain PyTorch versions
(:func:`pair_counts_fwd_plain`, :func:`pair_rowgrad_plain`,
:func:`pair_counts_bwd_plain`) run, one block of rows at a time.  The
tensor's device decides; there is no fallback from one to the other.  Each
kernel wrapper counts its launches (``pair_counts_fwd_cuda.launches``,
``pair_rowgrad_cuda.launches``, ``pair_counts_bwd_cuda.launches``).

The squared separations of both are computed in the same float32
operations in the same order, and the edges are squared once, here, so the
bin masks agree bit for bit and the counts differ only in the order of the
float32 sums.  The kernels decide the minimum image's ``round(d/box)``
without a division, by comparing ``|d|`` with :func:`min_image_threshold`.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build
from .kernel_costs import (declare_kernel, pair_bwd_ops, pair_fwd_ops,
                           pair_rowgrad_ops)

#: The kernels' source under ``csrc/`` (built by :mod:`.cuda_build`).
SOURCE = "pair_counts.cu"
#: Most bins the kernels take (``pallas_kernels._LANES``); more raise.
MAX_BINS = 128
#: Pairs per row block of the plain versions: their working memory is a few
#: ``(rows, N2)`` float32 blocks of this many elements.
PLAIN_PAIRS = 1 << 22


# --------------------------------------------------------------------------
# Plain PyTorch versions
# --------------------------------------------------------------------------
def _min_image(diff, box_size):
    """Periodic minimum-image displacement (``box_size`` may be None)."""
    if box_size is None:
        return diff
    return diff - box_size * torch.round(diff / box_size)


def _pair_metrics(pos1, pos2, box_size, projected):
    """``(sep², |π|)`` for an ``(n, m)`` pair block: the squared 3D
    separation, or r_p² over (x, y) and the absolute z separation when
    ``projected`` (``|π|`` is None otherwise).  Summed as the kernels do,
    ``(dx² + dy²) + dz²``."""
    dx, dy, dz = _min_image(pos1[:, None, :] - pos2[None, :, :],
                            box_size).unbind(-1)
    sep_sq = dx * dx + dy * dy
    if projected:
        return sep_sq, dz.abs()
    return sep_sq + dz * dz, None


def _bin_masks(pos1, pos2, edges_sq, box_size, pimax):
    """One float32 ``(n, m)`` mask per bin."""
    sep_sq, pi_abs = _pair_metrics(pos1, pos2, box_size, pimax is not None)
    pi_ok = None if pimax is None else pi_abs < pimax
    masks = []
    for b in range(edges_sq.shape[0] - 1):
        mask = (sep_sq >= edges_sq[b]) & (sep_sq < edges_sq[b + 1])
        if pi_ok is not None:
            mask = mask & pi_ok
        masks.append(mask.to(torch.float32))
    return masks


def _row_blocks(n1, n2, row_chunk):
    if row_chunk is None:
        row_chunk = max(1, PLAIN_PAIRS // max(n2, 1))
    return [(a, min(a + row_chunk, n1)) for a in range(0, n1, row_chunk)]


def pair_counts_fwd_plain(pos1, w1, pos2, w2, edges_sq, box=None, pimax=None,
                          row_chunk=None, rows=False):
    """Counts ``(B,)`` as ``w1 · (M_b @ w2)`` per bin, ``row_chunk`` rows of
    pos1 at a time (None: about :data:`PLAIN_PAIRS` pairs per block).
    Differentiable in the weights by autograd, as the JAX package's
    ``pairwise._block_counts`` is by autodiff.  With ``rows``, returns
    ``(counts, R)``: ``R`` ``(B, N1)`` holds the per-row bin sums
    ``M_b @ w2``."""
    counts = torch.zeros(edges_sq.shape[0] - 1, dtype=torch.float32,
                         device=pos1.device)
    row_sums = []
    for a, b in _row_blocks(pos1.shape[0], pos2.shape[0], row_chunk):
        w = w1[a:b]
        sums = [m @ w2 for m in _bin_masks(pos1[a:b], pos2, edges_sq, box,
                                           pimax)]
        counts = counts + torch.stack([w @ r for r in sums])
        if rows:
            row_sums.append(torch.stack(sums))
    if not rows:
        return counts
    return counts, (torch.cat(row_sums, dim=1) if row_sums else
                    counts.new_zeros((counts.shape[0], 0)))


def pair_rowgrad_plain(rows, g):
    """The row-side gradient ``dw1 = Σ_b g_b R_b`` ``(N1,)`` from the
    forward's row sums ``R`` ``(B, N1)`` and the cotangent ``g`` ``(B,)``."""
    return g @ rows


def pair_counts_bwd_plain(pos1, w1, pos2, w2, edges_sq, g, box=None,
                          pimax=None, row_chunk=None, autocorr=False):
    """``(dw1, dw2)`` for the cotangent ``g`` ``(B,)`` of the counts, as
    ``G @ w2`` and ``w1 @ G`` from a sweep over the pairs; ``dw2`` is
    ``dw1`` for an autocorrelation."""
    dw1 = []
    dw2 = torch.zeros_like(w2)
    for a, b in _row_blocks(pos1.shape[0], pos2.shape[0], row_chunk):
        masks = _bin_masks(pos1[a:b], pos2, edges_sq, box, pimax)
        gmat = sum(g[k] * m for k, m in enumerate(masks))
        dw1.append(gmat @ w2)
        if not autocorr:
            dw2 = dw2 + w1[a:b] @ gmat
    dw1 = torch.cat(dw1) if dw1 else torch.zeros_like(w1)
    return dw1, (dw1 if autocorr else dw2)


def min_image_threshold(box):
    """The least float32 ``t ≥ 0`` with ``fl(t / box) > 0.5`` in float32
    (IEEE division, round to nearest even).

    For ``|d| ≤ box``, ``round(fl(d / box))`` is ``±1`` exactly when
    ``|d| ≥ t`` and 0 otherwise (a quotient of exactly 0.5 rounds to 0), so
    the kernels take the minimum image without a division.  Found by
    stepping one float32 at a time from ``box / 2``; division is monotone,
    so the predicate flips once.  ``box`` must be positive and finite."""
    b = np.float32(box)
    if not (np.isfinite(b) and b > 0):
        raise ValueError(f"box_size must be positive and finite, got {box}")
    half = np.float32(0.5)
    t = b / np.float32(2.0)
    while t / b > half:
        t = np.nextafter(t, np.float32(0.0))
    while not t / b > half:
        t = np.nextafter(t, np.float32(np.inf))
    return float(t)


# --------------------------------------------------------------------------
# CUDA kernels: wrappers
# --------------------------------------------------------------------------
_P, _I64, _I32, _F32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
_SIGNATURES = {
    "pair_counts_fwd": [_P, _P, _I64, _P, _P, _I64, _P, _I32, _F32, _F32,
                        _I32, _F32, _I32, _P, _P, _I32, _P, _P],
    "pair_rowgrad": [_P, _I64, _P, _I32, _P, _I32, _P],
    "pair_counts_bwd": [_P, _I64, _P, _P, _I64, _P, _I32, _P, _F32, _F32,
                        _I32, _F32, _I32, _P, _I32, _P],
}


def _check_float32(device, named):
    for name, t in named:
        if t is None:
            continue
        if t.device != device or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {device}, got "
                             f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_cuda_args(pos1, pos2, edges_sq, w1=None, w2=None, g=None):
    _check_float32(pos1.device, [("pos1", pos1), ("pos2", pos2),
                                 ("edges_sq", edges_sq), ("w1", w1),
                                 ("w2", w2), ("g", g)])
    if not 2 <= edges_sq.shape[0] <= MAX_BINS + 1:
        raise ValueError(f"between 1 and {MAX_BINS} bins supported")
    for name, t, shape in (
            ("pos1", pos1, (pos1.shape[0], 3)),
            ("pos2", pos2, (pos2.shape[0], 3)),
            ("w1", w1, (pos1.shape[0],)), ("w2", w2, (pos2.shape[0],)),
            ("g", g, (edges_sq.shape[0] - 1,))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")


def _geometry(box, pimax):
    """The kernels' ``box, thr, use_box, pimax, projected`` arguments."""
    return (0.0 if box is None else float(box),
            0.0 if box is None else min_image_threshold(box),
            int(box is not None), 0.0 if pimax is None else float(pimax),
            int(pimax is not None))


def pair_counts_fwd_cuda(pos1, w1, pos2, w2, edges_sq, box=None, pimax=None,
                         rows=False):
    """Counts ``(B,)`` by the CUDA kernel: pos ``(N, 3)``, w ``(N,)``, the
    squared edges ``(B+1,)``, all float32, contiguous, on one device.  With
    ``rows``, returns ``(counts, R)``, ``R`` ``(B, N1)`` the per-row bin
    sums, as :func:`pair_counts_fwd_plain` does."""
    _check_cuda_args(pos1, pos2, edges_sq, w1=w1, w2=w2)
    lib = cuda_build.load(SOURCE, _SIGNATURES)
    n1, n2, n_edges = pos1.shape[0], pos2.shape[0], edges_sq.shape[0]
    device = pos1.device
    grid = cuda_build.row_blocks(n1)
    partials = torch.empty((grid, n_edges - 1), dtype=torch.float32,
                           device=device)
    counts = torch.empty(n_edges - 1, dtype=torch.float32, device=device)
    row_sums = (torch.empty((n_edges - 1, n1), dtype=torch.float32,
                            device=device) if rows else None)
    code = cuda_build.call(
        device, lib.pair_counts_fwd, pos1.data_ptr(), w1.data_ptr(), n1,
        pos2.data_ptr(), w2.data_ptr(), n2, edges_sq.data_ptr(), n_edges,
        *_geometry(box, pimax),
        None if row_sums is None else row_sums.data_ptr(),
        partials.data_ptr(), grid, counts.data_ptr(),
        cuda_build.stream(device))
    cuda_build.raise_on(code, "pair_counts_fwd")
    pair_counts_fwd_cuda.launches += 1
    return (counts, row_sums) if rows else counts


def pair_rowgrad_cuda(rows, g):
    """The row-side gradient ``dw1 = Σ_b g_b R_b`` ``(N1,)`` by the CUDA
    kernel, from the forward's row sums ``R`` ``(B, N1)`` and the cotangent
    ``g`` ``(B,)``, both float32, contiguous, on one device."""
    _check_float32(rows.device, [("rows", rows), ("g", g)])
    nb, n1 = rows.shape
    if not 1 <= nb <= MAX_BINS or tuple(g.shape) != (nb,):
        raise ValueError(f"rows (B, N1) and g (B,) with 1 <= B <= "
                         f"{MAX_BINS}, got {tuple(rows.shape)} and "
                         f"{tuple(g.shape)}")
    lib = cuda_build.load(SOURCE, _SIGNATURES)
    dw1 = torch.empty(n1, dtype=torch.float32, device=rows.device)
    code = cuda_build.call(
        rows.device, lib.pair_rowgrad, rows.data_ptr(), n1, g.data_ptr(), nb,
        dw1.data_ptr(), cuda_build.row_blocks(n1),
        cuda_build.stream(rows.device))
    cuda_build.raise_on(code, "pair_rowgrad")
    pair_rowgrad_cuda.launches += 1
    return dw1


def pair_counts_bwd_cuda(pos1, pos2, w2, edges_sq, g, box=None, pimax=None):
    """``dw1 = G·w2`` ``(N1,)`` by the CUDA sweep over the pairs, for the
    cotangent ``g`` ``(B,)``; a cross-correlation's ``dw2`` is this call
    with the two sides swapped."""
    _check_cuda_args(pos1, pos2, edges_sq, w2=w2, g=g)
    lib = cuda_build.load(SOURCE, _SIGNATURES)
    n1, n2, n_edges = pos1.shape[0], pos2.shape[0], edges_sq.shape[0]
    dw1 = torch.empty(n1, dtype=torch.float32, device=pos1.device)
    code = cuda_build.call(
        pos1.device, lib.pair_counts_bwd, pos1.data_ptr(), n1,
        pos2.data_ptr(), w2.data_ptr(), n2, edges_sq.data_ptr(), n_edges,
        g.data_ptr(), *_geometry(box, pimax), dw1.data_ptr(),
        cuda_build.row_blocks(n1), cuda_build.stream(pos1.device))
    cuda_build.raise_on(code, "pair_counts_bwd")
    pair_counts_bwd_cuda.launches += 1
    return dw1


pair_counts_fwd_cuda.launches = 0
pair_rowgrad_cuda.launches = 0
pair_counts_bwd_cuda.launches = 0


# --------------------------------------------------------------------------
# Dispatch by device, autograd, entry point
# --------------------------------------------------------------------------
class PairCounts(torch.autograd.Function):
    """Weighted ordered-pair counts with the analytic backward of the TPU
    kernel's ``custom_vjp``: ``apply(pos1, w1, pos2, w2, edges_sq, box,
    pimax, autocorr, row_chunk)``.  Differentiable in ``w1`` and ``w2``
    only; ``row_chunk`` bounds the plain (CPU) version's memory.

    The forward keeps its row sums ``R`` when ``w1`` needs a gradient (a
    target computed without one pays nothing), and the backward's ``dw1``
    is ``g @ R``; a cross-correlation's ``dw2`` sweeps the pairs again.
    On meta tensors, inside the static cost model, the kernels declare
    their counts (the pairs in the bins' range left out: a floor) and
    return empty results."""

    @staticmethod
    def forward(ctx, pos1, w1, pos2, w2, edges_sq, box, pimax, autocorr,
                row_chunk):
        keep_rows = ctx.needs_input_grad[1]
        if pos1.is_meta:
            n1, n_bins = pos1.shape[0], edges_sq.shape[0] - 1
            declare_kernel("pair_counts_fwd", pair_fwd_ops(
                n1, pos2.shape[0], n_bins, box is not None))
            out = torch.empty(n_bins, dtype=torch.float32, device="meta")
            if keep_rows:
                out = (out, torch.empty((n_bins, n1), dtype=torch.float32,
                                        device="meta"))
        elif pos1.is_cuda:
            out = pair_counts_fwd_cuda(pos1, w1, pos2, w2, edges_sq, box,
                                       pimax, keep_rows)
        else:
            out = pair_counts_fwd_plain(pos1, w1, pos2, w2, edges_sq, box,
                                        pimax, row_chunk, keep_rows)
        counts, rows = out if keep_rows else (out, None)
        ctx.save_for_backward(pos1, w1, pos2, w2, edges_sq, rows)
        ctx.geometry = (box, pimax, autocorr, row_chunk)
        return counts

    @staticmethod
    def backward(ctx, g):
        pos1, w1, pos2, w2, edges_sq, rows = ctx.saved_tensors
        box, pimax, autocorr, row_chunk = ctx.geometry
        need = ctx.needs_input_grad
        g = g.to(torch.float32).contiguous()
        dw1 = dw2 = None
        if pos1.is_meta:
            n_bins = edges_sq.shape[0] - 1
            if need[1]:
                declare_kernel("pair_rowgrad",
                               pair_rowgrad_ops(pos1.shape[0], n_bins))
                dw1 = torch.empty_like(w1)
            if not autocorr and need[3]:
                declare_kernel("pair_counts_bwd", pair_bwd_ops(
                    pos2.shape[0], pos1.shape[0], n_bins, box is not None))
                dw2 = torch.empty_like(w2)
            return (None, dw1, None, dw1 if autocorr else dw2, None, None,
                    None, None, None)
        if need[1]:
            dw1 = (pair_rowgrad_cuda(rows, g) if rows.is_cuda
                   else pair_rowgrad_plain(rows, g))
        if autocorr:
            dw2 = dw1
        elif need[3]:
            if pos1.is_cuda:
                dw2 = pair_counts_bwd_cuda(pos2, pos1, w1, edges_sq, g, box,
                                           pimax)
            else:
                dw2 = pair_counts_bwd_plain(pos1, w1, pos2, w2, edges_sq, g,
                                            box, pimax, row_chunk)[1]
        return (None, dw1 if need[1] else None, None,
                dw2 if need[3] else None, None, None, None, None, None)


def _f32(x):
    """A Python float rounded to float32 (as ``jnp.asarray(x, float32)``)."""
    return None if x is None else float(np.float32(x))


def pair_counts(pos1, w1, pos2, w2, bin_edges, box_size=None, pimax=None,
                row_chunk=None):
    """Weighted ordered-pair counts between two particle blocks — the
    port's ``pair_counts_pallas``.

    ``counts[b] = Σ_ij w1_i w2_j [edge_b ≤ sep < edge_{b+1}]``, with the
    periodic minimum image when ``box_size`` is given and projected bins
    (r_p over (x, y), ``|π| < pimax``) when ``pimax`` is given.
    Differentiable in the weights; positions are data.  The backward of
    an autocorrelation (``pos2 is pos1 and w2 is w1``) sweeps no pairs; a
    cross-correlation's sweeps them once, for ``dw2``.  At most
    :data:`MAX_BINS` bins; more raise ``ValueError``.  Weight-0 particles
    are exactly neutral.  ``row_chunk`` bounds the plain (CPU) version's
    memory; the CUDA kernels ignore it.
    """
    autocorr = pos2 is pos1 and w2 is w1
    pos1 = torch.as_tensor(pos1)
    device = pos1.device
    edges = torch.as_tensor(bin_edges, dtype=torch.float32, device=device)
    if edges.shape[0] - 1 > MAX_BINS:
        raise ValueError(f"at most {MAX_BINS} bins supported")
    edges_sq = (edges * edges).contiguous()
    pos1 = pos1.to(torch.float32).contiguous()
    w1 = torch.as_tensor(w1).to(torch.float32).contiguous()
    if autocorr:
        pos2, w2 = pos1, w1
    else:
        pos2 = torch.as_tensor(pos2).to(torch.float32).contiguous()
        w2 = torch.as_tensor(w2).to(torch.float32).contiguous()
    return PairCounts.apply(pos1, w1, pos2, w2, edges_sq, _f32(box_size),
                            _f32(pimax), autocorr, row_chunk)
