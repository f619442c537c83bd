"""Fused (windowed) erf-CDF counts: CUDA kernels, their plain versions,
autograd.

Counterpart of the fused half of :mod:`multigrad_tpu.ops.pallas_kernels`
(``binned_erf_counts_fused_pallas``).  Each particle ``i`` evaluates the
cdf at only the ``W`` consecutive edges that start at ``start_i``
(:func:`~multigrad_tpu_torch.ops.binned.window_starts`) and yields its
``W-1`` bin masses

    m[w, i] = Φ((e[s_i+w+1] − v_i)·inv_i) − Φ((e[s_i+w] − v_i)·inv_i)

which add into the count vector at bins ``s_i + w``.  Outside the window
the float32 cdf differences are exact zeros (``binned.SAT_Z``), so with a
window from :func:`~multigrad_tpu_torch.ops.binned.fused_bin_window` the
counts equal the dense path's.  The backward recomputes ``P = exp(−z²)``
with, per slot, the window-local ``h_w = gm[w−1] − gm[w]``, ``gm[w] =
dcounts[s_i + w]`` (``gm[−1] = gm[W−1] = 0``):

    dJ/dv_i      = −(inv_i/√π) Σ_w h_w P_w
    dJ/de[s_i+w] += (inv_i/√π) h_w P_w
    dJ/dσ_i      = −(1/(σ_i√π)) Σ_w h_w P_w z_w      (summed over i for
                                                      a scalar sigma)

On a CUDA tensor a call is one launch of a hand-written kernel of
``csrc/fused_counts.cu`` each way (see :mod:`.cuda_build`): the forward
finds each window's start, computes the masses and adds them into the
counts inside the kernel, in a fixed order, so the counts repeat bit for
bit; the backward takes the counts' cotangent and writes every gradient
scaled.  On a CPU tensor the plain versions run
(:func:`fused_counts_fwd_plain`, :func:`fused_counts_bwd_plain`), built
from the masses-level functions (:func:`fused_masses_fwd_plain`,
:func:`fused_masses_bwd_plain`; slot-major ``(W-1, N)``) and
:func:`~multigrad_tpu_torch.ops.binned.scatter_bin_masses`, the JAX
package's composition.  The tensor's device decides; there is no fallback
from one to the other.  Each kernel wrapper counts its launches
(``fused_counts_fwd_cuda.launches``, ``fused_counts_bwd_cuda.launches``).
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .kernel_costs import declare_kernel, fused_bwd_ops, fused_fwd_ops
from .erf_kernels import (_INV_SQRT_PI, _SQRT2, PAD_VALUE, _erf_f32, _inv,
                          check_sigma_shape)

#: The kernels' source under ``csrc/`` (built by :mod:`.cuda_build`).
SOURCE = "fused_counts.cu"
#: Largest window (``pallas_kernels._LANES``: the TPU kernel's slot count).
MAX_WINDOW = 128
#: Most bin edges the CUDA kernels take: the edges and the counts'
#: cotangent live in shared memory, 128 KB at this cap.
MAX_FUSED_EDGES = 16_384


# --------------------------------------------------------------------------
# Plain PyTorch versions
# --------------------------------------------------------------------------
def _window_z(values, edges, sigma, start, window):
    """``(z, inv)``: ``z[w, i] = (e[s_i+w] − v_i)·inv_i``, shape ``(W, N)``."""
    v = torch.clamp(values, -PAD_VALUE, PAD_VALUE)
    offs = start.long()[None, :] + torch.arange(window, device=v.device)[:, None]
    inv = _inv(sigma)
    return (edges[offs] - v[None, :]) * inv, inv


def fused_masses_fwd_plain(values, edges, sigma, start, window):
    """Window masses ``(W-1, N)``, slot-major; ``sigma`` 0-d or ``(N,)``."""
    z, _ = _window_z(values, edges, sigma, start, window)
    return torch.diff(0.5 * (1.0 + _erf_f32(z)), dim=0)


def fused_masses_bwd_plain(values, edges, sigma, start, window, g,
                           need_dewin=False):
    """``(dvalues, dewin, dsigma)`` for the slot-major cotangent ``g``
    ``(W-1, N)`` of the masses; ``dewin`` ``(W, N)`` is None unless
    ``need_dewin``, and ``dsigma`` has sigma's shape."""
    z, inv = _window_z(values, edges, sigma, start, window)
    zero = g.new_zeros(1, g.shape[1])
    hp = (torch.cat([zero, g]) - torch.cat([g, zero])) * torch.exp(-(z * z))
    dvalues = -(inv * _INV_SQRT_PI) * hp.sum(dim=0)
    dewin = (inv * _INV_SQRT_PI) * hp if need_dewin else None
    hz = (hp * z).sum(dim=0)
    scale = inv * (_SQRT2 * _INV_SQRT_PI)      # 1 / (σ √π)
    dsigma = -(scale * hz) if sigma.dim() else -(hz.sum() * scale)
    return dvalues, dewin, dsigma


def _starts(values, edges, sigma, window):
    from .binned import window_starts
    return window_starts(torch.clamp(values.detach(), -PAD_VALUE, PAD_VALUE),
                         edges.detach(), sigma.detach(), window)


def fused_counts_fwd_plain(values, edges, sigma, window):
    """Counts ``(E-1,)``: :func:`~.binned.window_starts`, the window masses
    (:func:`fused_masses_fwd_plain`), then
    :func:`~.binned.scatter_bin_masses`."""
    from .binned import scatter_bin_masses
    start = _starts(values, edges, sigma, window)
    masses = fused_masses_fwd_plain(values, edges, sigma, start, window)
    return scatter_bin_masses(masses.t(), start, edges.shape[0])


def fused_counts_bwd_plain(values, edges, sigma, window, dcounts,
                           need_dedges=False):
    """``(dvalues, dedges, dsigma)`` for the counts' cotangent ``dcounts``
    ``(E-1,)``: its gather into the window, ``(W-1, N)``, then
    :func:`fused_masses_bwd_plain`, and for ``dedges`` (None unless
    ``need_dedges``) the transpose of the edge-window gather
    (:func:`~.binned.window_rows`, :func:`~.binned.slot_diagonal_sum`)."""
    from .binned import slot_diagonal_sum, window_rows
    n_edges = edges.shape[0]
    start = _starts(values, edges, sigma, window)
    offs = start.long()[None, :] + torch.arange(
        window - 1, device=values.device)[:, None]
    dv, dewin, ds = fused_masses_bwd_plain(values, edges, sigma, start,
                                           window, dcounts[offs],
                                           need_dedges)
    dedges = slot_diagonal_sum(window_rows(dewin, start, n_edges),
                               n_edges) if need_dedges else None
    return dv, dedges, ds


# --------------------------------------------------------------------------
# CUDA kernels: wrappers
# --------------------------------------------------------------------------
_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "fused_counts_fwd": [_P, _I64, _P, _I32, _P, _I32, _I32, _P, _I64, _P,
                         _I32, _P, _P],
    "fused_counts_bwd": [_P, _I64, _P, _I32, _P, _I32, _I32, _P, _P, _P, _P,
                         _P, _I64, _P, _I32, _P],
}


def fused_grid(n: int, sms: int, n_edges: int) -> int:
    """Blocks of both fused kernels for ``n`` particles on ``sms`` SMs, by
    the one-launch kernels' rule (:func:`~.cuda_build.one_launch_grid`),
    with rows for ``n_edges + 1`` partials columns whatever the launch
    asks: the same grid with and without ``dedges`` keeps dsigma's sums
    in one order."""
    return cuda_build.one_launch_grid(n, sms, n_edges + 1)


def _check_cuda_args(values, edges, sigma, window, dcounts=None):
    device = values.device
    for name, t in (("values", values), ("bin_edges", edges),
                    ("sigma", sigma), ("dcounts", dcounts)):
        if t is None:
            continue
        if t.device != device or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {device}, got "
                             f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if values.dim() != 1 or sigma.dim() > 1 or (
            sigma.dim() == 1 and sigma.shape != values.shape):
        raise ValueError("values must be 1-d and sigma 0-d or of values' "
                         "shape")
    n_edges = edges.shape[0]
    if edges.dim() != 1 or not 2 <= n_edges <= MAX_FUSED_EDGES:
        raise ValueError(f"between 2 and {MAX_FUSED_EDGES} bin edges "
                         "supported")
    if not 2 <= window <= min(MAX_WINDOW, n_edges):
        raise ValueError(f"window must be in [2, {MAX_WINDOW}] and at most "
                         f"the edge count, got {window}")
    if dcounts is not None and tuple(dcounts.shape) != (n_edges - 1,):
        raise ValueError(f"dcounts must have shape ({n_edges - 1},), got "
                         f"{tuple(dcounts.shape)}")


def fused_counts_fwd_cuda(values, edges, sigma, window):
    """Counts ``(E-1,)`` by the CUDA kernel, one launch: the window starts,
    the masses and their sum into bins.  ``values`` ``(N,)``, ``edges``
    ``(E,)``, ``sigma`` 0-d or ``(N,)``, all float32, contiguous, on one
    device; ``2 <= window <= min(128, E)``."""
    _check_cuda_args(values, edges, sigma, window)
    lib = cuda_build.load(SOURCE, _SIGNATURES)
    device, n_edges = values.device, edges.shape[0]
    counts = torch.empty(n_edges - 1, dtype=torch.float32, device=device)
    ws = cuda_build.workspace(device)
    n = values.shape[0]
    code = cuda_build.call(
        device, lib.fused_counts_fwd, values.data_ptr(), n,
        edges.data_ptr(), n_edges, sigma.data_ptr(), sigma.dim(), window,
        ws.partials, cuda_build.PARTIALS, ws.counter(cuda_build.FUSED_FWD),
        fused_grid(n, ws.sms, n_edges), counts.data_ptr(), ws.stream)
    cuda_build.raise_on(code, "fused_counts_fwd")
    fused_counts_fwd_cuda.launches += 1
    return counts


def fused_counts_bwd_cuda(values, edges, sigma, window, dcounts,
                          need_dedges=False):
    """``(dvalues, dedges, dsigma)`` by the CUDA kernel, one launch, for the
    counts' float32 cotangent ``dcounts`` ``(E-1,)``, all three scaled;
    ``dedges`` ``(E,)`` is None unless ``need_dedges``, ``dsigma`` has
    sigma's shape."""
    _check_cuda_args(values, edges, sigma, window, dcounts)
    lib = cuda_build.load(SOURCE, _SIGNATURES)
    n_edges = edges.shape[0]
    dv = torch.empty_like(values)
    de = torch.empty_like(edges) if need_dedges else None
    ds = torch.empty_like(sigma)
    ws = cuda_build.workspace(values.device)
    n = values.shape[0]
    code = cuda_build.call(
        values.device, lib.fused_counts_bwd, values.data_ptr(), n,
        edges.data_ptr(), n_edges, sigma.data_ptr(), sigma.dim(), window,
        dcounts.data_ptr(), dv.data_ptr(),
        None if de is None else de.data_ptr(), ds.data_ptr(), ws.partials,
        cuda_build.PARTIALS, ws.counter(cuda_build.FUSED_BWD),
        fused_grid(n, ws.sms, n_edges), ws.stream)
    cuda_build.raise_on(code, "fused_counts_bwd")
    fused_counts_bwd_cuda.launches += 1
    return dv, de, ds


fused_counts_fwd_cuda.launches = 0
fused_counts_bwd_cuda.launches = 0


# --------------------------------------------------------------------------
# Dispatch by device, autograd, entry point
# --------------------------------------------------------------------------
class FusedCounts(torch.autograd.Function):
    """Fused counts ``(E-1,)`` with the analytic backward of the TPU
    kernel's ``custom_vjp``: ``apply(values, edges, sigma, window)``; the
    kernels on CUDA tensors, the plain versions on CPU tensors, and on
    meta tensors, inside the static cost model, the kernels' declared
    counts and empty results."""

    @staticmethod
    def forward(ctx, values, edges, sigma, window):
        ctx.save_for_backward(values, edges, sigma)
        ctx.window = window
        if values.is_meta:
            n, n_edges = values.shape[0], edges.shape[0]
            declare_kernel("fused_counts_fwd", fused_fwd_ops(
                n, n_edges, window, sigma.dim() > 0), erf=n * window)
            return torch.empty(n_edges - 1, dtype=torch.float32,
                               device="meta")
        if values.is_cuda:
            return fused_counts_fwd_cuda(values, edges, sigma, window)
        return fused_counts_fwd_plain(values, edges, sigma, window)

    @staticmethod
    def backward(ctx, g):
        values, edges, sigma = ctx.saved_tensors
        need = ctx.needs_input_grad
        if values.is_meta:
            n, n_edges = values.shape[0], edges.shape[0]
            declare_kernel("fused_counts_bwd", fused_bwd_ops(
                n, n_edges, ctx.window, sigma.dim() > 0),
                exp=n * ctx.window)
            return (torch.empty_like(values) if need[0] else None,
                    torch.empty_like(edges) if need[1] else None,
                    torch.empty_like(sigma) if need[2] else None, None)
        bwd = fused_counts_bwd_cuda if values.is_cuda \
            else fused_counts_bwd_plain
        dv, de, ds = bwd(values, edges, sigma, ctx.window, g.contiguous(),
                         need_dedges=need[1])
        return (dv if need[0] else None, de,
                ds.reshape(sigma.shape) if need[2] else None, None)


def erf_counts_fused(values, bin_edges, sigma, window: int):
    """Fused (windowed scatter-into-bins) smoothed histogram — the port's
    ``binned_erf_counts_fused_pallas``.

    Each particle's cdf is evaluated at only ``window`` consecutive edges
    around its value, and its masses are added into the ``(E-1,)`` counts:
    on a CUDA tensor by one kernel launch (and one for the backward), on a
    CPU tensor by the plain versions.  Differentiable in ``values``,
    ``bin_edges`` and ``sigma`` (a scalar or one width per particle).
    ``window`` is clipped to the edge count and must then lie in
    ``[2, 128]``; the kernels take up to 16,384 edges.
    """
    values = torch.as_tensor(values)
    vec = check_sigma_shape(values, sigma)
    device = values.device
    edges = torch.as_tensor(bin_edges, dtype=torch.float32,
                            device=device).contiguous()
    window = int(min(window, edges.shape[0]))
    if not 2 <= window <= MAX_WINDOW:
        raise ValueError(f"window must be in [2, {MAX_WINDOW}], "
                         f"got {window}")
    values = values.to(torch.float32).contiguous()
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=device)
    sigma = sigma.contiguous() if vec else sigma.reshape(())
    return FusedCounts.apply(values, edges, sigma, window)
