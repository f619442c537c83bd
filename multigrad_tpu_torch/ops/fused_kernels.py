"""Fused (windowed) erf-CDF bin masses: CUDA kernels, their plain versions,
autograd.

Counterpart of the fused half of :mod:`multigrad_tpu.ops.pallas_kernels`
(``binned_erf_counts_fused_pallas``).  Each particle ``i`` evaluates the
cdf at only the ``W`` consecutive edges that start at ``start_i``
(:func:`~multigrad_tpu_torch.ops.binned.window_starts`) and yields its
``W-1`` bin masses

    m[w, i] = Φ((e[s_i+w+1] − v_i)·inv_i) − Φ((e[s_i+w] − v_i)·inv_i)

which :func:`~multigrad_tpu_torch.ops.binned.scatter_bin_masses` adds
into the count vector.  Outside the window the float32 cdf differences
are exact zeros (``binned.SAT_Z``), so with a window from
:func:`~multigrad_tpu_torch.ops.binned.fused_bin_window` the counts equal
the dense path's.  The backward recomputes ``P = exp(−z²)`` with, per
slot, ``h_w = g[w−1, i] − g[w, i]``:

    dJ/dv_i      = −(inv_i/√π) Σ_w h_w P_w
    dJ/dewin_w,i =  (inv_i/√π) h_w P_w
    dJ/dσ_i      = −(1/(σ_i√π)) Σ_w h_w P_w z_w      (summed over i for
                                                      a scalar sigma)

and the per-slot edge cotangent ``dewin`` goes back onto the edge vector
by the transpose of the window gather.

Masses and their cotangent are slot-major, ``(W-1, N)``, in the kernels
and the plain versions alike; :func:`fused_masses` returns the
``(N, W-1)`` view the JAX package returns.

On a CUDA tensor the hand-written kernels of ``csrc/fused_masses.cu`` run
(see :mod:`.cuda_build`); on a CPU tensor the plain PyTorch versions
(:func:`fused_masses_fwd_plain`, :func:`fused_masses_bwd_plain`) run.
The tensor's device decides; there is no fallback from one to the other.
Each kernel wrapper counts its launches (``fused_masses_fwd_cuda
.launches``, ``fused_masses_bwd_cuda.launches``).
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .erf_kernels import (_INV_SQRT_PI, _SQRT2, PAD_VALUE, _erf_f32, _inv,
                          check_sigma_shape)

#: The kernels' source under ``csrc/`` (built by :mod:`.cuda_build`).
SOURCE = "fused_masses.cu"
#: Largest window (``pallas_kernels._LANES``: the TPU kernel's slot count).
MAX_WINDOW = 128
#: Most bin edges the CUDA kernels take: the edge vector lives in shared
#: memory, 64 KB at this cap.
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


# --------------------------------------------------------------------------
# CUDA kernels: wrappers
# --------------------------------------------------------------------------
_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "fused_masses_fwd": [_P, _I64, _P, _I32, _P, _I32, _P, _I32, _P, _I32,
                         _P],
    "fused_masses_bwd": [_P, _I64, _P, _I32, _P, _I32, _P, _I32, _P, _P, _P,
                         _P, _P, _I32, _P, _P],
}


def _check_cuda_args(values, edges, sigma, start, window):
    for name, t, dtype in (("values", values, torch.float32),
                           ("bin_edges", edges, torch.float32),
                           ("sigma", sigma, torch.float32),
                           ("start", start, torch.int32)):
        if t.device != values.device or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} on {values.device}, "
                             f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if sigma.dim() > 1 or (sigma.dim() == 1
                           and sigma.shape != values.shape):
        raise ValueError("sigma must be 0-d or of values' shape")
    if start.shape != values.shape:
        raise ValueError("start must have values' shape")
    n_edges = edges.shape[0]
    if not 2 <= n_edges <= MAX_FUSED_EDGES:
        raise ValueError(f"between 2 and {MAX_FUSED_EDGES} bin edges "
                         "supported")
    if not 2 <= window <= min(MAX_WINDOW, n_edges):
        raise ValueError(f"window must be in [2, {MAX_WINDOW}] and at most "
                         f"the edge count, got {window}")


def fused_masses_fwd_cuda(values, edges, sigma, start, window):
    """Window masses ``(W-1, N)``, slot-major, by the CUDA kernel.
    ``sigma`` is 0-d or ``(N,)``; ``start`` is int32 with
    ``0 <= start_i <= E - W`` (as :func:`~.binned.window_starts` gives)."""
    _check_cuda_args(values, edges, sigma, start, window)
    lib = cuda_build.load(SOURCE, _SIGNATURES)
    n, n_edges = values.shape[0], edges.shape[0]
    with torch.cuda.device(values.device):
        grid = cuda_build.grid(n, values.device)
        masses = torch.empty((window - 1, n), dtype=torch.float32,
                             device=values.device)
        stream = torch.cuda.current_stream(values.device).cuda_stream
        code = lib.fused_masses_fwd(values.data_ptr(), n, edges.data_ptr(),
                                    n_edges, sigma.data_ptr(),
                                    int(sigma.dim() > 0), start.data_ptr(),
                                    window, masses.data_ptr(), grid, stream)
    cuda_build.raise_on(code, "fused_masses_fwd")
    fused_masses_fwd_cuda.launches += 1
    return masses


def fused_masses_bwd_cuda(values, edges, sigma, start, window, g,
                          need_dewin=False):
    """``(dvalues, dewin, dsigma)`` by the CUDA kernel for the slot-major
    cotangent ``g`` ``(W-1, N)``; ``dewin`` ``(W, N)`` only if asked."""
    _check_cuda_args(values, edges, sigma, start, window)
    if g.dtype != torch.float32 or not g.is_contiguous() \
            or tuple(g.shape) != (window - 1, values.shape[0]):
        raise ValueError("g must be a contiguous float32 (W-1, N) tensor")
    lib = cuda_build.load(SOURCE, _SIGNATURES)
    n, n_edges = values.shape[0], edges.shape[0]
    vec = sigma.dim() > 0
    with torch.cuda.device(values.device):
        grid = cuda_build.grid(n, values.device)
        dv = torch.empty_like(values)
        dewin = (torch.empty((window, n), dtype=torch.float32,
                             device=values.device) if need_dewin else None)
        ds = torch.empty_like(values) if vec else None
        partials = None if vec else torch.empty(
            grid, dtype=torch.float32, device=values.device)
        ds_sum = None if vec else torch.empty(
            1, dtype=torch.float32, device=values.device)
        stream = torch.cuda.current_stream(values.device).cuda_stream
        code = lib.fused_masses_bwd(
            values.data_ptr(), n, edges.data_ptr(), n_edges,
            sigma.data_ptr(), int(vec), start.data_ptr(), window,
            g.data_ptr(), dv.data_ptr(),
            None if dewin is None else dewin.data_ptr(),
            None if ds is None else ds.data_ptr(),
            None if partials is None else partials.data_ptr(), grid,
            None if ds_sum is None else ds_sum.data_ptr(), stream)
    cuda_build.raise_on(code, "fused_masses_bwd")
    fused_masses_bwd_cuda.launches += 1
    if not vec:
        ds = -(ds_sum[0] * _inv(sigma) * (_SQRT2 * _INV_SQRT_PI))
    return dv, dewin, ds


fused_masses_fwd_cuda.launches = 0
fused_masses_bwd_cuda.launches = 0


# --------------------------------------------------------------------------
# Dispatch by device, autograd, entry point
# --------------------------------------------------------------------------
class FusedMasses(torch.autograd.Function):
    """Window masses ``(W-1, N)``, slot-major, with the analytic backward
    of the TPU kernel's ``custom_vjp``:
    ``apply(values, edges, sigma, start, window)``."""

    @staticmethod
    def forward(ctx, values, edges, sigma, start, window):
        ctx.save_for_backward(values, edges, sigma, start)
        ctx.window = window
        if values.is_cuda:
            return fused_masses_fwd_cuda(values, edges, sigma, start, window)
        return fused_masses_fwd_plain(values, edges, sigma, start, window)

    @staticmethod
    def backward(ctx, g):
        from .binned import slot_diagonal_sum, window_rows
        values, edges, sigma, start = ctx.saved_tensors
        need = ctx.needs_input_grad
        g = g.contiguous()
        bwd = fused_masses_bwd_cuda if values.is_cuda \
            else fused_masses_bwd_plain
        dv, dewin, ds = bwd(values, edges, sigma, start, ctx.window, g,
                            need_dewin=need[1])
        dedges = None
        if need[1]:
            # The transpose of the window gather e[s_i + w]: add each
            # slot's cotangents onto the edges its particles read.
            dedges = slot_diagonal_sum(
                window_rows(dewin, start, edges.shape[0]), edges.shape[0])
        return (dv if need[0] else None, dedges,
                ds.reshape(sigma.shape) if need[2] else None, None, None)


def fused_masses(values, edges, sigma, start, window):
    """Differentiable window masses, ``(N, W-1)`` (a view of the
    slot-major ``(W-1, N)`` result) — the port's ``_fused_masses_core``."""
    return FusedMasses.apply(values, edges, sigma, start, window).t()


def erf_counts_fused(values, bin_edges, sigma, window: int):
    """Fused (windowed scatter-into-bins) smoothed histogram — the port's
    ``binned_erf_counts_fused_pallas``.

    Each particle's cdf is evaluated at only ``window`` consecutive edges
    around its value; the windowed masses come from the kernels (or their
    plain versions on the CPU) and are added into the ``(E-1,)`` counts by
    :func:`~.binned.scatter_bin_masses`.  Differentiable in ``values``,
    ``bin_edges`` and ``sigma`` (a scalar or one width per particle).
    ``window`` is clipped to the edge count and must then lie in
    ``[2, 128]``.
    """
    from .binned import scatter_bin_masses, window_starts
    values = torch.as_tensor(values)
    vec = check_sigma_shape(values, sigma)
    device = values.device
    edges = torch.as_tensor(bin_edges, dtype=torch.float32,
                            device=device).contiguous()
    n_edges = edges.shape[0]
    window = int(min(window, n_edges))
    if not 2 <= window <= MAX_WINDOW:
        raise ValueError(f"window must be in [2, {MAX_WINDOW}], "
                         f"got {window}")
    values = values.to(torch.float32).contiguous()
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=device)
    sigma = sigma.contiguous() if vec else sigma.reshape(())
    start = window_starts(
        torch.clamp(values.detach(), -PAD_VALUE, PAD_VALUE), edges,
        sigma.detach(), window)
    masses = fused_masses(values, edges, sigma, start, window)
    return scatter_bin_masses(masses, start, n_edges)
