"""Dense erf-CDF binned counts: CUDA kernels, their plain versions, autograd.

Counterpart of the dense half of :mod:`multigrad_tpu.ops.pallas_kernels`
(``binned_erf_counts_pallas``), with a scalar or a per-particle sigma.
The forward computes, for ``inv_i = 1/(√2 σ_i)``,

    counts_b = Σ_i [Φ((e_{b+1} − v_i)·inv_i) − Φ((e_b − v_i)·inv_i)]

with the per-particle difference taken before the sum over particles,
and the backward all three gradients from one shared ``P = exp(−z²)``,
with ``h_e = g_{e−1} − g_e``:

    dJ/dv_i = −(inv_i/√π) Σ_e h_e P_{e,i}
    dJ/de_e =  (1/√π) h_e Σ_i inv_i P_{e,i}
    dJ/dσ_i = −(1/(σ_i√π)) Σ_e h_e P_{e,i} z_{e,i}

(with a scalar sigma, ``inv`` leaves the sum and dJ/dσ sums over i too).

On a CUDA tensor the hand-written kernels of ``csrc/erf_counts.cu`` run
(built with ``nvcc`` for ``sm_90a`` at first use, loaded with ctypes,
see :mod:`.cuda_build`); on a CPU tensor the plain PyTorch versions
(:func:`erf_counts_fwd_plain`, :func:`erf_counts_bwd_plain`) run.  The
tensor's device decides; there is no fallback from one to the other.
A CUDA call is one kernel launch: the backward forms ``h`` from ``g``
and applies every factor above inside the kernel, and the blocks'
partial sums are added up by the last block to finish.

Each kernel wrapper counts its launches in a plain integer attribute
(``erf_counts_fwd_cuda.launches`` and ``erf_counts_bwd_cuda.launches``
for a scalar sigma, ``erf_counts_fwd_vec_cuda.launches`` and
``erf_counts_bwd_vec_cuda.launches`` for a per-particle one), so a run
can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import cuda_build
from .kernel_costs import declare_kernel, erf_bwd_ops, erf_fwd_ops

_SQRT2 = 1.4142135623730951
_INV_SQRT_PI = 0.5641895835477563
_SQRT_PI = math.sqrt(math.pi)

#: Padding sentinel for the particle axis (``pallas_kernels._PAD_VALUE``).
#: ``±inf`` values are clipped to it: at ±1e18 the cdf still saturates
#: exactly, while z stays finite, so a padded particle's ``p·z`` term is
#: 0 instead of ``0·inf = NaN``.
PAD_VALUE = 1e18

#: Most bin edges the kernels take (the TPU kernel's lane count).
MAX_EDGES = 128

# XLA's float32 erf rational approximation: clamp to ±4, then
# x·P(x²)/Q(x²).  The same constants are in csrc/erf_counts.cu.
_ERF_ALPHA = (-2.72614225801306e-10, 2.77068142495902e-08,
              -2.10102402082508e-06, -5.69250639462346e-05,
              -7.34990630326855e-04, -2.95459980854025e-03,
              -1.60960333262415e-02)
_ERF_BETA = (-1.45660718464996e-05, -2.13374055278905e-04,
             -1.68282697438203e-03, -7.37332916720468e-03,
             -1.42647390514189e-02)

#: The kernels' source under ``csrc/`` (built by :mod:`.cuda_build`).
SOURCE = "erf_counts.cu"


def _erf_f32(x):
    """XLA's f32 erf (``pallas_kernels._erf_f32``), elementwise."""
    x = torch.clamp(x, -4.0, 4.0)
    x2 = x * x
    alpha = torch.full_like(x, _ERF_ALPHA[0])
    for c in _ERF_ALPHA[1:]:
        alpha = alpha * x2 + c
    beta = torch.full_like(x, _ERF_BETA[0])
    for c in _ERF_BETA[1:]:
        beta = beta * x2 + c
    return x * alpha / beta


class _Erf(torch.autograd.Function):
    """:func:`_erf_f32` with the derivative of the exact erf,
    ``2/√π·exp(−x²)`` (lax.erf's rule), not the polynomial's."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _erf_f32(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (2.0 * _INV_SQRT_PI) * torch.exp(-(x * x))


def erf(x):
    """The kernels' float32 erf, differentiable as the exact erf is."""
    return _Erf.apply(x)


# --------------------------------------------------------------------------
# Plain PyTorch versions
# --------------------------------------------------------------------------
def _chunks(values, sigma, chunk_size):
    """``(values, sigma)`` pieces of at most ``chunk_size`` particles; a
    scalar sigma goes whole with every piece."""
    if chunk_size is None or values.shape[0] <= chunk_size:
        return ((values, sigma),)
    pieces = torch.split(values, int(chunk_size))
    if sigma.dim():
        return zip(pieces, torch.split(sigma, int(chunk_size)))
    return ((v, sigma) for v in pieces)


def _inv(sigma):
    return 1.0 / (_SQRT2 * sigma)


def _as_sigma(sigma, values):
    return torch.as_tensor(sigma, dtype=torch.float32, device=values.device)


def erf_counts_fwd_plain(values, edges, sigma, chunk_size=None):
    """Forward counts ``(E-1,)``, one ``(E, chunk)`` cdf block at a time,
    for a scalar or a per-particle ``(N,)`` sigma.

    ``chunk_size`` bounds the working memory at ``E·chunk_size`` floats.
    """
    sigma = _as_sigma(sigma, values)
    counts = torch.zeros(edges.shape[0] - 1, dtype=torch.float32,
                         device=values.device)
    for v, s in _chunks(values, sigma, chunk_size):
        v = torch.clamp(v, -PAD_VALUE, PAD_VALUE)
        cdf = 0.5 * (1.0 + _erf_f32((edges[:, None] - v[None, :]) * _inv(s)))
        counts = counts + torch.diff(cdf, dim=0).sum(dim=1)
    return counts


def erf_counts_bwd_plain(values, edges, sigma, g, chunk_size=None):
    """``(dvalues, dedges, dsigma)`` for the cotangent ``g`` of the counts;
    ``dsigma`` has sigma's shape (a scalar, or ``(N,)`` per particle)."""
    sigma = _as_sigma(sigma, values)
    vec = sigma.dim() > 0
    h = _h_from_g(g)
    dv_raw, hz, rows, pz = [], [], 0.0, 0.0
    for v, s in _chunks(values, sigma, chunk_size):
        v = torch.clamp(v, -PAD_VALUE, PAD_VALUE)
        inv = _inv(s)
        z = (edges[:, None] - v[None, :]) * inv
        p = torch.exp(-(z * z))
        dv_raw.append((h[:, None] * p).sum(dim=0))
        if vec:
            rows = rows + (inv * p).sum(dim=1)
            hz.append((h[:, None] * (p * z)).sum(dim=0))
        else:
            rows = rows + p.sum(dim=1)
            pz = pz + (p * z).sum(dim=1)
    if vec:
        return _scale_vec_grads(torch.cat(dv_raw), rows, torch.cat(hz), h,
                                sigma)
    return _scale_grads(torch.cat(dv_raw), rows, (h * pz).sum(), h, sigma)


def _h_from_g(g):
    # h_e = g_{e-1} - g_e with g_{-1} = g_{E-1} = 0.
    zero = g.new_zeros(1)
    return torch.cat([zero, g]) - torch.cat([g, zero])


def _scale_grads(dv_raw, rows, hpz, h, sigma):
    """Apply the constant factors to the raw reductions (in place on
    ``dv_raw``), as ``pallas_kernels._erf_counts_bwd`` does."""
    scale = _inv(sigma) * _INV_SQRT_PI
    dvalues = dv_raw.mul_(-scale)
    dedges = scale * h * rows
    dsigma = -(hpz / (sigma * _SQRT_PI))
    return dvalues, dedges, dsigma


def _scale_vec_grads(dv_raw, rows, hz, h, sigma):
    """The per-particle-sigma factors, as the CUDA kernel applies them:
    ``dv_i = -(inv_i/√π) Σ_e h_e P``, ``dσ_i = -(inv_i √2/√π) Σ_e h_e P z``
    (``= -(1/(σ_i √π)) Σ_e h_e P z``); ``rows`` already carry ``inv_i``."""
    inv = _inv(sigma)
    return (-(inv * _INV_SQRT_PI) * dv_raw, _INV_SQRT_PI * h * rows,
            -(inv * (_SQRT2 * _INV_SQRT_PI)) * hz)


# --------------------------------------------------------------------------
# CUDA kernels: wrappers
# --------------------------------------------------------------------------
_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "erf_counts_fwd": [_P, _I64, _P, _I32, _P, _I32, _P, _P, _I32, _P, _P],
    "erf_counts_bwd": [_P, _I64, _P, _I32, _P, _I32, _P, _P, _P, _P, _P, _P,
                       _I32, _P],
}

#: Particles a kernel thread takes per step (``kPer`` in the source).
PER_THREAD = 4


def _lib():
    return cuda_build.load(SOURCE, _SIGNATURES)


def erf_grid(n: int, sms: int) -> int:
    """Blocks for ``n`` particles on ``sms`` SMs, by the one-launch
    kernels' rule (:func:`~.cuda_build.one_launch_grid`): a block per
    4,096 particles (four steps of ``PER_THREAD`` a thread) or more, the
    same number on every SM, at most 16 an SM (the grid-stride loop takes
    the rest)."""
    return cuda_build.one_launch_grid(n, sms, MAX_EDGES + 1)


def _check_cuda_args(values, edges, sigma, vec, g=None):
    for name, t in (("values", values), ("bin_edges", edges),
                    ("sigma", sigma), ("g", g)):
        if t is None:
            continue
        if t.device != values.device or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {values.device}, "
                             f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if vec and sigma.shape != values.shape:
        raise ValueError(f"a per-particle sigma must have values' shape "
                         f"{tuple(values.shape)}, got {tuple(sigma.shape)}")
    if not vec and sigma.numel() != 1:
        raise ValueError("a scalar sigma must be a one-element tensor")
    if not 2 <= edges.shape[0] <= MAX_EDGES:
        raise ValueError(f"between 2 and {MAX_EDGES} bin edges supported")
    if g is not None and g.shape != (edges.shape[0] - 1,):
        raise ValueError(f"the cotangent must have shape "
                         f"({edges.shape[0] - 1},), got {tuple(g.shape)}")


def _launch_fwd(values, edges, sigma, vec):
    _check_cuda_args(values, edges, sigma, vec)
    lib = _lib()
    n, n_edges, device = values.shape[0], edges.shape[0], values.device
    counts = torch.empty(n_edges - 1, dtype=torch.float32, device=device)
    ws = cuda_build.workspace(device)
    code = cuda_build.call(
        device, lib.erf_counts_fwd, values.data_ptr(), n, edges.data_ptr(),
        n_edges, sigma.data_ptr(), int(vec), ws.partials,
        ws.counter(cuda_build.ERF_FWD), erf_grid(n, ws.sms),
        counts.data_ptr(), ws.stream)
    cuda_build.raise_on(code, "erf_counts_fwd")
    return counts


def _launch_bwd(values, edges, sigma, g, vec):
    _check_cuda_args(values, edges, sigma, vec, g)
    lib = _lib()
    n, n_edges, device = values.shape[0], edges.shape[0], values.device
    dv = torch.empty_like(values)
    de = torch.empty_like(edges)
    ds = torch.empty_like(values) if vec else torch.empty(
        (), dtype=torch.float32, device=device)
    ws = cuda_build.workspace(device)
    code = cuda_build.call(
        device, lib.erf_counts_bwd, values.data_ptr(), n, edges.data_ptr(),
        n_edges, sigma.data_ptr(), int(vec), g.data_ptr(), dv.data_ptr(),
        de.data_ptr(), ds.data_ptr(), ws.partials,
        ws.counter(cuda_build.ERF_BWD), erf_grid(n, ws.sms), ws.stream)
    cuda_build.raise_on(code, "erf_counts_bwd")
    return dv, de, ds


def erf_counts_fwd_cuda(values, edges, sigma):
    """Forward counts ``(E-1,)`` by the CUDA kernel, scalar sigma (float32,
    contiguous, one device; ``sigma`` a one-element tensor)."""
    counts = _launch_fwd(values, edges, sigma, vec=False)
    erf_counts_fwd_cuda.launches += 1
    return counts


def erf_counts_fwd_vec_cuda(values, edges, sigma):
    """Forward counts ``(E-1,)`` by the CUDA kernel, per-particle sigma
    (``sigma`` of values' shape)."""
    counts = _launch_fwd(values, edges, sigma, vec=True)
    erf_counts_fwd_vec_cuda.launches += 1
    return counts


def erf_counts_bwd_cuda(values, edges, sigma, g):
    """``(dvalues, dedges, dsigma)`` by the CUDA kernel, scalar sigma, for
    the float32 cotangent ``g`` ``(E-1,)`` of the counts; the kernel
    scales all three (``dsigma`` 0-d)."""
    grads = _launch_bwd(values, edges, sigma, g, vec=False)
    erf_counts_bwd_cuda.launches += 1
    return grads


def erf_counts_bwd_vec_cuda(values, edges, sigma, g):
    """``(dvalues, dedges, dsigma)`` by the CUDA kernel, per-particle
    sigma, all three scaled by the kernel."""
    grads = _launch_bwd(values, edges, sigma, g, vec=True)
    erf_counts_bwd_vec_cuda.launches += 1
    return grads


erf_counts_fwd_cuda.launches = 0
erf_counts_fwd_vec_cuda.launches = 0
erf_counts_bwd_cuda.launches = 0
erf_counts_bwd_vec_cuda.launches = 0


# --------------------------------------------------------------------------
# Dispatch by device, autograd, entry point
# --------------------------------------------------------------------------
def erf_counts_fwd(values, edges, sigma, chunk_size=None):
    """Forward counts: the kernel on CUDA tensors, the plain version on
    CPU tensors (``chunk_size`` bounds the plain version's memory); on
    meta tensors, inside the static cost model, the kernel's declared
    count and an empty result."""
    if values.is_meta:
        vec, n, n_edges = sigma.dim() > 0, values.shape[0], edges.shape[0]
        declare_kernel("erf_counts_fwd_vec" if vec else "erf_counts_fwd",
                       erf_fwd_ops(n, n_edges, vec), erf=n * n_edges)
        return torch.empty(n_edges - 1, dtype=torch.float32, device="meta")
    if values.is_cuda:
        if sigma.dim():
            return erf_counts_fwd_vec_cuda(values, edges, sigma)
        return erf_counts_fwd_cuda(values, edges, sigma.reshape(1))
    return erf_counts_fwd_plain(values, edges, sigma, chunk_size)


def erf_counts_bwd(values, edges, sigma, g, chunk_size=None):
    """``(dvalues, dedges, dsigma)``: the kernel on CUDA tensors, the
    plain version on CPU tensors, the declared count on meta tensors."""
    if values.is_meta:
        vec, n, n_edges = sigma.dim() > 0, values.shape[0], edges.shape[0]
        declare_kernel("erf_counts_bwd_vec" if vec else "erf_counts_bwd",
                       erf_bwd_ops(n, n_edges, vec), exp=n * n_edges)
        return (torch.empty_like(values), torch.empty_like(edges),
                torch.empty_like(sigma))
    if values.is_cuda:
        if sigma.dim():
            return erf_counts_bwd_vec_cuda(values, edges, sigma, g)
        return erf_counts_bwd_cuda(values, edges, sigma.reshape(1), g)
    return erf_counts_bwd_plain(values, edges, sigma, g, chunk_size)


class ErfCounts(torch.autograd.Function):
    """Smoothed counts with the analytic backward of the TPU kernel's
    ``custom_vjp``: ``apply(values, edges, sigma, chunk_size)``."""

    @staticmethod
    def forward(ctx, values, edges, sigma, chunk_size):
        ctx.save_for_backward(values, edges, sigma)
        ctx.chunk_size = chunk_size
        return erf_counts_fwd(values, edges, sigma, chunk_size)

    @staticmethod
    def backward(ctx, g):
        values, edges, sigma = ctx.saved_tensors
        dv, de, ds = erf_counts_bwd(values, edges, sigma, g.contiguous(),
                                    ctx.chunk_size)
        need = ctx.needs_input_grad
        return (dv if need[0] else None, de if need[1] else None,
                ds.reshape(sigma.shape) if need[2] else None, None)


def check_sigma_shape(values, sigma):
    """Raise unless ``sigma`` is a scalar or has ``values``' shape."""
    vshape = tuple(torch.as_tensor(values).shape)
    sshape = tuple(torch.as_tensor(sigma).shape)
    if len(sshape) > 1 or (len(sshape) == 1 and sshape != vshape):
        raise ValueError(
            f"sigma must be a scalar or match values' shape {vshape}, "
            f"got {sshape}")
    return len(sshape) == 1


def erf_counts(values, bin_edges, sigma, chunk_size=None):
    """Differentiable smoothed histogram — the port's
    ``binned_erf_counts_pallas``.

    Parameters
    ----------
    values : (N,) tensor
    bin_edges : (B+1,) tensor, ``2 <= B+1 <= 128``
    sigma : float, 0-d tensor or (N,) tensor
        Gaussian smoothing width: one for all particles, or one per
        particle (mass-dependent scatter).
    chunk_size : int, optional
        Bounds the plain (CPU) version's ``(E, chunk)`` working memory;
        the CUDA kernels stream any N and ignore it.
    """
    values = torch.as_tensor(values)
    vec = check_sigma_shape(values, sigma)
    if torch.as_tensor(bin_edges).shape[0] > MAX_EDGES:
        raise ValueError(f"at most {MAX_EDGES} bin edges supported")
    device = values.device
    values = values.to(torch.float32).contiguous()
    edges = torch.as_tensor(bin_edges, dtype=torch.float32,
                            device=device).contiguous()
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=device)
    sigma = sigma.contiguous() if vec else sigma.reshape(())
    return ErfCounts.apply(values, edges, sigma, chunk_size)
