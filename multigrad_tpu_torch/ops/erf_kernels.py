"""Dense erf-CDF binned counts: CUDA kernels, their plain versions, autograd.

Counterpart of the dense, scalar-sigma half of
:mod:`multigrad_tpu.ops.pallas_kernels` (``binned_erf_counts_pallas``).
The forward computes, for ``inv = 1/(√2 σ)``,

    counts_b = Σ_i [Φ((e_{b+1} − v_i)·inv) − Φ((e_b − v_i)·inv)]

with the per-particle difference taken before the sum over particles,
and the backward all three gradients from one shared ``P = exp(−z²)``,
with ``h_e = g_{e−1} − g_e``:

    dJ/dv_i = −(inv/√π) Σ_e h_e P_{e,i}
    dJ/de_e =  (inv/√π) h_e Σ_i P_{e,i}
    dJ/dσ   = −(1/(σ√π)) Σ_{e,i} h_e P_{e,i} z_{e,i}

On a CUDA tensor the two hand-written kernels of ``csrc/erf_counts.cu``
run (built with ``nvcc`` for ``sm_90a`` at first use, loaded with
ctypes); on a CPU tensor the plain PyTorch versions
(:func:`erf_counts_fwd_plain`, :func:`erf_counts_bwd_plain`) run.  The
tensor's device decides; there is no fallback from one to the other.

Each kernel wrapper counts its launches in a plain integer attribute
(``erf_counts_fwd_cuda.launches``, ``erf_counts_bwd_cuda.launches``), so
a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

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

_THREADS = 256          # kThreads in erf_counts.cu
_BLOCKS_PER_SM = 8      # grid cap: enough resident blocks to fill an SM

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCE = _CSRC / "erf_counts.cu"
#: Where the shared library is built: ``build/multigrad_tpu_torch/``
#: beside the package.
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "multigrad_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


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


# --------------------------------------------------------------------------
# Plain PyTorch versions
# --------------------------------------------------------------------------
def _chunks(values, chunk_size):
    if chunk_size is None or values.shape[0] <= chunk_size:
        return (values,)
    return torch.split(values, int(chunk_size))


def _inv(sigma):
    return 1.0 / (_SQRT2 * sigma)


def erf_counts_fwd_plain(values, edges, sigma, chunk_size=None):
    """Forward counts ``(E-1,)``, one ``(E, chunk)`` cdf block at a time.

    ``chunk_size`` bounds the working memory at ``E·chunk_size`` floats.
    """
    inv = _inv(sigma)
    counts = torch.zeros(edges.shape[0] - 1, dtype=torch.float32,
                         device=values.device)
    for v in _chunks(values, chunk_size):
        v = torch.clamp(v, -PAD_VALUE, PAD_VALUE)
        cdf = 0.5 * (1.0 + _erf_f32((edges[:, None] - v[None, :]) * inv))
        counts = counts + torch.diff(cdf, dim=0).sum(dim=1)
    return counts


def erf_counts_bwd_plain(values, edges, sigma, g, chunk_size=None):
    """``(dvalues, dedges, dsigma)`` for the cotangent ``g`` of the counts."""
    inv = _inv(sigma)
    h = _h_from_g(g)
    dv_raw, rows, pz = [], 0.0, 0.0
    for v in _chunks(values, chunk_size):
        v = torch.clamp(v, -PAD_VALUE, PAD_VALUE)
        z = (edges[:, None] - v[None, :]) * inv
        p = torch.exp(-(z * z))
        dv_raw.append((h[:, None] * p).sum(dim=0))
        rows = rows + p.sum(dim=1)
        pz = pz + (p * z).sum(dim=1)
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


# --------------------------------------------------------------------------
# CUDA kernels: build, load, wrappers
# --------------------------------------------------------------------------
_LIB = None
_LIB_LOCK = threading.Lock()


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" \
        / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the erf_counts kernels are built "
                       "from csrc/erf_counts.cu at first use")


def build():
    """Compile ``csrc/erf_counts.cu`` unless a library built from the same
    source exists; return its path.  The file name carries the source's
    hash, so an edited source is rebuilt."""
    digest = hashlib.sha256(_SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"liberf_counts_{digest[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_SOURCE)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, lib)
    except subprocess.CalledProcessError as err:
        raise RuntimeError(f"nvcc failed on {_SOURCE}:\n{err.stderr}") \
            from err
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.erf_counts_fwd.argtypes = [p, i64, p, i32, p, p, i32, p, p]
            lib.erf_counts_fwd.restype = i32
            lib.erf_counts_bwd.argtypes = [p, i64, p, i32, p, p, p, p, i32,
                                           p, p]
            lib.erf_counts_bwd.restype = i32
            _LIB = lib
    return _LIB


def _grid(n, device):
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-n // _THREADS), sms * _BLOCKS_PER_SM))


def _check_cuda_args(values, edges, sigma):
    for name, t in (("values", values), ("bin_edges", edges),
                    ("sigma", sigma)):
        if t.device != values.device or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {values.device}, "
                             f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if sigma.numel() != 1:
        raise ValueError("the CUDA kernels take a scalar sigma")
    if not 2 <= edges.shape[0] <= MAX_EDGES:
        raise ValueError(f"between 2 and {MAX_EDGES} bin edges supported")


def _raise_on(code, name):
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code}")


def erf_counts_fwd_cuda(values, edges, sigma):
    """Forward counts ``(E-1,)`` by the CUDA kernel (float32, contiguous,
    one device; ``sigma`` a one-element tensor)."""
    _check_cuda_args(values, edges, sigma)
    lib = _lib()
    n, n_edges = values.shape[0], edges.shape[0]
    with torch.cuda.device(values.device):
        grid = _grid(n, values.device)
        partials = torch.empty((grid, n_edges - 1), dtype=torch.float32,
                               device=values.device)
        counts = torch.empty(n_edges - 1, dtype=torch.float32,
                             device=values.device)
        stream = torch.cuda.current_stream(values.device).cuda_stream
        code = lib.erf_counts_fwd(values.data_ptr(), n, edges.data_ptr(),
                                  n_edges, sigma.data_ptr(),
                                  partials.data_ptr(), grid,
                                  counts.data_ptr(), stream)
    _raise_on(code, "erf_counts_fwd")
    erf_counts_fwd_cuda.launches += 1
    return counts


def erf_counts_bwd_cuda(values, edges, sigma, g):
    """``(dvalues, dedges, dsigma)`` by the CUDA kernel, for the cotangent
    ``g`` ``(E-1,)`` of the counts."""
    _check_cuda_args(values, edges, sigma)
    lib = _lib()
    n, n_edges = values.shape[0], edges.shape[0]
    h = _h_from_g(g.to(torch.float32)).contiguous()
    with torch.cuda.device(values.device):
        grid = _grid(n, values.device)
        dv_raw = torch.empty_like(values)
        partials = torch.empty((grid, n_edges + 1), dtype=torch.float32,
                               device=values.device)
        sums = torch.empty(n_edges + 1, dtype=torch.float32,
                           device=values.device)
        stream = torch.cuda.current_stream(values.device).cuda_stream
        code = lib.erf_counts_bwd(values.data_ptr(), n, edges.data_ptr(),
                                  n_edges, sigma.data_ptr(), h.data_ptr(),
                                  dv_raw.data_ptr(), partials.data_ptr(),
                                  grid, sums.data_ptr(), stream)
    _raise_on(code, "erf_counts_bwd")
    erf_counts_bwd_cuda.launches += 1
    return _scale_grads(dv_raw, sums[:n_edges], sums[n_edges], h,
                        sigma.reshape(()))


erf_counts_fwd_cuda.launches = 0
erf_counts_bwd_cuda.launches = 0


# --------------------------------------------------------------------------
# Dispatch by device, autograd, entry point
# --------------------------------------------------------------------------
def erf_counts_fwd(values, edges, sigma, chunk_size=None):
    """Forward counts: the kernel on CUDA tensors, the plain version on
    CPU tensors (``chunk_size`` bounds the plain version's memory)."""
    if values.is_cuda:
        return erf_counts_fwd_cuda(values, edges, sigma.reshape(1))
    return erf_counts_fwd_plain(values, edges, sigma, chunk_size)


def erf_counts_bwd(values, edges, sigma, g, chunk_size=None):
    """``(dvalues, dedges, dsigma)``: the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if values.is_cuda:
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


def erf_counts(values, bin_edges, sigma, chunk_size=None):
    """Differentiable smoothed histogram — the port's
    ``binned_erf_counts_pallas``.

    Parameters
    ----------
    values : (N,) tensor
    bin_edges : (B+1,) tensor, ``2 <= B+1 <= 128``
    sigma : float or 0-d tensor
        Gaussian smoothing width.  A per-particle ``(N,)`` sigma passes
        the shape check but is not ported yet (ROADMAP Queue 2 item 1).
    chunk_size : int, optional
        Bounds the plain (CPU) version's ``(E, chunk)`` working memory;
        the CUDA kernels stream any N and ignore it.
    """
    values = torch.as_tensor(values)
    vshape = tuple(values.shape)
    sshape = tuple(torch.as_tensor(sigma).shape)
    if len(sshape) > 1 or (len(sshape) == 1 and sshape != vshape):
        raise ValueError(
            f"sigma must be a scalar or match values' shape {vshape}, "
            f"got {sshape}")
    if torch.as_tensor(bin_edges).shape[0] > MAX_EDGES:
        raise ValueError(f"at most {MAX_EDGES} bin edges supported")
    if len(sshape) == 1:
        raise NotImplementedError(
            "per-particle sigma is not ported yet (ROADMAP Queue 2 item 1)")
    device = values.device
    values = values.to(torch.float32).contiguous()
    edges = torch.as_tensor(bin_edges, dtype=torch.float32,
                            device=device).contiguous()
    sigma = torch.as_tensor(sigma, dtype=torch.float32,
                            device=device).reshape(())
    return ErfCounts.apply(values, edges, sigma, chunk_size)
