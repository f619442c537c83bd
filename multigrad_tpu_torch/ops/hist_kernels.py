"""The history model's chunk on the card: CUDA kernels and autograd.

One chunk of :class:`~multigrad_tpu_torch.models.galhalo_hist
.GalhaloHistModel` — each halo's mass accretion history, star-formation
rate, cumulative trapezoid and readout at the K observation epochs —
as one forward and one backward launch of ``csrc/hist_history.cu``
behind :class:`HistoryBlock`.  The forward writes the mean log10 M*
``(K, n)`` and nothing else; the backward recomputes each halo and
returns the gradient of the ten parameters (``sigma_0`` and
``sigma_slope``, which only the scatter reads, get 0).

The plain version is the model's own PyTorch block
(``models/galhalo_hist.py``, ``_mean_log_mstar_torch``), which CPU and
meta tensors take; the model chooses by the tensor's device alone, and
a grid of more than :data:`MAX_TIMES` steps or more than
:data:`MAX_EPOCHS` epochs is refused on the card with a ValueError.  The
kernels read the parameters from the device tensor and take the epochs
by value: a call copies nothing to the device and waits for nothing.

Each kernel wrapper counts its launches (``history_fwd_cuda.launches``,
``history_bwd_cuda.launches``).
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

#: The kernels' source under ``csrc/`` (built by :mod:`.cuda_build`).
SOURCE = "hist_history.cu"
#: Most time steps and epochs the kernels take (``kMaxTimes``,
#: ``kMaxEpochs`` in the source; the halo's steps live in registers).
MAX_TIMES = 64
MAX_EPOCHS = 64
#: The parameter vector's length (``GalhaloHistParams``).
N_PARAMS = 10

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "hist_history_fwd": [_P, _I64, _P, _P, _I32, _P, _I32, _P, _I32, _P],
    "hist_history_bwd": [_P, _I64, _P, _P, _I32, _P, _I32, _P, _I64, _I64,
                         _P, _P, _I32, _P, _P],
}


def history_grid(n: int, sms: int) -> int:
    """Blocks of both kernels for ``n`` halos on ``sms`` SMs: one thread
    a halo, at most ``MAX_BLOCKS_PER_SM`` blocks an SM (a grid-stride
    loop takes the rest), so the backward's last block adds at most that
    many partials rows."""
    return min(cuda_build.row_blocks(n),
               sms * cuda_build.MAX_BLOCKS_PER_SM)


def param_vector(params, device) -> torch.Tensor:
    """``params`` as the ``(10,)`` float32 tensor on ``device`` the
    kernels read: a tensor moved and cast (itself if it is one already),
    a sequence (numbers or 0-d tensors) stacked, differentiably."""
    if isinstance(params, torch.Tensor):
        return params.to(device, torch.float32)
    return torch.stack([torch.as_tensor(p, dtype=torch.float32,
                                        device=device) for p in params])


def _columns(obs_indices):
    """The epochs' cumulative-sum columns as a C int array (host memory:
    the launcher passes them by value)."""
    return (ctypes.c_int * len(obs_indices))(*[i - 1 for i in obs_indices])


def _check_cuda_args(log_mh0, params, t_grid, obs_indices, g=None):
    device = log_mh0.device
    for name, t in (("log_mh0", log_mh0), ("params", params),
                    ("t_grid", t_grid)):
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name} must be a float32 tensor on {device}"
                             f", got {type(t).__name__}")
        if t.device != device or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {device}, got "
                             f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if log_mh0.dim() != 1 or t_grid.dim() != 1:
        raise ValueError("log_mh0 and t_grid must be 1-d")
    if tuple(params.shape) != (N_PARAMS,):
        raise ValueError(f"params must have shape ({N_PARAMS},), got "
                         f"{tuple(params.shape)}")
    if not (2 <= t_grid.shape[0] <= MAX_TIMES
            and 1 <= len(obs_indices) <= MAX_EPOCHS):
        raise ValueError(f"the kernels take 2 to {MAX_TIMES} time steps and "
                         f"1 to {MAX_EPOCHS} epochs, got {t_grid.shape[0]} "
                         f"and {len(obs_indices)}")
    if min(obs_indices) < 1 or max(obs_indices) >= t_grid.shape[0]:
        raise ValueError(f"obs_indices must lie in [1, {t_grid.shape[0] - 1}]"
                         f", got {list(obs_indices)}")
    if g is not None and (g.device != device or g.dtype != torch.float32
                          or tuple(g.shape) != (len(obs_indices),
                                                log_mh0.shape[0])):
        raise ValueError(f"the cotangent must be float32 of shape "
                         f"({len(obs_indices)}, {log_mh0.shape[0]}) on "
                         f"{device}, got {g.dtype} {tuple(g.shape)} on "
                         f"{g.device}")


def history_fwd_cuda(log_mh0, params, t_grid, obs_indices):
    """Mean log10 M* ``(K, n)`` of the halos ``log_mh0`` ``(n,)`` at the
    epochs ``obs_indices`` (a tuple of grid indices in ``[1, T-1]``), by
    the CUDA kernel; ``params`` ``(10,)``, ``t_grid`` ``(T,)``, all
    float32, contiguous, on one device."""
    _check_cuda_args(log_mh0, params, t_grid, obs_indices)
    lib = cuda_build.load(SOURCE, _SIGNATURES)
    device, n = log_mh0.device, log_mh0.shape[0]
    out = torch.empty((len(obs_indices), n), dtype=torch.float32,
                      device=device)
    ws = cuda_build.workspace(device)
    code = cuda_build.call(
        device, lib.hist_history_fwd, log_mh0.data_ptr(), n,
        params.data_ptr(), t_grid.data_ptr(), t_grid.shape[0],
        _columns(obs_indices), len(obs_indices), out.data_ptr(),
        history_grid(n, ws.sms), ws.stream)
    cuda_build.raise_on(code, "hist_history_fwd")
    history_fwd_cuda.launches += 1
    return out


def history_bwd_cuda(log_mh0, params, t_grid, obs_indices, g):
    """The ``(10,)`` gradient of ``Σ g · out`` with respect to ``params``
    by the CUDA kernel, for the float32 cotangent ``g`` ``(K, n)`` of
    :func:`history_fwd_cuda`'s output (any strides)."""
    _check_cuda_args(log_mh0, params, t_grid, obs_indices, g)
    lib = cuda_build.load(SOURCE, _SIGNATURES)
    device, n = log_mh0.device, log_mh0.shape[0]
    grad = torch.empty(N_PARAMS, dtype=torch.float32, device=device)
    ws = cuda_build.workspace(device)
    code = cuda_build.call(
        device, lib.hist_history_bwd, log_mh0.data_ptr(), n,
        params.data_ptr(), t_grid.data_ptr(), t_grid.shape[0],
        _columns(obs_indices), len(obs_indices), g.data_ptr(), g.stride(1),
        g.stride(0), ws.partials, ws.counter(cuda_build.HIST_BWD),
        history_grid(n, ws.sms), grad.data_ptr(), ws.stream)
    cuda_build.raise_on(code, "hist_history_bwd")
    history_bwd_cuda.launches += 1
    return grad


history_fwd_cuda.launches = 0
history_bwd_cuda.launches = 0


class HistoryBlock(torch.autograd.Function):
    """Mean log10 M* ``(K, n)`` with the kernels' analytic gradient in
    ``params``: ``apply(log_mh0, params, t_grid, obs_indices)``.  The
    halo masses and the time grid are data: a backward that needs their
    gradient raises."""

    @staticmethod
    def forward(ctx, log_mh0, params, t_grid, obs_indices):
        ctx.save_for_backward(log_mh0, params, t_grid)
        ctx.obs_indices = obs_indices
        return history_fwd_cuda(log_mh0, params, t_grid, obs_indices)

    @staticmethod
    def backward(ctx, g):
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[2]:
            raise RuntimeError("the history kernels differentiate the "
                               "parameters only, not log_mh0 or t_grid")
        log_mh0, params, t_grid = ctx.saved_tensors
        dparams = history_bwd_cuda(log_mh0, params, t_grid, ctx.obs_indices,
                                   g) if ctx.needs_input_grad[1] else None
        return None, dparams, None, None


def mean_log_mstar_cuda(log_mh0, params, t_grid, obs_indices):
    """Mean log10 M* ``(n, K)`` (a view of the kernel's ``(K, n)``
    output, so each epoch's column is contiguous) of the halos
    ``log_mh0`` on the card, differentiable in ``params`` (the ``(10,)``
    float32 tensor on the card, :func:`param_vector`)."""
    return HistoryBlock.apply(log_mh0, params, t_grid,
                              tuple(obs_indices)).t()
