"""L-BFGS-B and L-BFGS optimization (port of
:mod:`multigrad_tpu.optim.bfgs`).

:func:`run_bfgs`: scipy's L-BFGS-B runs on the host around the port's
loss-and-grad.  :func:`run_lbfgs_scan`: optax's L-BFGS with its zoom
line search (the JAX package runs it as one ``lax.scan``), written out
in :mod:`._lbfgs` as a host loop whose vectors stay on the device.
Under ``torch.distributed`` every process runs the same loop: its
inputs are all-reduced results, identical on every process, so all
processes follow the same control flow and return the same result.
"""
from __future__ import annotations

import numpy as np
import scipy.optimize
import torch

from . import _lbfgs
from .adam import _wrap_bounded, init_randkey
from .transforms import (bounds_to_arrays, check_strictly_inside,
                         inverse_transform_array, transform_array)
from ..utils.util import resolve_device, trange


def bfgs_trange(n, progress: bool = True):
    """The BFGS loop's progress bar over ``n`` steps (see
    :func:`~multigrad_tpu_torch.utils.util.trange`)."""
    return trange(n, "BFGS Gradient Descent Progress", progress=progress)


def run_bfgs(loss_and_grad_fn, params, maxsteps=100, param_bounds=None,
             randkey=None, comm=None, progress=True, device=None):
    """Run scipy L-BFGS-B on ``loss_and_grad_fn(params[, randkey=key])``.

    The parameters reach ``loss_and_grad_fn`` as float32 tensors on the
    device of ``params`` (``device`` for params that are not a tensor;
    ``None`` means CUDA).  ``randkey`` is held constant across
    iterations (BFGS needs a deterministic objective).  ``comm`` is
    accepted and ignored, as in the JAX package: the loss-and-grad
    function reduces over its own comm.  Returns scipy's
    ``OptimizeResult`` (message, success, fun, x, jac, nfev, nit).
    """
    del comm
    if isinstance(params, torch.Tensor):
        device = params.device
        params = params.detach().cpu().numpy()
    else:
        device = resolve_device(device)
    kwargs = {}
    if randkey is not None:
        kwargs["randkey"] = init_randkey(randkey)
    pbar = bfgs_trange(maxsteps, progress=progress)

    # Outside the model's domain the loss can go NaN/inf.  scipy's line
    # search must see a finite, moderate penalty there (non-finite
    # values make it extrapolate instead of backtrack): 100x the
    # running max of the finite losses.
    max_finite_loss = [None]

    def fun(x):
        loss, grad = loss_and_grad_fn(
            torch.as_tensor(x, dtype=torch.float32, device=device), **kwargs)
        loss = float(loss)
        grad = grad.detach().cpu().numpy().astype(np.float64)
        if np.isfinite(loss):
            prev = max_finite_loss[0]
            max_finite_loss[0] = max(prev or 1.0, abs(loss), 1.0)
        elif max_finite_loss[0] is None:
            raise ValueError(
                f"run_bfgs: loss is non-finite ({loss}) at the initial "
                f"guess {np.asarray(x)}; start inside the model's domain "
                "or pass param_bounds")
        else:
            loss = 100.0 * max_finite_loss[0]
            grad = np.where(np.isfinite(grad), grad, 0.0)
        return loss, grad

    def callback(*_args, **_kwargs):
        if hasattr(pbar, "update"):
            pbar.update()

    try:
        return scipy.optimize.minimize(
            fun, x0=np.asarray(params, dtype=np.float64),
            method="L-BFGS-B", jac=True, options=dict(maxiter=maxsteps),
            callback=callback, bounds=param_bounds)
    finally:
        if hasattr(pbar, "close"):
            pbar.close()


def _lbfgs_fit(loss_and_grad_fn, params, maxsteps=100, randkey=None,
               memory_size=10, param_bounds=None, device=None,
               on_step=None):
    """:func:`run_lbfgs_scan`, with ``on_step`` handed to
    :func:`._lbfgs.lbfgs` (it sees each step's line search)."""
    kwargs = {} if randkey is None else {"randkey": init_randkey(randkey)}
    if isinstance(params, torch.Tensor):
        params = params.detach().to(torch.float32)
    else:
        params = torch.as_tensor(np.asarray(params, np.float32),
                                 device=resolve_device(device))

    def fn(p):
        return loss_and_grad_fn(p, **kwargs)

    bounded = param_bounds is not None
    if bounded:
        # 0-d params ride through a one-element view for the bounds (one
        # entry in param_bounds); the objective still sees a 0-d tensor.
        flat = params.reshape(-1) if params.dim() == 0 else params
        low, high = bounds_to_arrays(param_bounds, flat.shape[0],
                                     params.device)
        check_strictly_inside(flat, low, high, param_bounds)
        low, high = low.reshape(params.shape), high.reshape(params.shape)
        params = transform_array(params, low, high)
        fn = _wrap_bounded(fn, low, high)
    u, losses = _lbfgs.lbfgs(fn, params, maxsteps, memory_size=memory_size,
                             on_step=on_step)
    if bounded:
        u = inverse_transform_array(u, low, high)
    return u, losses


def run_lbfgs_scan(loss_and_grad_fn, params, maxsteps=100, randkey=None,
                   memory_size=10, param_bounds=None, device=None):
    """L-BFGS on ``loss_and_grad_fn(params[, randkey=key])``: optax's
    ``lbfgs(memory_size=memory_size)`` with its zoom line search, as the
    JAX package runs it (``optim/bfgs.py:143-187``).

    Each of the ``maxsteps`` steps evaluates the iterate once, then the
    line search's trials (at most 20), and there is no early stop.  The
    search decides on the host from one read of each trial's value and
    slope; everything else stays on the device of ``params`` (``device``
    for params that are not a tensor; ``None`` means CUDA).  ``randkey``
    is held constant over the fit.  ``param_bounds`` (``None | (low,
    high)`` a parameter, the start strictly inside) runs the fit in
    unbounded space through the bijection; 0-d params take one entry.

    Returns ``(final_params, losses)``, ``losses`` the ``(maxsteps,)``
    losses at the iterates, both on the device of ``params``.
    """
    return _lbfgs_fit(loss_and_grad_fn, params, maxsteps=maxsteps,
                      randkey=randkey, memory_size=memory_size,
                      param_bounds=param_bounds, device=device)
