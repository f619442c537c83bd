"""L-BFGS-B optimization (port of :mod:`multigrad_tpu.optim.bfgs`).

scipy's L-BFGS-B runs on the host around the port's loss-and-grad.
Under ``torch.distributed`` every process runs the same scipy loop: its
inputs are all-reduced results, identical on every process, so all
processes follow the same control flow and return the same result.
"""
from __future__ import annotations

import numpy as np
import scipy.optimize
import torch

from .adam import init_randkey
from ..utils.util import resolve_device, trange


def run_bfgs(loss_and_grad_fn, params, maxsteps=100, param_bounds=None,
             randkey=None, progress=True, device=None):
    """Run scipy L-BFGS-B on ``loss_and_grad_fn(params[, randkey=key])``.

    The parameters reach ``loss_and_grad_fn`` as float32 tensors on the
    device of ``params`` (``device`` for params that are not a tensor;
    ``None`` means CUDA).  ``randkey`` is held constant across
    iterations (BFGS needs a deterministic objective).  Returns scipy's
    ``OptimizeResult`` (message, success, fun, x, jac, nfev, nit).
    """
    if isinstance(params, torch.Tensor):
        device = params.device
        params = params.detach().cpu().numpy()
    else:
        device = resolve_device(device)
    kwargs = {}
    if randkey is not None:
        kwargs["randkey"] = init_randkey(randkey)
    pbar = trange(maxsteps, "BFGS Gradient Descent Progress", progress)

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
