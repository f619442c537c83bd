"""Adam optimization, host loop (port of :mod:`multigrad_tpu.optim.adam`).

The update is optax's ``adam`` written out: ``b1=0.9``, ``b2=0.999``,
``eps=1e-8`` outside the square root, bias-corrected moments.  Each
step is one call of the loss-and-grad function and a few elementwise
ops on the parameter tensor; nothing is copied to the host.

PRNG: a key is an integer seed (a ``torch.Generator`` seed for the
model).  Per step, ``key, key_i = split_key(key)`` (the reference's
rank-0 chain); with ``const_randkey`` the initial key is used at every
step.  The draws differ from ``jax.random``'s, so fits with keys match
the JAX package in distribution only.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .transforms import (bounds_to_arrays, check_strictly_inside,
                         inverse_transform_array,
                         inverse_transform_diag_jacobian, transform_array)
from ..utils.util import resolve_device, trange

B1, B2, EPS = 0.9, 0.999, 1e-8


def init_randkey(randkey) -> int:
    """Check that randkey is an integer seed."""
    if isinstance(randkey, (int, np.integer)) and not isinstance(
            randkey, bool):
        return int(randkey)
    raise TypeError(f"Invalid {type(randkey)=}: Must be int")


def split_key(key: int):
    """Two new seeds from ``key``, deterministically."""
    gen = torch.Generator().manual_seed(int(key))
    a, b = torch.randint(0, 2 ** 62, (2,), generator=gen).tolist()
    return a, b


def gen_new_key(randkey: int) -> int:
    """A new seed from ``randkey`` (parity: ``adam.py:254-257``)."""
    return split_key(randkey)[0]


def _wrap_bounded(loss_and_grad, low, high):
    """Loss-and-grad in unbounded space with the diagonal chain rule."""
    def unbound_loss_and_grad(uparams, **kwargs):
        loss, grad = loss_and_grad(
            inverse_transform_array(uparams, low, high), **kwargs)
        return loss, grad * inverse_transform_diag_jacobian(uparams, low,
                                                            high)
    return unbound_loss_and_grad


def run_adam(loss_and_grad: Callable, guess, nsteps: int = 100,
             param_bounds=None, learning_rate: float = 0.01, randkey=None,
             const_randkey: bool = False, progress: bool = True,
             device=None):
    """Adam on ``loss_and_grad(params[, randkey=key]) -> (loss, grad)``.

    With ``param_bounds`` (a sequence of ``None | (low, high)``) the loop
    runs in unbounded space through the bijection.  Returns the
    parameter trajectory, shape ``(nsteps + 1, ndim)``, starting point
    included, on the device of ``guess`` (``device`` for a guess that is
    not a tensor; ``None`` means CUDA).
    """
    if not isinstance(guess, torch.Tensor):
        guess = torch.as_tensor(np.asarray(guess, np.float32),
                                device=resolve_device(device))
    params = guess.detach().to(torch.float32)
    if const_randkey and randkey is None:
        raise ValueError("Must pass randkey if const_randkey")
    bounded = param_bounds is not None
    fn = loss_and_grad
    if bounded:
        low, high = bounds_to_arrays(param_bounds, params.shape[-1],
                                     params.device)
        check_strictly_inside(params, low, high, param_bounds)
        params = transform_array(params, low, high)
        fn = _wrap_bounded(loss_and_grad, low, high)
    key = None if randkey is None else init_randkey(randkey)

    u = params.clone()
    mu = torch.zeros_like(u)
    nu = torch.zeros_like(u)
    traj = [u]
    for step in trange(nsteps, "Adam Gradient Descent Progress", progress):
        kwargs = {}
        if key is not None:
            if const_randkey:
                kwargs["randkey"] = key
            else:
                key, kwargs["randkey"] = split_key(key)
        _, grad = fn(u, **kwargs)
        mu = (1 - B1) * grad + B1 * mu
        nu = (1 - B2) * grad ** 2 + B2 * nu
        count = torch.tensor(step + 1, dtype=torch.float32)
        mu_hat = mu / float(1 - torch.tensor(B1) ** count)
        nu_hat = nu / float(1 - torch.tensor(B2) ** count)
        u = u - learning_rate * (mu_hat / (torch.sqrt(nu_hat) + EPS))
        traj.append(u)
    traj = torch.stack(traj)
    return inverse_transform_array(traj, low, high) if bounded else traj
