"""Utility functions: devices, simple gradient descent, LHS sampling,
padding (port of :mod:`multigrad_tpu.utils.util`)."""
from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np
import torch
import torch.distributed as dist
from scipy.stats import qmc

try:
    from tqdm import auto as tqdm
except ImportError:  # pragma: no cover
    tqdm = None

__all__ = ["resolve_device", "simple_grad_descent",
           "simple_grad_descent_scan", "GradDescentResult",
           "latin_hypercube_sampler", "pad_to_multiple", "trange",
           "add_compile_observer", "remove_compile_observer"]

# Kernel-build observers (telemetry.resources subscribes).  Every
# kernel library the port loads passes through ops.cuda_build.build, so
# that one boundary sees every nvcc build (miss: its wall seconds) and
# every library found built (hit).  Observers must be cheap and must
# never raise: a broken observer costs its notification, not the build.
_COMPILE_OBSERVERS = []


def add_compile_observer(callback):
    """Register ``callback(key, seconds, hit)`` for kernel-library
    traffic: ``hit=False`` with the ``nvcc`` build's wall seconds on a
    miss, ``hit=True`` with ``seconds=0.0`` for a library found built
    (``key`` is the library's source name).  The JAX package's
    signature; there it observes the program cache."""
    if callback not in _COMPILE_OBSERVERS:
        _COMPILE_OBSERVERS.append(callback)


def remove_compile_observer(callback):
    """Unregister a :func:`add_compile_observer` callback (no-op if
    absent)."""
    try:
        _COMPILE_OBSERVERS.remove(callback)
    except ValueError:
        pass


def _notify_compile(key, seconds, hit):
    for cb in list(_COMPILE_OBSERVERS):
        try:
            cb(key, seconds, hit)
        except Exception:
            pass


def resolve_device(device=None) -> torch.device:
    """The port runs on the card: ``None`` means ``"cuda"``.

    Raises where CUDA is asked for and absent, rather than computing on
    the CPU; pass ``device="cpu"`` to run there.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return device


def trange(n, desc=None, leave=True, *, progress=True):
    """``tqdm.trange(n, desc=desc, leave=leave)`` when progress is wanted,
    tqdm is installed and this is process 0 (or ``torch.distributed`` is
    not initialised): the reference shows its bars on process 0 only.
    Else ``range(n)``.  The JAX package's signature, plus the keyword
    ``progress``."""
    if progress and tqdm is not None and _is_process_zero():
        return tqdm.trange(n, desc=desc, leave=leave)
    return range(n)


def _is_process_zero() -> bool:
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


class GradDescentResult(NamedTuple):
    """Parity: ``util.py:50-53`` of the reference."""
    loss: torch.Tensor
    params: torch.Tensor
    aux: Union[torch.Tensor, list]


def latin_hypercube_sampler(xmin, xmax, n_dim, num_evaluations,
                            seed=None, optimization=None):
    """Latin-Hypercube parameter sample, a numpy array (same draw as the
    JAX package's for the same seed)."""
    xmin = np.zeros(n_dim) + xmin
    xmax = np.zeros(n_dim) + xmax
    sampler = qmc.LatinHypercube(n_dim, seed=seed, optimization=optimization)
    return qmc.scale(sampler.random(num_evaluations), xmin, xmax)


def pad_to_multiple(array, multiple: int, axis: int = 0, pad_value=0.0):
    """Pad ``axis`` of a tensor up to a multiple of ``multiple`` with
    ``pad_value``; returns ``(padded, original_length)``."""
    array = torch.as_tensor(array)
    n = array.shape[axis]
    remainder = (-n) % multiple
    if remainder == 0:
        return array, n
    shape = list(array.shape)
    shape[axis] = remainder
    fill = torch.full(shape, pad_value, dtype=array.dtype,
                      device=array.device)
    return torch.cat([array, fill], dim=axis), n


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (dicts, lists,
    tuples and named tuples of leaves; ``None`` is an empty subtree)."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        out = [tree_map(fn, *items) for items in zip(*trees)]
        return type(first)(*out) if hasattr(first, "_fields") \
            else type(first)(out)
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    leaves = []
    tree_map(leaves.append, tree)
    return leaves


def _value_and_grad(loss_func, has_aux, argnums=0, holomorphic=False,
                    allow_int=False, reduce_axes=()):
    """``(loss[, aux]), grad`` of ``loss_func(params)`` by autograd, with
    ``jax.value_and_grad``'s options as the JAX package passes them: the
    loss takes one argument, so ``argnums`` must be 0; ``holomorphic``
    needs complex parameters, which the port's fits do not take;
    ``allow_int`` and ``reduce_axes`` change nothing for float
    parameters on one process."""
    del allow_int, reduce_axes
    if argnums != 0:
        raise ValueError(f"argnums={argnums!r}: the loss takes one "
                         "argument, the parameters (argnums=0)")
    if holomorphic:
        raise TypeError("holomorphic=True requires complex parameters")

    def fn(params):
        p = params.detach().requires_grad_(True)
        with torch.enable_grad():
            out = loss_func(p)
            loss = out[0] if has_aux else out
            (grad,) = torch.autograd.grad(loss, p)
        if has_aux:
            return (loss.detach(), out[1]), grad
        return loss.detach(), grad
    return fn


def simple_grad_descent(loss_func, guess, nsteps, learning_rate,
                        loss_and_grad_func=None, grad_loss_func=None,
                        has_aux=False, progress=True, **kwargs):
    """Fixed-learning-rate gradient descent, host loop (parity:
    ``util.py:80-134`` of the reference).

    Gradients come from ``loss_and_grad_func``, else from
    ``grad_loss_func``, else from autograd of ``loss_func``.  ``kwargs``
    are what the JAX package and the reference pass to
    ``jax.value_and_grad`` on that last path (``argnums``,
    ``holomorphic``, ``allow_int``, ``reduce_axes``; another name raises
    ``TypeError`` there, as in the JAX package; the other paths ignore
    them, as it does).  Returns the loss, params and aux trajectories of
    the ``nsteps`` evaluated points.
    """
    if loss_and_grad_func is not None:
        fn = loss_and_grad_func
    elif grad_loss_func is not None:
        def fn(params):
            return loss_func(params), grad_loss_func(params)
    else:
        fn = _value_and_grad(loss_func, has_aux, **kwargs)

    params = torch.as_tensor(guess)
    losses, trajectory, aux_trail = [], [], []
    for _ in trange(nsteps, "Simple Gradient Descent Progress",
                    progress=progress):
        if has_aux:
            (loss, aux), grad = fn(params)
        else:
            (loss, grad), aux = fn(params), None
        losses.append(torch.as_tensor(loss))
        trajectory.append(params)
        aux_trail.append(aux)
        params = params - learning_rate * grad
    if has_aux:
        try:
            aux_trail = torch.stack([torch.as_tensor(a) for a in aux_trail])
        except (TypeError, RuntimeError):
            pass  # heterogeneous aux stays a list
    return GradDescentResult(loss=torch.stack(losses),
                             params=torch.stack(trajectory), aux=aux_trail)


def simple_grad_descent_scan(loss_and_grad_func, guess, nsteps,
                             learning_rate, has_aux=False):
    """Fixed-learning-rate gradient descent with the JAX package's
    ``lax.scan`` contract (parity: ``util.py:240-276``): the host loop of
    :func:`simple_grad_descent` stands in for the scan, from a float32
    ``guess``.

    Returns the ``nsteps`` losses, the params *before* each update, and
    the aux stacked step by step, leaf by leaf (with ``has_aux``; else a
    list of ``nsteps`` zeros, as the scan's placeholder gives).
    """
    fn, trail = loss_and_grad_func, []
    if has_aux:
        def fn(params):
            (loss, aux), grad = loss_and_grad_func(params)
            trail.append(aux)
            return loss, grad
    result = simple_grad_descent(
        None, torch.as_tensor(guess, dtype=torch.float32), nsteps,
        learning_rate, loss_and_grad_func=fn, progress=False)
    if not has_aux:
        return result._replace(aux=list(torch.zeros(nsteps)))
    return result._replace(aux=tree_map(
        lambda *steps: torch.stack([torch.as_tensor(a) for a in steps]),
        *trail))
