"""Distributed gradient descent, the reference's in-graph surface (port of
:mod:`multigrad_tpu.ingraph`, after the reference's experimental
``multigrad.mpi4jax`` package).

* :func:`distribute_data` — this process's contiguous shard;
* :func:`reduce_sum` — the all-reduce over the comm;
* :func:`simple_grad_descent` — fixed-learning-rate descent returning a
  pandas DataFrame.

The JAX package runs the descent as one ``lax.scan`` inside the compiled
program.  Here a host loop stands in for the scan: each step is one
call of the per-shard loss and gradient and one all-reduce of both.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .parallel.collectives import reduce_sum as _reduce_sum
from .parallel.collectives import scatter_nd
from .parallel.mesh import MeshComm
from .utils.util import resolve_device

__all__ = ["distribute_data", "reduce_sum", "simple_grad_descent"]


def distribute_data(data, comm: Optional[MeshComm] = None, pad_value=0.0,
                    device=None):
    """This process's shard of ``data`` along its leading axis (padded
    with ``pad_value`` when ``comm.size`` does not divide it), on
    ``device`` (``None`` means CUDA); the whole array for ``comm=None``."""
    shard = scatter_nd(data, axis=0, comm=comm, pad_value=pad_value)
    return shard.to(resolve_device(device))


def reduce_sum(partial_value, comm: Optional[MeshComm] = None):
    """The sum over ``comm`` of each process's ``partial_value``, on every
    process (the JAX package's signature: the comm is the second
    argument); ``comm=None`` is the identity."""
    return _reduce_sum(partial_value, comm=comm)


def simple_grad_descent(data_dict, loss_and_grad_func: Callable, guess,
                        learning_rate: float = 0.01, nsteps: int = 100,
                        comm: Optional[MeshComm] = None, device=None):
    """Distributed fixed-learning-rate gradient descent on ``device``
    (``None`` means CUDA).

    ``loss_and_grad_func(data_dict, params)`` computes this shard's
    ``(loss, grad)``; both are summed over ``comm`` in one all-reduce a
    step, so every process takes the same step and records the total
    loss.  Returns a pandas DataFrame with columns ``loss`` and
    ``params`` (the point each loss was evaluated at), or, without
    pandas, the dict of the two stacked tensors.
    """
    params = torch.as_tensor(guess, dtype=torch.float32,
                             device=resolve_device(device))
    learning_rate = float(learning_rate)
    losses, points = [], []
    for _ in range(nsteps):
        loss, grad = loss_and_grad_func(data_dict, params)
        loss = torch.as_tensor(loss, dtype=params.dtype,
                               device=params.device)
        both = reduce_sum(torch.cat([loss.reshape(1),
                                     grad.to(params.device).reshape(-1)]),
                          comm=comm)
        losses.append(both[0])
        points.append(params)
        params = params - learning_rate * both[1:].reshape(params.shape)
    out = dict(loss=torch.stack(losses), params=torch.stack(points))
    try:
        import pandas as pd
    except ImportError:
        return out
    return pd.DataFrame(dict(loss=list(out["loss"]),
                             params=list(out["params"])))
