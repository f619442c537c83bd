"""``OnePointModel``: differentiable data-parallel fits over additive
summary statistics (port of :mod:`multigrad_tpu.core.model`).

Subclass it as a dataclass and implement the reference's two methods:

* ``calc_partial_sumstats_from_params(params[, randkey]) -> y_r`` —
  sumstats of this process's shard; the totals are the sum over shards.
* ``calc_loss_from_sumstats(y[, sumstats_aux][, randkey]) -> loss``

The gradient is the reference's two-stage chain rule
(``core/model.py:409-452`` of the JAX package):

1. ``y_r = f(params)`` with ``params.requires_grad_()``;
2. ``y = psum(y_r)``, an all-reduce over the comm;
3. ``dL/dy`` by autograd on a leaf ``y``;
4. ``dL/dparams_r = torch.autograd.grad(y_r, params, dL/dy)``;
5. ``psum`` of that gradient.

So the communication per evaluation is O(|y| + |params|) whatever the
size of the data.  Each process holds its own shard (see
:mod:`~multigrad_tpu_torch.parallel.mesh`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from ..optim import adam as _adam
from ..optim import bfgs as _bfgs
from ..parallel.collectives import psum
from ..parallel.mesh import MeshComm
from ..utils import util as _util


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for leaf in tree:
            found = _first_tensor(leaf)
            if found is not None:
                return found
    return None


def joint_loss_and_grad(models, comm, params, kwargs):
    """The two-stage chain rule over ``models`` that share ``comm`` or have
    ``comm=None``, all reading ``params``.

    Every model's partial sumstats ``y_r``; ONE ``psum`` of the comm-ful
    models' ``y_r``, flattened and joined (a ``comm=None`` model's are
    whole already); each model's ``dL/dy`` on a leaf; one VJP into
    ``params`` for the comm-ful models, whose gradient gets ONE ``psum``,
    and one for the rest.  So 2 all-reduces an evaluation whatever the
    number of models.  Returns each model's ``(loss, loss_aux)`` and the
    gradient summed over the models.
    """
    p = params.detach().requires_grad_(True)
    with torch.enable_grad():
        outs = [m._sumstats(p, kwargs) for m in models]
        shared = [i for i, m in enumerate(models) if m.comm is not None]
        local = [i for i, m in enumerate(models) if m.comm is None]
        totals = [y.detach() for y, _ in outs]
        if len(shared) == 1:
            totals[shared[0]] = psum(totals[shared[0]], comm)
        elif shared:
            flat = psum(torch.cat([totals[i].reshape(-1) for i in shared]),
                        comm)
            for i, part in zip(shared, flat.split(
                    [totals[i].numel() for i in shared])):
                totals[i] = part.reshape(totals[i].shape).to(
                    totals[i].dtype)
        losses, cotangents = [], []
        for m, (_, ss_aux), y in zip(models, outs, totals):
            y = y.requires_grad_(True)
            loss, laux = m._loss(y, ss_aux, kwargs)
            (dloss_dy,) = torch.autograd.grad(loss, y)
            losses.append((loss.detach(), laux))
            cotangents.append(dloss_dy)
        grad = None
        for members, comm_m in ((shared, comm), (local, None)):
            if members:
                (g,) = torch.autograd.grad(
                    [outs[i][0] for i in members], p,
                    grad_outputs=[cotangents[i] for i in members])
                g = psum(g, comm_m)
                grad = g if grad is None else grad + g
    return losses, grad


@dataclass
class OnePointModel:
    """Differentiable data-parallel model over additive summary statistics.

    Parameters
    ----------
    aux_data : Any
        Available to the user methods as ``self.aux_data``; its tensors
        (this process's shard of the data) fix the model's device.
    comm : MeshComm, optional
        The process group to reduce over; ``None`` runs single-process.
    loss_func_has_aux, sumstats_func_has_aux : bool
        The reference's aux-plumbing flags: the user method returns
        ``(value, aux)`` and the sumstats aux is passed on to the loss.
    """

    aux_data: Any = None
    comm: Optional[MeshComm] = None
    loss_func_has_aux: bool = False
    sumstats_func_has_aux: bool = False

    def calc_partial_sumstats_from_params(self, params, randkey=None):
        """Custom method to map parameters to partial summary statistics."""
        raise NotImplementedError(
            "Subclass must implement `calc_partial_sumstats_from_params`")

    def calc_loss_from_sumstats(self, sumstats, sumstats_aux=None,
                                randkey=None):
        """Custom method to map total summary statistics to loss."""
        raise NotImplementedError(
            "Subclass must implement `calc_loss_from_sumstats`")

    # The reference hashes models; identity semantics are all it needs.
    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    # ------------------------------------------------------------------ #
    @property
    def device(self) -> torch.device:
        """The device of the model's data (CUDA when it holds none)."""
        leaf = _first_tensor(self.aux_data)
        return leaf.device if leaf is not None else _util.resolve_device()

    def _params(self, params) -> torch.Tensor:
        if isinstance(params, torch.Tensor):
            return params.detach().to(self.device, torch.float32)
        if isinstance(params, (tuple, list)):
            params = [float(p) for p in params]
        return torch.as_tensor(np.asarray(params, np.float32),
                               device=self.device)

    @staticmethod
    def _key_kwargs(randkey):
        if randkey is None:
            return {}
        return {"randkey": _adam.init_randkey(randkey)}

    def _sumstats(self, params, kwargs):
        out = self.calc_partial_sumstats_from_params(params, **kwargs)
        return out if self.sumstats_func_has_aux else (out, None)

    def _loss(self, y, ss_aux, kwargs):
        args = (y, ss_aux) if self.sumstats_func_has_aux else (y,)
        out = self.calc_loss_from_sumstats(*args, **kwargs)
        return out if self.loss_func_has_aux else (out, None)

    def _loss_and_grad(self, params, kwargs):
        """The two-stage chain rule: ``((loss, loss_aux), grad)``."""
        (loss_aux,), grad = joint_loss_and_grad((self,), self.comm, params,
                                                kwargs)
        return loss_aux, grad

    # ------------------------------------------------------------------ #
    # Public API (parity: multigrad.py:398-538)
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def calc_sumstats_from_params(self, params, total=True, randkey=None):
        """Summary statistics at ``params``.

        With ``total=True`` (default) the sum over all processes of the
        comm.  With ``total=False`` THIS process's partial — as in the
        original MPI multigrad, and unlike the JAX package, whose single
        controller returns the stacked ``(comm.size, ...)`` partials.
        With ``sumstats_func_has_aux`` returns ``(sumstats, aux)``.
        """
        y, ss_aux = self._sumstats(self._params(params),
                                   self._key_kwargs(randkey))
        if total:
            y = psum(y, self.comm)
        return (y, ss_aux) if self.sumstats_func_has_aux else y

    def calc_dloss_dsumstats(self, sumstats, sumstats_aux=None,
                             randkey=None):
        """d(loss)/d(sumstats) at the given *total* sumstats."""
        y = torch.as_tensor(sumstats, device=self.device).detach() \
            .requires_grad_(True)
        with torch.enable_grad():
            loss, _ = self._loss(y, sumstats_aux, self._key_kwargs(randkey))
            (grad,) = torch.autograd.grad(loss, y)
        return grad

    @torch.no_grad()
    def calc_loss_from_params(self, params, randkey=None):
        """Loss at ``params`` (``(loss, aux)`` with ``loss_func_has_aux``)."""
        kwargs = self._key_kwargs(randkey)
        y_r, ss_aux = self._sumstats(self._params(params), kwargs)
        loss, laux = self._loss(psum(y_r, self.comm), ss_aux, kwargs)
        return (loss, laux) if self.loss_func_has_aux else loss

    def calc_dloss_dparams(self, params, randkey=None):
        """Gradient of the loss with respect to ``params``."""
        return self.calc_loss_and_grad_from_params(params, randkey)[1]

    def calc_loss_and_grad_from_params(self, params, randkey=None):
        """``(loss, grad)`` from one forward pass and one backward pass
        (``((loss, aux), grad)`` with ``loss_func_has_aux``)."""
        (loss, laux), grad = self._loss_and_grad(
            self._params(params), self._key_kwargs(randkey))
        return ((loss, laux) if self.loss_func_has_aux else loss), grad

    def _fit_loss_and_grad(self, params, randkey=None):
        """``(loss, grad)`` for the optimizers (loss aux dropped)."""
        (loss, _), grad = self._loss_and_grad(params,
                                              self._key_kwargs(randkey))
        return loss, grad

    # ------------------------------------------------------------------ #
    # Optimizer front-ends (parity: multigrad.py:226-352)
    # ------------------------------------------------------------------ #
    def run_simple_grad_descent(self, guess, nsteps=100, learning_rate=0.01):
        """Fixed-learning-rate gradient descent; returns a
        :class:`~multigrad_tpu_torch.utils.util.GradDescentResult`."""
        return _util.simple_grad_descent(
            None, guess=self._params(guess), nsteps=nsteps,
            learning_rate=learning_rate,
            loss_and_grad_func=self.calc_loss_and_grad_from_params,
            has_aux=self.loss_func_has_aux, progress=False)

    def run_adam(self, guess, nsteps=100, param_bounds=None,
                 learning_rate=0.01, randkey=None, const_randkey=False,
                 progress=True, checkpoint_dir=None, checkpoint_every=None):
        """Adam; returns the ``(nsteps+1, ndim)`` parameter trajectory
        (see :func:`multigrad_tpu_torch.optim.adam.run_adam`).  With
        ``checkpoint_dir`` the fit writes its restart state every
        ``checkpoint_every`` steps and resumes from it; the model's
        ``aux_data`` is fingerprinted into the checkpoint."""
        return _adam.run_adam(
            self._fit_loss_and_grad, self._params(guess), nsteps=nsteps,
            param_bounds=param_bounds, learning_rate=learning_rate,
            randkey=randkey, const_randkey=const_randkey, progress=progress,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            data=self.aux_data, comm=self.comm)

    def run_bfgs(self, guess, maxsteps=100, param_bounds=None, randkey=None,
                 progress=True):
        """L-BFGS-B; returns scipy's ``OptimizeResult`` (see
        :func:`multigrad_tpu_torch.optim.bfgs.run_bfgs`)."""
        return _bfgs.run_bfgs(
            self._fit_loss_and_grad, self._params(guess), maxsteps=maxsteps,
            param_bounds=param_bounds, randkey=randkey, progress=progress)
