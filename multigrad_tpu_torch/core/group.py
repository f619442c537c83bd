"""Multi-model composition: ``OnePointGroup`` and ``param_view`` (port of
:mod:`multigrad_tpu.core.group`).

Several :class:`~multigrad_tpu_torch.core.model.OnePointModel`\\ s, each
over its own comm, are fit jointly by summing their losses and gradients.
A group takes one of two paths:

* **Fused** (:attr:`OnePointGroup.fused`): every member shares one comm
  (one process group) or has ``comm=None``, and none has
  ``loss_func_has_aux``.  An evaluation computes every member's partial
  sumstats ``y_r``, makes **one** all-reduce of all of them flattened and
  joined, takes each member's ``dL/dy``, runs one backward pass of every
  member's VJP into the joint parameters, and makes **one** all-reduce of
  the joint gradient: 2 all-reduces an evaluation whatever the number of
  members, with ``(Σ|y_m| + |p|)·4`` bytes on the wire.  This is the
  PyTorch counterpart of the JAX package's one XLA program; a
  ``comm=None`` member's ``y`` and gradient are whole on every process
  and stay out of the all-reduces.
* **Host** (members on disjoint sub-communicators from
  :func:`~multigrad_tpu_torch.parallel.mesh.split_subcomms`, or a member
  with ``loss_func_has_aux``): the original multigrad's semantics.  Every
  process holds the same ``models`` tuple; a member whose comm this
  process is not in is skipped there (its ``aux_data`` may be ``None``);
  a member's loss and gradient count once, on its comm's rank 0 (a
  ``comm=None`` member on ``main_comm``'s rank 0), and are zero on its
  other ranks; one all-reduce of ``(loss, grad)`` over ``main_comm`` (the
  world when ``None``) gives every process the joint loss and gradient.

Typical setup (the reference's sub-communicator pattern)::

    subcomms, _, my_group = split_subcomms(ranks_per_group=[1, 2])
    smf = SMFModel(aux_data=smf_data if my_group == 0 else None,
                   comm=subcomms[0])
    wp = WprpModel(aux_data=wp_data if my_group == 1 else None,
                   comm=subcomms[1])
    group = OnePointGroup(models=(param_view(smf, [0, 1]),
                                  param_view(wp, [0, 2])))
    result = group.run_bfgs(guess)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Sequence, Tuple, Union

import numpy as np
import torch

from .model import (OnePointModel, _first_tensor, cached_program,
                    k_shard_axis_of, require_k_shard_axis,
                    joint_loss_and_grad)
from ..optim import adam as _adam
from ..optim import bfgs as _bfgs
from ..parallel.collectives import reduce_sum
from ..parallel.mesh import global_comm
from ..utils import util as _util


def param_view(model: OnePointModel,
               indices: Sequence[int]) -> OnePointModel:
    """Adapt ``model`` to read its parameters from a slice of a shared
    joint parameter vector.

    Each view sees ``joint_params[indices]`` (``torch.index_select``), so
    autograd scatters its gradient back into those joint slots; slots no
    member reads get a zero gradient.  Returns a new model of a derived
    dataclass; the wrapped model is not changed and stays usable alone.
    """
    cls = type(model)
    idx = tuple(int(i) for i in indices)
    if idx and min(idx) < 0:
        raise ValueError(
            f"param_view indices must be non-negative, got {idx}")
    if not idx:
        raise ValueError("param_view requires at least one index")
    index_on = {}

    @dataclass(eq=False, repr=False)
    class _ParamView(cls):
        def calc_partial_sumstats_from_params(self, params, randkey=None):
            if max(idx) >= params.shape[0]:
                raise ValueError(
                    f"param_view indices {idx} out of range for joint "
                    f"parameter vector of length {params.shape[0]}")
            if params.device not in index_on:
                index_on[params.device] = torch.tensor(
                    idx, dtype=torch.long, device=params.device)
            sub = torch.index_select(params, 0, index_on[params.device])
            if randkey is None:
                # Forwarded only when given: some models take no key.
                return cls.calc_partial_sumstats_from_params(self, sub)
            return cls.calc_partial_sumstats_from_params(
                self, sub, randkey=randkey)

    _ParamView.__name__ = f"ParamView({cls.__name__}, {idx})"
    field_values = {f.name: getattr(model, f.name)
                    for f in dataclasses.fields(model) if f.init}
    return _ParamView(**field_values)


def _runs_here(model: OnePointModel) -> bool:
    return model.comm is None or model.comm.is_member


@dataclass
class OnePointGroup:
    """Sum-of-models joint objective (parity: ``multigrad.py:547-607``).

    Parameters
    ----------
    models : tuple[OnePointModel] | OnePointModel
        The component models.  All receive the same joint parameter
        vector (wrap a model in :func:`param_view` to give it a slice).
    main_comm : MeshComm, optional
        The comm that joins the members' results on the host path (the
        world when ``None``).
    """

    models: Union[Tuple[OnePointModel, ...], OnePointModel]
    main_comm: Any = None

    def __post_init__(self):
        if isinstance(self.models, OnePointModel):
            self.models = (self.models,)
        self.models = tuple(self.models)
        if not (self.models
                and all(isinstance(m, OnePointModel) for m in self.models)):
            raise TypeError(
                "OnePointGroup.models must be one OnePointModel or a "
                "non-empty tuple of them")

    @property
    def fused(self) -> bool:
        """Whether an evaluation is the fused 2-all-reduce path: every
        member on the same process group or ``comm=None``, and none with
        ``loss_func_has_aux`` (the group sums plain scalar losses; an aux
        has no fused-sum semantics)."""
        if any(m.loss_func_has_aux for m in self.models):
            return False
        groups = [m.comm.group for m in self.models if m.comm is not None]
        return all(g is groups[0] for g in groups[1:])

    @property
    def comm(self):
        """The shared comm of a fused group (``None`` when every member
        has ``comm=None``)."""
        if not self.fused:
            raise ValueError(
                "this OnePointGroup is not fused (members on disjoint "
                "comms, or a member with loss_func_has_aux): it has no "
                "shared comm — see OnePointGroup.fused")
        return next((m.comm for m in self.models if m.comm is not None),
                    None)

    @property
    def _device(self) -> torch.device:
        """The device of the data of the members this process runs."""
        for m in self.models:
            if _runs_here(m):
                leaf = _first_tensor(m.aux_data)
                if leaf is not None:
                    return leaf.device
        return _util.resolve_device()

    def _params(self, params) -> torch.Tensor:
        if isinstance(params, torch.Tensor):
            return params.detach().to(self._device, torch.float32)
        if isinstance(params, (tuple, list)):
            params = [float(p) for p in params]
        return torch.as_tensor(np.asarray(params, np.float32),
                               device=self._device)

    @property
    def device(self) -> torch.device:
        """The device of the group's data on this process."""
        return self._device

    # ------------------------------------------------------------------ #
    @staticmethod
    def _sum_losses(losses):
        loss = losses[0][0]
        for loss_m, _ in losses[1:]:
            loss = loss + loss_m
        return loss

    def _fused_loss_and_grad(self, params, randkey, models=None):
        """One evaluation of the fused path: ``(loss, grad)``; a
        ``(K, ndim)`` batch gives ``(losses (K,), grads (K, ndim))``."""
        losses, grad = joint_loss_and_grad(
            self.models if models is None else models, self.comm, params,
            OnePointModel._key_kwargs(randkey))
        if params.dim() == 2:
            return torch.stack([self._sum_losses(row) for row in losses]), \
                grad
        return self._sum_losses(losses), grad

    def _host_loss_and_grad(self, params, randkey):
        """One evaluation of the host path: each member on its own comm,
        counted once, then one all-reduce over ``main_comm``."""
        main = self.main_comm if self.main_comm is not None \
            else global_comm()
        loss = torch.zeros((), dtype=torch.float32, device=params.device)
        grad = torch.zeros_like(params)
        for m in self.models:
            if not _runs_here(m):
                continue
            (loss_m, _), grad_m = m._loss_and_grad(
                m._params(params), m._key_kwargs(randkey))
            root = main if m.comm is None else m.comm
            if root.rank == 0:
                loss = loss + loss_m.to(params.device)
                grad = grad + grad_m.to(params.device)
        both = reduce_sum(torch.cat([loss.reshape(1), grad]), comm=main)
        return both[0], both[1:]

    def calc_loss_and_grad_from_params(self, params, randkey=None):
        """Joint loss and gradient: the sum over the component models."""
        params = self._params(params)
        if self.fused:
            return self._fused_loss_and_grad(params, randkey)
        return self._host_loss_and_grad(params, randkey)

    # ------------------------------------------------------------------ #
    # The inference surface of a fused group (parity: core/group.py:243,
    # 271, 334, 341 of the JAX package): the joint parameter vector, and
    # one tuple of each member's leaves as the data argument
    # ------------------------------------------------------------------ #
    # The group sums plain scalar losses (a fused group has no member with
    # loss_func_has_aux), as a model without aux does.
    loss_func_has_aux = False
    sumstats_func_has_aux = False

    def _require_fused(self):
        if not self.fused:
            raise ValueError(
                "this OnePointGroup is not fused (members on disjoint "
                "comms, or a member with loss_func_has_aux); "
                "loss_and_grad_fn, batched_loss_and_grad_fn, the "
                "ensemble and HMC need the fused path — see "
                "OnePointGroup.fused")

    def aux_leaves(self) -> tuple:
        """Each member's :meth:`OnePointModel.aux_leaves`, in member
        order: the data argument of the group's programs."""
        return tuple(m.aux_leaves() for m in self.models)

    def _rebound(self, aux_leaves):
        return tuple(m._with_leaves(leaves)
                     for m, leaves in zip(self.models, aux_leaves))

    def loss_and_grad_fn(self, with_key: bool = False):
        """``program(params, aux_leaves, key=None) -> (loss, grad)`` over
        the joint parameters, each member's data from ``aux_leaves``
        (:meth:`aux_leaves`); the fused path only."""
        self._require_fused()

        def program(params, aux_leaves, key=None):
            return self._fused_loss_and_grad(
                self._params(params), key if with_key else None,
                self._rebound(aux_leaves))
        return program

    def batched_loss_and_grad_fn(self, with_key: bool = False,
                                 k_sharded: bool = False):
        """``program(params (K, ndim), aux_leaves, key=None) -> (losses
        (K,), grads (K, ndim))``: K joint evaluations through every
        member's chain rule in one call, 2 all-reduces whatever the
        number of members and rows (see
        :meth:`OnePointModel.batched_loss_and_grad_fn`); the fused path
        only.  ``k_sharded=True`` is the K-partitioned sibling on this
        process's rows (the members on an ensemble comm), as the model's;
        both are cached on the group."""
        self._require_fused()
        if k_sharded:
            self._require_k_shard_axis()

        def build():
            def program(params, aux_leaves, key=None):
                params = self._params(params)
                if params.dim() != 2:
                    raise ValueError("batched params must be (K, ndim), "
                                     f"got shape {tuple(params.shape)}")
                return self._fused_loss_and_grad(
                    params, key if with_key else None,
                    self._rebound(aux_leaves))
            return program
        return cached_program(
            self, ("batched_loss_and_grad", bool(with_key), bool(k_sharded)),
            build)

    # Sharded K over the shared comm (parity: core/group.py:342-400 of
    # the JAX package).
    @property
    def k_shard_axis(self):
        """The replica axis of the members' shared ensemble comm, else
        ``None`` (see :attr:`OnePointModel.k_shard_axis`)."""
        return k_shard_axis_of(self.comm) if self.fused else None

    @property
    def k_shard_replicas(self) -> int:
        return self.comm.replica.size if self.k_shard_axis else 1

    def _require_k_shard_axis(self) -> str:
        self._require_fused()
        return require_k_shard_axis(self.comm)

    def k_sharding(self, ndim: int = 2):
        """The row partition over the replica axis (see
        :meth:`OnePointModel.k_sharding`)."""
        from ..parallel.mesh import KSharding
        del ndim
        self._require_k_shard_axis()
        return KSharding(self.comm.replica)

    # ------------------------------------------------------------------ #
    # Optimizer proxies (parity: multigrad.py:583-599)
    # ------------------------------------------------------------------ #
    def run_simple_grad_descent(self, guess, nsteps=100, learning_rate=0.01):
        return _util.simple_grad_descent(
            None, guess=self._params(guess), nsteps=nsteps,
            learning_rate=learning_rate,
            loss_and_grad_func=self.calc_loss_and_grad_from_params,
            has_aux=False, progress=False)

    def run_bfgs(self, guess, maxsteps=100, param_bounds=None, randkey=None,
                 progress=True):
        return _bfgs.run_bfgs(
            self.calc_loss_and_grad_from_params, self._params(guess),
            maxsteps=maxsteps, param_bounds=param_bounds, randkey=randkey,
            progress=progress)

    def run_adam(self, guess, nsteps=100, param_bounds=None,
                 learning_rate=0.01, randkey=None, const_randkey=False,
                 progress=True, checkpoint_dir=None,
                 checkpoint_every=None):
        """Adam over the joint objective; the same host loop on either
        path.  ``checkpoint_dir`` (see
        :func:`multigrad_tpu_torch.optim.adam._run_adam_loop`) needs the
        fused path, as in the JAX package."""
        if checkpoint_dir is not None and not self.fused:
            raise ValueError(
                "checkpoint_dir requires the fused group path (every "
                "member on one shared mesh and no member with "
                "loss_func_has_aux — see OnePointGroup.fused); this "
                "group runs the host-loop driver, which does not "
                "checkpoint")
        return _adam._run_adam_loop(
            self.calc_loss_and_grad_from_params, self._params(guess),
            nsteps=nsteps, param_bounds=param_bounds,
            learning_rate=learning_rate, randkey=randkey,
            const_randkey=const_randkey, progress=progress,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            data=[m.aux_data if _runs_here(m) else None
                  for m in self.models],
            comm=self.comm if checkpoint_dir is not None else None)

    def check_shard_safety(self, params, **kwargs):
        """Statically verify the group's program(s): the joint program of
        a fused group, the members' otherwise (see
        :func:`multigrad_tpu_torch.analysis.analyze_group`)."""
        from ..analysis import analyze_group
        return analyze_group(self, params, **kwargs)

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other
