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

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ..optim import adam as _adam
from ..optim import bfgs as _bfgs
from ..parallel.collectives import psum
from ..parallel.mesh import MeshComm
from ..utils import util as _util
from ..utils.util import tree_leaves, tree_map


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


def psum_joined(tensors, comm):
    """The sums over ``comm`` of ``tensors`` in ONE all-reduce: flattened,
    joined, reduced and split back, each to its own shape and dtype (one
    tensor is reduced as it is; ``comm=None`` is the identity)."""
    tensors = list(tensors)
    if comm is None or not tensors:
        return tensors
    if len(tensors) == 1:
        return [psum(tensors[0], comm)]
    dtype = functools.reduce(torch.promote_types,
                             [t.dtype for t in tensors])
    flat = psum(torch.cat([t.reshape(-1).to(dtype) for t in tensors]), comm)
    return [part.reshape(t.shape).to(t.dtype) for t, part in zip(
        tensors, flat.split([t.numel() for t in tensors]))]


#: Guards the gradient-noise-scale ratio against a zero mean gradient (the
#: JAX package's ``GNS_EPS``).
GNS_EPS = 1e-20


# ---------------------------------------------------------------------- #
# Sharded K: the replica axis of an ensemble comm (shared by the model and
# the fused group)
# ---------------------------------------------------------------------- #
def k_shard_axis_of(comm) -> Optional[str]:
    """The axis a comm's K batch axis can shard over: an
    :func:`~multigrad_tpu_torch.parallel.ensemble_comm`'s replica axis, or
    ``None``."""
    free = comm.free_axes if comm is not None else ()
    return free[-1] if free else None


def require_k_shard_axis(comm) -> str:
    """:func:`k_shard_axis_of`, raising ``ValueError`` (naming
    ``ensemble_comm``) where there is none."""
    axis = k_shard_axis_of(comm)
    if axis is None:
        raise ValueError(
            "this model's comm has no free replica axis to shard the K "
            "batch axis over; build it on a 2-level comm with "
            "multigrad_tpu_torch.parallel.ensemble_comm(n_replicas=R)")
    return axis


def cached_program(owner, key, build):
    """``owner``'s program ``key``, built once by ``build()`` and kept in
    its ``_program_cache`` (a sibling entry a variant), so a caller gets
    the same callable back every time."""
    cache = owner.__dict__.setdefault("_program_cache", {})
    if key not in cache:
        cache[key] = build()
    return cache[key]


def psum_tree(tree, comm):
    """A tree of tensors summed over ``comm`` in one all-reduce."""
    summed = iter(psum_joined(tree_leaves(tree), comm))
    return tree_map(lambda _: next(summed), tree)


#: The streamed scan path's remat policies (the JAX package's
#: ``REMAT_POLICY_NAMES``): what a chunk's checkpointed forward saves for
#: the backward pass, the rest being recomputed there.
REMAT_POLICY_NAMES = ("nothing", "dots", "dots_with_no_batch_dims",
                      "everything")
_MATMULS = ("mm", "addmm", "mv", "addmv", "dot", "vdot")
_BATCHED_MATMULS = ("bmm", "baddbmm")


def _saving(names):
    """A selective-checkpoint policy that saves the outputs of the aten
    ops ``names`` and recomputes every other op."""
    packets = {getattr(torch.ops.aten, name) for name in names}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op.overloadpacket in packets
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


def resolve_remat_policy(policy):
    """How the streamed scan path runs one chunk's forward, ``run(fn, p)
    -> fn(p)``, under ``policy`` (the JAX package's ``jax.checkpoint``
    policies, as ``torch.utils.checkpoint``):

    * ``None`` / ``"nothing"``: a checkpoint that saves nothing; the
      backward recomputes the whole chunk;
    * ``"dots"``: a selective checkpoint that saves matrix products (the
      ``aten.mm``/``bmm``/``addmm`` family) and recomputes the rest;
      ``"dots_with_no_batch_dims"`` the same without ``bmm``/``baddbmm``;
    * ``"everything"``: no checkpoint; every chunk's graph is kept for
      the one backward pass;
    * a callable: taken as a selective-checkpoint policy
      ``(ctx, op, *args, **kwargs) -> CheckpointPolicy``.
    """
    if policy == "everything":
        return lambda fn, p: fn(p)
    if policy is None or policy == "nothing":
        context_fn = noop_context_fn
    else:
        if callable(policy):
            rule = policy
        elif policy in ("dots", "dots_with_no_batch_dims"):
            rule = _saving(_MATMULS + (_BATCHED_MATMULS if policy == "dots"
                                       else ()))
        else:
            raise ValueError(
                f"unknown remat_policy {policy!r}; expected None, one of "
                f"{REMAT_POLICY_NAMES}, or a selective-checkpoint policy "
                "callable")
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       rule)
    return lambda fn, p: checkpoint(fn, p, use_reentrant=False,
                                    context_fn=context_fn)


def joint_loss_and_grad(models, comm, params, kwargs, with_local=False):
    """The two-stage chain rule over ``models`` that share ``comm`` or have
    ``comm=None``, all reading ``params``: one ``(ndim,)`` vector, or a
    ``(K, ndim)`` batch of K independent rows.

    Each row gets a leaf copy of its own, and every model its partial
    sumstats ``y_r`` from it; ONE ``psum`` of the comm-ful models' ``y_r``
    of every row, flattened and joined (a ``comm=None`` model's are whole
    already); each model's ``dL/dy`` of each row on a leaf; one VJP into
    every row's leaf for the comm-ful models, whose ``(K, ndim)`` gradient
    gets ONE ``psum``, and one for the rest.  So 2 all-reduces an
    evaluation whatever the number of models and rows, and row k runs
    the ops of a solo evaluation at ``params[k]``.  Returns, a row, each
    model's ``(loss, loss_aux)`` (one list for an ``(ndim,)`` vector, a
    list of K for a batch) and the gradient summed over the models, of
    ``params``' shape; with ``with_local``, also this process's gradient
    before its all-reduce (the gradient-noise-scale diagnostic's input).
    """
    batched = params.dim() == 2
    leaves = [row.detach().requires_grad_(True)
              for row in (params.unbind(0) if batched else (params,))]
    shared = [i for i, m in enumerate(models) if m.comm is not None]
    local = [i for i, m in enumerate(models) if m.comm is None]
    with torch.enable_grad():
        outs = [[m._sumstats(p, kwargs) for m in models] for p in leaves]
        totals = [[y.detach() for y, _ in row] for row in outs]
        summed = iter(psum_joined(
            [row[i] for row in totals for i in shared], comm))
        for row in totals:
            for i in shared:
                row[i] = next(summed)
        losses, cotangents = [], []
        for row_outs, row_totals in zip(outs, totals):
            row_losses, row_cts = [], []
            for m, (_, ss_aux), y in zip(models, row_outs, row_totals):
                y = y.requires_grad_(True)
                loss, laux = m._loss(y, ss_aux, kwargs)
                (dloss_dy,) = torch.autograd.grad(loss, y)
                row_losses.append((loss.detach(), laux))
                row_cts.append(dloss_dy)
            losses.append(row_losses)
            cotangents.append(row_cts)
        grad = local_grad = None
        for members, comm_m in ((shared, comm), (local, None)):
            if members:
                grads = torch.autograd.grad(
                    [row[i][0] for row in outs for i in members], leaves,
                    grad_outputs=[row[i] for row in cotangents
                                  for i in members])
                g_local = torch.stack(grads) if batched else grads[0]
                g = psum(g_local, comm_m)
                grad = g if grad is None else grad + g
                local_grad = g_local if local_grad is None \
                    else local_grad + g_local
    out = (losses if batched else losses[0]), grad
    return out + (local_grad,) if with_local else out


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
    # Sharded K (parity: core/model.py:213-252 of the JAX package)
    # ------------------------------------------------------------------ #
    @property
    def k_shard_axis(self) -> Optional[str]:
        """The axis the ensemble K batch axis can shard over: the replica
        axis of an :func:`~multigrad_tpu_torch.parallel.ensemble_comm`,
        else ``None``."""
        return k_shard_axis_of(self.comm)

    @property
    def k_shard_replicas(self) -> int:
        """The number of replica slices (1 without a replica axis)."""
        return self.comm.replica.size if self.k_shard_axis else 1

    def _require_k_shard_axis(self) -> str:
        return require_k_shard_axis(self.comm)

    def k_sharding(self, ndim: int = 2):
        """The row partition of a ``(K, ...)`` batch over the replica axis
        (a :class:`~multigrad_tpu_torch.parallel.KSharding`: this
        process's rows, and the gather of a result): what the K-sharded
        entry points place parameter batches, Adam carries and
        trajectories with.  ``ndim``, the batch's rank, is the JAX
        package's argument: the rows partition whatever it is.
        ``ValueError`` without a replica axis."""
        from ..parallel.mesh import KSharding
        del ndim
        self._require_k_shard_axis()
        return KSharding(self.comm.replica)

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

    def _fit_loss_and_grad_gns(self, params, randkey=None):
        """``(loss, grad, diagnostics)`` for ``run_adam(diagnostics=True)``
        (the JAX package's ``"loss_and_grad_gns"`` program,
        ``core/model.py:468-520``): the fit's chain rule with this
        process's gradient kept before its all-reduce, and ONE more
        all-reduce, of its squared norm (a scalar: the O(|y| + |params|)
        bound holds).  ``grad_noise_scale`` is the shards' relative
        gradient variance, ``(mean_r |g_r|² - |mean_r g_r|²) / |mean_r
        g_r|²`` (0 on one shard); ``grad_norm_shard`` is ``sqrt(mean_r
        |g_r|²)``.  The loss and gradient are :meth:`_fit_loss_and_grad`'s
        bit for bit."""
        ((loss, _),), grad, g_local = joint_loss_and_grad(
            (self,), self.comm, params, self._key_kwargs(randkey),
            with_local=True)
        size = self.comm.size if self.comm is not None else 1
        mean_sq = psum(torch.sum(g_local * g_local, dim=-1),
                       self.comm) / size
        g_bar = grad / size
        sq_mean = torch.sum(g_bar * g_bar, dim=-1)
        noise = torch.clamp(mean_sq - sq_mean, min=0.0)
        return loss, grad, {
            "grad_noise_scale": noise / (sq_mean + GNS_EPS),
            "grad_norm_shard": torch.sqrt(mean_sq)}

    def _sumstats_and_jac(self, params, kwargs):
        """This process's partial sumstats and their ``(*y, ndim)``
        Jacobian, in reverse mode: one ``torch.autograd.grad`` row a
        sumstat over one retained graph (the kernels' autograd Functions
        carry a backward and no forward-mode rule)."""
        p = params.detach().requires_grad_(True)
        with torch.enable_grad():
            y, _ = self._sumstats(p, kwargs)
            flat = y.reshape(-1)
            rows = []
            for i in range(flat.shape[0]):
                (row,) = torch.autograd.grad(
                    flat[i], p, retain_graph=i + 1 < flat.shape[0],
                    allow_unused=True)
                rows.append(torch.zeros_like(p) if row is None else row)
        return y.detach(), torch.stack(rows).reshape(
            *y.shape, p.shape[-1])

    def calc_sumstats_and_jac_from_params(self, params, randkey=None,
                                          mode: str = "fwd"):
        """Total sumstats and their Jacobian with respect to ``params``:
        shapes ``(*y,)`` and ``(*y, ndim)``, summed over the comm in one
        all-reduce of both joined (``J = Σ_r ∂y_r/∂p``).  Sumstats aux
        values (if any) are dropped; fetch them with
        :meth:`calc_sumstats_from_params`.

        ``mode`` (``"fwd"`` or ``"rev"``) is the JAX package's choice of
        ``jacfwd`` or ``jacrev``; both give the same numbers here, where
        the Jacobian is always taken in reverse mode, one backward pass a
        sumstat (10 for the SMF model).
        """
        if mode not in ("fwd", "rev"):
            raise ValueError(f"mode must be 'fwd' or 'rev', got {mode!r}")
        y, jac = self._sumstats_and_jac(self._params(params),
                                        self._key_kwargs(randkey))
        y, jac = psum_joined((y, jac), self.comm)
        return y, jac

    # ------------------------------------------------------------------ #
    # Programs over rebindable data (parity: core/model.py:1010-1044 of
    # the JAX package): the surface the ensemble and HMC run on
    # ------------------------------------------------------------------ #
    def aux_leaves(self) -> list:
        """The tensors of ``aux_data`` in tree order: the data argument
        of :meth:`loss_and_grad_fn` and :meth:`batched_loss_and_grad_fn`
        (the other leaves stay bound to the model)."""
        return [leaf for leaf in tree_leaves(self.aux_data)
                if isinstance(leaf, torch.Tensor)]

    def _with_leaves(self, leaves):
        """This model with ``leaves`` bound in place of its aux tensors,
        as :meth:`_with_chunk` binds a chunk; itself when they are its
        own."""
        leaves = list(leaves)
        own = self.aux_leaves()
        if len(leaves) != len(own):
            raise ValueError(f"expected {len(own)} aux leaves (see "
                             f"aux_leaves), got {len(leaves)}")
        if all(a is b for a, b in zip(leaves, own)):
            return self
        swap = iter(leaves)
        return dataclasses.replace(self, aux_data=tree_map(
            lambda leaf: next(swap) if isinstance(leaf, torch.Tensor)
            else leaf, self.aux_data))

    def loss_and_grad_fn(self, with_key: bool = False):
        """``program(params, aux_leaves, key=None) -> (loss, grad)``: one
        evaluation of the two-stage chain rule over the data ``aux_leaves``
        (from :meth:`aux_leaves`, or other tensors of the same tree), so
        a caller swaps data without building another model; ``key`` is
        the ``randkey`` seed with ``with_key``.  ``(loss, aux)`` with
        ``loss_func_has_aux``."""
        def program(params, aux_leaves, key=None):
            model = self._with_leaves(aux_leaves)
            kwargs = self._key_kwargs(key) if with_key else {}
            (loss, laux), grad = model._loss_and_grad(model._params(params),
                                                      kwargs)
            return ((loss, laux) if self.loss_func_has_aux else loss), grad
        return program

    def batched_loss_and_grad_fn(self, with_key: bool = False,
                                 k_sharded: bool = False):
        """``program(params (K, ndim), aux_leaves, key=None) -> (losses
        (K,), grads (K, ndim))``: K independent evaluations in one call,
        the JAX package's vmapped ``"batched_loss_and_grad"``.  A host
        loop over the rows inside :func:`joint_loss_and_grad`: each row's
        forward from its own leaf, every row's ``y_r`` in ONE all-reduce,
        one backward pass over all the rows, ONE all-reduce of the
        ``(K, ndim)`` gradient; 2 all-reduces whatever K, and row k equal
        to a solo :meth:`calc_loss_and_grad_from_params` at ``params[k]``
        bit for bit.  Loss aux values are dropped.

        ``k_sharded=True`` is the K-partitioned sibling (the JAX
        package's ``"batched_loss_and_grad_sharded"``): the model must be
        on an :func:`~multigrad_tpu_torch.parallel.ensemble_comm`
        (``ValueError`` otherwise), and the program takes THIS process's
        rows of the batch (``model.k_sharding(2).local(batch)``) and
        returns their losses and gradients, nothing gathered: K/R rows
        whose graphs the process holds, still 2 all-reduces on the data
        comm whatever K, none on the replica comm, each row the
        replicated call's bit for bit where the data comm has the same
        width.  Both programs are cached on the model, siblings, so a
        caller gets the same callable back."""
        if k_sharded:
            self._require_k_shard_axis()

        def build():
            def program(params, aux_leaves, key=None):
                model = self._with_leaves(aux_leaves)
                kwargs = self._key_kwargs(key) if with_key else {}
                params = model._params(params)
                if params.dim() != 2:
                    raise ValueError("batched params must be (K, ndim), "
                                     f"got shape {tuple(params.shape)}")
                rows, grads = joint_loss_and_grad((model,), model.comm,
                                                  params, kwargs)
                return torch.stack([loss for ((loss, _),) in rows]), grads
            return program
        return cached_program(
            self, ("batched_loss_and_grad", bool(with_key), bool(k_sharded)),
            build)

    @torch.no_grad()
    def run_lhs_param_scan(self, xmins, xmaxs, n_dim, num_evaluations,
                           seed=None, randkey=None, batched=True):
        """Sumstats and loss over a Latin-hypercube sample (parity:
        ``core/model.py:1204-1245`` of the JAX package); numpy arrays
        ``(params, sumstats, losses)``, ``params`` the sampler's float64
        draw.

        One no-grad pass over the rows, one row at a time (only one row's
        values live), ONE all-reduce of the ``(K, |y|)`` partial sumstats,
        then each row's loss (with the sumstats' aux where they carry
        one); loss aux values are dropped.  ``batched`` is accepted for
        the JAX package's signature: its per-sample loop (``batched=
        False``) gives the same values, so both run this one body.
        """
        del batched
        params = _util.latin_hypercube_sampler(
            xmins, xmaxs, n_dim, num_evaluations, seed=seed)
        kwargs = self._key_kwargs(randkey)
        rows = [self._sumstats(self._params(x), kwargs) for x in params]
        ys = psum(torch.stack([y for y, _ in rows]), self.comm)
        losses = [self._loss(y, ss_aux, kwargs)[0]
                  for y, (_, ss_aux) in zip(ys, rows)]
        return params, ys.cpu().numpy(), torch.stack(losses).cpu().numpy()

    # ------------------------------------------------------------------ #
    # Aux re-binding and the chunk programs of the streamed paths
    # (parity: core/model.py:650-883 of the JAX package)
    # ------------------------------------------------------------------ #
    def replace_aux(self, **updates):
        """A new model whose ``aux_data`` has ``updates`` rebound; the
        model is left as it was.  Requires dict aux_data."""
        if not isinstance(self.aux_data, dict):
            raise TypeError(
                "replace_aux needs dict aux_data, got "
                f"{type(self.aux_data).__name__}")
        return dataclasses.replace(
            self, aux_data={**self.aux_data, **updates})

    def _with_chunk(self, stream_names, chunk):
        """This model with a chunk's streamed tensors bound under
        ``stream_names`` in its (resident) dict aux, so that the sumstats
        method reads ``self.aux_data[name]`` as it does resident."""
        if not isinstance(self.aux_data, dict):
            raise TypeError(
                "streaming requires dict aux_data (stream leaves are "
                f"rebound by key), got {type(self.aux_data).__name__}")
        return dataclasses.replace(
            self, aux_data={**self.aux_data, **dict(zip(stream_names,
                                                        chunk))})

    def chunk_sumstats_fn(self, stream_names, with_key: bool = False):
        """``program(params, chunk, key=None)``: this process's partial
        sumstats of one chunk (``(y, aux)`` with ``sumstats_func_has_aux``;
        the aux must be additive).  ``chunk`` lists the chunk's tensors in
        ``stream_names`` order.  The streamed model adds the chunks'
        partials up on the device and sums the total over the comm once."""
        names = tuple(stream_names)

        @torch.no_grad()
        def program(params, chunk, key=None):
            kwargs = {"randkey": key} if with_key else {}
            return self._with_chunk(names, chunk) \
                .calc_partial_sumstats_from_params(params, **kwargs)
        return program

    def chunk_vjp_fn(self, stream_names, with_key: bool = False):
        """``program(params, chunk, ct, key=None)``: this process's part
        of ``dL/dparams`` from one chunk, the VJP of its partial sumstats
        against the total's cotangent ``ct = dL/dy`` (pass 2 of the
        streamed chain rule; no all-reduce)."""
        names = tuple(stream_names)

        def program(params, chunk, ct, key=None):
            kwargs = {"randkey": key} if with_key else {}
            model = self._with_chunk(names, chunk)
            p = params.detach().requires_grad_(True)
            with torch.enable_grad():
                y, _ = model._sumstats(p, kwargs)
                (grad,) = torch.autograd.grad(y, p, grad_outputs=ct)
            return grad
        return program

    def chunk_jac_fn(self, stream_names, with_key: bool = False):
        """``program(params, chunk, key=None) -> (y, J)``: this process's
        partial sumstats of one chunk and their Jacobian (reverse mode,
        see :meth:`calc_sumstats_and_jac_from_params`)."""
        names = tuple(stream_names)

        def program(params, chunk, key=None):
            kwargs = {"randkey": key} if with_key else {}
            return self._with_chunk(names, chunk)._sumstats_and_jac(
                params, kwargs)
        return program

    def chunk_scan_loss_and_grad_fn(self, stream_names,
                                    with_key: bool = False,
                                    remat_policy="dots"):
        """``program(params, stacks, key=None) -> (loss, grad)``: the
        whole two-stage chain rule over chunks resident on the device,
        ``stacks`` one ``(n_chunks, rows, ...)`` tensor a stream.

        Each chunk's forward runs under ``remat_policy`` (see
        :func:`resolve_remat_policy`; the default saves matrix products
        and recomputes the rest) from a leaf copy of ``params`` of its
        own; the partial sumstats add up in chunk order; their total (and
        any additive sumstats aux) is summed over the comm in one
        all-reduce; ``dL/dy`` is taken from it; one backward pass runs
        every chunk's VJP against it, recomputing one chunk at a time
        where the policy saved nothing; the chunks' gradients add up in
        chunk order and are summed over the comm in a second all-reduce.
        So no chunk's recomputed graph outlives its chunk, and the loss
        and gradient equal the two-pass streamed ones bit for bit.
        """
        names = tuple(stream_names)
        run = resolve_remat_policy(remat_policy)

        def program(params, stacks, key=None):
            kwargs = {"randkey": key} if with_key else {}
            leaves = [params.detach().requires_grad_(True)
                      for _ in range(stacks[0].shape[0])]
            with torch.enable_grad():
                total = None
                for k, p in enumerate(leaves):
                    model = self._with_chunk(names, [s[k] for s in stacks])
                    out = run(functools.partial(
                        model.calc_partial_sumstats_from_params, **kwargs),
                        p)
                    total = out if total is None else tree_map(
                        torch.add, total, out)
                y, ss_aux = total if self.sumstats_func_has_aux \
                    else (total, None)
                y_tot, aux_tot = psum_tree(
                    (y.detach(), tree_map(torch.Tensor.detach, ss_aux)),
                    self.comm)
                y_tot.requires_grad_(True)
                loss, _ = self._loss(y_tot, aux_tot, kwargs)
                (ct,) = torch.autograd.grad(loss, y_tot)
                grads = torch.autograd.grad(y, leaves, grad_outputs=ct)
            grad = grads[0]
            for g in grads[1:]:
                grad = grad + g
            return loss.detach(), psum(grad, self.comm)
        return program

    def check_shard_safety(self, params, **kwargs):
        """Statically verify this model's programs: one call to
        :func:`multigrad_tpu_torch.analysis.analyze_model`, which runs
        each program on meta tensors (nothing on the card) and returns a
        list of :class:`~multigrad_tpu_torch.analysis.Finding`, empty
        when the communication bound, dtype hygiene and constant-capture
        rules all hold.  ``kwargs`` are forwarded (``kinds=``,
        ``randkey=``, ``checks=``, ``scale=``, ``k_scale=``, ...)."""
        from ..analysis import analyze_model
        return analyze_model(self, params, **kwargs)

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
                 comm=None, progress=True, checkpoint_dir=None,
                 checkpoint_every=None, telemetry=None, log_every=0,
                 donate_carry=None, flight=None, live=None, alerts=None,
                 diagnostics=False):
        """Adam; returns the ``(nsteps+1, ndim)`` parameter trajectory
        (see :func:`multigrad_tpu_torch.optim.adam._run_adam_loop`).
        With ``checkpoint_dir`` the fit writes its restart state every
        ``checkpoint_every`` steps and resumes from it; the model's
        ``aux_data`` is fingerprinted into the checkpoint.  ``comm`` is
        accepted and ignored, as in the JAX package (the model's own comm
        reduces), and so is ``donate_carry``.

        Monitoring as :func:`~multigrad_tpu_torch.optim.adam
        .run_adam_scan`'s (``telemetry``, ``log_every``, ``flight``,
        ``live``, ``alerts``), with, as in the JAX package, a ``comm``
        record up front: :func:`~multigrad_tpu_torch.telemetry
        .measure_model_comm` of one loss and gradient at ``guess`` (the
        port counts a real evaluation: one more launch of each kernel).
        ``diagnostics=True`` (with a tap) adds the loss EMA and the
        gradient-noise-scale fields ``grad_noise_scale`` and
        ``grad_norm_shard`` to each ``adam`` record (one more scalar
        all-reduce a step).  The trajectory equals the fit without
        monitoring bit for bit."""
        del comm, donate_carry
        from ..telemetry.comm import measure_model_comm
        from ..telemetry.live import wire_monitoring

        if const_randkey and randkey is None:
            raise ValueError("Must pass randkey if const_randkey")
        guess = self._params(guess)
        telemetry, log_every, owned = wire_monitoring(
            telemetry, log_every, live, alerts)
        try:
            if telemetry is not None:
                cc = measure_model_comm(self, guess, randkey=randkey)
                telemetry.log(
                    "comm", **cc.step_record(scope="loss_and_grad_step"))
            diag = bool(diagnostics) and telemetry is not None \
                and log_every > 0
            return _adam._run_adam_loop(
                self._fit_loss_and_grad_gns if diag
                else self._fit_loss_and_grad, guess, nsteps=nsteps,
                param_bounds=param_bounds, learning_rate=learning_rate,
                randkey=randkey, const_randkey=const_randkey,
                progress=progress, checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every, data=self.aux_data,
                comm=self.comm, monitor=_adam._scan_monitor(
                    telemetry, log_every, flight, nsteps, checkpoint_every,
                    diagnostics=diag, fn_diag=diag))
        finally:
            if owned is not None:
                owned.close()

    def run_bfgs(self, guess, maxsteps=100, param_bounds=None, randkey=None,
                 comm=None, progress=True):
        """L-BFGS-B; returns scipy's ``OptimizeResult`` (see
        :func:`multigrad_tpu_torch.optim.bfgs.run_bfgs`).  ``comm`` is
        accepted and ignored, as in the JAX package."""
        del comm
        return _bfgs.run_bfgs(
            self._fit_loss_and_grad, self._params(guess), maxsteps=maxsteps,
            param_bounds=param_bounds, randkey=randkey, progress=progress)
