"""Multi-start ensembles (port of :mod:`multigrad_tpu.inference
.ensemble`).

One-point losses are rarely convex, so a single fit finds *a* basin,
not necessarily *the* basin.  :func:`run_multistart_adam` runs K
independent Adam fits as one: Adam's update is elementwise, so a
``(K, ndim)`` parameter matrix driven by the model's batched loss and
gradient (:meth:`~multigrad_tpu_torch.core.model.OnePointModel
.batched_loss_and_grad_fn`: K rows, 2 all-reduces a step) is K exact
independent fits.  :func:`run_multistart_lbfgs` polishes starts with
L-BFGS, one start after another (its curvature pairs couple the
coordinates), each evaluation one row of the same batched call.
:func:`hmc_init_from_ensemble` turns the winning basin into chain starts
for :func:`~multigrad_tpu_torch.inference.run_hmc`.

Sharded K: on an :func:`~multigrad_tpu_torch.parallel.ensemble_comm`
the K axis partitions over the replica axis (``k_sharded``), each
process holding K/R rows of the parameters, moments, trajectory and,
the port's own term, the rows' autograd graphs
(:func:`ensemble_memory_model`, :func:`row_graph_bytes`).
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.model import cached_program
from ..optim import adam as _adam
from ..optim import bfgs as _bfgs
from ..optim.transforms import bounds_to_arrays
from ..utils.util import latin_hypercube_sampler, resolve_device

__all__ = ["EnsembleResult", "batched_fit_wrapper",
           "run_multistart_adam", "run_multistart_lbfgs",
           "hmc_init_from_ensemble",
           "ensemble_memory_model", "max_k_for_budget",
           "resolve_k_sharded", "resolve_k_shard_topology",
           "k_shards_bucket", "pad_k_to_replicas", "row_graph_bytes",
           "DEFAULT_K_BUDGET_BYTES", "GRAPH_BYTES_PER_CATALOG_ROW"]

#: Per-member resident rows of the batched Adam fit beyond the
#: trajectory: params, Adam's two moment sets and the update transient,
#: each ``ndim`` floats a member.
ENSEMBLE_STATE_ROWS = 4

#: Bytes of a float32 item: the port's parameters and moments.
ITEMSIZE = 4

#: Default per-device memory budget of the ``k_sharded="auto"`` rule (the
#: JAX package's; overridable per call and with ``MGT_K_BUDGET_BYTES``).
DEFAULT_K_BUDGET_BYTES = 1 << 30

#: What one row of the port's batched loss and gradient holds until the
#: backward, a catalog row: the forward's float32 ``values``, which the
#: erf kernel saves as its input (the SMF model's ``log_mh + p0``: its
#: only catalog-sized tensor).  The one place the graph term is declared
#: (ROADMAP Queue 2 item 9); :func:`row_graph_bytes` reads it.
GRAPH_BYTES_PER_CATALOG_ROW = 4


def row_graph_bytes(model) -> int:
    """Bytes of one row's autograd graph in this process's batched call:
    :data:`GRAPH_BYTES_PER_CATALOG_ROW` a catalog row of the process's
    shard (each member's, in a group).  The port's batched call is a host
    loop with one backward over all rows, so every row's graph lives
    until that backward (the JAX package's vmapped program holds none)."""
    from ..tune.table import catalog_rows
    return GRAPH_BYTES_PER_CATALOG_ROW * sum(
        catalog_rows(m.aux_data) for m in getattr(model, "models", (model,)))


def ensemble_memory_model(k: int, ndim: int, nsteps: int, *,
                          n_replicas: int = 1, catalog_bytes: int = 0,
                          n_devices: Optional[int] = None,
                          itemsize: Optional[int] = None,
                          graph_bytes: int = 0) -> int:
    """Per-device bytes of a ``(K, ndim)`` batched Adam fit: the ``(nsteps
    + 1, K, ndim)`` trajectory plus :data:`ENSEMBLE_STATE_ROWS` state rows
    a member, divided by ``n_replicas`` when K is sharded, plus the
    catalog's share, ``catalog_bytes · n_replicas / n_devices`` (the JAX
    package's arithmetic).

    The port's term, ``graph_bytes`` (:func:`row_graph_bytes` of the
    model): each of a process's K/R rows holds its graph until the
    backward, and the backward adds one row's cotangent of the same size
    while it runs, so ``(K/R + 1) · graph_bytes``, the dispatch's own
    bytes above what the process held before it."""
    itemsize = ITEMSIZE if itemsize is None else int(itemsize)
    r = max(int(n_replicas), 1)
    k_local = math.ceil(max(int(k), 0) / r)
    state = k_local * int(ndim) * itemsize \
        * (int(nsteps) + 1 + ENSEMBLE_STATE_ROWS)
    data = 0
    if catalog_bytes and n_devices:
        data = int(catalog_bytes) * r // max(int(n_devices), 1)
    graph = (k_local + 1) * int(graph_bytes) if k_local else 0
    return int(state + data + graph)


def max_k_for_budget(budget_bytes: int, ndim: int, nsteps: int, *,
                     n_replicas: int = 1, catalog_bytes: int = 0,
                     n_devices: Optional[int] = None,
                     itemsize: Optional[int] = None,
                     graph_bytes: int = 0) -> int:
    """The largest K whose :func:`ensemble_memory_model` estimate fits
    ``budget_bytes`` a device (0 when the catalog's share, and the
    backward's one row of ``graph_bytes``, alone do not): ×R with
    ``n_replicas``."""
    itemsize = ITEMSIZE if itemsize is None else int(itemsize)
    r = max(int(n_replicas), 1)
    data = int(graph_bytes)
    if catalog_bytes and n_devices:
        data += int(catalog_bytes) * r // max(int(n_devices), 1)
    per_member = int(ndim) * itemsize \
        * (int(nsteps) + 1 + ENSEMBLE_STATE_ROWS) + int(graph_bytes)
    if budget_bytes <= data or per_member <= 0:
        return 0
    return ((int(budget_bytes) - data) // per_member) * r


def _k_budget_bytes(budget=None) -> int:
    if budget is not None:
        return int(budget)
    env = os.environ.get("MGT_K_BUDGET_BYTES")
    return int(env) if env else DEFAULT_K_BUDGET_BYTES


def resolve_k_shard_topology(model, k_sharded="auto"):
    """``(sharded, n_replicas)`` for a ``k_sharded`` knob (``"auto"`` or a
    bool): the one rule every sharded-K consumer shares (the ensemble,
    the scheduler, warmup, the tuner, the HMC stage).  ``True`` demands a
    replica axis (``ValueError`` naming ``ensemble_comm`` without one),
    ``False`` pins the replicated layout, and ``"auto"`` shards exactly
    when the model is on an ensemble comm.  ``n_replicas`` is 1 whenever
    ``sharded`` is ``False``."""
    if k_sharded is True:
        model._require_k_shard_axis()
        return True, model.k_shard_replicas
    if k_sharded is False:
        return False, 1
    if k_sharded != "auto":
        raise ValueError(
            f"k_sharded must be True, False or 'auto', got {k_sharded!r}")
    if model.k_shard_axis is None:
        return False, 1
    return True, model.k_shard_replicas


def k_shards_bucket(bucket: int, k_sharded: bool, n_replicas: int) -> bool:
    """The dispatch rule: a ``(K, ndim)`` batch runs the K-partitioned
    program exactly when sharding is on and the replica count divides K
    (an indivisible rung, the K = 1 singleton, runs replicated)."""
    r = max(int(n_replicas), 1)
    return bool(k_sharded) and int(bucket) % r == 0


def resolve_k_sharded(model, k: int, ndim: int, nsteps: int,
                      k_sharded="auto", k_budget_bytes=None) -> bool:
    """Resolve ``k_sharded`` for a K-member batched fit, the JAX package's
    rule: ``"auto"`` shards when the model has a replica axis, K is at
    least the replica count, and the replicated layout's per-device
    estimate (:func:`ensemble_memory_model`, with the port's graph term
    :func:`row_graph_bytes`) exceeds ``k_budget_bytes`` (default
    :data:`DEFAULT_K_BUDGET_BYTES`, env ``MGT_K_BUDGET_BYTES``).
    ``True`` demands the replica axis, ``False`` pins replicated."""
    sharded, r = resolve_k_shard_topology(model, k_sharded)
    if not sharded or k_sharded != "auto":
        return sharded
    if int(k) < r:
        return False
    replicated = ensemble_memory_model(int(k), int(ndim), int(nsteps),
                                       graph_bytes=row_graph_bytes(model))
    return replicated > _k_budget_bytes(k_budget_bytes)


def pad_k_to_replicas(inits, n_replicas: int):
    """``(padded, K)``: a ``(K, ndim)`` batch padded up to a multiple of
    the replica count with copies of row 0 (inert independent fits)."""
    k = int(inits.shape[0])
    pad = (-k) % max(int(n_replicas), 1)
    if pad:
        inits = torch.cat([inits, inits[:1].expand(pad, *inits.shape[1:])])
    return inits, k


def batched_fit_wrapper(model, with_key: bool, k_sharded: bool = False):
    """``wrapper(params_batch, key, aux_leaves) -> (losses, grads)`` over
    the model's :meth:`batched_loss_and_grad_fn`, in the argument order
    of the JAX package's Adam scan.  Cached on the model, so ensembles
    and the serving layer's bucket dispatches share one wrapper;
    ``k_sharded=True`` wraps the K-partitioned program, a sibling
    entry."""
    def build():
        program = model.batched_loss_and_grad_fn(with_key,
                                                 k_sharded=k_sharded)

        def wrapper(p, key, aux_leaves):
            return program(p, aux_leaves, key)
        return wrapper
    return cached_program(
        model, ("multistart_adam_wrapper", bool(with_key), bool(k_sharded)),
        build)


def _numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def float32_on(x, device) -> torch.Tensor:
    """``x`` (a tensor, or anything numpy takes) as float32 on
    ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, np.float32))
    return x.detach().to(device, torch.float32)


@dataclass(frozen=True)
class EnsembleResult:
    """Outcome of a multi-start fit.

    Attributes
    ----------
    best_params : tensor, shape (ndim,)
        Parameters of the lowest-loss basin.
    best_loss : float
        Its loss.
    params : tensor, shape (n_starts, ndim)
        Final parameters of every start.
    losses : tensor, shape (n_starts,)
        Final losses of every start (``argmin`` over the finite ones picks
        ``best_params``).
    inits : tensor, shape (n_starts, ndim)
        The starts.
    k_sharded : bool
        Whether the fit ran with K sharded over the replica axis (what
        the ``k_sharded="auto"`` rule resolved to).
    """

    best_params: torch.Tensor
    best_loss: float
    params: torch.Tensor
    losses: torch.Tensor
    inits: torch.Tensor
    k_sharded: bool = False

    @property
    def n_starts(self) -> int:
        return self.params.shape[0]

    def basin_spread(self) -> float:
        """The largest distance of a final point from the winner: ~0 when
        every start found the same basin."""
        d = np.linalg.norm(_numpy(self.params) - _numpy(self.best_params),
                           axis=1)
        return float(np.max(d))


def _sample_inits(param_bounds, n_starts, ndim, seed):
    """Latin-hypercube starts strictly inside the bounds box (pulled 5% in
    from each face: the bounds bijection needs interior points), float64
    numpy."""
    low, high = (b.numpy().astype(np.float64)
                 for b in bounds_to_arrays(param_bounds, ndim, "cpu"))
    if not (np.all(np.isfinite(low)) and np.all(np.isfinite(high))):
        raise ValueError(
            "multi-start sampling needs finite (low, high) bounds for "
            "every parameter; pass explicit `inits` for unbounded fits")
    pad = 0.05 * (high - low)
    return latin_hypercube_sampler(low + pad, high - pad, ndim, n_starts,
                                   seed=seed)


def run_multistart_adam(model, param_bounds=None, n_starts: int = 8,
                        nsteps: int = 200, learning_rate: float = 0.01,
                        inits=None, seed: int = 0, randkey=None,
                        const_randkey: bool = False, bound_fits: bool = True,
                        donate_carry=None, telemetry=None,
                        log_every: int = 0, live=None, alerts=None,
                        k_sharded="auto",
                        k_budget_bytes=None) -> EnsembleResult:
    """K independent Adam fits as one batched fit (parity:
    ``inference/ensemble.py:296-434`` of the JAX package).

    One :func:`~multigrad_tpu_torch.optim.adam.run_adam_scan` call on the
    ``(K, ndim)`` starts through :func:`batched_fit_wrapper` (each step
    one batched loss and gradient), then one batched evaluation of the
    finals; the best start is the ``argmin`` over finite losses.

    Parameters
    ----------
    model : OnePointModel or fused OnePointGroup
    param_bounds : sequence of (low, high), optional
        Finite boxes: the starts are a Latin-hypercube design inside them
        (seed ``seed``) and, with ``bound_fits``, the fits run through the
        bounds bijection.
    n_starts, nsteps, learning_rate : int, int, float
    inits : array (n_starts, ndim), optional
        Explicit starts (instead of the design; needed without bounds).
    randkey, const_randkey
        The model's randomness a step, as in ``run_adam``.
    donate_carry
        Accepted and ignored (a host loop has no carry to donate).
    telemetry, log_every, live, alerts
        The monitoring of :func:`~multigrad_tpu_torch.optim.adam
        .run_adam_scan`: ``adam`` records every ``log_every`` steps, each
        scalar the K-vector across starts, a ``fit_plan`` up front; and
        the ensemble's own closing ``fit_summary`` (``final_loss`` of the
        winning start, ``n_starts``, ``best_start``, ``k_sharded``).
    k_sharded : "auto" or bool
        Partition the K axis over the replica axis of an
        :func:`~multigrad_tpu_torch.parallel.ensemble_comm` (K/R rows of
        parameters, moments, trajectory and graphs a process; the
        trajectory and the finals' losses gathered at the end).  K is
        padded to a multiple of R with copies of row 0 and sliced back.
        ``"auto"`` follows :func:`resolve_k_sharded`; ``True`` on a flat
        comm raises ``ValueError``.
    k_budget_bytes : int, optional
        The ``"auto"`` rule's per-device budget.
    """
    del donate_carry
    from ..parallel.distributed import process_index
    from ..telemetry.live import wire_monitoring
    if inits is None:
        if param_bounds is None:
            raise ValueError(
                "pass param_bounds (finite boxes; inits are sampled "
                "inside them) or explicit inits")
        inits = _sample_inits(param_bounds, n_starts, len(param_bounds),
                              seed)
    inits = float32_on(inits, model.device)
    if inits.dim() != 2:
        raise ValueError(f"inits must be (n_starts, ndim), got shape "
                         f"{tuple(inits.shape)}")
    with_key = randkey is not None
    if const_randkey and not with_key:
        raise ValueError("Must pass randkey if const_randkey")
    sharded = resolve_k_sharded(model, inits.shape[0], inits.shape[1],
                                nsteps, k_sharded=k_sharded,
                                k_budget_bytes=k_budget_bytes)
    n_real, ks = int(inits.shape[0]), None
    if sharded:
        inits, n_real = pad_k_to_replicas(inits, model.k_shard_replicas)
        ks = model.k_sharding(inits.dim())
    wrapper = batched_fit_wrapper(model, with_key, k_sharded=sharded)
    leaves = model.aux_leaves()

    telemetry, log_every, owned = wire_monitoring(
        telemetry, log_every, live, alerts)
    try:
        traj = _adam.run_adam_scan(
            wrapper, inits, nsteps=nsteps,
            param_bounds=param_bounds if bound_fits else None,
            learning_rate=learning_rate, randkey=randkey,
            const_randkey=const_randkey, progress=False,
            fn_args=(leaves,), telemetry=telemetry, log_every=log_every,
            carry_sharding=ks)
        finals = traj[-1]
        key = _adam.init_randkey(randkey) if with_key else None
        if ks is None:
            losses, _ = wrapper(finals, key, leaves)
        else:
            losses = ks.gather(wrapper(ks.local(finals), key, leaves)[0])
        finals, losses, inits = finals[:n_real], losses[:n_real], \
            inits[:n_real]
        best = int(torch.argmin(torch.where(torch.isfinite(losses), losses,
                                            torch.inf)))
        best_loss = float(losses[best])
        if telemetry is not None and process_index() == 0:
            telemetry.log("fit_summary", steps=int(nsteps),
                          n_starts=n_real, best_start=best,
                          final_loss=best_loss, k_sharded=sharded)
    finally:
        if owned is not None:
            owned.close()
    return EnsembleResult(best_params=finals[best], best_loss=best_loss,
                          params=finals, losses=losses, inits=inits,
                          k_sharded=sharded)


def _lbfgs_polish_objective(model, with_key: bool):
    """``loss_and_grad(p, randkey=None) -> (loss, grad)`` for the L-BFGS
    polish: one row of the model's cached :func:`batched_fit_wrapper`
    (the call the Adam ensemble makes), itself cached on the model."""
    def build():
        wrapper = batched_fit_wrapper(model, with_key)
        leaves = model.aux_leaves()

        def loss_and_grad(p, randkey=None):
            losses, grads = wrapper(p[None], randkey, leaves)
            return losses[0], grads[0]
        return loss_and_grad
    return cached_program(
        model, ("multistart_lbfgs_objective", bool(with_key)), build)


def run_multistart_lbfgs(model, param_bounds=None, n_starts: int = 8,
                         maxsteps: int = 100, inits=None, seed: int = 0,
                         randkey=None, memory_size: int = 10
                         ) -> EnsembleResult:
    """K L-BFGS fits from scattered starts, one after another (parity:
    ``inference/ensemble.py:466-507`` of the JAX package): each start
    runs :func:`~multigrad_tpu_torch.optim.bfgs.run_lbfgs_scan` on
    :func:`_lbfgs_polish_objective`.  Typically the polish after
    :func:`run_multistart_adam` has ranked the basins: pass its best
    finals as ``inits``.  Each start's loss is its fit's last (the loss
    at the iterate before the last step); the best start is the
    ``argmin`` over the finite ones."""
    if inits is None:
        if param_bounds is None:
            raise ValueError(
                "pass param_bounds (finite boxes; inits are sampled "
                "inside them) or explicit inits")
        inits = _sample_inits(param_bounds, n_starts, len(param_bounds),
                              seed)
    inits = float32_on(inits, model.device)
    loss_and_grad = _lbfgs_polish_objective(model, randkey is not None)
    finals, losses = [], []
    for init in inits:
        u, traj_losses = _bfgs.run_lbfgs_scan(
            loss_and_grad, init, maxsteps=maxsteps, randkey=randkey,
            memory_size=memory_size, param_bounds=param_bounds)
        finals.append(u)
        losses.append(traj_losses[-1])
    finals, losses = torch.stack(finals), torch.stack(losses)
    best = int(torch.argmin(torch.where(torch.isfinite(losses), losses,
                                        torch.inf)))
    return EnsembleResult(best_params=finals[best],
                          best_loss=float(losses[best]), params=finals,
                          losses=losses, inits=inits)


def hmc_init_from_ensemble(result: EnsembleResult, num_chains: int = 4,
                           spread: float = 1e-2, randkey=0,
                           stderr=None) -> torch.Tensor:
    """``(num_chains, ndim)`` chain starts around an ensemble's winner: a
    Gaussian scatter of scale ``spread`` (``spread · stderr`` a component
    when Laplace errors are given, e.g. ``FisherResult.stderr()``) around
    ``best_params``, drawn from a ``torch.Generator`` seeded with
    ``randkey`` on the result's device (``None`` means CUDA when
    ``best_params`` is not a tensor).  It matches the JAX package in
    distribution only."""
    best = result.best_params
    device = best.device if isinstance(best, torch.Tensor) \
        else resolve_device()
    best = float32_on(best, device)
    scale = torch.full_like(best, spread) if stderr is None \
        else spread * float32_on(stderr, device)
    gen = torch.Generator(device=device).manual_seed(
        _adam.init_randkey(randkey))
    noise = torch.randn((num_chains, best.shape[0]), generator=gen,
                        device=device)
    return best[None] + noise * scale[None]
