"""Adam optimization, host loop (port of :mod:`multigrad_tpu.optim.adam`).

Every entry point runs one host loop, :func:`_run_adam_loop`, over the
JAX package's contracts: :func:`run_adam` and :func:`run_adam_unbounded`
call ``logloss_and_grad_fn(params, data[, randkey=key])`` (the
reference's generic form), :func:`run_adam_scan` calls
``loss_and_grad(params, key, *fn_args)``, and the models' ``run_adam``
and :func:`run_adam_streamed` call ``loss_and_grad(params[,
randkey=key])``.

The update is optax's ``adam`` written out: ``b1=0.9``, ``b2=0.999``,
``eps=1e-8`` outside the square root, bias-corrected moments.  Each
step is one call of the loss-and-grad function and a few elementwise
ops on the parameter tensor; nothing is copied to the host.

PRNG: a key is an integer seed (a ``torch.Generator`` seed for the
model).  Per step, ``key, key_i = split_key(key)`` (the reference's
rank-0 chain); with ``const_randkey`` the initial key is used at every
step.  The draws differ from ``jax.random``'s, so fits with keys match
the JAX package in distribution only.

Checkpointing (``checkpoint_dir``): the same host loop runs in segments
of ``checkpoint_every`` steps, and after each the restart state (step,
unbounded params, moments, key, trajectory so far) is written to
``checkpoint_dir/adam_state.npz``, with the fit's configuration and a
fingerprint of its data inside; the last write holds the trajectory the
fit returns (bounded, with ``param_bounds``).  A call with the same
arguments resumes from the last segment written, so a checkpointed fit
equals the plain one bit for bit; a finished fit is a pure read.
"""
from __future__ import annotations

import os
import zlib
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from .transforms import (bounds_to_arrays, check_strictly_inside,
                         inverse_transform_array,
                         inverse_transform_diag_jacobian, transform_array)
from ..parallel.collectives import all_gather
from ..parallel.mesh import MeshComm
from ..utils import checkpoint as _ckpt
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
    """Loss-and-grad in unbounded space with the diagonal chain rule;
    positional and keyword arguments after the parameters pass
    through."""
    def unbound_loss_and_grad(uparams, *args, **kwargs):
        loss, grad = loss_and_grad(
            inverse_transform_array(uparams, low, high), *args, **kwargs)
        return loss, grad * inverse_transform_diag_jacobian(uparams, low,
                                                            high)
    return unbound_loss_and_grad


def _run_adam_loop(loss_and_grad: Callable, guess, nsteps: int = 100,
                   param_bounds=None, learning_rate: float = 0.01,
                   randkey=None, const_randkey: bool = False,
                   progress: bool = True, device=None,
                   checkpoint_dir: Optional[str] = None,
                   checkpoint_every: Optional[int] = None, data=None,
                   comm: Optional[MeshComm] = None):
    """The host loop every Adam entry point runs: Adam on
    ``loss_and_grad(params[, randkey=key]) -> (loss, grad)``.

    With ``param_bounds`` (a sequence of ``None | (low, high)``) the loop
    runs in unbounded space through the bijection.  Returns the
    parameter trajectory, shape ``(nsteps + 1, ndim)``, starting point
    included, on the device of ``guess`` (``device`` for a guess that is
    not a tensor; ``None`` means CUDA).

    A ``(K, ndim)`` guess is K independent fits (the update is
    elementwise; the bounds apply to every row): the trajectory is
    ``(nsteps + 1, K, ndim)``, and ``loss_and_grad`` takes the batch and
    may return a ``(K,)`` loss (the ensemble's batched call).

    With ``checkpoint_dir`` the fit runs in segments of
    ``checkpoint_every`` steps (default ``max(1, nsteps // 10)``) and
    writes its restart state after each; a call with the same arguments
    and ``data`` resumes from it (see the module docstring), and another
    configuration or other data raises ``ValueError``.  ``data`` is the
    tree of tensors the loss reads, fingerprinted into the checkpoint;
    ``comm`` the processes that run the fit together: its rank 0 writes,
    and every rank reads after a barrier.
    """
    if not isinstance(guess, torch.Tensor):
        guess = torch.as_tensor(np.asarray(guess, np.float32),
                                device=resolve_device(device))
    params = guess.detach().to(torch.float32)
    if const_randkey and randkey is None:
        raise ValueError("Must pass randkey if const_randkey")
    bounded = param_bounds is not None
    key = None if randkey is None else init_randkey(randkey)

    state, save = None, None
    if checkpoint_dir is not None:
        every = max(1, nsteps // 10) if checkpoint_every is None \
            else int(checkpoint_every)
        if every < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got {every}")
        # Built on the host, so that the read of a finished fit launches
        # no kernel: the guess, the bounds, the rest of the arguments.
        bounds = bounds_to_arrays(param_bounds, params.shape[-1], "cpu") \
            if bounded else ()
        config = np.concatenate([
            params.cpu().numpy().astype(np.float64).reshape(-1),
            *[b.numpy().astype(np.float64) for b in bounds],
            np.asarray([learning_rate, float(bounded), float(key is not None),
                        float(const_randkey)], np.float64)])
        config_key = np.asarray([-1 if key is None else key], np.int64)
        state, traj, save = _resume(checkpoint_dir, params, nsteps, config,
                                    config_key, data, comm, every)
        if state is not None and state["step"] == nsteps:
            # A finished fit: the trajectory it returned, stored as it
            # was.
            return traj

    fn = loss_and_grad
    low = high = None
    if bounded:
        low, high = bounds_to_arrays(param_bounds, params.shape[-1],
                                     params.device)
        check_strictly_inside(params, low, high, param_bounds)
        params = transform_array(params, low, high)
        fn = _wrap_bounded(loss_and_grad, low, high)
    if state is None:
        state = dict(step=0, u=params.clone(), mu=torch.zeros_like(params),
                     nu=torch.zeros_like(params), key=key)
        traj = [state["u"]]

    u, mu, nu, key = state["u"], state["mu"], state["nu"], state["key"]
    start = state["step"]
    for i in trange(nsteps - start, "Adam Gradient Descent Progress",
                    progress):
        step = start + i
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
        if save is not None and step + 1 < nsteps:
            save(step + 1, u, mu, nu, key, traj)
    traj = torch.stack(traj)
    if bounded:
        traj = inverse_transform_array(traj, low, high)
    if save is not None:
        save(nsteps, u, mu, nu, key, traj)
    return traj


#: The monitoring arguments, which belong to telemetry (not ported yet).
MONITORING_NOT_PORTED = (
    "{} is not ported yet (telemetry: ROADMAP.md Queue 1 item 7)")


def _refuse_monitoring(**given):
    """Raise ``NotImplementedError`` for a monitoring argument given a
    value other than ``None``, 0 or ``False``."""
    for name, value in given.items():
        if value not in (None, 0):
            raise NotImplementedError(MONITORING_NOT_PORTED.format(name))


def run_adam_unbounded(logloss_and_grad_fn, params, data, nsteps=100,
                       learning_rate=0.01, randkey=None, progress=True,
                       device=None):
    """Adam on ``logloss_and_grad_fn(params, data[, randkey=key]) -> (loss,
    grad)`` (parity: ``optim/adam.py:1259-1290`` of the JAX package, the
    reference's contract).  Returns the ``(nsteps + 1, ndim)`` trajectory
    on the device of ``params`` (``device`` for params that are not a
    tensor; ``None`` means CUDA)."""
    return _run_adam_loop(
        lambda p, **kwargs: logloss_and_grad_fn(p, data, **kwargs), params,
        nsteps=nsteps, learning_rate=learning_rate, randkey=randkey,
        progress=progress, device=device)


def run_adam(logloss_and_grad_fn, params, data, nsteps=100,
             param_bounds=None, learning_rate=0.01, randkey=None,
             progress=True, device=None):
    """Adam on ``logloss_and_grad_fn(params, data[, randkey=key])``,
    through the bounds bijection with ``param_bounds`` (a sequence of
    ``None | (low, high)``, one a parameter, the start strictly inside)
    (parity: ``optim/adam.py:1293-1319`` of the JAX package).  Returns
    the ``(nsteps + 1, ndim)`` trajectory, as
    :func:`run_adam_unbounded`."""
    if param_bounds is None:
        return run_adam_unbounded(
            logloss_and_grad_fn, params, data, nsteps=nsteps,
            learning_rate=learning_rate, randkey=randkey, progress=progress,
            device=device)
    n = len(params)
    if n != len(param_bounds):
        raise ValueError(
            f"param_bounds must have one entry per parameter: got "
            f"{len(param_bounds)} bounds for {n} params")
    return _run_adam_loop(
        lambda p, **kwargs: logloss_and_grad_fn(p, data, **kwargs), params,
        nsteps=nsteps, param_bounds=param_bounds,
        learning_rate=learning_rate, randkey=randkey, progress=progress,
        device=device)


def run_adam_scan(loss_and_grad: Callable, params, nsteps: int = 100,
                  param_bounds=None, learning_rate: float = 0.01,
                  randkey=None, const_randkey: bool = False,
                  progress: bool = False, fn_args=(),
                  checkpoint_dir: Optional[str] = None,
                  checkpoint_every: Optional[int] = None, telemetry=None,
                  log_every: int = 0, donate_carry: Optional[bool] = None,
                  flight=None, live=None, alerts=None,
                  diagnostics: bool = False, fn_diag: bool = False,
                  carry_sharding=None, device=None):
    """Adam on ``loss_and_grad(params, key, *fn_args) -> (loss, grad)``
    (the contract of the JAX package's ``run_adam_scan``,
    ``optim/adam.py:675``), on the port's host loop.

    ``key`` is the step's integer seed: split off ``randkey`` each step,
    ``randkey`` itself with ``const_randkey``, and 0 without ``randkey``
    (the JAX package passes ``jax.random.key(0)`` there).  ``params`` may
    be ``(K, ndim)``, K independent fits.  With ``checkpoint_dir`` (1-D
    params only, as in the JAX package) the fit writes its restart state
    every ``checkpoint_every`` steps and resumes from it; ``fn_args`` is
    fingerprinted into it.  ``donate_carry`` is accepted and has no
    effect (a host loop has no carry to donate).  The monitoring
    arguments (``telemetry``, ``log_every``, ``flight``, ``live``,
    ``alerts``, ``diagnostics``, ``fn_diag``) and ``carry_sharding``
    (sharded K) are not ported yet and raise when given.
    """
    del donate_carry
    _refuse_monitoring(telemetry=telemetry, log_every=log_every,
                       flight=flight, live=live, alerts=alerts,
                       diagnostics=diagnostics, fn_diag=fn_diag,
                       carry_sharding=carry_sharding)
    fn_args = tuple(fn_args)
    ndim = params.dim() if isinstance(params, torch.Tensor) \
        else np.ndim(params)
    if checkpoint_dir is not None and ndim != 1:
        raise ValueError(
            "checkpoint_dir requires 1-D params (the restart state "
            f"layout is per-fit); got shape {np.shape(params)}")

    def fn(p, randkey=0):
        return loss_and_grad(p, randkey, *fn_args)

    return _run_adam_loop(
        fn, params, nsteps=nsteps, param_bounds=param_bounds,
        learning_rate=learning_rate, randkey=randkey,
        const_randkey=const_randkey, progress=progress, device=device,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        data=fn_args)


def run_adam_streamed(loss_and_grad: Callable, params, nsteps: int = 100,
                      param_bounds=None, learning_rate: float = 0.01,
                      randkey=None, const_randkey: bool = False,
                      progress: bool = True,
                      checkpoint_dir: Optional[str] = None,
                      checkpoint_every: Optional[int] = None,
                      comm: Optional[MeshComm] = None):
    """Adam over a *streamed* loss-and-grad callable (the fit loop of
    :class:`~multigrad_tpu_torch.data.streaming.StreamingOnePointModel`;
    parity: ``optim/adam.py:952`` of the JAX package).

    Each step calls ``loss_and_grad(params[, randkey=...]) -> (loss,
    grad)``, which for a streamed model runs the two-pass chunked chain
    rule (or the scan path) on the host.  The same host loop as
    :func:`_run_adam_loop`, so the same trajectory contract, bounds and
    checkpointing: with ``checkpoint_dir`` the restart state is written
    every ``checkpoint_every`` steps and a call with the same arguments
    resumes from it.  The streamed catalog is not fingerprinted into the
    checkpoint (the callable closes over its sources): keep it fixed
    across a resume.  ``comm``: the processes that run the fit together
    (its rank 0 writes the checkpoint).
    """
    return _run_adam_loop(
        loss_and_grad, params, nsteps=nsteps, param_bounds=param_bounds,
        learning_rate=learning_rate, randkey=randkey,
        const_randkey=const_randkey, progress=progress,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        data=None, comm=comm)


#: Bytes of a leaf copied to the host at a time for its checksum.
_DIGEST_CHUNK = 1 << 26


def _leaf_entries(tree, path=""):
    """``(path, shape, dtype, crc32 of every byte)`` for each tensor or
    array of ``tree`` (dict keys sorted), ``(path, repr)`` for any other
    leaf.  The bytes reach the host in chunks; no kernel is launched."""
    if isinstance(tree, dict):
        return [e for k in sorted(tree, key=str)
                for e in _leaf_entries(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [e for i, item in enumerate(tree)
                for e in _leaf_entries(item, f"{path}/{i}")]
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(np.ascontiguousarray(tree))
    if not isinstance(tree, torch.Tensor):
        return [(path, repr(tree))]
    flat = tree.detach().contiguous().reshape(-1)
    raw = flat.view(torch.uint8) if flat.numel() else flat
    crc = 0
    for at in range(0, raw.numel(), _DIGEST_CHUNK):
        crc = zlib.crc32(raw[at:at + _DIGEST_CHUNK].cpu().numpy(), crc)
    return [(path, tuple(tree.shape), str(tree.dtype), crc)]


def _args_fingerprint(data, comm: Optional[MeshComm] = None) -> int:
    """CRC of the data's leaves (every byte of every tensor); with a comm
    of several processes, of every process's shard, in rank order."""
    crc = zlib.crc32(repr(_leaf_entries(data)).encode())
    if comm is not None and comm.size > 1:
        crcs = all_gather(torch.tensor([crc], dtype=torch.int64), comm)
        crc = zlib.crc32(np.asarray(crcs.cpu(), np.int64).tobytes())
    return crc


def _barrier(comm: Optional[MeshComm]):
    if comm is not None and comm.distributed and comm.size > 1:
        dist.barrier(group=comm.group)


def _resume(checkpoint_dir, params, nsteps, config, config_key, data, comm,
            every):
    """The restart state of ``checkpoint_dir`` when it holds one for this
    fit (raise when it holds another's), else ``None``; the trajectory so
    far (a list of unbounded rows, or the returned tensor of a finished
    fit); and the ``save(step, u, mu, nu, key, rows)`` callback of the
    segment ends, whose ``rows`` are the list of unbounded rows so far or,
    at the last step, the trajectory tensor the fit returns."""
    path = os.path.join(checkpoint_dir, "adam_state")
    config_args = np.asarray([_args_fingerprint(data, comm)], np.uint32)
    like = dict(step=0, u=params, mu=params, nu=params, key=0,
                traj=params.new_empty((nsteps + 1,) + tuple(params.shape)),
                config=config, config_key=config_key,
                config_args=config_args)
    _barrier(comm)
    state, traj = None, None
    if os.path.exists(path + ".npz"):
        try:
            saved = _ckpt.load(path, like)
        except ValueError as e:
            raise ValueError(
                f"cannot resume from checkpoint in {checkpoint_dir!r}: {e} "
                "(use a fresh checkpoint_dir to start over)") from e
        if saved["traj"].shape[0] != nsteps + 1:
            raise ValueError(
                f"checkpoint in {checkpoint_dir!r} was written for a "
                "different nsteps; use a fresh checkpoint_dir")
        if not (np.array_equal(saved["config"], config)
                and np.array_equal(saved["config_key"], config_key)):
            raise ValueError(
                f"checkpoint in {checkpoint_dir!r} was written for a "
                "different fit configuration (guess/bounds/learning_rate/"
                "randkey); use a fresh checkpoint_dir")
        if not np.array_equal(saved["config_args"], config_args):
            raise ValueError(
                f"checkpoint in {checkpoint_dir!r} was written for "
                "different training data (aux-data fingerprint mismatch); "
                "use a fresh checkpoint_dir")
        step = saved["step"]
        state = dict(step=step, u=saved["u"], mu=saved["mu"],
                     nu=saved["nu"],
                     key=None if saved["key"] < 0 else saved["key"])
        traj = saved["traj"] if step == nsteps \
            else list(saved["traj"][:step + 1].unbind(0))
    writer = comm is None or comm.rank == 0

    def save(step, u, mu, nu, key, rows):
        if step % every and step != nsteps:
            return
        if writer:
            os.makedirs(checkpoint_dir, exist_ok=True)
            if isinstance(rows, list):
                rows = torch.stack(rows)
            full = rows.new_zeros((nsteps + 1,) + tuple(rows.shape[1:]))
            full[:rows.shape[0]] = rows
            _ckpt.save(path, dict(
                step=np.int64(step), u=u, mu=mu, nu=nu,
                key=np.int64(-1 if key is None else key), traj=full,
                config=config, config_key=config_key,
                config_args=config_args))
        if step == nsteps:
            _barrier(comm)

    return state, traj, save
