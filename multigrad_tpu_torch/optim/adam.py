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

Monitoring (``telemetry``, ``log_every``, ``flight``, ``live``,
``alerts``, ``diagnostics``, ``fn_diag``; see :class:`_AdamMonitor`):
the ``adam`` tap, the non-finite sentinel and the loss EMA are a few
elementwise kernels on the step's tensors and deferred copies
(:mod:`multigrad_tpu_torch.telemetry.taps`), so a monitored step never
waits for the card either, and its trajectory equals the plain fit's
bit for bit.  The fit's end waits once, for the last records, before
its ``fit_summary``.
"""
from __future__ import annotations

import contextlib
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
from ..telemetry.spans import span
from ..parallel.mesh import MeshComm
from ..utils import checkpoint as _ckpt
from ..utils.util import resolve_device, trange

B1, B2, EPS = 0.9, 0.999, 1e-8


def adam_trange(n, progress: bool = True):
    """The Adam loop's progress bar over ``n`` steps (see
    :func:`~multigrad_tpu_torch.utils.util.trange`)."""
    return trange(n, "Adam Gradient Descent Progress", progress=progress)


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


def bias_corrections(step: int):
    """optax's bias corrections of step ``step`` (from 0), ``1 - B1**t``
    and ``1 - B2**t`` at ``t = step + 1``, computed in float32 on the
    host: Python floats."""
    count = torch.tensor(step + 1, dtype=torch.float32)
    return (float(1 - torch.tensor(B1) ** count),
            float(1 - torch.tensor(B2) ** count))


def adam_update(u, grad, mu, nu, corrections, learning_rate: float):
    """One Adam update of the unbounded parameters ``u`` from ``grad``,
    the moments ``mu``, ``nu`` and the step's :func:`bias_corrections`:
    ``(u, mu, nu, update)``.  Elementwise ops on the parameters' device
    and nothing read off it."""
    mu = (1 - B1) * grad + B1 * mu
    nu = (1 - B2) * grad ** 2 + B2 * nu
    mu_hat = mu / corrections[0]
    nu_hat = nu / corrections[1]
    update = learning_rate * (mu_hat / (torch.sqrt(nu_hat) + EPS))
    return u - update, mu, nu, update


def _wrap_bounded(loss_and_grad, low, high):
    """Loss-and-grad in unbounded space with the diagonal chain rule;
    positional and keyword arguments after the parameters pass through,
    and so does a third element of the result (the diagnostics dict of
    a ``fn_diag`` callable: scalar summaries, not parameter vectors)."""
    def unbound_loss_and_grad(uparams, *args, **kwargs):
        out = loss_and_grad(
            inverse_transform_array(uparams, low, high), *args, **kwargs)
        return (out[0], out[1] * inverse_transform_diag_jacobian(
            uparams, low, high)) + tuple(out[2:])
    return unbound_loss_and_grad


#: Decay of the loss-EMA plateau diagnostic (the JAX package's
#: ``PLATEAU_EMA_DECAY``: half-life ~34 steps).
PLATEAU_EMA_DECAY = 0.98


class _AdamMonitor:
    """What a monitored Adam fit does beside its steps.

    * the ``adam`` tap: every ``log_every``-th step, ``loss``,
      ``grad_norm``, ``param_norm`` and ``update_norm`` (unbounded
      space; per-member lists for a ``(K, ndim)`` fit), the ``fn_diag``
      diagnostics and, with ``diagnostics``, ``loss_ema`` and
      ``loss_ema_slope`` (the bias-corrected EMA of the loss, updated on
      the device every step, and its change a step since the last
      record);
    * the flight recorder's non-finite latch, on ``loss`` and
      ``grad_norm`` every step, riding the tap's copies;
    * the ``fit_plan`` record up front (``plan``, with the resume step
      when it holds ``start``), ``checkpoint`` spans around the writes,
      the ``fit_summary`` at the end, after the last records, and the
      :class:`~multigrad_tpu_torch.telemetry.flight
      .FlightRecorderTripped` after that;
    * with ``streamed``: the ``fit`` span, a heartbeat every
      ``heartbeat_s`` seconds, and ``steps_per_sec``, ``final_loss`` and
      the prefetcher's overlap (``stream_stats()``) in the summary.

    Nothing here reads a device value inside a step.
    """

    def __init__(self, telemetry, log_every: int, flight=None,
                 diagnostics: bool = False, fn_diag: bool = False,
                 plan: Optional[dict] = None, streamed: bool = False,
                 heartbeat_s: Optional[float] = None,
                 stream_stats: Optional[Callable] = None):
        from ..telemetry.taps import make_tap

        self.telemetry = telemetry
        self.flight = flight
        self.fn_diag = bool(fn_diag)
        self.tap = make_tap(telemetry, "adam", log_every)
        self.sentinel = flight.sentinel("adam") if flight is not None \
            else None
        self.diagnostics = bool(diagnostics) and self.tap is not None
        self.plan = plan or {}
        self.streamed = streamed
        self.heartbeat_s = heartbeat_s
        self.stream_stats = stream_stats
        self.last_loss = None
        self._heartbeat = self._meter = None
        self._ema = self._ema_prev = None
        self._ema_n = 0
        if self.sentinel is not None and self.tap is not None:
            self.tap.ride(self.sentinel)

    @contextlib.contextmanager
    def running(self, start: int):
        """Around the steps: the plan, the latch armed, and for streamed
        fits the ``fit`` span and the heartbeat."""
        from ..telemetry.spans import Heartbeat
        from ..utils.profiling import StepsPerSecond

        if self.sentinel is not None:
            self.sentinel.arm()
        if self.telemetry is not None:
            plan = dict(self.plan)
            if "start" in plan:
                plan["start"] = int(start)
            self.telemetry.log("fit_plan", **plan)
        self._start = start
        if not self.streamed:
            yield
            return
        self._meter = StepsPerSecond()
        if self.telemetry is not None and self.heartbeat_s:
            self._heartbeat = Heartbeat(self.telemetry,
                                        interval=self.heartbeat_s)
        with span(self.telemetry, "fit", nsteps=self.plan.get("nsteps"),
                  start=int(start)), \
                (self._heartbeat or contextlib.nullcontext()):
            yield

    def step(self, step: int, out, u, update):
        """After step ``step``: ``out`` is the loss-and-grad's result at
        the step's parameters, ``u`` the new unbounded parameters,
        ``update`` the step's change (up to sign)."""
        import torch

        from ..telemetry.taps import batch_norm

        loss, grad = out[0], out[1]
        self.last_loss = loss
        grad_norm = None
        if self.sentinel is not None:
            grad_norm = batch_norm(grad)
            self.sentinel.watch(step, dict(loss=loss, grad_norm=grad_norm))
        if self.diagnostics:
            if self._ema is None:
                self._ema = torch.zeros_like(loss)
            self._ema = torch.add(self._ema * PLATEAU_EMA_DECAY, loss,
                                  alpha=1.0 - PLATEAU_EMA_DECAY)
            self._ema_n += 1
        if self._meter is not None:
            self._meter.tick()
            if step == self._start:
                # The first step paid the warm-up (StepsPerSecond.reset).
                self._meter.reset()
        if self._heartbeat is not None:
            self._heartbeat.tick(step + 1)
        if self.tap is None:
            return
        if step % self.tap.log_every:
            self.tap.drain()
            return
        scalars = dict(
            loss=loss,
            grad_norm=batch_norm(grad) if grad_norm is None else grad_norm,
            param_norm=batch_norm(u), update_norm=batch_norm(update))
        if self.fn_diag:
            scalars.update(out[2])
        if self.diagnostics:
            corrected = self._ema / (1.0 - PLATEAU_EMA_DECAY ** self._ema_n)
            scalars["loss_ema"] = corrected
            # The first record's slope is 0, not a NaN.
            scalars["loss_ema_slope"] = torch.zeros_like(corrected) \
                if self._ema_prev is None \
                else (corrected - self._ema_prev) / self.tap.log_every
            self._ema_prev = corrected
        self.tap.maybe_emit(step, scalars)

    def tripped(self) -> bool:
        """Whether the latch has fired, waiting for the card (called
        only where the fit waits anyway: before a checkpoint's write)."""
        if self.sentinel is None:
            return False
        if self.tap is not None:
            self.tap.drain(block=True)
        self.sentinel.finish()
        return self.flight.fatal

    def finish(self, nsteps: int):
        """The fit's end: the last records, the latch read, the
        ``fit_summary``; raise if the recorder tripped fatally."""
        from ..parallel.distributed import process_index

        if self.tap is not None:
            self.tap.drain(block=True)
        if self.sentinel is not None:
            self.sentinel.finish()
        flight, telemetry = self.flight, self.telemetry
        if telemetry is not None and (
                process_index() == 0
                or (flight is not None and flight.fatal
                    and not self.streamed)):
            summary = {"steps": int(nsteps)}
            if self.streamed:
                final = None if self.last_loss is None \
                    else float(self.last_loss)
                # Read after the final loss reached the host, so the
                # rate covers the card's work, not the enqueue.
                summary.update(steps_per_sec=round(self._meter.rate, 4),
                               final_loss=final)
                stats = self.stream_stats() if self.stream_stats else None
                if stats is not None:
                    summary["overlap_frac"] = round(
                        stats.overlap_fraction, 4)
                    summary["pass_overlap"] = {
                        name: p["overlap_frac"]
                        for name, p in stats.pass_summary().items()}
            elif flight is not None and flight.fatal:
                summary["final_loss"] = None
            if flight is not None and flight.bundle_path:
                summary["postmortem_bundle"] = flight.bundle_path
            telemetry.log("fit_summary", **summary)
        if flight is not None:
            flight.raise_if_fatal()


def _monitor(telemetry, log_every, flight=None, **kwargs):
    """An :class:`_AdamMonitor` when there is anything to monitor."""
    if telemetry is None and flight is None:
        return None
    return _AdamMonitor(telemetry, log_every, flight=flight, **kwargs)


def _run_adam_loop(loss_and_grad: Callable, guess, nsteps: int = 100,
                   param_bounds=None, learning_rate: float = 0.01,
                   randkey=None, const_randkey: bool = False,
                   progress: bool = True, device=None,
                   checkpoint_dir: Optional[str] = None,
                   checkpoint_every: Optional[int] = None, data=None,
                   comm: Optional[MeshComm] = None,
                   monitor: Optional[_AdamMonitor] = None):
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

    ``monitor`` (an :class:`_AdamMonitor`) sees every step; a fit whose
    non-finite latch fired stops before the next checkpoint write, and
    raises at its end.
    """
    if not isinstance(guess, torch.Tensor):
        guess = torch.as_tensor(np.asarray(guess, np.float32),
                                device=resolve_device(device))
    params = guess.detach().to(torch.float32)
    if const_randkey and randkey is None:
        raise ValueError("Must pass randkey if const_randkey")
    bounded = param_bounds is not None
    key = None if randkey is None else init_randkey(randkey)

    state, save, every = None, None, None
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
                                    config_key, data, comm, every, monitor)
        if monitor is not None and monitor.flight is not None:
            monitor.flight.attach(last_checkpoint=os.path.join(
                checkpoint_dir, "adam_state.npz"))
        if state is not None and state["step"] == nsteps:
            # A finished fit: the trajectory it returned, stored as it
            # was.
            if monitor is not None:
                with monitor.running(nsteps):
                    pass
                monitor.finish(nsteps)
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
    if monitor is not None and monitor.flight is not None:
        monitor.flight.watch_program("adam_loss_and_grad", loss_and_grad,
                                     (params,))
    stopped = False
    with (monitor.running(start) if monitor is not None
          else contextlib.nullcontext()):
        for i in adam_trange(nsteps - start, progress=progress):
            # Profiler ranges only, no record a step: the loop's host work
            # and the update's (perfbench's ``adam.*`` metrics).
            with span(None, "adam.step"):
                step = start + i
                kwargs = {}
                if key is not None:
                    if const_randkey:
                        kwargs["randkey"] = key
                    else:
                        key, kwargs["randkey"] = split_key(key)
                out = fn(u, **kwargs)
                with span(None, "adam.update"):
                    u, mu, nu, update = adam_update(u, out[1], mu, nu,
                                                    bias_corrections(step),
                                                    learning_rate)
                traj.append(u)
                if monitor is not None:
                    monitor.step(step, out, u, update)
                if save is not None and step + 1 < nsteps:
                    if monitor is not None and (step + 1) % every == 0 \
                            and monitor.tripped():
                        # The latch fired: keep the last good restart
                        # state (the one the postmortem bundle points at).
                        stopped = True
                        break
                    save(step + 1, u, mu, nu, key, traj)
    traj = torch.stack(traj)
    if bounded:
        traj = inverse_transform_array(traj, low, high)
    if save is not None and not stopped:
        save(nsteps, u, mu, nu, key, traj)
    if monitor is not None:
        monitor.finish(nsteps)
    return traj


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
    effect (a host loop has no carry to donate).

    Monitoring, as in the JAX package: with ``telemetry`` (a
    :class:`~multigrad_tpu_torch.telemetry.MetricsLogger`) and
    ``log_every > 0``, ``adam`` records (loss, |grad|, |params|,
    |update| in unbounded space) every ``log_every``-th step, numbered
    globally across checkpoint segments and resumes, a ``fit_plan`` up
    front, ``checkpoint`` spans and a ``fit_summary``; ``flight`` (a
    :class:`~multigrad_tpu_torch.telemetry.FlightRecorder`) arms the
    non-finite latch on loss and |grad| (a trip dumps the postmortem
    bundle, and the fit raises :class:`~multigrad_tpu_torch.telemetry
    .FlightRecorderTripped` at its end); ``live`` and ``alerts`` join the
    stream (:func:`~multigrad_tpu_torch.telemetry.wire_monitoring`);
    ``diagnostics`` adds ``loss_ema`` and ``loss_ema_slope``; with
    ``fn_diag`` the callable returns ``(loss, grad, diagnostics dict)``
    and the dict's scalars join each record.  See :class:`_AdamMonitor`:
    no step waits for the card.

    ``carry_sharding`` (a model's :meth:`~multigrad_tpu_torch.core.model
    .OnePointModel.k_sharding`) partitions a ``(K, ndim)`` fit over an
    ensemble comm's replica axis, the ZeRO layout: ``params`` is the
    full batch, and each process keeps only its K/R rows of the
    parameters, both moments and the trajectory through the steps,
    ``loss_and_grad`` being the K-partitioned program of those rows (see
    ``batched_loss_and_grad_fn(k_sharded=True)``).  No collective crosses
    the replica comm inside the loop; the trajectory is gathered once at
    the end, so every process returns the whole ``(nsteps + 1, K,
    ndim)``.  Monitoring records then cover this process's rows.
    """
    del donate_carry
    from ..telemetry.live import wire_monitoring

    fn_args = tuple(fn_args)
    ndim = params.dim() if isinstance(params, torch.Tensor) \
        else np.ndim(params)
    if checkpoint_dir is not None and ndim != 1:
        raise ValueError(
            "checkpoint_dir requires 1-D params (the restart state "
            f"layout is per-fit); got shape {np.shape(params)}")
    if carry_sharding is not None:
        if ndim != 2:
            raise ValueError(
                "carry_sharding partitions a (K, ndim) batch; got shape "
                f"{tuple(np.shape(params))}")
        if not isinstance(params, torch.Tensor):
            params = torch.as_tensor(np.asarray(params, np.float32),
                                     device=resolve_device(device))
        params = carry_sharding.local(params)

    def fn(p, randkey=0):
        return loss_and_grad(p, randkey, *fn_args)

    telemetry, log_every, owned = wire_monitoring(
        telemetry, log_every, live, alerts)
    try:
        traj = _run_adam_loop(
            fn, params, nsteps=nsteps, param_bounds=param_bounds,
            learning_rate=learning_rate, randkey=randkey,
            const_randkey=const_randkey, progress=progress, device=device,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, data=fn_args,
            monitor=_scan_monitor(telemetry, log_every, flight, nsteps,
                                  checkpoint_every, diagnostics, fn_diag))
    finally:
        if owned is not None:
            owned.close()
    if carry_sharding is not None:
        traj = carry_sharding.gather(traj, axis=1)
    return traj


def _scan_monitor(telemetry, log_every, flight, nsteps, checkpoint_every,
                  diagnostics=False, fn_diag=False):
    """The monitor of a resident fit (``run_adam_scan``'s records)."""
    return _monitor(
        telemetry, log_every, flight=flight, diagnostics=diagnostics,
        fn_diag=fn_diag, plan=dict(
            kind="adam_scan", nsteps=int(nsteps), log_every=int(log_every),
            checkpoint_every=(int(checkpoint_every) if checkpoint_every
                              else None)))


def run_adam_streamed(loss_and_grad: Callable, params, nsteps: int = 100,
                      param_bounds=None, learning_rate: float = 0.01,
                      randkey=None, const_randkey: bool = False,
                      progress: bool = True,
                      checkpoint_dir: Optional[str] = None,
                      checkpoint_every: Optional[int] = None,
                      telemetry=None, log_every: int = 0,
                      heartbeat_s: Optional[float] = None,
                      donate_carry: Optional[bool] = None,
                      stream_stats: Optional[Callable] = None,
                      flight=None, live=None, alerts=None,
                      diagnostics: bool = False, *,
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
    across a resume.  ``donate_carry`` is accepted and has no effect.

    Monitoring as :func:`run_adam_scan`'s, and as the JAX package's
    streamed fit: a ``fit_plan`` with the resume ``start``, a ``fit``
    span, ``checkpoint`` spans, a heartbeat thread every ``heartbeat_s``
    seconds (liveness and stall records), and a ``fit_summary`` with
    ``steps_per_sec`` (the first step left out), ``final_loss`` (the
    last evaluation's) and, from ``stream_stats()`` (the current
    :class:`~multigrad_tpu_torch.utils.profiling.StreamStats` or None),
    the prefetcher's ``overlap_frac`` and per-pass overlaps.

    ``comm`` (keyword-only, the port's own): the processes that run the
    fit together; its rank 0 writes the checkpoint, and every rank
    reads it after a barrier.
    """
    del donate_carry
    from ..telemetry.live import wire_monitoring

    telemetry, log_every, owned = wire_monitoring(
        telemetry, log_every, live, alerts)
    monitor = _monitor(
        telemetry, log_every, flight=flight, diagnostics=diagnostics,
        plan=dict(kind="adam_streamed", nsteps=int(nsteps), start=None,
                  log_every=int(log_every)),
        streamed=True, heartbeat_s=heartbeat_s, stream_stats=stream_stats)
    try:
        return _run_adam_loop(
            loss_and_grad, params, nsteps=nsteps, param_bounds=param_bounds,
            learning_rate=learning_rate, randkey=randkey,
            const_randkey=const_randkey, progress=progress,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, data=None, comm=comm,
            monitor=monitor)
    finally:
        if owned is not None:
            owned.close()


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
            every, monitor=None):
    """The restart state of ``checkpoint_dir`` when it holds one for this
    fit (raise when it holds another's), else ``None``; the trajectory so
    far (a list of unbounded rows, or the returned tensor of a finished
    fit); and the ``save(step, u, mu, nu, key, rows)`` callback of the
    segment ends, whose ``rows`` are the list of unbounded rows so far or,
    at the last step, the trajectory tensor the fit returns; each write
    inside ``monitor``'s ``checkpoint`` span."""
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
            with span(monitor.telemetry if monitor is not None else None,
                      "checkpoint", step=int(step)):
                _ckpt.save(path, dict(
                    step=np.int64(step), u=u, mu=mu, nu=nu,
                    key=np.int64(-1 if key is None else key), traj=full,
                    config=config, config_key=config_key,
                    config_args=config_args))
        if step == nsteps:
            _barrier(comm)

    return state, traj, save
