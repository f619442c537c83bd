"""Scalar taps: metrics out of a running fit that never make the host
wait for the card (port of :mod:`multigrad_tpu.telemetry.taps`).

The JAX package compiles whole fits into one XLA program and lets
values out through ``jax.debug.callback``, which XLA runs unordered.
The port's fits are host loops that enqueue a step's kernels and go on
to the next step without waiting for the card; a tap that read a value
(``loss.item()``) would wait for the card at every emit.  So a
:class:`ScalarTap` defers the read:

* the host loop knows the step, so :meth:`ScalarTap.maybe_emit` returns
  at once, with no device work, unless ``step % log_every == 0``;
* on an emit step it joins the scalars into one vector on the device,
  copies it with ``non_blocking=True`` into a pinned host buffer (reused
  once its copy has landed), records a CUDA event and queues the copy;
* every later call (:meth:`ScalarTap.drain`) logs, in step order, the
  queued copies whose event has completed (``event.query()``), and
  never blocks; the fit's end drains with a block
  (``drain(block=True)``, the counterpart of ``jax.effects_barrier``),
  before its ``fit_summary``.

On the CPU the copy is synchronous and the record is logged at once.
Only process 0 logs (every process computes the same replicated values;
the others make no copy).  ``gate`` is a Python bool.  Values are
emitted as the JAX package emits them: a 0-d tensor becomes a float, a
batched fit's per-member vector (e.g. a ``(n_starts,)`` loss) a list.

A tap carries *riders*: device state whose value travels in the same
copy as each record (the flight recorder's non-finite latch,
:class:`~multigrad_tpu_torch.telemetry.flight.NonFiniteSentinel`), so
the host learns of it without a read of its own.
"""
from __future__ import annotations

import collections
from typing import Optional

__all__ = ["ScalarTap", "make_tap", "batch_norm"]

def batch_norm(x):
    """L2 norm over the trailing (parameter) axis — scalar for a 1-D
    vector, per-member vector for a batched ``(K, ndim)`` fit."""
    import torch

    return torch.sqrt(torch.sum(x * x, dim=-1))


class ScalarTap:
    """Throttled scalar emitter bound to a MetricsLogger.

    Parameters
    ----------
    logger : MetricsLogger
        Destination of the emitted records (event = ``name``).
    name : str
        Record event name (``"adam"``, ``"hmc"``, ...).
    log_every : int
        Emit every ``log_every``-th step.

    A tap hashes and compares by ``(logger identity, name, log_every)``,
    as the JAX package's does.
    """

    def __init__(self, logger, name: str = "fit", log_every: int = 50):
        if log_every < 1:
            raise ValueError(f"log_every must be >= 1, got {log_every}")
        self.logger = logger
        self.name = name
        self.log_every = int(log_every)
        self._riders: list = []
        # (step, layout, host vector, event or None), in step order.
        self._pending = collections.deque()
        self._free: dict = {}       # (numel, dtype) -> [pinned buffers]

    def _key(self):
        return (id(self.logger), self.name, self.log_every)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, ScalarTap) and self._key() == other._key()

    def ride(self, rider):
        """Carry ``rider.state`` (a 1-D tensor on the fit's device, or
        None before it has one) in every record's copy; at the record's
        drain the host hands it to ``rider.seen(step, values)`` before
        the record is logged."""
        if rider not in self._riders:
            self._riders.append(rider)

    # -- the emit step ------------------------------------------------------
    def maybe_emit(self, step: int, scalars: dict, gate=None):
        """Queue ``scalars`` (names to tensors on one device) iff ``step %
        log_every == 0`` (and ``gate``, a Python bool, when given), then
        log every queued record whose copy has landed.  No device work
        and no wait otherwise."""
        step = int(step)
        if step % self.log_every or (gate is not None and not gate) \
                or not _is_process_zero():
            self.drain()
            return
        self._queue(step, scalars)
        self.drain()

    def _queue(self, step, scalars):
        import torch

        names = tuple(scalars)
        values = [scalars[n] for n in names]
        riders = [r for r in self._riders if r.state is not None]
        layout = ([(n, v.dim(), v.numel()) for n, v in zip(names, values)],
                  [(r, r.state.numel()) for r in riders])
        flat = torch.cat([v.detach().reshape(-1) for v in values]
                         + [r.state for r in riders])
        if flat.device.type != "cuda":
            self._pending.append((step, layout, flat, None))
            return
        buf = self._buffer(flat.numel(), flat.dtype)
        buf.copy_(flat, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(flat.device))
        self._pending.append((step, layout, buf, event))

    def _buffer(self, numel, dtype):
        """A pinned host buffer whose last copy has landed, or a new one
        (from PyTorch's caching host allocator)."""
        import torch

        free = self._free.setdefault((numel, dtype), [])
        return free.pop() if free else torch.empty(numel, dtype=dtype,
                                                   pin_memory=True)

    # -- the host side ------------------------------------------------------
    def drain(self, block: bool = False):
        """Log the queued records whose copies have landed, in step order
        (with ``block``, all of them, waiting for the last copies: the
        fit's end)."""
        while self._pending:
            step, layout, buf, event = self._pending[0]
            if event is not None:
                if block:
                    event.synchronize()
                elif not event.query():
                    return
            self._pending.popleft()
            host = buf.tolist()
            if event is not None:
                self._free[(buf.numel(), buf.dtype)].append(buf)
            self._emit(step, layout, host)

    def _emit(self, step, layout, host):
        fields, riders = layout
        record, at = {}, 0
        for name, ndim, numel in fields:
            vals = host[at:at + numel]
            record[name] = float(vals[0]) if ndim == 0 \
                else [float(v) for v in vals]
            at += numel
        for rider, numel in riders:
            rider.seen(step, host[at:at + numel])
            at += numel
        self.logger.log(self.name, step=step, **record)


def _is_process_zero() -> bool:
    from ..parallel.distributed import process_index

    return process_index() == 0


def make_tap(telemetry, name: str, log_every: int) -> Optional[ScalarTap]:
    """The wiring convention every fit entry point shares: a tap
    exists iff a logger was passed AND ``log_every > 0``."""
    if telemetry is None or not log_every:
        return None
    return ScalarTap(telemetry, name=name, log_every=log_every)
