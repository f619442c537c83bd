"""Wall-clock spans and liveness: the host-side half of telemetry (port
of :mod:`multigrad_tpu.telemetry.spans`).

:func:`span` is the one idiom that unifies the repo's scattered
timers — ``utils.profiling.Timer`` (benchmark reps),
``utils.profiling.trace`` (profiler capture), and
``StreamStats.summary()`` (prefetch counters) all measure *something
for some wall-clock window*; a span names the window, nests (a
``fit`` span contains ``checkpoint`` spans), and lands in the same
record stream as the taps, so one JSONL file tells the whole story:
when each checkpoint was cut, what fraction of the fit the stream
spent stalled.  While a ``torch.profiler`` session runs, the same span
also opens a ``record_function`` range named ``mgt.<name>``, so the
profiler's trace holds the program's own layers beside the kernels they
launched, on the trace's clock; with no profiler and no logger a span
does nothing.

:class:`Heartbeat` is the liveness layer production pod training
treats as table stakes: a long streamed fit that stops ticking (a
wedged prefetch thread, a dead tunnel, a preempted host) is invisible
until a timeout kills the job — the heartbeat thread emits a
``heartbeat`` record every ``interval`` seconds with the last step it
saw, and a ``stall`` record the moment no progress has been observed
for ``stall_after`` seconds.  Every process emits (records carry
``process_index``), so under multi-host a single silent host is
identifiable from the surviving hosts' files.
"""
from __future__ import annotations

import contextlib
import sys
import threading
import time
from typing import Optional

__all__ = ["span", "Heartbeat"]

_STACK = threading.local()
#: The context of a span that records nothing (reusable).
_NOOP = contextlib.nullcontext()
#: ``torch.autograd.profiler``, found in ``sys.modules`` at the first span
#: after torch is imported (a profiler cannot run before).
_PROFILER = None


def _profiler():
    global _PROFILER
    _PROFILER = sys.modules.get("torch.autograd.profiler")
    return _PROFILER


def _span_stack() -> list:
    stack = getattr(_STACK, "stack", None)
    if stack is None:
        stack = _STACK.stack = []
    return stack


def span(logger, name: str, trace=None, **fields):
    """Record a named wall-clock span around a block.

    Nesting is tracked per thread: a span opened inside another gets a
    ``path`` of ``"outer/inner"`` and ``depth`` of its nesting level,
    so the report can attribute child time to parents.  The record is
    written at span *exit* (elapsed is known then); spans that raise
    still record, with ``ok: false``.

    ``trace`` accepts a :class:`~multigrad_tpu_torch.telemetry.tracing
    .TraceContext` (or any object with ``trace_id`` and ``span_id``): the
    span record is stamped with the trace's id and the context's span
    id as ``parent_span_id``, so wall-clock spans in a fit's telemetry
    stream correlate with the distributed request trace that
    triggered the fit (join on ``trace_id``).

    While a profiler runs (``torch.autograd.profiler``'s process-wide
    flag, which every thread sees, unlike the thread-local one), the
    span also opens the range ``mgt.<name>``, with or without a logger:
    ranges nest as spans do, and a thread the profiler does not record
    drops them at no cost to the result.

    ``logger=None`` with no profiler running is a no-op: one flag read
    and a shared empty context, so callers can wire spans into hot loops
    unconditionally and let the telemetry flag decide.
    """
    prof = _PROFILER or _profiler()
    ranged = prof is not None and prof._is_profiler_enabled
    if logger is None and not ranged:
        return _NOOP
    return _span(logger, name, trace, fields,
                 prof.record_function("mgt." + name) if ranged
                 else _NOOP)


@contextlib.contextmanager
def _span(logger, name, trace, fields, profiler_range):
    with profiler_range:
        if logger is None:
            yield
            return
        if trace is not None:
            fields = {"trace_id": trace.trace_id,
                      "parent_span_id": trace.span_id, **fields}
        stack = _span_stack()
        path = "/".join([*stack, name])
        stack.append(name)
        t0 = time.perf_counter()
        ok = True
        try:
            yield
        except BaseException:
            ok = False
            raise
        finally:
            stack.pop()
            logger.log("span", name=name, path=path,
                       depth=len(stack), elapsed_s=time.perf_counter() - t0,
                       ok=ok, **fields)


class Heartbeat:
    """Background liveness emitter + stall detector for host loops.

    Parameters
    ----------
    logger : MetricsLogger
        Destination stream (``None`` disables everything — the same
        no-op convention as :func:`span`).
    interval : float
        Seconds between ``heartbeat`` records.
    stall_after : float, optional
        Emit a ``stall`` record when no :meth:`tick` has been seen for
        this many seconds (default ``3 * interval``).  One record per
        stall episode, plus a closing ``stall_recovered`` when ticks
        resume — not one per interval, so a long hang doesn't flood
        the stream.

    Usage::

        with Heartbeat(logger, interval=30.0) as hb:
            for step in range(nsteps):
                ...                      # one optimizer step
                hb.tick(step)
    """

    def __init__(self, logger, interval: float = 30.0,
                 stall_after: Optional[float] = None):
        self.logger = logger
        self.interval = float(interval)
        self.stall_after = (float(stall_after) if stall_after is not None
                            else 3.0 * float(interval))
        from .._lockdep import make_lock
        self._lock = make_lock("telemetry.spans.Heartbeat._lock")
        self._last_step: Optional[int] = None
        self._last_tick = time.perf_counter()
        self._prev_beat_step: Optional[int] = None
        self._prev_beat_time = time.perf_counter()
        self._stalled = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- producer side (the fit loop) ---------------------------------------
    def tick(self, step: int):
        """Mark progress; call once per completed step."""
        with self._lock:
            self._last_step = int(step)
            self._last_tick = time.perf_counter()

    # -- heartbeat thread ---------------------------------------------------
    def _run(self):
        from ..parallel.distributed import process_index

        process = process_index()
        while not self._stop.wait(self.interval):
            now = time.perf_counter()
            with self._lock:
                step = self._last_step
                since_tick = now - self._last_tick
            rate = None
            if (step is not None and self._prev_beat_step is not None
                    and now > self._prev_beat_time):
                rate = ((step - self._prev_beat_step)
                        / (now - self._prev_beat_time))
            self.logger.log("heartbeat", step=step, process=process,
                            since_last_tick_s=round(since_tick, 3),
                            steps_per_sec=(round(rate, 3)
                                           if rate is not None else None))
            self._prev_beat_step, self._prev_beat_time = step, now
            if since_tick > self.stall_after and not self._stalled:
                self._stalled = True
                self.logger.log("stall", step=step, process=process,
                                stalled_s=round(since_tick, 3),
                                stall_after_s=self.stall_after)
            elif since_tick <= self.stall_after and self._stalled:
                self._stalled = False
                self.logger.log("stall_recovered", step=step,
                                process=process)

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        if self.logger is not None and self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="mgt-heartbeat")
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
