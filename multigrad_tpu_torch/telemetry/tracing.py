"""Distributed request tracing: W3C-traceparent contexts + span sink (a copy of
:mod:`multigrad_tpu.telemetry.tracing`).

The serve layer's end-to-end latency is a chain of hops nobody can
see from aggregate counters alone: router affinity routing, RPC
send (and its backoff retries), worker queue wait, bucket
coalescing, the compile-or-cached dispatch, the Adam scan itself,
finalize, the result's trip back — and, under preemption, whole
requeue odysseys across worker generations.  This module is the
context-propagation core that turns that chain into *one* navigable
waterfall per request:

* :class:`TraceContext` — a W3C-traceparent-style identity
  (``trace_id``, ``span_id``, ``parent_span_id``).  Minted once per
  request at :meth:`FleetRouter.submit <multigrad_tpu_torch.serve.fleet
  .FleetRouter.submit>` (or :meth:`FitScheduler.submit
  <multigrad_tpu_torch.serve.scheduler.FitScheduler.submit>` for
  single-process serving), serialized as a ``traceparent`` string
  (``00-<trace_id>-<span_id>-01``) on the ``submit`` wire message,
  and re-hydrated on the worker so every hop's span — on whichever
  process it happens — carries the same ``trace_id`` and a parent
  link back to the request's root span.
* :class:`Tracer` — the per-process span recorder: each finished hop
  becomes one ``trace_span`` JSONL record (``t_start``/``t_end``
  wall clock, ``elapsed_s``, ``ok``, free-form attributes), appended
  line-atomically through :class:`~multigrad_tpu_torch.telemetry.metrics
  .JsonlSink` so per-process trace files are safe to tail and
  survive a SIGKILL with every already-written span intact — which
  is exactly what makes a killed worker's partial hops show up in
  the merged waterfall.

Merging is :func:`multigrad_tpu_torch.telemetry.aggregate.merge_traces`
(group the per-process files' spans by ``trace_id``); rendering is
``python -m multigrad_tpu_torch.telemetry.trace`` (stdlib-only — a trace
is debuggable from the JSONLs alone, no live process needed).

Wall-clock convention: span endpoints are ``time.time()`` on the
recording process.  Fleet workers today share the router's host, so
cross-process spans align directly; across hosts the per-hop
*durations* stay exact while offsets inherit clock skew (the
``multigrad_fleet_rpc_rtt`` gauge is the noise floor to read them
against).

This module is pure stdlib, per the telemetry package contract.
"""
from __future__ import annotations

import contextlib
import os
import secrets
import threading
import time
from dataclasses import dataclass
from typing import Optional

__all__ = ["TraceContext", "Tracer", "new_trace",
           "parse_traceparent", "TRACE_EVENT"]

#: Record type of one finished hop in a telemetry/trace JSONL stream.
TRACE_EVENT = "trace_span"

_TRACE_ID_LEN = 32        # 16 random bytes, hex
_SPAN_ID_LEN = 16         # 8 random bytes, hex


def _new_id(hex_len: int) -> str:
    return secrets.token_hex(hex_len // 2)


@dataclass(frozen=True)
class TraceContext:
    """One span's identity within a trace (W3C traceparent shape).

    ``trace_id`` names the whole request journey (32 hex chars);
    ``span_id`` names this span (16 hex chars); ``parent_span_id``
    links it into the waterfall (``None`` marks the root).  Contexts
    are immutable — :meth:`child` derives a new span under this one,
    which is how a hop's recorder parents itself without any shared
    mutable state across threads or processes.
    """

    trace_id: str
    span_id: str
    parent_span_id: Optional[str] = None

    def child(self) -> "TraceContext":
        """A fresh span context parented under this span."""
        return TraceContext(self.trace_id, _new_id(_SPAN_ID_LEN),
                            self.span_id)

    @property
    def traceparent(self) -> str:
        """The W3C ``traceparent`` header rendering
        (``00-<trace_id>-<span_id>-01``).  The parent link is NOT in
        the header (per the spec): the receiver's spans parent to
        ``span_id``, which is the point of propagation."""
        return f"00-{self.trace_id}-{self.span_id}-01"

    def to_wire(self) -> dict:
        """The dict form carried on serve wire messages.  Receivers
        must treat the whole field as optional — mixed-version
        fleets have undecorated peers (see :func:`parse_traceparent`
        for the tolerant read side)."""
        return {"traceparent": self.traceparent}

    @classmethod
    def from_wire(cls, value) -> Optional["TraceContext"]:
        """Re-hydrate a context from a wire dict; ``None`` on
        anything malformed or absent (never raises — an undecorated
        or future-versioned peer must not kill the handler)."""
        if not isinstance(value, dict):
            return None
        return parse_traceparent(value.get("traceparent"))


def new_trace() -> TraceContext:
    """Mint a fresh root context: new ``trace_id``, new ``span_id``,
    no parent.  Called exactly once per request, at the submit
    surface the request first enters."""
    return TraceContext(_new_id(_TRACE_ID_LEN),
                        _new_id(_SPAN_ID_LEN), None)


def parse_traceparent(value) -> Optional[TraceContext]:
    """Parse a ``traceparent`` string; ``None`` on malformed input.

    Deliberately tolerant (no exceptions): trace fields roll out
    across a mixed-version fleet, so a worker must shrug off a
    missing, truncated, or future-versioned header and serve the
    fit untraced rather than reject it.
    """
    if not isinstance(value, str):
        return None
    parts = value.split("-")
    if len(parts) != 4:
        return None
    _, trace_id, span_id, _ = parts
    if len(trace_id) != _TRACE_ID_LEN or len(span_id) != _SPAN_ID_LEN:
        return None
    try:
        int(trace_id, 16)
        int(span_id, 16)
    except ValueError:
        return None
    return TraceContext(trace_id, span_id, None)


class Tracer:
    """Per-process span recorder writing ``trace_span`` records.

    Parameters
    ----------
    sink : str | sink | None
        A path (wrapped in a line-atomic :class:`~multigrad_tpu_torch
        .telemetry.metrics.JsonlSink` — parent directory created),
        any object with ``write(record)``/``close()``, or ``None``
        for an in-memory ring (:class:`~multigrad_tpu_torch.telemetry
        .metrics.MemorySink`) — the test/ad-hoc mode, readable via
        :attr:`records`.
    service : str, optional
        Stamped on every span (``"router"``, ``"worker:w0"``, ...)
        so a merged waterfall names which process ran each hop.

    Thread-safe: the fleet router's reader threads, the scheduler's
    dispatcher thread, and worker waiter threads all record
    concurrently.
    """

    def __init__(self, sink=None, service: Optional[str] = None):
        from .metrics import JsonlSink, MemorySink
        self.path = None
        if sink is None:
            sink = MemorySink(capacity=65536)
        elif isinstance(sink, str):
            parent = os.path.dirname(os.path.abspath(sink))
            os.makedirs(parent, exist_ok=True)
            self.path = sink
            sink = JsonlSink(sink)
        from .._lockdep import make_lock
        self._sink = sink
        self.service = service
        self._lock = make_lock("telemetry.tracing.Tracer._lock")
        self._closed = False

    # -- span production ----------------------------------------------------
    def new_trace(self) -> TraceContext:
        return new_trace()

    def record(self, ctx: TraceContext, name: str, t_start: float,
               t_end: Optional[float] = None, ok: bool = True,
               **attrs) -> dict:
        """Write one finished span.  ``t_start``/``t_end`` are wall
        clock (``time.time()``); attributes are free-form JSON-able
        fields (worker id, bucket size, retry counts, postmortem
        bundle paths...).  Returns the record written."""
        t_end = time.time() if t_end is None else float(t_end)
        t_start = float(t_start)
        record = {
            "event": TRACE_EVENT,
            "t": t_end,
            "trace_id": ctx.trace_id,
            "span_id": ctx.span_id,
            "parent_span_id": ctx.parent_span_id,
            "name": name,
            "service": self.service,
            "t_start": t_start,
            "t_end": t_end,
            "elapsed_s": max(0.0, t_end - t_start),
            "ok": bool(ok),
        }
        record.update(attrs)
        self._write(record)
        return record

    @contextlib.contextmanager
    def span(self, parent: TraceContext, name: str, **attrs):
        """Record a hop around a block; yields the child context so
        nested hops can parent under it.  A block that raises still
        records, with ``ok: false``."""
        ctx = parent.child()
        t0 = time.time()
        ok = True
        try:
            yield ctx
        except BaseException:
            ok = False
            raise
        finally:
            self.record(ctx, name, t0, time.time(), ok=ok, **attrs)

    def log(self, event: str, **fields) -> dict:
        """Write a non-span record into the trace stream (e.g. the
        router's ``trace_rtt`` noise-floor samples)."""
        record = {"event": event, "t": time.time(),
                  "service": self.service, **fields}
        self._write(record)
        return record

    def _write(self, record: dict):
        with self._lock:
            if self._closed:
                return
            # lock-ok: callback-under-lock the tracer's sinks are the line-atomic JsonlSink / MemorySink (tiny appends, no locks of their own); the lock totally orders spans per process, which the waterfall merge depends on
            self._sink.write(record)

    # -- read/lifecycle -----------------------------------------------------
    @property
    def records(self) -> list:
        """In-memory records (only for the ``sink=None`` mode)."""
        return getattr(self._sink, "records", [])

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._sink.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
