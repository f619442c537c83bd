"""Fleet wire protocol: newline-delimited JSON over a local socket (a copy of
:mod:`multigrad_tpu.serve.wire`).

The router (:class:`~multigrad_tpu_torch.serve.fleet.FleetRouter`) and its
worker processes (:mod:`~multigrad_tpu_torch.serve.worker`) speak a tiny
asynchronous message protocol — one JSON object per line over one
persistent TCP connection per worker.  Requests and responses are
correlated by the router-assigned request id (``rid``); nothing in
the protocol blocks, so a worker can stream heartbeats while fits are
in flight and the router can keep submitting while results drain.

Router → worker ops:

``submit``
    ``{rid, guess, config, deadline_t, retried, submitted_t,
    trace}`` — one fit request.  ``deadline_t`` is an *absolute*
    wall-clock epoch so a request re-enqueued after a worker death
    keeps its original deadline; ``retried`` forwards the request's
    consumed poison retry so a re-enqueue cannot double-fire it;
    ``trace`` carries the request's W3C-style trace context
    (``{"traceparent": ...}``, see :mod:`~multigrad_tpu_torch.telemetry
    .tracing`) so the worker's hop spans join the router-minted
    trace; ``qos`` (optional) carries the request's QoS tag
    (``{tenant, priority_class, slo_deadline_s}``, see
    :mod:`~multigrad_tpu_torch.serve.qos`) — absent for untagged
    requests, ignored by pre-QoS workers.
``drain``
    Graceful preemption: serve everything queued, then exit (the
    protocol twin of SIGTERM).
``ping`` / ``stop`` / ``chaos``
    Liveness probe / hard shutdown / fault injection (the latter only
    honored by workers launched with ``--chaos``).  ``ping`` may
    carry ``t0`` (sender wall clock); the ``pong`` echoes it back,
    which is how the router measures per-worker RPC round-trip time
    (the ``multigrad_fleet_rpc_rtt`` gauge).

Worker → router ops:

``result`` / ``error`` / ``reject``
    Per-request terminal responses (``reject`` is the load-shed
    signal: the worker's queue is full, route elsewhere).  A
    QoS-aware worker's reject additionally carries ``reason``
    (``"queue_full"`` vs ``"tenant_quota"`` — "the fleet is busy"
    vs "YOU are over quota"), the rejected tenant, and ``shed``
    (cumulative per-class/per-tenant shed counters) — all optional
    keys an untagged router simply ignores.
``heartbeat``
    Periodic liveness + load report (``queue_depth``, ``inflight``,
    scheduler counters).  A monitored worker additionally carries
    ``resources`` — the compact :class:`~multigrad_tpu_torch.telemetry
    .ResourceMonitor` snapshot (RSS, device memory, ``busy_frac``,
    compile accounting) feeding the router's fleet-wide utilization
    view; optional both ways (a legacy heartbeat decodes with the
    field ``None``, a decorated one is ignored by a legacy router).
    A history-keeping worker also carries ``rollup`` — the compact
    since-last-heartbeat slice of its windowed rollup store (fit /
    shed / device-busy counters, queue-wait count/sum/max) the
    router merges into a fleet-level history that survives the
    worker; optional both ways with the same legacy semantics (no
    key → no history, never fabricated zeros).  Heartbeat loss is
    how the router detects a SIGKILL'd or wedged worker.
``poison_retry``
    The worker's scheduler consumed a request's one poison retry —
    recorded by the router so a later requeue forwards
    ``retried=True``.
``draining`` / ``drained``
    Preemption notices bracketing a graceful drain.

**Forward compatibility is a protocol invariant**: every handler on
both sides MUST ignore unknown message keys, unknown config fields,
and unknown ops — trace fields (and whatever comes next) roll out
across a *mixed-version* fleet, where a decorated router talks to an
undecorated worker and vice versa.  The codecs below read known
keys explicitly (``d.get(...)`` with defaults) and never splat a
wire dict into a constructor; ``tests/test_tracing.py`` pins the
contract by sending decorated messages at undecorated handlers.

Everything here is stdlib + numpy; torch never enters the wire layer, and
the JAX package's wire is the same protocol byte for byte.
"""
from __future__ import annotations

import json
import socket
from typing import Optional

import numpy as np

from .._lockdep import make_lock
from .queue import FitConfig, FitResult

__all__ = ["JsonlChannel", "config_to_wire", "config_from_wire",
           "qos_to_wire", "qos_from_wire", "shed_to_wire",
           "shed_from_wire", "result_to_wire", "result_from_wire",
           "resources_to_wire", "resources_from_wire",
           "rollup_to_wire", "rollup_from_wire"]


class JsonlChannel:
    """Thread-safe newline-JSON message channel over a socket.

    ``send`` may be called from any thread (one writer lock
    serializes lines); ``recv``/iteration is single-consumer.
    Iteration ends cleanly on EOF or a closed socket — the reader
    loop's "peer went away" signal.
    """

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._rfile = sock.makefile("rb")
        self._wlock = make_lock("serve.wire.JsonlChannel._wlock")

    def send(self, msg: dict):
        data = (json.dumps(msg, separators=(",", ":")) + "\n").encode()
        with self._wlock:
            # lock-ok: blocking-under-lock the lock EXISTS to serialize whole lines onto the socket; no other lock is ever taken under it (leaf in the lock graph), so a slow peer delays only other writers of the same channel
            self._sock.sendall(data)

    def recv(self) -> Optional[dict]:
        """Next message, or ``None`` on EOF."""
        line = self._rfile.readline()
        if not line:
            return None
        return json.loads(line)

    def __iter__(self):
        while True:
            try:
                msg = self.recv()
            except (OSError, ValueError):
                return
            if msg is None:
                return
            yield msg

    def close(self):
        for fn in (self._rfile.close,
                   lambda: self._sock.shutdown(socket.SHUT_RDWR),
                   self._sock.close):
            try:
                fn()
            except OSError:
                pass


# ------------------------------------------------------------------ #
# codecs
# ------------------------------------------------------------------ #
def config_to_wire(config: FitConfig) -> dict:
    return {
        "nsteps": config.nsteps,
        "learning_rate": config.learning_rate,
        "param_bounds": (None if config.param_bounds is None
                         else [None if b is None else list(b)
                               for b in config.param_bounds]),
        "randkey": config.randkey,
        "const_randkey": config.const_randkey,
        "job_id": config.job_id,
        "stage": config.stage,
    }


def config_from_wire(d: dict) -> FitConfig:
    # FitConfig.__post_init__ re-normalizes bounds lists to tuples,
    # so the JSON round trip lands on an == / hash-equal config — the
    # property worker-side bucket grouping depends on.
    #
    # Known keys are read EXPLICITLY (never FitConfig(**d)): a newer
    # router decorating the config with fields this worker predates
    # must not crash admission — the unknown fields are simply not
    # part of this version's batchability identity.
    return FitConfig(
        nsteps=d["nsteps"], learning_rate=d["learning_rate"],
        param_bounds=d.get("param_bounds"),
        randkey=d.get("randkey"),
        const_randkey=bool(d.get("const_randkey", False)),
        job_id=d.get("job_id"), stage=d.get("stage"))


def qos_to_wire(tag) -> Optional[dict]:
    """A request's :class:`~multigrad_tpu_torch.serve.qos.QosTag` as a
    wire dict (``None`` for untagged requests — the key stays off
    the message entirely, so an untagged router's traffic is
    byte-identical to the pre-QoS protocol)."""
    if tag is None:
        return None
    return {
        "tenant": tag.tenant,
        "priority_class": tag.priority_class,
        "slo_deadline_s": tag.slo_deadline_s,
    }


def qos_from_wire(d) -> Optional["QosTag"]:
    """Decode a submit message's ``qos`` field.  Known keys are read
    EXPLICITLY with defaults (never ``QosTag(**d)``): a newer router
    decorating the tag with fields this worker predates must not
    crash admission — and an untagged message (``None`` / ``{}``,
    an older router) decodes to ``None``, scheduling as the default
    tenant."""
    if not d:
        return None
    from .qos import DEFAULT_CLASS, DEFAULT_TENANT, QosTag
    slo_deadline = d.get("slo_deadline_s")
    return QosTag(
        tenant=str(d.get("tenant", DEFAULT_TENANT)),
        priority_class=str(d.get("priority_class", DEFAULT_CLASS)),
        slo_deadline_s=(None if slo_deadline is None
                        else float(slo_deadline)))


def shed_to_wire(counts) -> dict:
    """Per-class / per-tenant shed counters for a worker ``reject``
    message (JSON-safe copies)."""
    counts = counts or {}
    return {
        "by_class": {str(k): int(v) for k, v in
                     (counts.get("by_class") or {}).items()},
        "by_tenant": {str(k): int(v) for k, v in
                      (counts.get("by_tenant") or {}).items()},
    }


def shed_from_wire(d) -> dict:
    """Decode a ``reject`` message's ``shed`` field.  Tolerant of
    untagged workers (missing / partial dicts decode to empty
    counters) — the router's shed accounting must survive a
    mixed-version fleet."""
    if not isinstance(d, dict):
        return {"by_class": {}, "by_tenant": {}}
    out = {}
    for side in ("by_class", "by_tenant"):
        sub = d.get(side)
        out[side] = ({str(k): int(v) for k, v in sub.items()}
                     if isinstance(sub, dict) else {})
    return out


# The compact resource snapshot a heartbeat carries: every field
# numeric-or-None.  Int fields and float fields are coerced on decode
# so the router's arithmetic (headroom, fleet aggregation) never
# meets a string a buggy or future worker put on the wire.
_RESOURCE_INT_KEYS = ("rss_bytes", "device_bytes_in_use",
                      "device_peak_bytes", "device_bytes_limit",
                      "compile_count", "compile_hits",
                      "compile_misses")
_RESOURCE_FLOAT_KEYS = ("t", "uptime_s", "busy_frac", "busy_s_total",
                        "compile_s_total")


def resources_to_wire(snap) -> Optional[dict]:
    """A :meth:`~multigrad_tpu_torch.telemetry.ResourceMonitor.snapshot`
    as a heartbeat field (``None`` before the first sample or for an
    unmonitored worker — the key stays off the message entirely, so
    an unmonitored worker's heartbeat is byte-identical to the
    pre-resources protocol)."""
    if not isinstance(snap, dict):
        return None
    out = {}
    for key in _RESOURCE_INT_KEYS:
        v = snap.get(key)
        out[key] = int(v) if isinstance(v, (int, float)) else None
    for key in _RESOURCE_FLOAT_KEYS:
        v = snap.get(key)
        out[key] = float(v) if isinstance(v, (int, float)) else None
    return out


def resources_from_wire(d) -> Optional[dict]:
    """Decode a heartbeat's ``resources`` field.  Known keys are read
    EXPLICITLY with ``None`` defaults (never splatted): a newer
    worker decorating the snapshot with fields this router predates
    must not crash the reader — and a legacy heartbeat (no
    ``resources`` key) decodes to ``None``, leaving the handle's
    fleet view unpopulated rather than zeroed."""
    if not isinstance(d, dict):
        return None
    out = {}
    for key in _RESOURCE_INT_KEYS:
        v = d.get(key)
        out[key] = int(v) if isinstance(v, (int, float)) else None
    for key in _RESOURCE_FLOAT_KEYS:
        v = d.get(key)
        out[key] = float(v) if isinstance(v, (int, float)) else None
    return out


# The compact rollup delta a heartbeat carries: the
# since-last-heartbeat slice of the worker's history plane
# (:meth:`~multigrad_tpu_torch.telemetry.rollup.RollupStore.take_delta`).
# Same known-keys discipline as the resource snapshot: every field
# numeric-or-None, coerced on decode, never splatted.
_ROLLUP_INT_KEYS = ("fits", "sheds", "queue_wait_count")
_ROLLUP_FLOAT_KEYS = ("t", "span_s", "device_busy_s",
                      "queue_wait_sum_s", "queue_wait_max_s")


def rollup_to_wire(delta) -> Optional[dict]:
    """A :meth:`~multigrad_tpu_torch.telemetry.rollup.RollupStore
    .take_delta` dict as a heartbeat field (``None`` for an idle
    interval or a history-less worker — the key stays off the
    message entirely, so such a heartbeat is byte-identical to the
    pre-rollup protocol a legacy router expects)."""
    if not isinstance(delta, dict):
        return None
    out = {}
    for key in _ROLLUP_INT_KEYS:
        v = delta.get(key)
        out[key] = int(v) if isinstance(v, (int, float)) else None
    for key in _ROLLUP_FLOAT_KEYS:
        v = delta.get(key)
        out[key] = float(v) if isinstance(v, (int, float)) else None
    return out


def rollup_from_wire(d) -> Optional[dict]:
    """Decode a heartbeat's ``rollup`` field.  Known keys read
    EXPLICITLY with ``None`` defaults (never splatted): a newer
    worker's extra fields are dropped, a legacy heartbeat (no
    ``rollup`` key) decodes to ``None`` — no history, never
    fabricated zeros — and string-typed values coerce to ``None`` so
    the router's merge arithmetic never meets a str."""
    if not isinstance(d, dict):
        return None
    out = {}
    for key in _ROLLUP_INT_KEYS:
        v = d.get(key)
        out[key] = int(v) if isinstance(v, (int, float)) else None
    for key in _ROLLUP_FLOAT_KEYS:
        v = d.get(key)
        out[key] = float(v) if isinstance(v, (int, float)) else None
    return out


def result_to_wire(result: FitResult) -> dict:
    return {
        "params": np.asarray(result.params).tolist(),
        "loss": float(result.loss),
        "traj": np.asarray(result.traj).tolist(),
        "steps": int(result.steps),
        "bucket": int(result.bucket),
        "wait_s": float(result.wait_s),
        "fit_s": float(result.fit_s),
        "retried": bool(result.retried),
        "trace_id": result.trace_id,
        "hops": result.hops,
        "job_id": result.job_id,
        "stage": result.stage,
    }


def result_from_wire(d: dict, request_id, worker: Optional[str] = None
                     ) -> FitResult:
    # Trace fields are optional on the way in — an undecorated
    # (pre-tracing) worker's result still decodes; the router fills
    # in what it knows from its own side of the trace.
    hops = d.get("hops")
    return FitResult(
        request_id=request_id,
        params=np.asarray(d["params"], dtype=float),
        loss=float(d["loss"]),
        traj=np.asarray(d["traj"], dtype=float),
        steps=int(d["steps"]), bucket=int(d["bucket"]),
        wait_s=float(d["wait_s"]), fit_s=float(d["fit_s"]),
        retried=bool(d.get("retried", False)), worker=worker,
        trace_id=d.get("trace_id"),
        hops=dict(hops) if isinstance(hops, dict) else None,
        job_id=d.get("job_id"), stage=d.get("stage"))
