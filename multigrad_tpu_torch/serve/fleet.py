"""Preemption-resilient fit-fleet: a router over N worker processes (port
of :mod:`multigrad_tpu.serve.fleet`).

The :class:`~multigrad_tpu_torch.serve.scheduler.FitScheduler` is
single-process end to end — one queue, one device, one dispatcher — and
a killed process loses every in-flight request.  This module is the
horizontal dimension: a :class:`FleetRouter` front-end that shards
incoming :class:`~multigrad_tpu_torch.serve.queue.FitConfig` traffic across
N **worker processes** (spawned subprocesses running
``python -m multigrad_tpu_torch.serve.worker``, each its own process,
CUDA context and :class:`FitScheduler`), with the failure semantics
preemptible serving actually needs:

* **Config-affinity routing** — requests sharing a config land on the
  worker whose buckets already ran (rendezvous hashing over
  ``(config, ndim)``, so a worker death remaps only its own keys).  The
  kernel-library directory
  (:func:`~multigrad_tpu_torch.serve.compile_cache.enable_compile_cache`)
  is shared by every worker, making a warm build a *fleet-wide* asset:
  no worker runs ``nvcc`` for libraries another process built.
* **Heartbeat health tracking** — every worker streams heartbeats
  (queue depth, in-flight count, scheduler counters); heartbeat loss
  or an unexpected process exit declares the worker lost.
* **Preemption-resilient draining** — a SIGTERM'd worker announces
  ``draining``, serves everything it already queued
  (``FitScheduler.close(drain=True)``), and exits 0; the router
  routes around it meanwhile.  A SIGKILL'd worker's in-flight
  requests are detected by heartbeat/connection loss and
  **re-enqueued on a surviving worker**, preserving the original
  wall-clock deadline and the consumed poison retry, with the full
  requeue history carried on the
  :class:`~multigrad_tpu_torch.serve.queue.FitFuture` (``.requeues``) and a
  ``worker_lost`` postmortem bundle dumped through the existing
  flight-recorder machinery.  Requests that exhaust ``max_requeues``
  (or find no survivor) resolve with the typed
  :class:`WorkerLostError` — never silently lost, never hung.
* **Load shedding / work stealing** — a worker whose queue saturates
  rejects the request (``QueueFullError`` worker-side becomes a
  ``reject`` message); the router steals the request onto the next
  live worker, and only when *every* live worker pushed back does
  the caller see the typed :class:`FleetSaturatedError`.  Optionally
  (``shed_inflight=``) the router sheds *proactively*, routing away
  from a worker whose router-known in-flight load exceeds the least
  loaded worker's by the threshold.
* **Bounded retry-with-backoff** on worker RPC failures: a failed
  send is retried with exponential backoff before the worker is
  declared lost and the request re-enqueued.

Observability: fleet gauges (``multigrad_fleet_*``) land in the
``live=`` registry, per-worker telemetry JSONL streams are wired as
``rank_paths`` of a :class:`~multigrad_tpu_torch.telemetry.LiveServer` so
the existing ``/fleet`` endpoint (:mod:`~multigrad_tpu_torch.telemetry
.aggregate`) serves the cross-worker view, and the router logs
``fleet_worker`` / ``fleet_requeue`` records into ``telemetry=``.
**Distributed request tracing** (on by default, ``trace=``): a
W3C-style trace context minted per request at :meth:`FleetRouter
.submit` rides every wire hop, each stage records a span into its
process's trace JSONL (router: ``route``/``rpc_send``/``requeue``/
``result_return``; worker scheduler: ``queue_wait``/
``bucket_coalesce``/``dispatch``/``adam_segments``/``finalize``),
end-to-end latency histograms with p50/p95/p99 and exemplar trace
ids land in ``/status``, per-worker RPC round-trip time is sampled
into the ``multigrad_fleet_rpc_rtt`` gauge, and ``python -m
multigrad_tpu_torch.telemetry.trace`` renders any request's merged
waterfall from the files alone — a chaos-killed request shows one
explicit ``requeue`` hop per worker generation it crossed.

The chaos-injection harness proving all of this lives in
:mod:`.chaos`; ``examples/fleet_chaos_demo.py`` runs the
kill-a-worker scenario end to end and CI greps its ``FLEET OK``
receipt.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import itertools
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from ..telemetry.tracing import Tracer
from .._lockdep import make_lock
from .compile_cache import DEFAULT_BUCKETS
from .qos import class_rank, make_tag, request_tag
from .queue import (FitCancelled, FitConfig, FitDeadlineExceeded,
                    FitFailed, FitFuture, QueueFullError)
from .wire import (JsonlChannel, config_to_wire, qos_to_wire,
                   resources_from_wire, result_from_wire,
                   rollup_from_wire, shed_from_wire)

__all__ = ["FleetRouter", "WorkerHandle", "WorkerLostError",
           "FleetSaturatedError"]


class WorkerLostError(RuntimeError):
    """A request's worker died and the fleet could not finish it —
    requeues exhausted, or no surviving worker to re-enqueue on.
    ``requeues`` carries the request's full migration history (the
    same entries as ``FitFuture.requeues``), each with the lost
    worker, the reason, and the ``worker_lost`` postmortem bundle
    path when one was dumped."""

    def __init__(self, message: str, request_id=None, requeues=None):
        self.request_id = request_id
        self.requeues = list(requeues or ())
        super().__init__(message)


class FleetSaturatedError(QueueFullError):
    """Admission-reject: every live worker's queue pushed back.  The
    fleet-level analog of :class:`~multigrad_tpu_torch.serve.queue
    .QueueFullError` — raised onto the future only after reroute
    (work stealing) was attempted on every live worker.

    With QoS-aware workers the error carries *why*: ``reason`` is
    ``"tenant_quota"`` when the rejects said "YOU are over quota"
    (vs the default ``"queue_full"``, "the fleet is busy"), and
    ``shed_by_class`` / ``shed_by_tenant`` snapshot the fleet's
    cumulative shed counters at reject time — an operator can tell
    from the exception alone whether the fix is "raise the tenant's
    quota" or "add workers".  All attributes default benign, so a
    pre-QoS fleet raises the same error it always did."""

    def __init__(self, message: str, reason: str = "queue_full",
                 shed_by_class=None, shed_by_tenant=None):
        self.reason = reason
        self.shed_by_class = dict(shed_by_class or {})
        self.shed_by_tenant = dict(shed_by_tenant or {})
        super().__init__(message)


@dataclass
class FleetRequest:
    """Router-side bookkeeping for one fleet fit request."""

    id: str
    guess: np.ndarray
    config: FitConfig
    future: FitFuture
    deadline_t: Optional[float] = None     # absolute wall clock
    submitted_t: float = field(default_factory=time.time)
    worker: Optional[str] = None           # current home
    poison_retried: bool = False           # consumed its one retry
    rejected_by: set = field(default_factory=set)
    # Distributed tracing: the context minted at submit, the
    # router-side hop-latency accumulator (route / rpc_send /
    # result_return / requeue seconds, merged with the worker-side
    # hops onto FitResult.hops), the wall clock of the latest
    # dispatch send (a requeue span covers [last dispatch, requeue]
    # — the whole lost attempt INCLUDING the heartbeat-timeout
    # detection window, which no live process can span), and the
    # one-root latch.
    trace: Optional[object] = None
    hops: dict = field(default_factory=dict)
    last_dispatch_t: Optional[float] = None
    root_recorded: bool = False
    # QoS tag (qos.QosTag | None).  Deliberately NOT part of `key`:
    # the batchability identity stays (config, ndim), so same-config
    # fits from different tenants share one affinity home — and one
    # bucket — instead of fragmenting the buckets per tenant.
    qos: Optional[object] = None

    @property
    def key(self) -> str:
        """Affinity key: the batchability identity — the same
        (config, ndim) pair the scheduler's queue groups buckets by,
        rendered through the frozen dataclass repr so a future
        FitConfig field joins the routing key automatically."""
        return repr((self.config, int(self.guess.shape[0])))


class WorkerHandle:
    """One fleet worker: process + channel + health/load state.

    ``state`` walks ``up → draining → dead`` (or straight to
    ``dead`` on SIGKILL/heartbeat loss).  ``inflight`` maps request
    ids to :class:`FleetRequest`\\ s currently homed on this worker —
    the set the router re-enqueues when the worker is lost.
    """

    def __init__(self, worker_id: str, proc=None, chan=None,
                 telemetry_path: Optional[str] = None,
                 log_path: Optional[str] = None,
                 live_port: Optional[int] = None,
                 trace_path: Optional[str] = None):
        self.id = worker_id
        self.proc = proc
        self.chan = chan
        self.telemetry_path = telemetry_path
        self.log_path = log_path
        self.live_port = live_port
        self.trace_path = trace_path
        self.state = "up"
        self.last_heartbeat = time.time()
        self.rpc_rtt_s: Optional[float] = None
        self._rtt_logged_t = 0.0
        self.queue_depth = 0
        self.saturated_until = 0.0
        self.inflight: dict = {}
        self.sched_stats: dict = {}
        # Live resource view (latest heartbeat snapshot) plus a small
        # ring of recent snapshots: a SIGKILL'd worker cannot dump
        # its own resource ring, so the router's copy of its last
        # heartbeats IS the ring its worker_lost postmortem captures.
        self.resources: Optional[dict] = None
        self.resource_ring: collections.deque = \
            collections.deque(maxlen=32)
        self.drained = threading.Event()

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None

    def routable(self) -> bool:
        return self.state == "up"

    def send(self, msg: dict):
        if self.chan is None:
            raise OSError(f"worker {self.id} has no channel")
        self.chan.send(msg)

    def load(self) -> int:
        """Router-known load: requests homed here and unresolved.
        Known synchronously (unlike heartbeat queue depth, which lags
        by one interval), so burst routing can balance on it."""
        return len(self.inflight)


class FleetRouter:
    """Config-affinity router over N fit-fleet worker processes.

    Parameters
    ----------
    n_workers : int
        Worker processes to spawn (0 is allowed: tests register
        handles manually).
    model, model_kwargs :
        The worker model spec, resolved by ``multigrad_tpu_torch.serve
        .worker`` — the builtin ``"smf"`` (``model_kwargs`` may carry
        ``num_halos``) or a ``"module:factory"`` path whose factory
        receives ``model_kwargs``.
    base_dir : str, optional
        Fleet working directory (default: a fresh temp dir): worker
        telemetry JSONLs, worker logs, postmortem bundles and trace
        files land here.
    buckets, max_pending, batch_window_s, retry_poisoned :
        Forwarded to each worker's :class:`~multigrad_tpu_torch.serve
        .scheduler.FitScheduler`.
    device : str | torch.device | list or tuple of them
        The device each worker's model lives on, passed as the worker's
        ``--device`` (``"cuda"`` by default, as every entry point of the
        port; ``"cpu"`` for tests).  A sequence is assigned to the
        workers round-robin — ``["cuda:0", "cuda:1"]`` gives each
        worker its own card; workers sharing one card each hold a CUDA
        context of their own, which the card time-slices.
    compile_cache : str | None
        The kernel-library directory every worker builds into and
        loads from (``--compile-cache``) — the fleet-wide warm asset.
        ``"auto"`` (default) is this process's current library
        directory (:func:`~multigrad_tpu_torch.ops.cuda_build
        .build_dir`), so the workers load what this process built and
        run no ``nvcc``; ``None`` leaves each worker its default.
    telemetry : MetricsLogger, optional
        Router-side ``fleet_worker`` / ``fleet_requeue`` records.
    live : LiveServer | LiveSink | LiveMetrics, optional
        Fleet gauges (``multigrad_fleet_*``).  A ``LiveServer`` whose
        ``rank_paths`` is unset additionally gets the workers'
        telemetry paths, so its ``/fleet`` endpoint serves the
        cross-worker aggregate view.
    heartbeat_s / heartbeat_timeout_s :
        Worker heartbeat period and the age beyond which a worker is
        declared lost.
    max_requeues : int
        How many times one request may be re-enqueued off dead
        workers before it resolves with :class:`WorkerLostError`.
    rpc_retries / rpc_backoff_s :
        Bounded exponential backoff for a failed worker send before
        the worker is declared lost.
    shed_inflight : int, optional
        Proactive load shedding: route away from the affinity home
        when its router-known in-flight load exceeds the least
        loaded live worker's by at least this many requests
        (``None`` disables; reject-driven stealing still applies).
    trace : bool | Tracer
        Distributed request tracing (default on).  ``True`` writes
        the router's spans to ``<base_dir>/router.trace.jsonl`` and
        spawns every worker with its own ``<worker>.trace.jsonl``;
        a :class:`~multigrad_tpu_torch.telemetry.tracing.Tracer` instance
        substitutes for the router's own sink.  A trace context is
        minted per request at :meth:`submit` and propagated on the
        wire, so each request's full hop journey — across requeues
        and worker generations — merges into one waterfall
        (``python -m multigrad_tpu_torch.telemetry.trace`` over
        :attr:`trace_paths`).  ``False`` disables tracing.
    worker_live_port : int, optional
        Base port for each worker's own :class:`~multigrad_tpu_torch
        .telemetry.LiveServer`.  All workers get the SAME base —
        the ``EADDRINUSE`` bind-retry probes forward, and each
        worker's ``/status`` reports the port it actually bound.
    chaos : bool
        Spawn workers with ``--chaos`` so the
        :class:`~multigrad_tpu_torch.serve.chaos.ChaosController` can
        inject protocol-level faults (queue-full rejects, stalls).
    qos : bool
        Multi-tenant QoS (default off): spawn every worker with
        ``--qos`` (weighted-fair dequeue, class-aware shed,
        deadline-aware packing; see :mod:`~multigrad_tpu_torch.serve.qos`)
        and propagate each request's tag on the wire.  Off, tags
        still ride :meth:`submit` for telemetry but workers dequeue
        FIFO.
    tenant_quota : int, optional
        Per-tenant queued-request cap forwarded to each worker
        (requires ``qos=True``); an over-quota submit rejects with
        reason ``"tenant_quota"`` — which the router treats as "this
        tenant is over", NOT as fleet saturation (the worker is not
        marked saturated, other tenants keep routing to it).
    slo : SloMonitor | iterable of Slo | str, optional
        Router-side SLO monitor (see :mod:`~multigrad_tpu_torch.serve
        .slo`): every served fit's end-to-end latency is observed
        per priority class, declared objectives export as
        ``multigrad_qos_*`` gauges into ``live=``, and
        ``router.slo.evaluate()`` judges them.  Iterables/strings
        are declarative objectives (``"p95 < 2 s for
        interactive"``); ``qos=True`` with no ``slo`` still attaches
        a bare monitor (observation without judgment).
    """

    #: Minimum seconds between ``trace_rtt`` JSONL samples per
    #: worker (the RTT gauge still refreshes on every pong).
    RTT_LOG_INTERVAL_S = 10.0

    def __init__(self, n_workers: int = 2, *,
                 model: str = "smf",
                 model_kwargs: Optional[dict] = None,
                 base_dir: Optional[str] = None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_pending: int = 1024,
                 batch_window_s: float = 0.05,
                 retry_poisoned: bool = True,
                 device="cuda",
                 compile_cache: Optional[str] = "auto",
                 telemetry=None, live=None,
                 heartbeat_s: float = 0.25,
                 heartbeat_timeout_s: float = 2.0,
                 max_requeues: int = 2,
                 rpc_retries: int = 3,
                 rpc_backoff_s: float = 0.05,
                 shed_inflight: Optional[int] = None,
                 saturate_cooldown_s: float = 0.5,
                 trace=True,
                 worker_live_port: Optional[int] = None,
                 chaos: bool = False,
                 qos: bool = False,
                 tenant_quota: Optional[int] = None,
                 slo=None,
                 spawn_timeout_s: float = 240.0,
                 worker_args: Optional[Sequence[str]] = None,
                 env: Optional[dict] = None):
        self.base_dir = base_dir or tempfile.mkdtemp(prefix="mgt_fleet_")
        os.makedirs(self.base_dir, exist_ok=True)
        self.model = model
        self.model_kwargs = dict(model_kwargs or {})
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.max_pending = int(max_pending)
        self.batch_window_s = float(batch_window_s)
        self.retry_poisoned = bool(retry_poisoned)
        self.devices = ([str(d) for d in device]
                        if isinstance(device, (list, tuple))
                        else [str(device)])
        if not self.devices:
            raise ValueError("device= names no device")
        if compile_cache == "auto":
            from ..ops.cuda_build import build_dir
            compile_cache = str(build_dir())
        self.compile_cache = compile_cache
        self.telemetry = telemetry
        self._metrics = getattr(live, "metrics", live)
        from ..telemetry.live import LatencyObserver
        self._latency = LatencyObserver(self._metrics,
                                        "multigrad_fleet",
                                        "fleet fit")
        self.heartbeat_s = float(heartbeat_s)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.max_requeues = int(max_requeues)
        self.rpc_retries = int(rpc_retries)
        self.rpc_backoff_s = float(rpc_backoff_s)
        self.shed_inflight = shed_inflight
        self.saturate_cooldown_s = float(saturate_cooldown_s)
        self.worker_live_port = worker_live_port
        self.chaos_enabled = bool(chaos)
        self.qos_enabled = bool(qos)
        self.tenant_quota = tenant_quota
        from .slo import SloMonitor
        if isinstance(slo, SloMonitor):
            self.slo = slo
        elif slo is not None:
            self.slo = SloMonitor(self._metrics, slo)
        elif self.qos_enabled:
            self.slo = SloMonitor(self._metrics, ())
        else:
            self.slo = None
        # Fleet-wide shed accounting, accumulated from QoS-aware
        # workers' reject messages (wire `shed` field) under _lock.
        self._shed_by_class: dict = {}
        self._shed_by_tenant: dict = {}
        # Fleet-level history plane: every worker heartbeat's
        # compact rollup delta merges here, so windowed fleet rates
        # and queue-wait trends survive a SIGKILL'd worker — the
        # worker's own store dies with it, the merged history does
        # not.  Also a sink on the router's record stream and a
        # scraper of its registry, so router-side fit_summary /
        # resource_sample records land in the same windows.
        from ..telemetry.rollup import RollupStore
        self.rollup = RollupStore()
        if telemetry is not None:
            telemetry.add_sink(self.rollup)
        if self._metrics is not None:
            self.rollup.attach_live(self._metrics)
        self.spawn_timeout_s = float(spawn_timeout_s)
        self.worker_args = list(worker_args or ())
        self._env = env

        self._owns_tracer = False
        if trace is True:
            self._tracer = Tracer(
                os.path.join(self.base_dir, "router.trace.jsonl"),
                service="router")
            self._owns_tracer = True
        elif trace:
            self._tracer = trace
        else:
            self._tracer = None

        from ..telemetry.flight import FlightRecorder
        self._recorder = FlightRecorder(
            dump_dir=os.path.join(self.base_dir, "postmortems"),
            trip_on_stall=False, divergence_spike=None)

        # The router claims futures (FitFuture._set_running takes
        # the future's own lock) inside its registry critical
        # section — an ordering the AST cannot derive through the
        # dynamic `req.future` dispatch, hence declared.
        self._lock = make_lock(
            "serve.fleet.FleetRouter._lock",
            may_precede=("serve.queue.FitFuture._lock",))
        self._ids = itertools.count()
        self._requests: dict = {}
        # Sticky config homes: key -> worker id of the last dispatch.
        # Affinity must survive a steal — when load shedding (or a
        # reject) moves a config off its hash home, the config's
        # LATER traffic follows it, so one worker still
        # serves the whole stream instead of every batch window
        # being paid twice on two half-groups.
        self._key_home: dict = {}
        self._stats: dict = {}
        self._first_submit_t: Optional[float] = None
        self._last_completed_t: Optional[float] = None
        self._closing = False
        self.workers: list = []
        self._reader_threads: list = []

        # All workers start at once and are connected in order: a
        # worker's start (its imports and its model's data) takes
        # seconds, and N of them overlap instead of adding up.
        launches = [self._launch(f"w{i}", i) for i in range(int(n_workers))]
        try:
            for launch in launches:
                self.workers.append(self._connect(launch))
        except BaseException:
            for launch in launches:      # no half-started fleet
                launch["proc"].kill()
            raise
        # Wire the /fleet plane: the per-worker telemetry JSONLs are
        # exactly the "per-rank files" aggregate.py merges.
        paths = [w.telemetry_path for w in self.workers
                 if w.telemetry_path]
        if live is not None and paths \
                and getattr(live, "rank_paths", "absent") is None:
            live.rank_paths = paths
        self._monitor_stop = threading.Event()
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True,
            name="mgt-fleet-monitor")
        self._monitor.start()
        self._refresh_gauges()

    # ------------------------------------------------------------------ #
    # worker lifecycle
    # ------------------------------------------------------------------ #
    def _worker_env(self) -> dict:
        env = dict(os.environ if self._env is None else self._env)
        # The workers must import the same multigrad_tpu_torch the
        # router runs — prepend its repo root so a source checkout works
        # without installation (harmless when pip-installed).
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep \
            + env.get("PYTHONPATH", "")
        return env

    def _worker_paths(self, worker_id: str) -> tuple:
        """A worker's telemetry, log and trace files (no trace file with
        tracing off)."""
        return (os.path.join(self.base_dir, f"{worker_id}.jsonl"),
                os.path.join(self.base_dir, f"{worker_id}.log"),
                (os.path.join(self.base_dir, f"{worker_id}.trace.jsonl")
                 if self._tracer is not None else None))

    def _launch_cmd(self, worker_id: str, index: int) -> list:
        """The command line of worker ``index`` (its device is
        ``device[index]``, round-robin)."""
        telemetry_path, _, trace_path = self._worker_paths(worker_id)
        cmd = [sys.executable, "-m", "multigrad_tpu_torch.serve.worker",
               "--worker-id", worker_id,
               "--rank", str(index), "--port", "0",
               "--model", self.model,
               "--device", self.devices[index % len(self.devices)],
               "--model-kwargs", json.dumps(self.model_kwargs),
               "--buckets", ",".join(str(b) for b in self.buckets),
               "--max-pending", str(self.max_pending),
               "--batch-window-s", str(self.batch_window_s),
               "--heartbeat-s", str(self.heartbeat_s),
               "--telemetry", telemetry_path,
               "--flight-dir",
               os.path.join(self.base_dir, "postmortems")]
        if trace_path is not None:
            cmd += ["--trace", trace_path]
        if not self.retry_poisoned:
            cmd.append("--no-retry-poisoned")
        if self.compile_cache:
            cmd += ["--compile-cache", self.compile_cache]
        if self.worker_live_port is not None:
            cmd += ["--live-port", str(self.worker_live_port)]
        if self.chaos_enabled:
            cmd.append("--chaos")
        if self.qos_enabled:
            cmd.append("--qos")
            if self.tenant_quota is not None:
                cmd += ["--tenant-quota", str(self.tenant_quota)]
        return cmd + self.worker_args

    def _launch(self, worker_id: str, index: int) -> dict:
        """Start worker ``index``'s process and the thread that copies
        its output into its log and reads its READY line; returns what
        :meth:`_connect` needs."""
        telemetry_path, log_path, trace_path = \
            self._worker_paths(worker_id)
        proc = subprocess.Popen(
            self._launch_cmd(worker_id, index), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=self._worker_env())

        ready: dict = {}
        ready_evt = threading.Event()

        def _drain_stdout():
            # All worker output lands in a per-worker log; the READY
            # handshake is parsed on the way through.
            with open(log_path, "w") as log:
                for line in proc.stdout:
                    log.write(line)
                    log.flush()
                    if line.startswith("FLEET-WORKER-READY "):
                        try:
                            ready.update(json.loads(
                                line.split(" ", 1)[1]))
                        except ValueError:
                            pass
                        ready_evt.set()
            ready_evt.set()       # EOF: unblock the spawn wait too

        threading.Thread(target=_drain_stdout, daemon=True,
                         name=f"mgt-fleet-{worker_id}-log").start()
        return dict(worker_id=worker_id, proc=proc, ready=ready,
                    ready_evt=ready_evt, telemetry_path=telemetry_path,
                    log_path=log_path, trace_path=trace_path)

    def _connect(self, launch: dict) -> WorkerHandle:
        """Wait for a launched worker's READY line (at most
        ``spawn_timeout_s``), connect to it and start its reader."""
        worker_id, proc, ready = (launch["worker_id"], launch["proc"],
                                  launch["ready"])
        log_path = launch["log_path"]
        if not launch["ready_evt"].wait(self.spawn_timeout_s) \
                or "port" not in ready:
            proc.kill()
            tail = ""
            try:
                with open(log_path) as f:
                    tail = f.read()[-2000:]
            except OSError:
                pass
            raise RuntimeError(
                f"fleet worker {worker_id} failed to start within "
                f"{self.spawn_timeout_s}s (rc={proc.poll()}):\n{tail}")
        import socket as _socket
        sock = _socket.create_connection(
            ("127.0.0.1", int(ready["port"])), timeout=10)
        handle = WorkerHandle(
            worker_id, proc=proc, chan=JsonlChannel(sock),
            telemetry_path=launch["telemetry_path"], log_path=log_path,
            live_port=ready.get("live_port"),
            trace_path=launch["trace_path"])
        t = threading.Thread(target=self._reader, args=(handle,),
                             daemon=True,
                             name=f"mgt-fleet-{worker_id}-reader")
        t.start()
        self._reader_threads.append(t)
        self._log_event("fleet_worker", worker=worker_id,
                        state="up", pid=proc.pid,
                        live_port=ready.get("live_port"))
        return handle

    # ------------------------------------------------------------------ #
    # submit side
    # ------------------------------------------------------------------ #
    def submit(self, guess, nsteps: int = 100,
               learning_rate: float = 0.01, param_bounds=None,
               randkey=None, const_randkey: bool = False,
               config: Optional[FitConfig] = None,
               deadline_s: Optional[float] = None,
               trace=None, qos=None, tenant: Optional[str] = None,
               priority_class: Optional[str] = None,
               slo_deadline_s: Optional[float] = None) -> FitFuture:
        """Queue one fit on the fleet; returns its
        :class:`~multigrad_tpu_torch.serve.queue.FitFuture`.

        Same surface as :meth:`FitScheduler.submit
        <multigrad_tpu_torch.serve.scheduler.FitScheduler.submit>` minus
        the queue-blocking knobs (fleet backpressure is reroute →
        typed :class:`FleetSaturatedError`).  ``deadline_s`` is
        converted to an absolute wall-clock deadline once, here — a
        requeue after a worker death does NOT reset it.

        With tracing on (the default) this is the **mint point** of
        the request's trace: a fresh W3C-style context is created
        here, propagated on every wire hop, and closed by the root
        ``request`` span when the future settles — the returned
        future carries the id as ``.trace_id``.  ``trace`` overrides
        the mint with a caller-supplied
        :class:`~multigrad_tpu_torch.telemetry.tracing.TraceContext` — the
        job-DAG runner (:mod:`multigrad_tpu_torch.serve.jobs`) passes a
        child of its stage span, so every per-fit ``request`` span
        parents into the job's single waterfall instead of starting
        a trace of its own.

        ``qos`` (a :class:`~multigrad_tpu_torch.serve.qos.QosTag`) — or
        the convenience kwargs ``tenant`` / ``priority_class`` /
        ``slo_deadline_s`` — tags the request for multi-tenant
        scheduling; the tag rides the wire to the worker (honored
        under ``qos=True``, ignored by pre-QoS workers) and an SLO
        deadline doubles as the request deadline when ``deadline_s``
        is unset.
        """
        if self._closing:
            raise RuntimeError("fleet router is closed")
        tag = make_tag(qos, tenant, priority_class, slo_deadline_s)
        if deadline_s is None and tag is not None \
                and tag.slo_deadline_s is not None:
            deadline_s = tag.slo_deadline_s
        if config is None:
            config = FitConfig(
                nsteps=nsteps, learning_rate=learning_rate,
                param_bounds=param_bounds, randkey=randkey,
                const_randkey=const_randkey)
        guess = np.asarray(guess, dtype=float)
        from .scheduler import FitScheduler
        FitScheduler._validate(guess, config)
        rid = f"r{next(self._ids)}"
        ctx = trace
        if ctx is None:
            ctx = self._tracer.new_trace() \
                if self._tracer is not None else None
        future = FitFuture(rid)
        if ctx is not None:
            future.trace_id = ctx.trace_id
        req = FleetRequest(
            id=rid, guess=guess, config=config,
            future=future, trace=ctx, qos=tag,
            deadline_t=(time.time() + float(deadline_s)
                        if deadline_s is not None else None))
        with self._lock:
            self._requests[rid] = req
            self._count_locked("submitted")
            if self._first_submit_t is None:
                self._first_submit_t = req.submitted_t
        self._dispatch(req)
        return req.future

    # ------------------------------------------------------------------ #
    # routing
    # ------------------------------------------------------------------ #
    def _affinity_order(self, key: str) -> list:
        """Rendezvous (highest-random-weight) order of ALL workers
        for one affinity key: deterministic, and a worker's death
        remaps only the keys it owned."""
        def weight(w):
            return hashlib.md5(
                f"{key}|{w.id}".encode()).hexdigest()
        return sorted(self.workers, key=weight, reverse=True)

    def _route(self, req: FleetRequest, exclude=frozenset()
               ) -> Optional[WorkerHandle]:
        now = time.time()
        order = [w for w in self._affinity_order(req.key)
                 if w.routable() and w.id not in exclude]
        if not order:
            return None
        with self._lock:
            sticky = self._key_home.get(req.key)
        pick = next((w for w in order if w.id == sticky), None)
        if pick is None:
            # New (or orphaned) key: hash home first; skip recently-
            # saturated workers when a fresh one exists (reject-
            # driven stealing sets the flag).
            candidates = [w for w in order
                          if w.saturated_until <= now] or order
            pick = candidates[0]
            if self.shed_inflight is not None and len(candidates) > 1:
                # Proactive shed — only at key-assignment time, so a
                # config's burst is never split across two workers'
                # batch windows: abandon the hash home when it is
                # this much deeper than the lightest live worker.
                lightest = min(candidates, key=WorkerHandle.load)
                if pick.load() - lightest.load() >= self.shed_inflight:
                    pick = lightest
        with self._lock:
            self._key_home[req.key] = pick.id
        return pick

    def _dispatch(self, req: FleetRequest, exclude=frozenset()):
        if req.future.done():
            return            # cancelled (or settled) while pending
        t_route = time.time()
        worker = self._route(req, exclude)
        if worker is None:
            self._settle_lost(
                req, "no live fleet worker available")
            return
        with self._lock:
            if worker.state != "up":
                # Lost between route and claim: try again without it.
                pass
            else:
                req.worker = worker.id
                req.future._set_running()
                worker.inflight[req.id] = req
        if req.worker != worker.id:
            self._dispatch(req, exclude | {worker.id})
            return
        self._trace_hop(req, "route", t_route, worker=worker.id)
        msg = {"op": "submit", "rid": req.id,
               "guess": req.guess.tolist(),
               "config": config_to_wire(req.config),
               "deadline_t": req.deadline_t,
               "retried": req.poison_retried,
               "submitted_t": req.submitted_t}
        if req.trace is not None:
            msg["trace"] = req.trace.to_wire()
        if req.qos is not None:
            # Key stays off untagged messages entirely: an untagged
            # router's traffic is byte-identical to the pre-QoS
            # protocol.
            msg["qos"] = qos_to_wire(req.qos)
        # lock-ok: unlocked-shared-write single-owner field: only the thread that just claimed the request under _lock (it is in exactly one worker's inflight map) reaches this write; readers (_requeue) run only after popping the claim back
        req.last_dispatch_t = time.time()
        self._send_with_retry(worker, msg, req)

    def _send_with_retry(self, worker: WorkerHandle, msg: dict,
                         req: FleetRequest):
        """Bounded retry-with-backoff on RPC failures, then declare
        the worker lost and re-enqueue the request elsewhere."""
        t0 = time.time()
        n_attempts = 0
        for attempt in range(self.rpc_retries):
            n_attempts = attempt + 1
            try:
                worker.send(msg)
                # The span covers backoff sleeps of earlier failed
                # attempts — rpc_send time as the tenant experienced
                # it, not just the final successful write.
                self._trace_hop(req, "rpc_send", t0,
                                worker=worker.id,
                                attempts=n_attempts)
                return
            except OSError:
                if worker.state != "up":
                    break
                time.sleep(self.rpc_backoff_s * (2 ** attempt))
        # n_attempts is the sends actually tried — the loop breaks
        # early on a known-down worker, and an operator reading the
        # failed span must not conclude the whole backoff ladder ran.
        self._trace_hop(req, "rpc_send", t0, ok=False,
                        worker=worker.id,
                        attempts=n_attempts)
        # Claim the request back BEFORE declaring the worker lost —
        # and only requeue on a successful claim: a concurrent
        # _worker_lost (reader EOF, monitor) may have emptied the
        # inflight map and requeued this request already, and a
        # second requeue here would double-count the migration (and
        # could spuriously exhaust the fleet's exclude set).
        with self._lock:
            claimed = worker.inflight.pop(req.id, None)
        self._worker_lost(worker, "rpc send failure")
        if claimed is not None:
            self._requeue(req, f"rpc to worker {worker.id} failed",
                          bundle=None)

    # ------------------------------------------------------------------ #
    # worker responses (reader threads)
    # ------------------------------------------------------------------ #
    def _reader(self, handle: WorkerHandle):
        # The broad backstop is the reader's settlement contract: a
        # malformed message (or a handler bug) must kill neither the
        # thread nor the worker's inflight futures silently — the
        # disconnect path requeues or settles every one of them.
        try:
            self._reader_loop(handle)
        except Exception as err:
            self._log_event("fleet_reader_error", worker=handle.id,
                            error=repr(err))
        finally:
            self._on_disconnect(handle)

    def _reader_loop(self, handle: WorkerHandle):
        for msg in handle.chan:
            op = msg.get("op")
            if op == "result":
                self._on_result(handle, msg)
            elif op == "error":
                self._on_error(handle, msg)
            elif op == "reject":
                self._on_reject(handle, msg)
            elif op == "heartbeat":
                handle.last_heartbeat = time.time()
                handle.queue_depth = int(msg.get("queue_depth", 0))
                handle.sched_stats = msg.get("stats", {})
                # Optional resource snapshot (mixed-version fleet):
                # a legacy heartbeat decodes to None and leaves the
                # view unpopulated; a decorated one from a NEWER
                # worker is read known-keys-only.
                res = resources_from_wire(msg.get("resources"))
                if res is not None:
                    handle.resources = res
                    handle.resource_ring.append(res)
                    self._refresh_resource_gauges(handle, res)
                # Optional rollup delta (same mixed-version rules:
                # legacy heartbeat -> None -> no history, never
                # fabricated zeros).  Merged fleet-level; the
                # contribution outlives the worker.
                roll = rollup_from_wire(msg.get("rollup"))
                if roll is not None:
                    self.rollup.merge_delta(roll, worker=handle.id)
            elif op == "pong":
                handle.last_heartbeat = time.time()
                self._on_pong(handle, msg)
            elif op == "poison_retry":
                self._on_poison_retry(handle, msg)
            elif op == "draining":
                self._on_draining(handle,
                                  msg.get("reason", "draining"))
            elif op == "drained":
                handle.drained.set()

    def _pop_inflight(self, handle: WorkerHandle, rid
                      ) -> Optional[FleetRequest]:
        with self._lock:
            return handle.inflight.pop(rid, None)

    def _forget(self, req: FleetRequest):
        """Drop a terminally-settled request from the registry — a
        long-lived router must not pin every guess/trajectory ever
        served until shutdown."""
        with self._lock:
            self._requests.pop(req.id, None)

    def _on_result(self, handle: WorkerHandle, msg: dict):
        req = self._pop_inflight(handle, msg.get("rid"))
        if req is None or req.future.done():
            return        # late duplicate from a written-off worker
        done_t = time.time()
        sent_t = msg.get("sent_t")
        if isinstance(sent_t, (int, float)):
            self._trace_hop(req, "result_return",
                            min(sent_t, done_t), done_t,
                            worker=handle.id)
        result = result_from_wire(msg["result"], req.id,
                                  worker=handle.id)
        # The delivered hop vector is worker hops (queue_wait,
        # bucket_coalesce, dispatch, adam_segments, finalize — from
        # the wire) + router hops (route, rpc_send, result_return,
        # requeue) — the full per-request latency breakdown.
        result = dataclasses.replace(
            result,
            trace_id=(req.trace.trace_id if req.trace is not None
                      else result.trace_id),
            hops={**(result.hops or {}), **req.hops})
        # Counters, trace root, and latency histograms all land
        # BEFORE the future resolves (the scheduler's convention): a
        # caller that wakes on the last result and reads .stats or
        # /status must see the completion — and the observation —
        # that produced it.
        with self._lock:
            self._count_locked("completed")
            self._last_completed_t = done_t
        self._fits_counter("ok")
        self._trace_root(req, "ok", done_t, worker=handle.id)
        self._observe_latency(req, done_t - req.submitted_t,
                              result.hops)
        if self.slo is not None:
            tag = request_tag(req)
            self.slo.observe(tag.priority_class, tag.tenant,
                             done_t - req.submitted_t,
                             trace_id=result.trace_id)
        req.future._set_result(result)
        self._forget(req)
        self._refresh_gauges()

    def _on_error(self, handle: WorkerHandle, msg: dict):
        req = self._pop_inflight(handle, msg.get("rid"))
        if req is None or req.future.done():
            return
        if msg.get("retried"):
            req.poison_retried = True
        # Trace root BEFORE the future resolves (the convention
        # everywhere a request settles): the caller waking on this
        # error may immediately merge the trace files for triage and
        # must find a complete, rooted trace.
        self._trace_root(req, msg.get("etype", "error"),
                         worker=handle.id,
                         bundle=msg.get("bundle_path"))
        with self._lock:
            self._count_locked("failed")
        self._fits_counter("failed")
        req.future._set_exception(self._exception_from_wire(msg, req))
        self._forget(req)
        self._refresh_gauges()

    @staticmethod
    def _exception_from_wire(msg: dict, req: FleetRequest
                             ) -> BaseException:
        etype = msg.get("etype", "RuntimeError")
        message = msg.get("message", "")
        if etype == "FitFailed":
            return FitFailed(message, req.id,
                             bundle_path=msg.get("bundle_path"))
        if etype == "FitDeadlineExceeded":
            return FitDeadlineExceeded(message)
        if etype == "FitCancelled":
            return FitCancelled(message)
        if etype in ("ValueError", "TypeError"):
            return {"ValueError": ValueError,
                    "TypeError": TypeError}[etype](message)
        return RuntimeError(f"{etype}: {message}")

    def _on_reject(self, handle: WorkerHandle, msg: dict):
        """Load shed: the worker's queue is full (or it is draining).
        Steal the request onto the next live worker; admission-reject
        with the typed error only when everyone pushed back.

        QoS-aware workers say *why*: reason ``"tenant_quota"`` means
        "this TENANT is over its per-worker cap" — a per-tenant
        verdict, not fleet saturation — so the worker is NOT marked
        saturated (other tenants keep routing to it), though this
        request still moves on (a different worker has a different
        quota ledger).  The reject's cumulative ``shed`` counters
        fold into the router's fleet-wide accounting either way."""
        req = self._pop_inflight(handle, msg.get("rid"))
        if req is None or req.future.done():
            return
        reason = msg.get("reason", "queue_full")
        shed = shed_from_wire(msg.get("shed"))
        with self._lock:
            # Worker counters are CUMULATIVE: replace, don't add.
            for side, dst in (("by_class", self._shed_by_class),
                              ("by_tenant", self._shed_by_tenant)):
                dst.setdefault(handle.id, {})
                dst[handle.id] = shed[side] or dst[handle.id]
        if reason != "tenant_quota":
            handle.saturated_until = \
                time.time() + self.saturate_cooldown_s
        req.rejected_by.add(handle.id)
        with self._lock:
            self._count_locked("rejected")
        self._inc_counter("multigrad_fleet_rejects_total",
                          help="worker queue-full rejects",
                          labels={"worker": handle.id})
        remaining = [w for w in self.workers if w.routable()
                     and w.id not in req.rejected_by]
        if not remaining:
            self._trace_root(req, "shed")
            if self.slo is not None:
                tag = request_tag(req)
                self.slo.record_shed(tag.priority_class, tag.tenant)
            by_class, by_tenant = self.shed_counts()
            with self._lock:
                self._count_locked("shed")
            self._fits_counter("shed")
            req.future._set_exception(FleetSaturatedError(
                f"every live fleet worker rejected request {req.id} "
                f"(reason: {reason})", reason=reason,
                shed_by_class=by_class, shed_by_tenant=by_tenant))
            self._forget(req)
            return
        self._dispatch(req, exclude=req.rejected_by)

    def shed_counts(self) -> tuple:
        """Fleet-wide shed accounting summed over workers:
        ``(by_class, by_tenant)`` dicts from the cumulative counters
        the QoS-aware workers report on their reject messages."""
        by_class: dict = {}
        by_tenant: dict = {}
        with self._lock:
            for per_worker, dst in ((self._shed_by_class, by_class),
                                    (self._shed_by_tenant, by_tenant)):
                for counts in per_worker.values():
                    for k, v in counts.items():
                        dst[k] = dst.get(k, 0) + int(v)
        return by_class, by_tenant

    def _on_pong(self, handle: WorkerHandle, msg: dict):
        """RPC round-trip sample: the monitor's ping carried its
        send time, the worker echoed it back.  This is the fleet's
        link-latency floor — the health plane knew liveness but not
        how long a hop actually takes, and it is also the wall-clock
        noise floor to read cross-process trace offsets against.
        An old worker's pong has no ``t0``: skip, don't crash
        (mixed-version fleet)."""
        t0 = msg.get("t0")
        if not isinstance(t0, (int, float)):
            return
        now = time.time()
        rtt = max(0.0, now - t0)
        handle.rpc_rtt_s = rtt
        if self._metrics is not None:
            self._metrics.set(
                "multigrad_fleet_rpc_rtt", rtt,
                help="per-worker heartbeat-RPC round-trip seconds",
                labels={"worker": handle.id})
        # The gauge refreshes on every pong; the JSONL noise-floor
        # sample is throttled per worker — the monitor pings up to
        # 4x/s and an unthrottled log would grow the trace file by
        # megabytes/hour on a long-lived router, dwarfing the
        # request spans it exists to annotate.
        if self._tracer is not None \
                and now - handle._rtt_logged_t \
                >= self.RTT_LOG_INTERVAL_S:
            handle._rtt_logged_t = now
            self._tracer.log("trace_rtt", worker=handle.id,
                             rtt_s=round(rtt, 6))

    def _on_poison_retry(self, handle: WorkerHandle, msg: dict):
        with self._lock:
            req = self._requests.get(msg.get("rid"))
        if req is not None:
            req.poison_retried = True

    def _on_draining(self, handle: WorkerHandle, reason: str):
        with self._lock:
            if handle.state == "up":
                handle.state = "draining"
        self._log_event("fleet_worker", worker=handle.id,
                        state="draining", reason=reason)
        self._refresh_gauges()

    def _on_disconnect(self, handle: WorkerHandle):
        if self._closing:
            # Shutdown owns the cleanup — but the drain wait blocks
            # on inflight, so a worker dying mid-close must still
            # release its entries (close() settles their futures).
            with self._lock:
                handle.state = "dead"
                handle.inflight.clear()
            return
        if handle.state == "dead":
            return
        if handle.state == "draining":
            self._worker_drained(handle)
        else:
            self._worker_lost(handle, "connection closed")

    # ------------------------------------------------------------------ #
    # death / drain / requeue
    # ------------------------------------------------------------------ #
    def _worker_lost(self, handle: WorkerHandle, reason: str):
        """Declare a worker lost and re-enqueue its in-flight
        requests on survivors — the preemption-resilience core."""
        with self._lock:
            if handle.state == "dead":
                return
            handle.state = "dead"
            inflight = list(handle.inflight.values())
            handle.inflight.clear()
            self._count_locked("worker_deaths")
        if handle.proc is not None and handle.proc.poll() is None:
            handle.proc.kill()
        bundle = self._recorder.dump(
            "worker_lost", worker=handle.id, cause=reason,
            pid=handle.pid,
            inflight=[r.id for r in inflight],
            # Bundle -> trace navigation: every stranded request's
            # trace id (the reverse link is the requeue span's
            # `bundle` attribute).
            trace_ids=[r.trace.trace_id for r in inflight
                       if r.trace is not None],
            last_heartbeat_age_s=round(
                time.time() - handle.last_heartbeat, 3),
            sched_stats=handle.sched_stats,
            # The dead worker's last known resource history (its
            # heartbeat snapshots — it cannot dump its own ring
            # after a SIGKILL).
            resources=list(handle.resource_ring))
        self._log_event("fleet_worker", worker=handle.id,
                        state="dead", reason=reason,
                        inflight=len(inflight),
                        postmortem_bundle=bundle)
        self._inc_counter("multigrad_fleet_worker_deaths_total",
                          help="workers declared lost")
        # Class-aware recovery order: the survivors' queues may be
        # tight, so the stranded requests most worth saving go first
        # — highest priority class, then nearest deadline, then
        # oldest submit (FIFO among equals; a pre-QoS fleet's
        # untagged requests all tie and keep the old order).
        def _rescue_key(r):
            tag = request_tag(r)
            return (-class_rank(tag.priority_class),
                    r.deadline_t is None,
                    r.deadline_t if r.deadline_t is not None else 0.0,
                    r.submitted_t)
        for req in sorted(inflight, key=_rescue_key):
            self._requeue(req, f"worker {handle.id} lost ({reason})",
                          bundle)
        self._refresh_gauges()

    def _worker_drained(self, handle: WorkerHandle):
        with self._lock:
            if handle.state == "dead":
                return
            handle.state = "dead"
            leftovers = list(handle.inflight.values())
            handle.inflight.clear()
            self._count_locked("drained")
        self._log_event("fleet_worker", worker=handle.id,
                        state="drained", leftovers=len(leftovers))
        # A clean drain answered everything it had; anything left
        # (drain cut short) migrates like a death would.
        for req in leftovers:
            self._requeue(req,
                          f"worker {handle.id} exited mid-drain",
                          None)
        self._refresh_gauges()

    def _requeue(self, req: FleetRequest, reason: str,
                 bundle: Optional[str]):
        """Re-enqueue one request off a lost worker.

        The contract (tests/test_fleet.py pins each clause): the
        requeue history lands on the future; a cancelled future stays
        cancelled; the ORIGINAL wall-clock deadline still applies (a
        requeue never resets it); the consumed poison retry is
        forwarded so it cannot double-fire; and after
        ``max_requeues`` migrations the request resolves with the
        typed :class:`WorkerLostError` instead of bouncing forever.

        Each migration is one explicit ``requeue`` trace span naming
        both worker generations (``from_worker``/``to_worker``) and
        the ``worker_lost`` bundle.  The span STARTS at the lost
        attempt's dispatch time: everything the dead worker did (and
        the heartbeat-timeout window where nothing ran anywhere) is
        accounted to the requeue hop, so a chaos-killed request's
        waterfall still sums to its end-to-end latency.
        """
        fut = req.future
        from_worker = req.worker
        hop_t0 = req.last_dispatch_t or time.time()
        entry = {"t": time.time(), "worker": req.worker,
                 "reason": reason, "bundle": bundle}
        fut.requeues.append(entry)
        self._log_event("fleet_requeue", request=req.id,
                        worker=req.worker, reason=reason,
                        n_requeues=len(fut.requeues), bundle=bundle)
        self._inc_counter("multigrad_fleet_requeues_total",
                          help="requests re-enqueued off lost workers")
        with self._lock:
            self._count_locked("requeued")

        def _requeue_span(to_worker, outcome, t_end=None,
                          count_hop=True):
            if self._tracer is None or req.trace is None:
                return
            t_end = time.time() if t_end is None else t_end
            self._tracer.record(
                req.trace.child(), "requeue", hop_t0, t_end,
                from_worker=from_worker, to_worker=to_worker,
                reason=reason, bundle=bundle, outcome=outcome,
                n_requeues=len(fut.requeues))
            if count_hop:
                req.hops["requeue"] = round(
                    req.hops.get("requeue", 0.0)
                    + max(0.0, t_end - hop_t0), 6)

        fut._requeued()
        if fut.done() or fut.cancelled():
            _requeue_span(None, "already_settled")
            self._forget(req)
            return
        if req.deadline_t is not None and time.time() > req.deadline_t:
            _requeue_span(None, "expired")
            self._trace_root(req, "expired")
            with self._lock:
                self._count_locked("expired")
            self._fits_counter("expired")
            fut._set_exception(FitDeadlineExceeded(
                f"request {req.id} deadline passed before requeue "
                f"(after {len(fut.requeues)} migration(s))"))
            self._forget(req)
            return
        if len(fut.requeues) > self.max_requeues:
            _requeue_span(None, "max_requeues")
            self._settle_lost(
                req, f"request {req.id} requeued "
                     f"{len(fut.requeues)} times (max "
                     f"{self.max_requeues}); giving up")
            return
        # lock-ok: unlocked-shared-write single-owner field: a request is requeued by exactly one thread at a time (it was popped from the dead worker's inflight map under _lock before this path runs)
        req.rejected_by = {req.worker} if req.worker else set()
        # The hop seconds land on req.hops BEFORE the redispatch: a
        # cached fit on the survivor can answer (and _on_result
        # merge the hop vector into FitResult) before this thread
        # resumes.  The span itself is written after, so its
        # to_worker/outcome reflect what _dispatch actually did —
        # the request may have settled as lost or been cancelled in
        # there, and 'redispatched' must not be a lie in the trace.
        hop_end = time.time()
        if self._tracer is not None and req.trace is not None:
            req.hops["requeue"] = round(
                req.hops.get("requeue", 0.0)
                + max(0.0, hop_end - hop_t0), 6)
        self._dispatch(req, exclude=req.rejected_by)
        if fut.done():
            _requeue_span(None, "not_redispatched", t_end=hop_end,
                          count_hop=False)
        else:
            _requeue_span(req.worker, "redispatched",
                          t_end=hop_end, count_hop=False)

    def _settle_lost(self, req: FleetRequest, message: str):
        self._trace_root(req, "lost")
        with self._lock:
            self._count_locked("lost")
        self._fits_counter("lost")
        req.future._set_exception(WorkerLostError(
            message, req.id, req.future.requeues))
        self._forget(req)

    # ------------------------------------------------------------------ #
    # health monitor
    # ------------------------------------------------------------------ #
    def _monitor_loop(self):
        interval = max(0.02, min(self.heartbeat_timeout_s / 4,
                                 0.25))
        while not self._monitor_stop.wait(interval):
            # Per-iteration backstop: the monitor's loss paths
            # (_worker_lost -> _requeue) settle futures, so one bad
            # tick must not kill the thread and leave every later
            # loss undetected — log and keep monitoring.
            try:
                self._monitor_tick()
            except Exception as err:
                self._log_event("fleet_monitor_error",
                                error=repr(err))

    def _monitor_tick(self):
        now = time.time()
        for w in list(self.workers):
            if w.state == "up" and w.chan is not None:
                # RPC RTT probe: the pong echoes t0 back (see
                # _on_pong).  Send failures are the reader/
                # monitor loss paths' problem, not the probe's.
                try:
                    w.send({"op": "ping", "t0": now})
                except OSError:
                    pass
            if w.state == "up":
                if w.proc is not None \
                        and w.proc.poll() is not None:
                    self._worker_lost(
                        w, "process exited "
                           f"rc={w.proc.returncode}")
                elif now - w.last_heartbeat \
                        > self.heartbeat_timeout_s:
                    self._worker_lost(
                        w, "heartbeat lost "
                           f"({now - w.last_heartbeat:.2f}s)")
            elif w.state == "draining" and w.proc is not None \
                    and w.proc.poll() is not None:
                self._worker_drained(w)
        self._refresh_gauges()

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def close(self, drain: bool = True,
              timeout: Optional[float] = 60.0):
        """Shut the fleet down.  ``drain=True`` asks every live
        worker to serve what it holds (the SIGTERM path, over the
        protocol), waits for in-flight requests to settle, then
        reaps the processes; ``drain=False`` reaps immediately.
        Futures still unresolved afterwards get
        :class:`~multigrad_tpu_torch.serve.queue.FitCancelled`."""
        if self._closing:
            return
        self._closing = True
        self._monitor_stop.set()
        if drain:
            for w in self.workers:
                if w.routable():
                    try:
                        w.send({"op": "drain"})
                    except OSError:
                        pass
            deadline = None if timeout is None \
                else time.time() + timeout
            while deadline is None or time.time() < deadline:
                with self._lock:
                    if not any(w.inflight for w in self.workers):
                        break
                time.sleep(0.02)
        for w in self.workers:
            if w.chan is not None:
                w.chan.close()
            if w.proc is not None:
                w.proc.terminate()
        for w in self.workers:
            if w.proc is not None:
                try:
                    w.proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    w.proc.kill()
        # Same lock as every other .state transition: the monitor
        # and reader threads are still draining their final
        # callbacks at this point, and an unlocked write here raced
        # their _worker_lost / _worker_drained state machine.
        with self._lock:
            for w in self.workers:
                w.state = "dead"
        with self._lock:
            leftovers = [r for r in self._requests.values()
                         if not r.future.done()]
        for req in leftovers:
            self._trace_root(req, "cancelled")
            req.future._set_exception(FitCancelled(
                f"request {req.id} cancelled by fleet shutdown"))
        if self._owns_tracer and self._tracer is not None:
            self._tracer.close()
        self.rollup.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(drain=True)
        return False

    # ------------------------------------------------------------------ #
    # observability
    # ------------------------------------------------------------------ #
    @property
    def trace_paths(self) -> list:
        """Every per-process trace JSONL of this fleet (router +
        workers) — the argument list for ``python -m multigrad_tpu_torch
        .telemetry.trace`` / :func:`~multigrad_tpu_torch.telemetry
        .aggregate.merge_traces`."""
        paths = []
        if self._tracer is not None and self._tracer.path:
            paths.append(self._tracer.path)
        paths += [w.trace_path for w in self.workers
                  if getattr(w, "trace_path", None)]
        return paths

    def _trace_hop(self, req: FleetRequest, name: str,
                   t_start: float, t_end: Optional[float] = None,
                   ok: bool = True, **attrs):
        """Record one router-side hop span under the request's trace
        and accumulate its seconds into the request's hop vector
        (delivered on ``FitResult.hops``)."""
        if self._tracer is None or req.trace is None:
            return
        t_end = time.time() if t_end is None else t_end
        self._tracer.record(req.trace.child(), name, t_start, t_end,
                            ok=ok, **attrs)
        req.hops[name] = round(
            req.hops.get(name, 0.0) + max(0.0, t_end - t_start), 6)

    def _trace_root(self, req: FleetRequest, outcome: str,
                    t_end: Optional[float] = None, **attrs):
        """Close the request's trace with its root span (first
        settle wins — e.g. an error then a shutdown sweep must not
        record two roots)."""
        if self._tracer is None or req.trace is None:
            return
        with self._lock:
            if req.root_recorded:
                return
            req.root_recorded = True
        if req.config.job_id is not None:
            attrs.setdefault("job_id", req.config.job_id)
        if req.config.stage is not None:
            attrs.setdefault("stage", req.config.stage)
        self._tracer.record(req.trace, "request", req.submitted_t,
                            t_end, outcome=outcome, request=req.id,
                            requeues=len(req.future.requeues),
                            **attrs)

    def _observe_latency(self, req: FleetRequest, e2e_s: float,
                         hops: Optional[dict]):
        """Feed the fleet latency histograms (p50/p95/p99 in
        ``/status``) with the trace id as the exemplar; the
        :class:`~multigrad_tpu_torch.telemetry.live.LatencyObserver` keeps
        the slowest-fit gauge pointing at its offending trace
        (thread-safe — one reader thread per worker observes)."""
        self._latency.observe(
            e2e_s, hops,
            req.trace.trace_id if req.trace is not None else None)

    def _count_locked(self, key: str):
        self._stats[key] = self._stats.get(key, 0) + 1

    def _log_event(self, event: str, **fields):
        if self.telemetry is not None:
            try:
                self.telemetry.log(event, **fields)
            except Exception:
                pass

    def _inc_counter(self, name: str, help=None, labels=None):
        if self._metrics is not None:
            self._metrics.inc(name, help=help, labels=labels)

    def _fits_counter(self, outcome: str):
        if self._metrics is not None:
            self._metrics.inc("multigrad_fleet_fits_total",
                              help="fleet fit requests, by outcome",
                              labels={"outcome": outcome})

    def _refresh_gauges(self):
        if self._metrics is None:
            return
        alive = sum(w.state == "up" for w in self.workers)
        self._metrics.set("multigrad_fleet_workers_alive",
                          float(alive),
                          help="fleet workers currently routable")
        self._metrics.set(
            "multigrad_fleet_inflight",
            float(sum(len(w.inflight) for w in self.workers)),
            help="requests dispatched and unresolved, fleet-wide")
        for w in self.workers:
            self._metrics.set(
                "multigrad_fleet_worker_up",
                1.0 if w.state == "up" else 0.0,
                help="per-worker liveness",
                labels={"worker": w.id})
            self._metrics.set(
                "multigrad_fleet_worker_queue_depth",
                float(w.queue_depth),
                help="per-worker scheduler queue depth "
                     "(last heartbeat)",
                labels={"worker": w.id})
        rate = self.fits_per_hour()
        if rate is not None:
            self._metrics.set("multigrad_fleet_fits_per_hour", rate,
                              help="aggregate served-fit rate")

    def _refresh_resource_gauges(self, handle: WorkerHandle,
                                 res: dict):
        """Per-worker resource gauges from a heartbeat snapshot —
        the fleet-wide utilization view in the router's registry
        (one labelled series per worker, refreshed at heartbeat
        cadence)."""
        if self._metrics is None:
            return
        labels = {"worker": handle.id}
        for gauge, key, help_ in (
                ("multigrad_fleet_worker_busy_frac", "busy_frac",
                 "per-worker dispatch duty cycle (last heartbeat)"),
                ("multigrad_fleet_worker_rss_bytes", "rss_bytes",
                 "per-worker host RSS (last heartbeat)"),
                ("multigrad_fleet_worker_device_bytes_in_use",
                 "device_bytes_in_use",
                 "per-worker device memory in use (last heartbeat)"),
                ("multigrad_fleet_worker_device_peak_bytes",
                 "device_peak_bytes",
                 "per-worker device memory high-water "
                 "(last heartbeat)"),
                ("multigrad_fleet_worker_compile_seconds_total",
                 "compile_s_total",
                 "per-worker cumulative program-build seconds "
                 "(last heartbeat)")):
            v = res.get(key)
            if v is not None:
                self._metrics.set(gauge, float(v), help=help_,
                                  labels=labels)

    def fits_per_hour(self) -> Optional[float]:
        """Aggregate fleet throughput: completions per hour from the
        first submission to the latest completion."""
        with self._lock:
            n = self._stats.get("completed", 0)
            if (not n or self._first_submit_t is None
                    or self._last_completed_t is None):
                return None
            span = self._last_completed_t - self._first_submit_t
        if span <= 0:
            return None
        return n / span * 3600.0

    @property
    def stats(self) -> dict:
        """Aggregate counters (submitted / completed / failed /
        requeued / rejected / shed / lost / expired / worker_deaths /
        drained) plus a per-worker health snapshot."""
        now = time.time()
        with self._lock:
            out = dict(self._stats)
            out["workers"] = {
                w.id: {"state": w.state,
                       "inflight": len(w.inflight),
                       "queue_depth": w.queue_depth,
                       "heartbeat_age_s": round(
                           now - w.last_heartbeat, 3),
                       "rpc_rtt_s": (round(w.rpc_rtt_s, 6)
                                     if w.rpc_rtt_s is not None
                                     else None),
                       "live_port": w.live_port,
                       "resources": (dict(w.resources)
                                     if w.resources is not None
                                     else None)}
                for w in self.workers}
        out["workers_alive"] = sum(
            1 for w in self.workers if w.state == "up")
        # Fleet-wide utilization: mean duty cycle over live monitored
        # workers and summed memory — the router-side aggregate the
        # autoscaler reads next to per-worker detail.
        fracs = [w.resources.get("busy_frac") for w in self.workers
                 if w.state == "up" and w.resources is not None
                 and w.resources.get("busy_frac") is not None]
        out["fleet_busy_frac"] = (
            round(sum(fracs) / len(fracs), 4) if fracs else None)
        rss = [w.resources.get("rss_bytes") for w in self.workers
               if w.state == "up" and w.resources is not None
               and w.resources.get("rss_bytes") is not None]
        out["fleet_rss_bytes"] = int(sum(rss)) if rss else None
        out["fits_per_hour"] = self.fits_per_hour()
        if self.qos_enabled or self.slo is not None:
            by_class, by_tenant = self.shed_counts()
            out["qos_shed"] = {"by_class": by_class,
                               "by_tenant": by_tenant}
        out["history"] = self.history()
        return out

    def history(self, window_s: float = 600.0) -> dict:
        """Windowed fleet history from the merged heartbeat rollups:
        trailing fit/shed counts and rate, device-busy seconds, and
        the queue-wait mean/max/trend over ``window_s``.  Values are
        ``None`` until heartbeat deltas have landed — a legacy
        (pre-rollup) fleet reports an empty history, never zeros."""
        from ..telemetry.rollup import (DEVICE_BUSY_S, FITS,
                                        QUEUE_WAIT_S, SHEDS)
        r = self.rollup

        def rnd(v, k=6):
            return None if v is None else round(v, k)

        return {
            "window_s": float(window_s),
            "fits": (int(v) if (v := r.delta(
                "fleet." + FITS, window_s)) is not None else None),
            "fits_per_s": rnd(r.rate("fleet." + FITS, window_s)),
            "sheds": (int(v) if (v := r.delta(
                "fleet." + SHEDS, window_s)) is not None else None),
            "device_busy_s": rnd(
                r.delta("fleet." + DEVICE_BUSY_S, window_s), 3),
            "queue_wait_mean_s": rnd(
                r.mean_over("fleet." + QUEUE_WAIT_S, window_s)),
            "queue_wait_max_s": rnd(
                r.max_over("fleet." + QUEUE_WAIT_S, window_s)),
            "queue_wait_trend": rnd(
                r.trend("fleet." + QUEUE_WAIT_S, window_s), 8),
        }
