"""Bucketed fit scheduler: pad-and-pack dispatch over the batched scan
(port of :mod:`multigrad_tpu.serve.scheduler`).

The dispatcher half of the fit-fleet serving layer.  A daemon thread
drains the :class:`~multigrad_tpu_torch.serve.queue.FitQueue`, packs
same-config requests into a few **quantized bucket sizes** (default
``K ∈ {1, 4, 16, 64}``), pads the guess matrix up to the bucket, and
drives the whole bucket through ONE batched ``(K, ndim)`` Adam fit on
the model's device: the same :func:`~multigrad_tpu_torch.optim.adam
.run_adam_scan` + ``batched_loss_and_grad`` path
:func:`~multigrad_tpu_torch.inference.run_multistart_adam` already uses,
through the same cached wrapper, so ensembles and served fits share it.

Why quantize?  In the JAX package the compiled program's identity
includes the batch shape, so admitting arbitrary K would retrace per
distinct request count.  The port has no traced program; what buckets
bound here is the number of distinct ``(config, ndim, K)`` dispatch
shapes (the caching allocator's block sizes, the warmup's work, the
``compiled`` flag on ``dispatch`` spans): **programs built are bounded
by the bucket count per fit config, not by the request count**
(``tests/test_torch_serve.py`` counts them).  Padding rows replicate
the first request's guess — they advance as a redundant fit and are
sliced away in finalize (Adam's elementwise update makes batch rows
exact independent fits, so padding never perturbs real rows).

Fault isolation (the serving layer's robustness contract, helpers in
:mod:`.robustness`):

* a NaN/Inf in one tenant's fit is contained to its own row — its
  batch-mates' results are bitwise identical to a clean batch;
* the poisoned request alone gets a flight-recorder postmortem
  bundle and (after one retry in a fresh bucket, if enabled) an
  errored future carrying the bundle path;
* deadlines are enforced at dispatch time; cancelled requests are
  purged before they cost a bucket row;
* :meth:`FitScheduler.close` drains gracefully by default — pending
  requests are served before the dispatcher exits.

Observability: scheduler gauges (queue depth, bucket occupancy,
fits/hour, per-outcome counters) land in the
:class:`~multigrad_tpu_torch.telemetry.LiveServer` registry via ``live=``,
and every served request closes with its own ``fit_summary``
telemetry record via ``telemetry=``.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Optional

import numpy as np
import torch

from .compile_cache import DEFAULT_BUCKETS, warmup_buckets
from .qos import QosPolicy, make_tag, request_tag
from .queue import (FitCancelled, FitConfig, FitFailed, FitFuture,
                    FitOOMError, FitQueue, FitRequest, FitResult)
from .robustness import nonfinite_rows, request_postmortem, \
    split_expired

__all__ = ["FitScheduler", "DEFAULT_BUCKETS"]

#: Message fragments that identify a device out-of-memory failure
#: across backends (the JAX package's XLA and allocator messages;
#: ``torch.cuda.OutOfMemoryError``'s "CUDA out of memory" contains
#: "out of memory").  Deliberately no bare "oom" token:
#: as a substring it matches innocent words (room/bloom/doom) and
#: would reclassify unrelated failures.
_OOM_MARKERS = ("resource_exhausted", "out of memory",
                "hbm_allocator", "allocation failure")


def _is_oom(exc: BaseException) -> bool:
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        text = f"{type(exc).__name__}: {exc}".lower()
        if any(m in text for m in _OOM_MARKERS):
            return True
        exc = exc.__cause__ or exc.__context__
    return False


class FitScheduler:
    """Multi-tenant batched fit scheduler over one model.

    Parameters
    ----------
    model : OnePointModel
        The model every request fits, on its device (the card unless
        it was built on the CPU): every dispatch puts its tensors
        there explicitly, whatever the dispatcher thread's current
        device.  Its comm decides the processes; the batched call
        makes 2 all-reduces whatever K, so the per-request
        communication stays O(|sumstats| + |params|).
    buckets : sequence of int, or "auto"
        Quantized batch sizes (sorted ascending internally).  A
        dispatch group of n requests runs in the smallest bucket
        ≥ n; groups larger than the top bucket split across
        dispatches.  ``"auto"`` (the default) resolves the measured
        fits/hour ladder from the tuning table
        (:func:`multigrad_tpu_torch.tune.tune_buckets` writes it, keyed
        by the model's device: a ladder measured on another device is
        never read); a cold table resolves to :data:`DEFAULT_BUCKETS`.
        Workers sharing the kernel-library directory share the table, so
        a fleet boots tuned.
    max_pending : int
        Queue bound — the backpressure knob (see
        :class:`~multigrad_tpu_torch.serve.queue.FitQueue`).
    batch_window_s : float
        How long the dispatcher holds a non-full bucket open for a
        burst to coalesce.  0 disables coalescing (lowest latency,
        worst packing).
    telemetry : MetricsLogger, optional
        Per-request ``fit_summary`` records and per-dispatch
        ``serve_dispatch`` records join this stream; the scheduler's
        flight recorder is attached as a sink so postmortem bundles
        carry the records around the failure.
    live : LiveServer | LiveSink | LiveMetrics, optional
        Scheduler gauges (``multigrad_serve_*``) land in this
        registry — pass the same :class:`~multigrad_tpu_torch.telemetry
        .LiveServer` the fits' monitors use and ``/metrics`` serves
        the fleet view.  Also joined to ``telemetry`` as a sink when
        both are given.
    flight_dir : str, optional
        Where per-request postmortem bundles land (default: a fresh
        temp dir on first dump).
    retry_poisoned : bool
        Re-enqueue a poisoned request once, at the head of the queue
        (a fresh bucket).  A second poisoning fails the future.
    on_poison_retry : callable, optional
        Called with the :class:`~multigrad_tpu_torch.serve.queue
        .FitRequest` the moment its one poison retry is consumed —
        the fleet worker uses this to tell its router, so a request
        re-enqueued after a worker death cannot double-fire the
        retry.  Exceptions from the callback are swallowed (a
        notification must never fail the retry it reports).
    donate_carry : bool, optional
        Forwarded to the batched fit, where it has no effect (a host
        loop has no carry to donate).
    tuning_table : TuningTable | str, optional
        Tuning table ``buckets="auto"`` resolves from (default: the table
        beside the kernel-library directory; see
        :func:`multigrad_tpu_torch.tune.default_table_path`).
    k_sharded : {"auto", True, False}
        Run bucket dispatches on the sharded-K path (the K axis over a
        replica axis of the mesh).  The port has no replica axis yet
        (ROADMAP.md Queue 1 item 6): ``"auto"`` and ``False`` run every
        bucket replicated, and ``True`` raises.
    k_budget_bytes : int, optional
        Per-device memory budget for bucket dispatch state.  When
        set, the bucket ladder is capped per (config, ndim) by the
        ensemble memory model
        (:func:`~multigrad_tpu_torch.inference.max_k_for_budget`) instead
        of a hardcoded max: a dispatch group larger than the cap
        splits across dispatches rather than risking a device OOM.
        An OOM that still happens fails its group with the typed
        :class:`~multigrad_tpu_torch.serve.queue.FitOOMError` carrying the
        memory-model estimate and the sharded-K remedy.
    tracer : Tracer, optional
        Distributed request tracing (:class:`~multigrad_tpu_torch
        .telemetry.tracing.Tracer`): every dispatched request's hops
        — ``queue_wait``, ``bucket_coalesce``, ``dispatch``
        (``compiled``: the first dispatch of its (config, ndim,
        bucket)), ``adam_segments``,
        ``finalize``, ``result_return`` — are recorded as
        ``trace_span`` records under the request's trace context.
        Requests submitted without a context (direct single-process
        serving) get one minted here, and the scheduler also records
        their root ``request`` span at settle; requests arriving
        WITH a context (a fleet worker relaying router traffic)
        parent their hops into it, and the root stays the router's.
        Hop latencies additionally feed ``multigrad_serve_hop_
        seconds`` / ``multigrad_serve_fit_latency_seconds``
        histograms in ``live=`` with the trace id as the exemplar.
    qos : QosPolicy | bool, optional
        Multi-tenant QoS (:mod:`multigrad_tpu_torch.serve.qos`): replaces
        the FIFO dequeue with per-tenant deficit-round-robin +
        EDF-within-config scheduling, per-tenant quotas, and
        class-aware shedding.  ``True`` builds a default
        :class:`~multigrad_tpu_torch.serve.qos.QosPolicy`; ``None`` /
        ``False`` (the default) keeps legacy FIFO behavior
        bit-for-bit.  Tag requests via :meth:`submit`'s ``qos`` /
        ``tenant`` / ``priority_class`` / ``slo_deadline_s``.
    slo : SloMonitor | iterable of (Slo | str), optional
        Declared latency objectives (:mod:`multigrad_tpu_torch.serve
        .slo`): per-class latency histograms and SLO verdict gauges
        (``multigrad_qos_*``) export into ``live=``; with QoS on
        and no SLOs declared, a bare monitor still observes
        per-class latency for ``/status``.
    monitor_resources : bool
        Run a per-process :class:`~multigrad_tpu_torch.telemetry
        .ResourceMonitor` for the scheduler's lifetime (default on):
        host RSS / device memory / kernel-build accounting sampled on a
        daemon thread, every bucket dispatch bracketed for the
        busy/idle duty cycle, ``multigrad_resource_*`` gauges in
        ``live=``, and a ``measured_vs_modeled`` memory-truth record
        per dispatch comparing the measured device peak against the
        ensemble memory model.
    history : bool
        Keep a windowed history plane (default on): a
        :class:`~multigrad_tpu_torch.telemetry.RollupStore` fed from the
        settle/shed paths (fits, sheds, device-busy seconds,
        queue-wait samples, per-(tenant, class) usage), scraped
        against ``live=``'s gauges on a daemon thread, and exporting
        the ``multigrad_rollup_*`` windowed signals
        ``autoscaler_inputs`` v2 reads.  The fleet worker cuts its
        heartbeat ``rollup`` deltas from this store.  ``False``
        turns the plane off entirely (the rollup-overhead bench's
        baseline leg).
    start : bool
        Start the dispatcher thread immediately.  ``start=False``
        lets tests and bulk loaders queue a full burst first.
    """

    def __init__(self, model, buckets="auto",
                 max_pending: int = 1024,
                 batch_window_s: float = 0.05, telemetry=None,
                 live=None, flight_dir: Optional[str] = None,
                 retry_poisoned: bool = True, donate_carry=None,
                 on_poison_retry=None, tuning_table=None,
                 tracer=None, k_sharded="auto",
                 k_budget_bytes: Optional[int] = None,
                 qos=None, slo=None, monitor_resources: bool = True,
                 history: bool = True, start: bool = True):
        self.model = model
        self.tracer = tracer
        # "auto": shard whenever the model was built on a 2-level
        # ensemble mesh — the operator chose that topology for
        # exactly this — and never otherwise (the shared resolution
        # rule of every sharded-K consumer).
        from ..inference.ensemble import resolve_k_shard_topology
        self.k_sharded, self._k_replicas = \
            resolve_k_shard_topology(model, k_sharded)
        self.k_budget_bytes = (int(k_budget_bytes)
                               if k_budget_bytes is not None else None)
        self._bucket_caps: dict = {}
        if isinstance(buckets, str):
            if buckets != "auto":
                raise ValueError(
                    f"buckets must be a sequence of ints or 'auto', "
                    f"got {buckets!r}")
            from ..tune.resolve import resolve_buckets
            buckets = resolve_buckets(model, table=tuning_table)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints, got "
                             f"{buckets}")
        self.batch_window_s = float(batch_window_s)
        self.retry_poisoned = bool(retry_poisoned)
        self.on_poison_retry = on_poison_retry
        self.donate_carry = donate_carry
        if qos is True:
            qos = QosPolicy()
        elif qos is False:
            qos = None
        if qos is not None and not isinstance(qos, QosPolicy):
            raise TypeError(
                f"qos must be a QosPolicy or bool, got "
                f"{type(qos).__name__}")
        self.qos = qos
        self.queue = FitQueue(max_pending=max_pending, qos=qos,
                              on_settle=self._queue_settled)
        self.telemetry = telemetry
        # A LiveServer/LiveSink exposes its registry as .metrics; a
        # bare LiveMetrics IS the registry.
        self._metrics = getattr(live, "metrics", live)
        from .slo import SloMonitor
        if isinstance(slo, SloMonitor):
            self.slo = slo
        elif slo:
            self.slo = SloMonitor(self._metrics, slo)
        elif qos is not None:
            # QoS without declared objectives still observes
            # per-class latency — /status needs the histograms.
            self.slo = SloMonitor(self._metrics, ())
        else:
            self.slo = None
        if telemetry is not None and live is not None \
                and hasattr(live, "write"):
            telemetry.add_sink(live)

        from ..telemetry.flight import FlightRecorder
        # Serve recorders never latch fatal on stalls/divergences —
        # one tenant's anomaly must not wedge the fleet.
        self._recorder = FlightRecorder(
            dump_dir=flight_dir, trip_on_stall=False,
            divergence_spike=None)
        if telemetry is not None:
            telemetry.add_sink(self._recorder)

        self._dynamic = model.aux_leaves()
        self._device = model.device
        self._wrappers: dict = {}
        # (config, ndim, bucket) keys already dispatched: the
        # compile-vs-cached flag on `dispatch` trace spans — the first
        # dispatch of a shape grows the caching allocator (and, in a
        # process that ran nothing yet, loads the kernel libraries),
        # every later one reuses it.
        self._dispatched_programs: set = set()
        self._window_open_t: Optional[float] = None
        from ..telemetry.live import LatencyObserver
        from .._lockdep import make_lock
        self._latency = LatencyObserver(self._metrics,
                                        "multigrad_serve",
                                        "served fit")
        self._lock = make_lock("serve.scheduler.FitScheduler._lock")
        self._stats = collections.Counter()
        self._inflight_group: Optional[list] = None
        # (bucket, use_sharded) of the dispatch currently executing —
        # what _fail_group's OOM diagnostic reports, so the typed
        # error names the bucket/layout that actually failed rather
        # than re-deriving one from the pending count.
        self._inflight_dispatch: Optional[tuple] = None
        self._bucket_dispatches: collections.Counter = \
            collections.Counter()
        self._first_submit_t: Optional[float] = None
        self._last_completed_t: Optional[float] = None
        self.resources = None
        if monitor_resources:
            from ..telemetry.resources import ResourceMonitor
            self.resources = ResourceMonitor(
                live=self._metrics, logger=telemetry).start()
        # History plane: windowed rollups fed from the
        # settle/shed paths below; the scrape thread samples the
        # registry's gauges and publishes the multigrad_rollup_*
        # windowed signals autoscaler_inputs v2 reads.
        self.rollup = None
        self._usage_logged_t = 0.0
        if history:
            from ..telemetry.rollup import RollupStore
            self.rollup = RollupStore()
            if self._metrics is not None:
                self.rollup.attach_live(self._metrics)
        self._stop = threading.Event()
        self._abort = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def start(self) -> "FitScheduler":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._abort.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name="mgt-fit-scheduler")
            self._thread.start()
        return self

    def close(self, drain: bool = True,
              timeout: Optional[float] = None):
        """Shut the scheduler down.

        ``drain=True`` (default, the graceful path): stop accepting
        new requests, serve everything already queued, then exit.
        ``drain=False``: stop immediately; still-pending futures are
        resolved with :class:`~multigrad_tpu_torch.serve.queue
        .FitCancelled`.
        """
        self.queue.close()
        self._stop.set()
        if not drain:
            self._abort.set()
        if self._thread is not None:
            self._thread.join(timeout)
        for req in self.queue.drain_pending():
            # Root-before-resolve, like every other settle path: the
            # woken caller must see a rooted trace and a bumped
            # counter, not catch up to them later.
            self._trace_root(req, "cancelled")
            self._count("cancelled")
            req.future._set_exception(FitCancelled(
                f"request {req.id} cancelled by scheduler shutdown"))
        if self.resources is not None:
            self.resources.close()
        if self.rollup is not None:
            # Final per-tenant accounting flush, then stop the
            # scrape thread.
            self._emit_usage()
            self.rollup.close()

    def __enter__(self):
        # Deliberately NOT start(): a scheduler built with
        # start=False stays paused inside `with` so callers can queue
        # a deterministic burst before dispatch begins (the default
        # construction already started the thread).
        return self

    def __exit__(self, *exc):
        self.close(drain=True)
        return False

    # ------------------------------------------------------------------ #
    # submit side
    # ------------------------------------------------------------------ #
    def submit(self, guess, nsteps: int = 100,
               learning_rate: float = 0.01, param_bounds=None,
               randkey=None, const_randkey: bool = False,
               config: Optional[FitConfig] = None,
               deadline_s: Optional[float] = None,
               block: bool = False,
               timeout: Optional[float] = None,
               retried: bool = False, trace=None,
               submitted_t: Optional[float] = None,
               qos=None, tenant: Optional[str] = None,
               priority_class: Optional[str] = None,
               slo_deadline_s: Optional[float] = None) -> FitFuture:
        """Queue one fit; returns its :class:`~multigrad_tpu_torch.serve
        .queue.FitFuture`.

        Either pass the fit schedule piecewise (``nsteps`` /
        ``learning_rate`` / ``param_bounds`` / ``randkey``) or a
        prebuilt :class:`~multigrad_tpu_torch.serve.queue.FitConfig` —
        requests sharing a config are batchable into one bucket.
        ``deadline_s`` is a relative deadline: a request still queued
        when it expires is resolved with
        :class:`~multigrad_tpu_torch.serve.queue.FitDeadlineExceeded`
        instead of occupying a bucket row.  ``block``/``timeout``
        select the backpressure behavior at a full queue (see
        :meth:`~multigrad_tpu_torch.serve.queue.FitQueue.submit`).
        ``retried=True`` marks the request as having already consumed
        its one poison retry elsewhere — the fleet router sets it
        when re-enqueuing a request off a dead worker, so the retry
        cannot double-fire across worker generations.

        ``trace`` propagates a :class:`~multigrad_tpu_torch.telemetry
        .tracing.TraceContext` minted upstream (the fleet worker
        passes the router's); with a ``tracer`` configured and no
        context given, one is minted HERE — this submit is then the
        trace's origin and the scheduler records its root span.
        ``submitted_t`` backdates the request's arrival to its
        origin wall clock (the fleet worker passes the router-side
        submit time) so ``queue_wait`` — and ``wait_s`` on the
        result — measure the tenant's real wait, transit included.

        ``qos`` (a prebuilt :class:`~multigrad_tpu_torch.serve.qos
        .QosTag`) or the piecewise ``tenant`` / ``priority_class``
        / ``slo_deadline_s`` tag the request for QoS scheduling —
        on the request, never in the config, so same-config fits
        from different tenants still co-batch.  A tag's
        ``slo_deadline_s`` becomes the request's deadline when
        ``deadline_s`` is not given.
        """
        tag = make_tag(qos, tenant, priority_class, slo_deadline_s)
        if (deadline_s is None and tag is not None
                and tag.slo_deadline_s is not None):
            deadline_s = tag.slo_deadline_s
        if config is None:
            config = FitConfig(
                nsteps=nsteps, learning_rate=learning_rate,
                param_bounds=param_bounds, randkey=randkey,
                const_randkey=const_randkey)
        guess = np.asarray(guess, dtype=float)
        self._validate(guess, config)
        rid = self.queue.next_id()
        owns_trace = False
        if trace is None and self.tracer is not None:
            trace = self.tracer.new_trace()
            owns_trace = True
        future = FitFuture(rid)
        if trace is not None:
            future.trace_id = trace.trace_id
        request = FitRequest(
            id=rid, guess=guess, config=config,
            future=future,
            deadline=(time.time() + float(deadline_s)
                      if deadline_s is not None else None),
            retried=bool(retried), trace=trace,
            owns_trace=owns_trace, qos=tag)
        if submitted_t is not None:
            request.submitted_t = float(submitted_t)
        self.queue.submit(request, block=block, timeout=timeout)
        with self._lock:
            self._stats["submitted"] += 1
            if self._first_submit_t is None:
                self._first_submit_t = request.submitted_t
        self._gauge("multigrad_serve_queue_depth", len(self.queue),
                    help="fit requests waiting for a bucket")
        return request.future

    def _queue_settled(self, req, kind: str):
        """Bookkeeping for a request the QUEUE settles itself —
        take/submit-time expiry purge (``kind="expired"``) and
        class-aware shed (``kind="shed"``).  Called by the queue
        outside its lock, before the future resolves: the same
        root-before-resolve accounting as the dispatch-time
        paths."""
        self._trace_root(req, kind)
        self._count(kind)
        self._fits_counter(kind)
        if kind == "shed":
            tag = request_tag(req)
            if self.slo is not None:
                self.slo.record_shed(tag.priority_class, tag.tenant)
            if self.rollup is not None:
                from ..telemetry.rollup import SHEDS
                self.rollup.inc(SHEDS)
                self.rollup.note_usage(tag.tenant,
                                       tag.priority_class, sheds=1)

    def _note_history(self, req, queue_wait_s: float,
                      busy_share_s: float, now: float):
        """Feed the history plane at settle: fleet-level fit /
        queue-wait / device-busy series plus the (tenant, class)
        usage ledger, and the rate-limited ``tenant_usage`` /
        ``slo_budget`` record emission the report/dashboard
        surfaces read."""
        from ..telemetry.rollup import (DEVICE_BUSY_S, FITS,
                                        QUEUE_WAIT_S)
        self.rollup.inc(FITS)
        self.rollup.observe(QUEUE_WAIT_S, queue_wait_s)
        self.rollup.inc(DEVICE_BUSY_S, busy_share_s)
        tag = request_tag(req)
        violations = 0
        slo = self.slo.slos.get(tag.priority_class) \
            if self.slo is not None else None
        if slo is not None and now - req.submitted_t \
                > slo.threshold_s:
            violations = 1
        self.rollup.note_usage(tag.tenant, tag.priority_class,
                               fits=1, busy_s=busy_share_s,
                               violations=violations)
        if self.telemetry is not None \
                and now - self._usage_logged_t >= 2.0:
            self._emit_usage(now=now)

    def _emit_usage(self, now: Optional[float] = None):
        """Log one ``tenant_usage`` record per (tenant, class) pair
        and one ``slo_budget`` record per budgeted class — the
        stream-side view of the history plane (``telemetry.report``
        ``usage:`` section, ``telemetry.top --tenants``, the
        dashboard's budget line)."""
        if self.telemetry is None or self.rollup is None:
            return
        # lock-ok: unlocked-shared-write benign rate-limit stamp: the settle loop is the only periodic writer; close() writes once after the loop stopped, and the worst race outcome is one duplicate usage emission, never corruption
        self._usage_logged_t = time.time() if now is None else now
        for rec in self.rollup.usage_records():
            self.telemetry.log("tenant_usage", **rec)
        if self.slo is not None:
            for cls, ledger in self.slo.budgets.items():
                snap = ledger.snapshot()
                self.telemetry.log(
                    "slo_budget", priority_class=cls,
                    budget=snap["budget"],
                    remaining_frac=round(snap["remaining_frac"], 6),
                    burn_rate=round(snap["burn_rate"], 4),
                    fast_burning=snap["fast_burning"],
                    exhaustion_eta_s=snap["exhaustion_eta_s"],
                    violations=snap["violations"])

    @staticmethod
    def _validate(guess: np.ndarray, config: FitConfig):
        """Admission control: structural validity, checked at submit
        so a bad request fails its caller instead of a whole bucket.
        (Runtime failures — a finite guess whose fit goes NaN — are
        the dispatcher's per-row containment problem, not
        admission's.)"""
        if guess.ndim != 1 or guess.size == 0:
            raise ValueError(
                f"guess must be a 1-D parameter vector, got shape "
                f"{guess.shape}")
        if config.param_bounds is not None:
            from ..optim.transforms import (bounds_to_arrays,
                                            check_strictly_inside)
            # On the host: admission never touches the card.
            low, high = bounds_to_arrays(config.bounds_list(),
                                         guess.shape[0], "cpu")
            check_strictly_inside(torch.as_tensor(guess), low, high,
                                  config.bounds_list())

    def warmup(self, configs, ndim: Optional[int] = None,
               buckets=None) -> list:
        """Build and load the kernel libraries and run one Adam step
        and one finalize of each of this scheduler's buckets for
        ``configs``, discarding the results (see
        :func:`~multigrad_tpu_torch.serve.compile_cache
        .warmup_buckets`); with :func:`~multigrad_tpu_torch.serve
        .compile_cache.enable_compile_cache` the libraries come from,
        or are built into, the shared directory."""
        return warmup_buckets(
            self.model, configs,
            buckets=self.buckets if buckets is None else buckets,
            ndim=ndim, donate_carry=self.donate_carry,
            k_sharded=self.k_sharded)

    # ------------------------------------------------------------------ #
    # dispatch side (scheduler thread)
    # ------------------------------------------------------------------ #
    def _loop(self):
        try:
            self._loop_body()
        except BaseException as e:
            # The dispatcher thread itself is dying — an escape the
            # per-group handler below cannot catch (BaseException, or
            # a failure in take_group/grouping).  A dead dispatcher
            # would strand every pending future forever, so settle
            # ALL of them with the cause chain attached before the
            # thread exits.  Not re-raised: the cause now lives on
            # every failed future and in the postmortem bundle, and
            # an unhandled-thread-exception would only add noise.
            self._dispatcher_backstop(e)

    def _loop_body(self):
        while not self._abort.is_set():
            group = []
            try:
                # Wall-clock anchor of the batch window: the
                # bucket_coalesce trace span measures from here (or
                # from a later request's own arrival) to dispatch.
                self._window_open_t = time.time()
                group, cancelled = self.queue.take_group(
                    self.buckets[-1],
                    window_s=self.batch_window_s,
                    timeout=0.05)
                for _ in cancelled:
                    self._count("cancelled")
                if group:
                    # Tracked for the backstop: a BaseException out
                    # of _dispatch must still fail THIS group.
                    self._inflight_group = group
                    self._dispatch(group)
                self._inflight_group = None
                self._inflight_dispatch = None
            except Exception as e:
                # ANY failure in the loop body — a dispatch dying for
                # a non-row reason (device loss, OOM) or an
                # unexpected grouping error — must fail at most its
                # own group's requests, never the dispatcher thread:
                # a dead dispatcher strands every pending future
                # forever.  Only not-yet-resolved futures count:
                # requests the dispatch already settled (expired,
                # poison-failed) must not be double-counted.
                self._fail_group(group, e, "dispatch_failed")
                self._inflight_group = None
                self._inflight_dispatch = None
            if not group and self._stop.is_set() and self.queue.empty():
                break

    def _fail_group(self, requests, exc: BaseException, reason: str,
                    bundle: Optional[str] = None):
        """Settle a group's unresolved futures with a typed error
        carrying the originating exception (``__cause__``) and the
        postmortem bundle path — the caller sees WHY its fit died,
        not a bare backstop exception.  A device OOM is classified
        into :class:`~multigrad_tpu_torch.serve.queue.FitOOMError` with
        the sharded-K memory-model estimate and remedy in both the
        message and the bundle."""
        pending = [r for r in requests if not r.future.done()]
        if not pending:
            return
        oom = _is_oom(exc)
        est = bucket = None
        oom_msg = f"{reason}: {exc!r}"
        extra = {}
        if oom:
            from ..inference.ensemble import ensemble_memory_model
            req0 = pending[0]
            ndim = int(req0.guess.shape[0])
            nsteps = int(req0.config.nsteps)
            # The estimate and the layout named in the message must
            # describe the dispatch that actually OOMed: a dying
            # dispatch leaves its (bucket, use_sharded) in
            # _inflight_dispatch (a split group may be failing far
            # more pending requests than the failed bucket held, so
            # re-deriving the bucket from the pending count would
            # name one that never ran).  The fallback — no dispatch
            # in flight — mirrors the dispatch rule on the group
            # size.
            if self._inflight_dispatch is not None:
                bucket, sharded = self._inflight_dispatch
            else:
                from ..inference.ensemble import k_shards_bucket
                n = len(pending)
                bucket = next(b for b in self.buckets + (n,)
                              if b >= n)
                sharded = k_shards_bucket(bucket, self.k_sharded,
                                          self._k_replicas)
            n_replicas = self._k_replicas if sharded else 1
            est = ensemble_memory_model(bucket, ndim, nsteps,
                                        n_replicas=n_replicas)
            layout = (f"sharded over {n_replicas} replica slices"
                      if sharded else "replicated")
            if sharded:
                remedy = (
                    "widen the mesh — more replica slices in "
                    "parallel.ensemble_comm(n_replicas=R) shrink "
                    "per-device state K/R — or cap the bucket "
                    "ladder with k_budget_bytes")
            elif self.k_sharded:
                remedy = (
                    f"this bucket is not divisible by the replica "
                    f"count ({self._k_replicas}) so it ran the "
                    "replicated layout — use bucket sizes the "
                    "replica count divides, or cap the ladder "
                    "with k_budget_bytes")
            else:
                remedy = (
                    "cap the bucket ladder with k_budget_bytes "
                    "(sharded K, which spreads a bucket's rows over "
                    "a replica axis, is not ported yet: ROADMAP.md "
                    "Queue 1 item 6)")
            oom_msg = (
                f"bucket dispatch ran out of device memory "
                f"(K={bucket}, nsteps={nsteps}, {layout}: estimated "
                f"per-device fit state ≈ {est / 1e6:.1f} MB); "
                f"{remedy}")
            extra = {"oom": True, "estimated_bytes": est,
                     "bucket": bucket, "k_sharded": sharded,
                     "n_replicas": n_replicas}
        if bundle is None:
            bundle = self._recorder.dump(
                reason, error=repr(exc),
                requests=[r.id for r in pending],
                resources=self._resource_ring(), **extra)
        for req in pending:
            if oom:
                err = FitOOMError(oom_msg, req.id,
                                  bundle_path=bundle,
                                  estimated_bytes=est, bucket=bucket)
            else:
                err = FitFailed(oom_msg, req.id, bundle_path=bundle)
            err.__cause__ = exc
            # Root-before-resolve, like every other settle path: the
            # woken caller's trace triage must find a rooted trace
            # and already-bumped counters.
            self._trace_root(req, "failed", bundle=bundle)
            self._count("failed")
            self._fits_counter("failed")
            req.future._set_exception(err)

    def _dispatcher_backstop(self, exc: BaseException):
        """The dispatcher thread is exiting abnormally: refuse new
        work and fail every claimed-but-unresolved and still-queued
        request with the cause chain + one shared postmortem bundle.
        No future may hang on a dead dispatcher."""
        bundle = self._recorder.dump("dispatcher_died",
                                     error=repr(exc),
                                     resources=self._resource_ring())
        self.queue.close()
        stranded = list(self._inflight_group or []) \
            + self.queue.drain_pending()
        self._inflight_group = None
        self._fail_group(stranded, exc, "scheduler dispatcher died",
                         bundle=bundle)

    def _wrapper(self, with_key: bool, k_sharded: bool = False):
        key = (with_key, "k_sharded") if k_sharded else with_key
        if key not in self._wrappers:
            from ..inference.ensemble import batched_fit_wrapper
            self._wrappers[key] = batched_fit_wrapper(
                self.model, with_key, k_sharded=k_sharded)
        return self._wrappers[key]

    def _bucket_caps_for(self, config, ndim: int):
        """``(replicated_cap, sharded_cap)`` — the largest K the
        memory budget admits under EACH layout for this (config,
        ndim); the sharded-K memory model replacing any hardcoded
        max.  None without a budget."""
        if self.k_budget_bytes is None:
            return None
        key = (int(config.nsteps), int(ndim))
        if key not in self._bucket_caps:
            from ..inference.ensemble import max_k_for_budget
            cap_rep = max_k_for_budget(self.k_budget_bytes, ndim,
                                       config.nsteps)
            cap_sh = max_k_for_budget(
                self.k_budget_bytes, ndim, config.nsteps,
                n_replicas=self._k_replicas) if self.k_sharded \
                else cap_rep
            self._bucket_caps[key] = (cap_rep, cap_sh)
        return self._bucket_caps[key]

    def _allowed_buckets(self, config, ndim: int) -> tuple:
        caps = self._bucket_caps_for(config, ndim)
        if caps is None:
            return self.buckets
        cap_rep, cap_sh = caps
        # Each rung is judged under the layout it would actually
        # dispatch with: indivisible rungs run REPLICATED (full K
        # rows per device), so the sharded cap must not admit them.
        from ..inference.ensemble import k_shards_bucket
        allowed = tuple(
            b for b in self.buckets
            if b <= (cap_sh if k_shards_bucket(b, self.k_sharded,
                                               self._k_replicas)
                     else cap_rep))
        # The smallest rung always stays servable: a budget too tight
        # even for it degrades to singleton dispatches, never to a
        # scheduler that can serve nothing.
        return allowed or self.buckets[:1]

    def _dispatch(self, requests):
        now = time.time()
        # Roots for about-to-expire requests land BEFORE
        # split_expired resolves their futures (it raises
        # FitDeadlineExceeded inside itself) — root-before-resolve,
        # like every other settle path.  Same `now`, same verdicts.
        for req in requests:
            if req.expired(now):
                self._trace_root(req, "expired", now)
        live, expired = split_expired(requests, now)
        for req in expired:
            self._count("expired")
            self._fits_counter("expired")
        live = [r for r in live if r.future._set_running()]
        if not live:
            return
        config = live[0].config
        ndim = int(live[0].guess.shape[0])
        allowed = self._allowed_buckets(config, ndim)
        coalesce_open_t = self._window_open_t or now
        # A group larger than the memory-capped top bucket splits
        # across dispatches instead of risking a device OOM.
        step = allowed[-1]
        for i in range(0, len(live), step):
            self._dispatch_group(live[i:i + step], config, ndim,
                                 allowed, coalesce_open_t)

    def _dispatch_group(self, live, config, ndim: int, allowed,
                        coalesce_open_t):
        from ..optim import adam as _adam
        from ..optim.adam import init_randkey

        now = time.time()
        n = len(live)
        bucket = next(b for b in allowed + (n,) if b >= n)
        # Sharded-K dispatch: buckets divisible by the replica count
        # run the K-partitioned program (K/R rows of params,
        # trajectory and both Adam moment sets per device); the K=1
        # singleton rung — and any other indivisible rung — keeps
        # the replicated program (the shared k_shards_bucket rule).
        from ..inference.ensemble import k_shards_bucket
        use_sharded = k_shards_bucket(bucket, self.k_sharded,
                                      self._k_replicas)
        self._inflight_dispatch = (bucket, use_sharded)
        # compile-vs-cached for the dispatch trace span: the first
        # dispatch of this (config, ndim, bucket) grows the allocator
        # to its size; later ones reuse it.
        program_key = (config, ndim, bucket, use_sharded)
        compiled = program_key not in self._dispatched_programs
        self._dispatched_programs.add(program_key)
        t_claim = now
        # Pad-and-pack: rows n..K replicate request 0's guess.  The
        # rows advance as redundant independent fits (elementwise
        # Adam) and finalize slices them away — padding is masking by
        # construction, no in-graph select needed.
        inits = np.empty((bucket, ndim), dtype=float)
        for i, req in enumerate(live):
            inits[i] = req.guess
        inits[n:] = inits[0]

        if self.resources is not None:
            # Busy-window bracket: everything between enter and exit
            # is device work, the numerator of the duty-cycle
            # busy_frac the autoscaler contract publishes.
            self.resources.dispatch_enter()
        try:
            t0 = time.perf_counter()
            # The dispatcher is its own thread: grad mode and the
            # current device are per thread, so neither the caller's
            # no_grad() nor its set_device() reaches here.  The batch
            # goes to the model's device explicitly, and the fit runs
            # the same under either grad mode.
            with torch.no_grad():
                inits = torch.as_tensor(inits, dtype=torch.float32,
                                        device=self._device)
                traj = _adam.run_adam_scan(
                    self._wrapper(config.with_key, use_sharded), inits,
                    nsteps=config.nsteps,
                    param_bounds=config.bounds_list(),
                    learning_rate=config.learning_rate,
                    randkey=config.randkey,
                    const_randkey=config.const_randkey, progress=False,
                    fn_args=(self._dynamic,),
                    donate_carry=self.donate_carry)
                finals = traj[-1]
                if finals.is_cuda:
                    # Fence so the adam_segments trace span measures
                    # the fit itself, not the launches returning
                    # early: an event on this thread's stream, waited
                    # for (never a device-wide synchronize).
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(finals.device))
                    done.synchronize()
                t_scan_wall = time.time()
                # Finalize: one batched evaluation ranks/validates
                # every row (the ensemble runner's convention — final
                # loss is not in the fit's return).
                key = init_randkey(config.randkey) if config.with_key \
                    else 0
                losses, _ = self.model.batched_loss_and_grad_fn(
                    config.with_key, k_sharded=use_sharded)(
                    finals, self._dynamic, key)
                # One read back of the whole bucket: trajectory (its
                # last row the finals) and losses in one copy.
                flat = torch.cat([traj.reshape(-1),
                                  losses.reshape(-1).to(traj.dtype)]
                                 ).cpu().numpy()
            fit_s = time.perf_counter() - t0
        finally:
            if self.resources is not None:
                self.resources.dispatch_exit()

        traj_np = flat[:traj.numel()].reshape(tuple(traj.shape))
        losses_np = flat[traj.numel():]
        finals_np = traj_np[-1]
        poisoned = nonfinite_rows(finals_np, losses_np)
        done_t = time.time()
        t_fit_wall = done_t
        # Dispatch-level counters land BEFORE any future resolves: a
        # caller that wakes on the last result and reads .stats must
        # see the dispatch that produced it (bench_serve snapshots
        # exactly that way).
        self._count("dispatches")
        with self._lock:
            self._bucket_dispatches[bucket] += 1
            self._stats["rows_total"] += bucket
            self._stats["rows_padded"] += bucket - n
        for i, req in enumerate(live):
            self._trace_dispatch_hops(
                req, coalesce_open_t, t_claim, t_scan_wall,
                t_fit_wall, bucket, n, compiled)
            if poisoned[i]:
                self._resolve_poisoned(req, i, bucket, finals_np[i],
                                       losses_np[i])
                continue
            hops = {
                "queue_wait": round(
                    max(0.0, t_claim - req.submitted_t), 6),
                "bucket_coalesce": round(max(0.0, t_claim - max(
                    coalesce_open_t, req.submitted_t)), 6),
                "dispatch": round(t_fit_wall - t_claim, 6),
                "adam_segments": round(t_scan_wall - t_claim, 6),
                "finalize": round(t_fit_wall - t_scan_wall, 6),
            }
            # .copy(): a row slice is a VIEW pinning the whole
            # (nsteps+1, K, ndim) bucket trajectory — one retained
            # result must not hold K rows of memory in a
            # long-running service.
            result = FitResult(
                request_id=req.id, params=finals_np[i].copy(),
                loss=float(losses_np[i]),
                traj=traj_np[:, i, :].copy(),
                steps=config.nsteps, bucket=bucket,
                wait_s=round(now - req.submitted_t, 6),
                fit_s=round(fit_s, 6), retried=req.retried,
                trace_id=(req.trace.trace_id if req.trace is not None
                          else None),
                hops=hops, job_id=config.job_id, stage=config.stage)
            # Counters, trace spans, and latency observations all
            # land BEFORE the future resolves: a caller that wakes
            # on result() and immediately reads .stats, /status, or
            # the trace files must see a fully-accounted request.
            t_set = time.time()
            if self.tracer is not None and req.trace is not None:
                self.tracer.record(req.trace.child(),
                                   "result_return", t_fit_wall,
                                   t_set)
            self._trace_root(req, "ok", t_set)
            self._latency.observe(t_set - req.submitted_t, hops,
                                  result.trace_id)
            if self.slo is not None:
                tag = request_tag(req)
                self.slo.observe(tag.priority_class, tag.tenant,
                                 t_set - req.submitted_t,
                                 trace_id=result.trace_id)
            if self.rollup is not None:
                self._note_history(req, hops["queue_wait"],
                                   fit_s / n, t_set)
            self._fits_counter("ok")
            with self._lock:
                self._stats["completed"] += 1
                self._last_completed_t = done_t
            req.future._set_result(result)
            if self.telemetry is not None:
                self.telemetry.log(
                    "fit_summary", request=req.id,
                    steps=config.nsteps,
                    final_loss=float(losses_np[i]), bucket=bucket,
                    occupancy=round(n / bucket, 4),
                    wait_s=result.wait_s, fit_s=result.fit_s,
                    retried=req.retried, serve=True,
                    trace_id=result.trace_id, hops=hops,
                    job_id=config.job_id, stage=config.stage,
                    **({"tenant": req.qos.tenant,
                        "priority_class": req.qos.priority_class}
                       if req.qos is not None else {}))

        if self.telemetry is not None:
            self.telemetry.log(
                "serve_dispatch", bucket=bucket, n_requests=n,
                occupancy=round(n / bucket, 4),
                fit_s=round(fit_s, 6),
                poisoned=int(np.sum(poisoned[:n])))
        self._memory_truth(config, ndim, bucket, use_sharded)
        self._refresh_gauges(bucket, n)

    def _resource_ring(self):
        """The monitor's sample ring for postmortem bundles, with
        one fresh sample so the bundle carries "now" (``None`` when
        monitoring is off — the key stays a null in the bundle,
        distinguishing "unmonitored" from "no samples yet")."""
        if self.resources is None:
            return None
        self.resources.sample()          # never raises
        return self.resources.ring()

    def _memory_truth(self, config, ndim: int, bucket: int,
                      use_sharded: bool):
        """Per-dispatch memory-truth record: measured device peak
        (``torch.cuda.max_memory_allocated`` of the model's card,
        ``None`` on the CPU — the regress gate treats nulls as
        warn-only) cross-checked against the ensemble memory model
        for the layout that just ran.  The model counts the Adam
        carry, not each row's autograd graph, so on the card the
        ratio reads far above 1.  Never raises — a probe failure
        costs the record, not the dispatch."""
        if self.telemetry is None and self._metrics is None:
            return
        try:
            from ..inference.ensemble import ensemble_memory_model
            from ..telemetry.resources import (device_memory,
                                               measured_vs_modeled,
                                               read_rss_bytes)
            n_replicas = self._k_replicas if use_sharded else 1
            modeled = ensemble_memory_model(
                bucket, ndim, int(config.nsteps),
                n_replicas=n_replicas)
            mvm = measured_vs_modeled(
                device_memory(self._device)["peak_bytes"], modeled)
            if self.telemetry is not None:
                self.telemetry.log(
                    "measured_vs_modeled", bucket=bucket, ndim=ndim,
                    nsteps=int(config.nsteps),
                    sharded=bool(use_sharded),
                    n_replicas=n_replicas,
                    rss_bytes=read_rss_bytes(), **mvm)
            if self._metrics is not None \
                    and mvm["accuracy_frac"] is not None:
                self._metrics.set(
                    "multigrad_resource_memory_model_accuracy_frac",
                    mvm["accuracy_frac"],
                    help="1 - |measured peak - modeled| / modeled "
                         "for the last bucket dispatch")
        except Exception:
            pass

    def _resolve_poisoned(self, req, row, bucket, params, loss):
        bundle = request_postmortem(self._recorder, req, row, bucket,
                                    params, loss,
                                    resources=self._resource_ring())
        if self.telemetry is not None:
            self.telemetry.log(
                "fit_summary", request=req.id,
                steps=req.config.nsteps, final_loss=None,
                bucket=bucket, retried=req.retried,
                postmortem_bundle=bundle, serve=True,
                trace_id=(req.trace.trace_id
                          if req.trace is not None else None))
        if self.retry_poisoned and not req.retried:
            req.retried = True
            req.future._requeued()
            if self.on_poison_retry is not None:
                try:
                    self.on_poison_retry(req)
                except Exception:
                    pass
            try:
                # Head of the queue, capacity bypassed (`force`: the
                # request was already admitted once — a full queue
                # must not silently eat the promised retry): the
                # fresh bucket runs before newer work.
                self.queue.submit(req, front=True, force=True)
                self._count("retried")
                return
            except RuntimeError:
                pass        # closed mid-drain: fall through to fail
        # Failure is navigable from either end: the bundle carries
        # the trace id (request_postmortem), the trace's root span
        # carries the bundle path — recorded BEFORE the future
        # resolves, so the woken caller's triage sees a rooted trace.
        self._trace_root(req, "failed", bundle=bundle)
        self._count("failed")
        self._fits_counter("failed")
        req.future._set_exception(FitFailed(
            "fit produced non-finite parameters or loss", req.id,
            bundle_path=bundle))

    # ------------------------------------------------------------------ #
    # observability
    # ------------------------------------------------------------------ #
    def _trace_dispatch_hops(self, req, coalesce_open_t, t_claim,
                             t_scan_wall, t_fit_wall, bucket, n,
                             compiled):
        """One set of hop spans for a request that rode a dispatch:
        queue_wait / bucket_coalesce parent to the request root;
        adam_segments and finalize nest under dispatch.  Recorded
        for poisoned rows too — a poisoned request's waterfall shows
        BOTH its attempts."""
        tracer, ctx = self.tracer, req.trace
        if tracer is None or ctx is None:
            return
        tracer.record(ctx.child(), "queue_wait",
                      min(req.submitted_t, t_claim), t_claim)
        tracer.record(ctx.child(), "bucket_coalesce",
                      min(max(coalesce_open_t, req.submitted_t),
                          t_claim),
                      t_claim, bucket=bucket, n_requests=n)
        dispatch_ctx = ctx.child()
        tracer.record(dispatch_ctx, "dispatch", t_claim, t_fit_wall,
                      bucket=bucket, n_requests=n,
                      compiled=compiled)
        tracer.record(dispatch_ctx.child(), "adam_segments",
                      t_claim, t_scan_wall,
                      nsteps=req.config.nsteps)
        tracer.record(dispatch_ctx.child(), "finalize",
                      t_scan_wall, t_fit_wall)

    def _trace_root(self, req, outcome: str, t_end=None, **attrs):
        """Close a trace this scheduler minted (single-process
        serving) with its root `request` span.  Fleet-relayed
        requests (``owns_trace=False``) keep their root on the
        router, which sees the true end-to-end settle."""
        if (self.tracer is None or req.trace is None
                or not req.owns_trace):
            return
        if req.config.job_id is not None:
            attrs.setdefault("job_id", req.config.job_id)
        if req.config.stage is not None:
            attrs.setdefault("stage", req.config.stage)
        self.tracer.record(req.trace, "request", req.submitted_t,
                           t_end, outcome=outcome, request=req.id,
                           **attrs)

    def _count(self, key: str):
        with self._lock:
            self._stats[key] += 1

    def _gauge(self, name, value, help=None, labels=None):
        if self._metrics is not None:
            self._metrics.set(name, float(value), help=help,
                              labels=labels)

    def _fits_counter(self, outcome: str):
        if self._metrics is not None:
            self._metrics.inc("multigrad_serve_fits_total",
                              help="served fit requests, by outcome",
                              labels={"outcome": outcome})

    def fits_per_hour(self) -> Optional[float]:
        """Served-fit throughput: completions per hour over the span
        from the first submission to the latest completion (None
        until the first fit lands)."""
        with self._lock:
            n = self._stats["completed"]
            if (not n or self._first_submit_t is None
                    or self._last_completed_t is None):
                return None
            span = self._last_completed_t - self._first_submit_t
        if span <= 0:
            return None
        return n / span * 3600.0

    def _refresh_gauges(self, bucket, n):
        if self._metrics is None:
            return
        self._gauge("multigrad_serve_queue_depth", len(self.queue),
                    help="fit requests waiting for a bucket")
        self._gauge("multigrad_serve_occupancy", n / bucket,
                    help="valid rows / bucket rows of the last "
                         "dispatch")
        self._metrics.inc("multigrad_serve_dispatches_total",
                          help="bucket dispatches, by bucket size",
                          labels={"bucket": str(bucket)})
        self._metrics.inc("multigrad_serve_padded_rows_total",
                          float(bucket - n),
                          help="bucket rows filled by padding")
        rate = self.fits_per_hour()
        if rate is not None:
            self._gauge("multigrad_serve_fits_per_hour", rate,
                        help="trailing served-fit rate")

    @property
    def stats(self) -> dict:
        """Counters snapshot: submitted / completed / failed /
        expired / cancelled / retried / shed / dispatches /
        rows_total / rows_padded, plus per-bucket dispatch counts,
        the trailing fits/hour, and (with QoS on) the class-aware
        shed counters."""
        with self._lock:
            out = dict(self._stats)
            out["bucket_dispatches"] = dict(self._bucket_dispatches)
        out["fits_per_hour"] = self.fits_per_hour()
        out["queue_depth"] = len(self.queue)
        if self.qos is not None:
            out["qos_shed"] = self.queue.qos_counts()
        return out
