"""Fit-request queue: the submit/await surface of the serving layer (a copy of
:mod:`multigrad_tpu.serve.queue`).

The multi-tenant front door of :mod:`multigrad_tpu_torch.serve`: callers
build a :class:`FitConfig` (fit schedule + bounds — everything about a
fit *except* its initial guess), submit ``(guess, config)`` pairs, and
get back a :class:`FitFuture` to await, poll or cancel.  The queue
itself is a bounded thread-safe FIFO with admission control — a
structurally invalid request (wrong guess shape, guess outside its
bounds box) is rejected at ``submit`` time, and a full queue pushes
back instead of growing without bound (``block=False`` raises
:class:`QueueFullError` immediately; ``block=True`` waits up to
``timeout`` for the dispatcher to drain headroom).

Requests sharing a config — the same ``(nsteps, learning_rate,
bounds, randkey)`` — are *batchable*: the scheduler
(:mod:`.scheduler`) pops same-config groups off this queue and packs
them into one ``(K, ndim)`` bucket dispatch.  :meth:`FitQueue
.take_group` implements exactly that pop: the oldest pending request
plus every compatible request behind it, up to the bucket cap,
waiting a short batch window for a burst to coalesce.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from .._lockdep import make_condition, make_lock

__all__ = ["FitConfig", "FitRequest", "FitFuture", "FitResult",
           "FitQueue", "QueueFullError", "FitCancelled",
           "FitDeadlineExceeded", "FitFailed", "FitOOMError"]


class QueueFullError(RuntimeError):
    """Admission control pushed back: the queue is at ``max_pending``
    (and stayed there for the whole ``timeout``, when blocking)."""


class FitCancelled(RuntimeError):
    """The future was cancelled before its fit was dispatched."""


class FitDeadlineExceeded(TimeoutError):
    """The request's deadline passed before a bucket could serve it."""


class FitFailed(RuntimeError):
    """The fit produced a non-finite result (NaN/Inf parameters or
    loss).  ``bundle_path`` points at the per-request flight-recorder
    postmortem bundle; ``request_id`` names the tenant's request."""

    def __init__(self, message: str, request_id: int,
                 bundle_path: Optional[str] = None):
        self.request_id = request_id
        self.bundle_path = bundle_path
        at = f"; postmortem bundle: {bundle_path}" if bundle_path \
            else ""
        super().__init__(f"{message} (request {request_id}){at}")


class FitOOMError(FitFailed):
    """A bucket dispatch ran out of device memory.

    The typed, actionable form of the failure that used to land as a
    generic :class:`FitFailed`: the scheduler classifies a
    RESOURCE_EXHAUSTED / out-of-memory dispatch error, attaches the
    sharded-K memory-model estimate (``estimated_bytes``, from
    :func:`~multigrad_tpu_torch.inference.ensemble_memory_model` —
    per-device optimizer + trajectory state for this bucket), and the
    message spells out the remedy: shard the K axis (build the model
    on :func:`~multigrad_tpu_torch.parallel.ensemble_comm` and pass
    ``FitScheduler(k_sharded=True)``), or cap the ladder with
    ``k_budget_bytes``.  The same estimate rides in the postmortem
    bundle.
    """

    def __init__(self, message: str, request_id: int,
                 bundle_path: Optional[str] = None,
                 estimated_bytes: Optional[int] = None,
                 bucket: Optional[int] = None):
        self.estimated_bytes = estimated_bytes
        self.bucket = bucket
        super().__init__(message, request_id,
                         bundle_path=bundle_path)


def _normalize_bounds(param_bounds) -> Optional[tuple]:
    """Bounds as a hashable tuple of ``None | (low, high)`` floats —
    the form that can live inside a frozen, dict-keyable config."""
    if param_bounds is None:
        return None
    out = []
    for entry in param_bounds:
        if entry is None:
            out.append(None)
            continue
        low, high = entry
        out.append((float(low), float(high)))
    return tuple(out)


@dataclass(frozen=True)
class FitConfig:
    """Everything about a fit except its initial guess.

    Two requests are *batchable* iff their configs are equal: the
    scheduler packs them into one ``(K, ndim)`` parameter matrix
    driven by a single batched Adam scan, so every field here is part
    of the compiled program's identity (``nsteps`` and
    ``learning_rate`` join the segment-program cache key;
    ``param_bounds`` selects the bounded bijection; ``randkey``
    selects the keyed kernel and the per-step key chain, shared by
    all rows of a batch).

    ``param_bounds`` follows the ``run_adam`` convention — a sequence
    of ``None | (low, high)`` per parameter — normalized to a
    hashable tuple so configs can key dispatch groups.

    ``job_id``/``stage`` are optional pipeline metadata stamped by
    the job-DAG runner (:mod:`multigrad_tpu_torch.serve.jobs`): free-form
    strings naming the owning job and stage.  Being config fields
    they join dispatch-group equality and the fleet's affinity key
    automatically — a stage's burst coalesces into its own bucket
    family and lands on one worker's compile cache — and they ride
    the wire protocol as ordinary known keys (older peers simply
    drop them; see :mod:`multigrad_tpu_torch.serve.wire`).
    """

    nsteps: int = 100
    learning_rate: float = 0.01
    param_bounds: Optional[tuple] = None
    randkey: Optional[int] = None
    const_randkey: bool = False
    job_id: Optional[str] = None
    stage: Optional[str] = None

    def __post_init__(self):
        for field_name in ("job_id", "stage"):
            value = getattr(self, field_name)
            if value is not None and not isinstance(value, str):
                raise TypeError(
                    f"FitConfig.{field_name} must be a str or None, "
                    f"got {type(value).__name__}")
        object.__setattr__(self, "nsteps", int(self.nsteps))
        object.__setattr__(self, "learning_rate",
                           float(self.learning_rate))
        object.__setattr__(self, "param_bounds",
                           _normalize_bounds(self.param_bounds))
        if self.nsteps <= 0:
            raise ValueError(f"nsteps must be positive, got "
                             f"{self.nsteps}")
        if self.randkey is not None:
            # Configs key dispatch groups (hashed, compared with ==),
            # so the randkey must be a plain int seed — a PRNG key
            # ARRAY would make config equality raise inside the
            # dispatcher thread.  run_adam_scan builds the typed key
            # from the seed at dispatch.
            if not isinstance(self.randkey, (int, np.integer)) \
                    or isinstance(self.randkey, bool):
                raise TypeError(
                    "FitConfig.randkey must be an int seed (or "
                    f"None), got {type(self.randkey).__name__}")
            object.__setattr__(self, "randkey", int(self.randkey))
        if self.const_randkey and self.randkey is None:
            raise ValueError("Must pass randkey if const_randkey")

    @property
    def with_key(self) -> bool:
        return self.randkey is not None

    @property
    def bounded(self) -> bool:
        return self.param_bounds is not None

    def bounds_list(self) -> Optional[list]:
        """Bounds in the list form the optimizer entry points take."""
        return None if self.param_bounds is None \
            else list(self.param_bounds)


@dataclass(frozen=True)
class FitResult:
    """A served fit, as delivered by :meth:`FitFuture.result`.

    ``traj`` is this request's own ``(nsteps + 1, ndim)`` trajectory
    slice of the batched scan — bitwise identical to what a solo
    :func:`~multigrad_tpu_torch.optim.adam.run_adam_scan` of the same guess
    would return (Adam's update is elementwise, so batch rows advance
    as independent fits).  ``worker`` names the fleet worker that
    served the fit when the request traveled through a
    :class:`~multigrad_tpu_torch.serve.fleet.FleetRouter` (``None`` for
    in-process scheduling).
    """

    request_id: int
    params: np.ndarray
    loss: float
    traj: np.ndarray
    steps: int
    bucket: int
    wait_s: float
    fit_s: float
    retried: bool = False
    worker: Optional[str] = None
    # Distributed-tracing surface: the request's trace id (mint
    # point: FleetRouter.submit / FitScheduler.submit) and the
    # per-hop latency breakdown in seconds — scheduler hops
    # (queue_wait / bucket_coalesce / dispatch / adam_segments /
    # finalize) plus, for fleet-served fits, the router's hops
    # (route / rpc_send / result_return, and requeue time when the
    # request migrated off a lost worker).  ``wait_s``/``fit_s``
    # above are the coarse pre-tracing bookkeeping; ``hops`` is the
    # full vector the waterfall renders.
    trace_id: Optional[str] = None
    hops: Optional[dict] = None
    # Pipeline metadata echoed back from the request's FitConfig (see
    # FitConfig.job_id/.stage): lets a job runner — or any caller
    # multiplexing stages over one scheduler — attribute results
    # without a side table.
    job_id: Optional[str] = None
    stage: Optional[str] = None


class FitFuture:
    """Await/poll/cancel handle for one submitted fit request.

    The deliberately tiny subset of ``concurrent.futures.Future`` the
    serving layer needs: :meth:`result` blocks (with an optional
    caller-side timeout — independent of the request's *deadline*,
    which the scheduler enforces), :meth:`exception` fetches the
    error without raising, :meth:`cancel` withdraws a request that
    has not been picked up by a bucket yet.

    ``requeues`` is the request's requeue history: the fleet router
    appends one ``{"t", "worker", "reason", "bundle"}`` entry every
    time the request is moved off a lost/preempted worker, so a
    delivered result (or terminal error) carries the full migration
    story of the request that produced it.  Empty for requests that
    never left their first home.
    """

    def __init__(self, request_id: int):
        self.request_id = request_id
        self.requeues: list = []
        # The request's distributed-tracing id (None when tracing is
        # off): the caller-side handle into the merged waterfall —
        # `python -m multigrad_tpu_torch.telemetry.trace --trace <id>`.
        self.trace_id: Optional[str] = None
        self._event = threading.Event()
        self._lock = make_lock("serve.queue.FitFuture._lock")
        self._result: Optional[FitResult] = None
        self._exception: Optional[BaseException] = None
        self._running = False
        self._cancelled = False

    # -- scheduler side -----------------------------------------------------
    def _set_running(self) -> bool:
        """Claim the request for a dispatch; False if already
        cancelled (the dispatcher skips it)."""
        with self._lock:
            if self._cancelled:
                return False
            self._running = True
            return True

    def _requeued(self):
        """Back to pending (the retry path re-enqueues the request)."""
        with self._lock:
            self._running = False

    def _set_result(self, result: FitResult):
        # First resolution wins (same contract as _set_exception): a
        # request requeued off a stalled-but-alive worker can complete
        # twice — once on the survivor, once when the original worker
        # wakes up — and the late duplicate must not clobber the
        # delivered result.
        with self._lock:
            if self._event.is_set():
                return
            self._result = result
        self._event.set()

    def _set_exception(self, exc: BaseException):
        with self._lock:
            if self._event.is_set():
                return
            self._exception = exc
        self._event.set()

    # -- caller side --------------------------------------------------------
    def cancel(self) -> bool:
        """Withdraw the request.  Only a still-pending request can be
        cancelled — once a bucket has claimed it (or it is done) this
        returns False.  A successful cancel resolves the future with
        :class:`FitCancelled`; the queue slot is reclaimed lazily at
        the dispatcher's next pass."""
        with self._lock:
            if self._running or self._event.is_set():
                return False
            self._cancelled = True
            self._exception = FitCancelled(
                f"request {self.request_id} cancelled")
        self._event.set()
        return True

    def cancelled(self) -> bool:
        return self._cancelled

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> FitResult:
        """Block until served; raises the fit's error
        (:class:`FitFailed` / :class:`FitDeadlineExceeded` /
        :class:`FitCancelled`) or ``TimeoutError`` if ``timeout``
        elapses first."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not served within "
                f"{timeout} s (still "
                f"{'running' if self._running else 'queued'})")
        if self._exception is not None:
            raise self._exception
        return self._result

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        """The fit's error (or None on success), without raising it."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not served within "
                f"{timeout} s")
        return self._exception


@dataclass
class FitRequest:
    """One queued fit: a guess, its config, and delivery bookkeeping."""

    id: int
    guess: np.ndarray
    config: FitConfig
    future: FitFuture
    deadline: Optional[float] = None      # absolute time.time()
    submitted_t: float = field(default_factory=time.time)
    retried: bool = False
    # Trace context (telemetry.tracing.TraceContext) propagated from
    # the request's origin; ``owns_trace`` marks contexts THIS
    # scheduler minted (single-process serving), i.e. the scheduler
    # also records the root `request` span at settle — a fleet
    # worker's scheduler must not, the router owns that root.
    trace: Optional[object] = None
    owns_trace: bool = False
    # QoS identity (serve.qos.QosTag): tenant / priority_class /
    # slo_deadline.  Carried on the REQUEST, deliberately not in the
    # config — the config is the batchability key, and same-config
    # fits from different tenants must still co-batch (duck-typed
    # object here so the queue stays import-free of the policy
    # module).  None schedules as the shared default tenant.
    qos: Optional[object] = None

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline is None:
            return False
        return (time.time() if now is None else now) > self.deadline


def _group_key(req: FitRequest) -> tuple:
    """Batchability key: the config AND the guess dimensionality.

    Unbounded configs carry no ndim of their own, and packing a
    stray 3-parameter guess into a 2-parameter bucket would fail the
    whole group at the stack step — the ndim in the key keeps a
    malformed request's failure its own."""
    return (req.config, int(req.guess.shape[0]))


class FitQueue:
    """Bounded thread-safe FIFO of :class:`FitRequest`\\ s.

    ``max_pending`` is the backpressure bound: :meth:`submit` beyond
    it raises :class:`QueueFullError` (immediately, or after
    ``timeout`` when ``block=True``).  Cancelled requests keep their
    slot until the dispatcher's next :meth:`take_group` purges them —
    the bound is on *tracked* requests, which is what admission
    control is protecting.  Expired requests do NOT keep theirs: both
    admission (a full queue) and :meth:`take_group` purge them,
    settling their futures :class:`FitDeadlineExceeded` — a backlog
    of dead deadlines must never block a live tenant's submit.

    ``qos`` (a :class:`~multigrad_tpu_torch.serve.qos.QosPolicy`) replaces
    the FIFO dequeue with policy-driven scheduling: per-tenant
    deficit round-robin picks whose config home dequeues, EDF orders
    the group, per-tenant quotas reject before global queue-full,
    and a full queue sheds its lowest priority class to admit
    strictly-higher-class work.  ``None`` (the default) keeps the
    legacy FIFO behavior bit-for-bit.

    ``on_settle(request, kind)`` is called — outside the lock,
    before the future resolves — for every request the queue settles
    itself (``kind`` is ``"expired"`` or ``"shed"``): the
    scheduler's hook for trace roots and counters, preserving the
    root-before-resolve convention of every other settle path.
    """

    def __init__(self, max_pending: int = 1024, qos=None,
                 on_settle=None):
        self.max_pending = int(max_pending)
        if self.max_pending <= 0:
            raise ValueError("max_pending must be positive")
        self.qos = qos
        self._on_settle = on_settle
        self._lock = make_lock("serve.queue.FitQueue._lock")
        self._not_empty = make_condition(
            "serve.queue.FitQueue._not_empty", lock=self._lock)
        self._not_full = make_condition(
            "serve.queue.FitQueue._not_full", lock=self._lock)
        self._pending: collections.deque = collections.deque()
        self._ids = itertools.count()
        self._closed = False

    # -- producer side ------------------------------------------------------
    def next_id(self) -> int:
        return next(self._ids)

    def submit(self, request: FitRequest, block: bool = False,
               timeout: Optional[float] = None, front: bool = False,
               force: bool = False) -> FitFuture:
        """Enqueue; raises :class:`QueueFullError` on backpressure and
        ``RuntimeError`` once the queue is closed.  ``front`` puts the
        request at the head (the retry path: a poisoned request gets
        its fresh bucket before newer work); ``force`` bypasses the
        capacity check — ONLY for re-enqueues of already-admitted
        requests (their slot was released at take time, so forcing
        them back never grows the tracked-work bound past one request
        beyond ``max_pending``).

        With a QoS policy attached, admission is class- and
        tenant-aware: the tenant's quota is checked first
        (:class:`~multigrad_tpu_torch.serve.qos.TenantQuotaError` — "you
        are over quota" — before any global queue-full verdict), a
        full queue first purges expired requests (settled
        :class:`FitDeadlineExceeded`), and failing that sheds its
        lowest-class queued request (settled
        :class:`~multigrad_tpu_torch.serve.qos.FitShedError`) to admit
        strictly-higher-class work."""
        deadline = None if timeout is None else time.time() + timeout
        use_qos = self.qos is not None and self.qos.enabled
        while True:
            settle: list = []    # (request, kind, exc), resolved
            admitted = False     # outside the lock below
            with self._not_full:
                if self._closed:
                    raise RuntimeError(
                        "queue is closed (scheduler shutting down)")
                now = time.time()
                if use_qos and not force:
                    self.qos.check_quota(self._pending, request, now)
                if force or len(self._pending) < self.max_pending:
                    admitted = True
                else:
                    # Full queue: dead deadlines don't hold slots —
                    # purge-then-admit, so a queue full of expired
                    # requests still admits a live tenant.
                    popped = self._pop_expired(now)
                    if popped:
                        settle += [
                            (r, "expired", FitDeadlineExceeded(
                                f"request {r.id} deadline passed "
                                "while queued"))
                            for r in popped]
                        admitted = True
                    elif use_qos:
                        victim = self.qos.shed_victim(self._pending,
                                                      request)
                        if victim is not None:
                            self._pending = collections.deque(
                                r for r in self._pending
                                if r is not victim)
                            self.qos.record_shed(victim)
                            settle.append((
                                victim, "shed",
                                self.qos.shed_error(victim,
                                                    request)))
                            admitted = True
                    if not admitted:
                        if not block:
                            raise QueueFullError(
                                f"queue at max_pending="
                                f"{self.max_pending}")
                        remaining = None if deadline is None \
                            else deadline - time.time()
                        if remaining is not None and remaining <= 0:
                            raise QueueFullError(
                                f"queue still at max_pending="
                                f"{self.max_pending} after "
                                f"{timeout} s")
                        self._not_full.wait(remaining)
                if admitted:
                    if front:
                        self._pending.appendleft(request)
                    else:
                        self._pending.append(request)
                    self._not_empty.notify()
            self._settle(settle)
            if admitted:
                return request.future

    # -- consumer (dispatcher) side -----------------------------------------
    def take_group(self, max_n: int, window_s: float = 0.0,
                   timeout: Optional[float] = None
                   ) -> Tuple[list, list]:
        """Pop the oldest request plus every same-config request
        behind it, up to ``max_n``.

        Blocks up to ``timeout`` for the first request; once one is
        available, waits up to ``window_s`` more (the batch window)
        for a burst to coalesce into a fuller bucket — returning
        early the moment ``max_n`` compatible requests are pending.
        Cancelled requests are purged along the way.

        Returns ``(group, cancelled)``; ``group`` is empty on
        timeout.  FIFO order is preserved for requests left behind
        (other-config requests keep their positions).

        Expired requests are purged HERE — settled
        :class:`FitDeadlineExceeded` (after the ``on_settle`` hook)
        instead of occupying capacity until a dispatch notices.

        With a QoS policy the head is policy-chosen instead of
        FIFO: deficit round-robin over tenants picks the winner,
        EDF picks the winner's most urgent request, and the
        returned group is packing-ordered (winner first, then
        co-batched riders, each EDF-sorted) with the winner's
        deficit charged.  A head deadline tighter than the batch
        window collapses the window (see
        :meth:`~multigrad_tpu_torch.serve.qos.QosPolicy
        .effective_window`).
        """
        expired: list = []
        use_qos = self.qos is not None and self.qos.enabled
        try:
            with self._not_empty:
                if not self._wait_for_pending(timeout):
                    return [], self._purge_cancelled()
                cancelled = self._purge_cancelled()
                now = time.time()
                expired += self._pop_expired(now)
                if not self._pending:
                    return [], cancelled
                # lock-ok: blocking-under-lock QosPolicy.select is pure in-memory DRR+EDF over the pending deque (no I/O, no other lock) — the policy's documented contract is that every mutator runs under this queue lock
                head = self.qos.select(self._pending, now) \
                    if use_qos else self._pending[0]
                key = _group_key(head)
                if use_qos:
                    window_s = self.qos.effective_window(
                        head, window_s, now)
                if window_s > 0:
                    batch_deadline = time.time() + window_s
                    while (self._count_matching(key) < max_n):
                        remaining = batch_deadline - time.time()
                        if remaining <= 0:
                            break
                        self._not_empty.wait(remaining)
                    cancelled += self._purge_cancelled()
                    expired += self._pop_expired()
                if use_qos:
                    matching = [r for r in self._pending
                                if _group_key(r) == key]
                    group = self.qos.order_group(matching)[:max_n]
                    taken = set(map(id, group))
                    keep = collections.deque(
                        r for r in self._pending
                        if id(r) not in taken)
                    self.qos.charge(group)
                else:
                    group, keep = [], collections.deque()
                    for req in self._pending:
                        if len(group) < max_n \
                                and _group_key(req) == key:
                            group.append(req)
                        else:
                            keep.append(req)
                self._pending = keep
                if group:      # cancelled purges notified already
                    self._not_full.notify_all()
                return group, cancelled
        finally:
            # Settled OUTSIDE the lock (root-before-resolve via the
            # on_settle hook, no user code under the queue lock).
            self._settle([(r, "expired", FitDeadlineExceeded(
                f"request {r.id} deadline passed while queued"))
                for r in expired])

    def _wait_for_pending(self, timeout: Optional[float]) -> bool:
        deadline = None if timeout is None else time.time() + timeout
        while not any(not r.future.cancelled() for r in self._pending):
            if self._closed and not self._pending:
                return False
            remaining = None if deadline is None \
                else deadline - time.time()
            if remaining is not None and remaining <= 0:
                return bool(self._pending)
            self._not_empty.wait(remaining)
        return True

    def _count_matching(self, key) -> int:
        return sum(1 for r in self._pending
                   if _group_key(r) == key
                   and not r.future.cancelled())

    def _purge_cancelled(self) -> list:
        purged = [r for r in self._pending if r.future.cancelled()]
        if purged:
            self._pending = collections.deque(
                r for r in self._pending if not r.future.cancelled())
            # Every purge frees backpressure headroom — wake blocked
            # producers HERE, so no take_group return path (e.g. the
            # everything-was-cancelled early return) can strand a
            # submit(block=True) caller on a now-empty queue.
            self._not_full.notify_all()
        return purged

    def _pop_expired(self, now: Optional[float] = None) -> list:
        """Remove (but do NOT settle) expired, uncancelled requests
        — called under the lock; the caller settles the returned
        requests outside it via :meth:`_settle`."""
        now = time.time() if now is None else now
        popped = [r for r in self._pending
                  if not r.future.cancelled() and r.expired(now)]
        if popped:
            dead = set(map(id, popped))
            self._pending = collections.deque(
                r for r in self._pending if id(r) not in dead)
            self._not_full.notify_all()
        return popped

    def _settle(self, items):
        """Resolve queue-settled requests — ``(request, kind, exc)``
        triples — outside the lock: the ``on_settle`` hook first
        (trace roots / counters; root-before-resolve), then the
        future.  Hook failures never strand a future unresolved."""
        for req, kind, exc in items:
            if self._on_settle is not None:
                try:
                    self._on_settle(req, kind)
                except Exception:
                    pass
            req.future._set_exception(exc)

    def qos_counts(self) -> dict:
        """Cumulative class-aware shed counters
        (``{"by_class": {...}, "by_tenant": {...}}``) — the payload
        tagged worker ``reject`` messages and
        :class:`~multigrad_tpu_torch.serve.fleet.FleetSaturatedError`
        carry.  Empty without a policy."""
        with self._lock:
            if self.qos is None:
                return {"by_class": {}, "by_tenant": {}}
            return self.qos.shed_counts()

    # -- shared -------------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._pending)

    def empty(self) -> bool:
        return len(self) == 0

    def close(self):
        """Refuse new submissions (pending requests stay drainable)."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    def drain_pending(self) -> list:
        """Pop everything (the non-graceful shutdown path)."""
        with self._lock:
            out = list(self._pending)
            self._pending.clear()
            self._not_full.notify_all()
        return out
