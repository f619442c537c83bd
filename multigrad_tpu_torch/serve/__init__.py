"""Fit-fleet serving layer: multi-tenant batched fits as a service
(port of :mod:`multigrad_tpu.serve`).

The paper's core identity makes the *marginal* cost of one more fit
tiny — sumstats and gradients cost O(|sumstats| + |params|) in
communication regardless of catalog size — and the batched
``(K, ndim)`` loss and gradient already runs K independent fits as one
call.  This package puts a scheduler in front of that call and turns
the repo's hand-driven fits into sustained throughput on the card:

* :mod:`.queue` — the tenant surface: :class:`FitConfig` +
  :meth:`FitScheduler.submit` → :class:`FitFuture` (await / poll /
  cancel), with admission control and bounded backpressure
  (:class:`QueueFullError`).
* :mod:`.scheduler` — :class:`FitScheduler`: a dispatcher thread
  pad-and-packs compatible requests into quantized ``(K, ndim)``
  buckets (default ``K ∈ {1, 4, 16, 64}``) dispatched through the
  batched Adam fit, so the distinct dispatch shapes are bounded by the
  bucket count, not the request count; finalize splits the batched
  result back into per-request results.
* :mod:`.compile_cache` — the kernel-library directory shared across
  processes (:func:`enable_compile_cache`) plus bucket warmup
  (:func:`warmup_buckets`, which runs one step of each bucket): a
  fresh process serves its first fit without paying ``nvcc``.
* :mod:`.robustness` — per-request fault isolation: a NaN/Inf in one
  tenant's fit is contained to its own batch row; the poisoned
  request alone gets a flight-recorder postmortem bundle and an
  errored future (:class:`FitFailed`), with one retry on a fresh
  bucket; deadline timeouts (:class:`FitDeadlineExceeded`) and
  graceful drain on shutdown.
* :mod:`.fleet` + :mod:`.worker` + :mod:`.wire` — the horizontal
  dimension: :class:`FleetRouter` shards config traffic across N worker
  *processes* (``python -m multigrad_tpu_torch.serve.worker``, each on
  its ``device=``; workers sharing one card each hold a CUDA context)
  with config-affinity routing over the shared kernel-library
  directory, heartbeat health tracking, load shedding / work stealing
  (:class:`FleetSaturatedError`), and preemption-resilient draining — a
  killed worker's in-flight requests re-enqueue on survivors (requeue
  history on the future; :class:`WorkerLostError` when the fleet truly
  cannot finish one).  The wire is the JAX package's protocol byte for
  byte, so a JAX router can drive a port worker.
* :mod:`.chaos` — :class:`ChaosController`: SIGKILL / SIGTERM /
  SIGSTOP, forced queue-full, stalls — injected at configurable
  points, proving "every future resolves" under fire.
* :mod:`.qos` + :mod:`.slo` — the multi-tenant scheduling dimension:
  a :class:`QosTag` (tenant, priority class, optional SLO deadline)
  rides each request — deliberately NOT part of the batchability
  key, so same-config fits from different tenants still co-batch —
  and a :class:`QosPolicy` turns FIFO dequeue into weighted-fair
  (deficit round-robin over tenants), makes shedding class-aware
  (:class:`FitShedError`, :class:`TenantQuotaError`), and packs
  buckets deadline-first (EDF).  :class:`SloMonitor` states latency
  objectives declaratively (``"p95 < 2 s for interactive"``),
  evaluates them live, and exports ``multigrad_qos_*`` gauges.
* :mod:`.jobs` + :mod:`.stages` — the pipeline dimension:
  :class:`JobRunner` runs a whole posterior pipeline submitted as
  ONE :class:`Job` — a typed DAG of stages (sweep → ensemble →
  Laplace → HMC → predictive checks) — fanning fit-type stages out
  through the scheduler/fleet, running host-side inference stages
  locally on the model's device, flowing small JSON artifacts between
  stages, tracing the whole job as one waterfall, and checkpointing at
  stage boundaries so a lost worker costs a stage, not the job.

Minimal service::

    from multigrad_tpu_torch.serve import FitScheduler, enable_compile_cache

    enable_compile_cache()                   # the kernel libraries' dir
    with FitScheduler(model) as sched:
        futs = [sched.submit(g, nsteps=500, param_bounds=bounds)
                for g in guesses]
        results = [f.result() for f in futs]     # FitResult each

Scheduler gauges (queue depth, bucket occupancy, fits/hour) land in
the :class:`~multigrad_tpu_torch.telemetry.LiveServer` ``/metrics``
endpoint via ``live=``, and every served request closes with a
``fit_summary`` telemetry record via ``telemetry=``.
"""
from .queue import (FitCancelled, FitConfig,  # noqa: F401
                    FitDeadlineExceeded, FitFailed, FitFuture,
                    FitOOMError, FitQueue, FitRequest, FitResult,
                    QueueFullError)
from .compile_cache import (DEFAULT_BUCKETS,  # noqa: F401
                            cache_entries, enable_compile_cache,
                            warmup_buckets)
from .qos import (FitShedError, QosPolicy, QosTag,  # noqa: F401
                  TenantQuotaError)
from .slo import Slo, SloMonitor, parse_slo  # noqa: F401
from .scheduler import FitScheduler  # noqa: F401
from .robustness import nonfinite_rows  # noqa: F401
from .fleet import (FleetRouter, FleetSaturatedError,  # noqa: F401
                    WorkerHandle, WorkerLostError)
from .chaos import ChaosController  # noqa: F401
from .stages import (EnsembleStage, FitStage, HmcStage,  # noqa: F401
                     LaplaceStage, PredictiveCheckStage, Stage,
                     StageRuntime, SweepStage)
from .jobs import (Job, JobFailed, JobFuture, JobResult,  # noqa: F401
                   JobRunner, StageResult)

__all__ = [
    "FitScheduler", "FitConfig", "FitRequest", "FitFuture",
    "FitResult", "FitQueue", "QueueFullError", "FitCancelled",
    "FitDeadlineExceeded", "FitFailed", "FitOOMError",
    "enable_compile_cache", "cache_entries", "warmup_buckets",
    "DEFAULT_BUCKETS", "nonfinite_rows",
    "FleetRouter", "WorkerHandle", "WorkerLostError",
    "FleetSaturatedError", "ChaosController",
    "QosTag", "QosPolicy", "TenantQuotaError", "FitShedError",
    "Slo", "SloMonitor", "parse_slo",
    "Job", "JobRunner", "JobFuture", "JobResult", "JobFailed",
    "StageResult", "Stage", "StageRuntime", "FitStage",
    "SweepStage", "EnsembleStage", "LaplaceStage", "HmcStage",
    "PredictiveCheckStage",
]
