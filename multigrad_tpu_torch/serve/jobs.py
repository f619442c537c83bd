"""Job-DAG pipeline subsystem: joint posteriors as a service (a copy of
:mod:`multigrad_tpu.serve.jobs`).

One :class:`Job` — a typed DAG of stages (:mod:`multigrad_tpu_torch.serve
.stages`) — submitted to a :class:`JobRunner` runs a whole posterior
pipeline (Latin-hypercube scan → multi-start ensemble → Laplace →
HMC → predictive checks) through the existing serving planes instead
of caller-side orchestration around one-shot ``submit`` calls:

* **Dependency resolution** — stages whose dependencies have settled
  run concurrently (one ``mgt-job-*`` thread per ready stage);
  artifacts flow between stages as small JSON-able host-side dicts
  (the stage contract — never catalogs).
* **Fit fan-out** — fit-type stages push bursts through the runner's
  backend (:class:`~multigrad_tpu_torch.serve.scheduler.FitScheduler` or
  :class:`~multigrad_tpu_torch.serve.fleet.FleetRouter`); each stage's
  shared :class:`~multigrad_tpu_torch.serve.queue.FitConfig` is stamped
  with ``job_id``/``stage``, so the burst coalesces into its own
  bucket family and keys its own fleet affinity.  Host-side stages
  (Laplace/HMC/predictive checks) run on the runner's local model,
  on its device, from the runner's own ``mgt-job-*`` threads.
* **Tracing** — the runner mints ONE trace per job; every stage
  attempt is a ``stage`` span under the job root, every fit's
  ``request`` span (and the scheduler/router hops under it) parents
  into its stage span, so ``python -m multigrad_tpu_torch.telemetry.trace``
  renders the complete multi-stage DAG as a single waterfall.
* **Checkpoints** — with ``checkpoint_dir`` set, job state is written
  at every stage boundary (artifacts are JSON by contract, so the
  checkpoint is a plain file).  A crashed/killed runner re-submitted
  with the same ``job_id`` restores every completed stage — and keeps
  the same trace — so a lost worker costs a *stage*, not the job.
  (Within a stage, a fleet backend already migrates in-flight fits
  off a dead worker via its requeue machinery; the runner's
  ``max_stage_attempts`` re-runs the stage only when the backend
  gives up.)
* **Observability** — ``multigrad_job_*`` gauges feed ``/status``;
  one ``job_summary`` telemetry record per job (per-stage outcomes,
  latencies, fit counts) feeds the report CLI's ``job:`` section;
  predictive-check verdicts are their own ``predictive_check``
  records.

::

    job = Job(stages=(
        SweepStage("scan", n_points=32, param_bounds=BOUNDS),
        EnsembleStage("ensemble", deps=("scan",), n_starts=8,
                      param_bounds=BOUNDS),
        LaplaceStage("laplace", deps=("ensemble",)),
        HmcStage("hmc", deps=("ensemble", "laplace")),
        PredictiveCheckStage("check", deps=("hmc",)),
    ))
    future = JobRunner(router, model=joint_model,
                       checkpoint_dir=ckpt).submit(job)
    result = future.result()          # JobResult: per-stage outcomes
"""
from __future__ import annotations

import json
import os
import secrets
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple, Union

from .._lockdep import make_condition, make_lock
from .stages import Stage, StageRuntime

__all__ = ["Job", "JobResult", "JobRunner", "JobFuture",
           "StageResult", "JobFailed"]


class JobFailed(RuntimeError):
    """The job runner itself died before settling the job (stage
    *failures* do not raise — they settle the
    :class:`JobFuture` with a :class:`JobResult` whose ``ok`` is
    False and per-stage outcomes tell the story)."""


@dataclass
class Job:
    """A typed DAG of stages, submitted as one unit.

    ``job_id`` names the job everywhere — config stamps, trace
    attributes, gauges, the checkpoint file — and is minted
    (``job-<hex>``) when not given.  Re-submitting a job with the
    same ``job_id`` to a runner with a ``checkpoint_dir`` resumes it:
    completed stages restore from the checkpoint.  Validation
    (unique names, known dependencies, acyclicity) happens here, at
    construction, so a malformed DAG fails its caller instead of a
    runner thread.
    """

    stages: Union[Tuple[Stage, ...], Stage]
    job_id: Optional[str] = None
    # Multi-tenant QoS: the whole job's fit traffic is tagged with
    # this tenant/class (see multigrad_tpu_torch.serve.qos) — stages
    # propagate the tag on every backend.submit, so a QoS-enabled
    # fleet schedules the job's bursts under its tenant's fair share.
    tenant: Optional[str] = None
    priority_class: Optional[str] = None

    def __post_init__(self):
        if isinstance(self.stages, Stage):
            self.stages = (self.stages,)
        self.stages = tuple(self.stages)
        if not self.stages:
            raise ValueError("Job needs at least one stage")
        names = [s.name for s in self.stages]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stage names: {names}")
        known = set(names)
        for s in self.stages:
            missing = [d for d in s.deps if d not in known]
            if missing:
                raise ValueError(
                    f"stage {s.name!r} depends on unknown stage(s) "
                    f"{missing}")
        self._toposort()            # raises on cycles
        if self.job_id is None:
            self.job_id = f"job-{secrets.token_hex(4)}"

    def _toposort(self) -> Tuple[Stage, ...]:
        by_name = {s.name: s for s in self.stages}
        done, order, visiting = set(), [], set()

        def visit(s):
            if s.name in done:
                return
            if s.name in visiting:
                raise ValueError(
                    f"stage dependency cycle through {s.name!r}")
            visiting.add(s.name)
            for d in s.deps:
                visit(by_name[d])
            visiting.discard(s.name)
            done.add(s.name)
            order.append(s)

        for s in self.stages:
            visit(s)
        return tuple(order)


@dataclass(frozen=True)
class StageResult:
    """One stage's outcome within a settled job."""

    name: str
    #: "ok" | "failed" | "skipped" (an upstream dependency failed) |
    #: "restored" (completed in a previous run, replayed from the
    #: job checkpoint).
    outcome: str
    artifact: Optional[dict] = None
    elapsed_s: float = 0.0
    attempts: int = 0
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.outcome in ("ok", "restored")


@dataclass(frozen=True)
class JobResult:
    """A settled job: per-stage results plus the roll-up."""

    job_id: str
    ok: bool
    stages: Dict[str, StageResult]
    elapsed_s: float
    trace_id: Optional[str] = None

    def artifact(self, stage: str) -> Optional[dict]:
        result = self.stages.get(stage)
        return result.artifact if result is not None else None

    def outcomes(self) -> Dict[str, str]:
        return {name: r.outcome for name, r in self.stages.items()}


class JobFuture:
    """Await/poll handle for one submitted job.

    :meth:`result` blocks for the :class:`JobResult` (stage failures
    settle the future normally — check ``result.ok``); runner-level
    crashes surface as a raised :class:`JobFailed`.
    ``stage_results`` is live: stages appear as they settle, so a
    dashboard can render pipeline progress without waiting for the
    job.
    """

    def __init__(self, job_id: str):
        self.job_id = job_id
        #: The job's trace id (None with tracing off): the handle
        #: into `python -m multigrad_tpu_torch.telemetry.trace`.
        self.trace_id: Optional[str] = None
        self._lock = make_lock("serve.jobs.JobFuture._lock")
        self._cond = make_condition("serve.jobs.JobFuture._cond",
                                    self._lock)
        self._stage_results: Dict[str, StageResult] = {}
        self._result: Optional[JobResult] = None
        self._exception: Optional[BaseException] = None

    @property
    def stage_results(self) -> Dict[str, StageResult]:
        with self._lock:
            return dict(self._stage_results)

    def done(self) -> bool:
        with self._lock:
            return self._result is not None \
                or self._exception is not None

    def result(self, timeout: Optional[float] = None) -> JobResult:
        with self._cond:
            if not self._cond.wait_for(
                    lambda: self._result is not None
                    or self._exception is not None,
                    timeout=timeout):
                raise TimeoutError(
                    f"job {self.job_id} not settled within "
                    f"{timeout}s")
            if self._exception is not None:
                raise self._exception
            return self._result

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        try:
            self.result(timeout=timeout)
        except TimeoutError:
            raise
        except BaseException as err:
            return err
        return None

    # -- runner side --------------------------------------------------------
    def _stage_settled(self, result: StageResult):
        with self._cond:
            self._stage_results[result.name] = result
            self._cond.notify_all()

    def _set_result(self, result: JobResult):
        with self._cond:
            # First-wins: a late duplicate settle (the runner's
            # crash backstop racing the normal completion path) must
            # not clobber the outcome a caller may already hold.
            if self._result is not None \
                    or self._exception is not None:
                return
            self._result = result
            self._cond.notify_all()

    def _set_exception(self, err: BaseException):
        with self._cond:
            if self._result is not None \
                    or self._exception is not None:
                return
            self._exception = err
            self._cond.notify_all()


class JobRunner:
    """Runs job DAGs over a fit backend.

    Parameters
    ----------
    backend :
        A :class:`~multigrad_tpu_torch.serve.scheduler.FitScheduler` or
        :class:`~multigrad_tpu_torch.serve.fleet.FleetRouter`; fit-type
        stages fan their bursts out through it.
    model : optional
        Local model (or fused :class:`~multigrad_tpu_torch.core.group
        .OnePointGroup`) for the host-side stages (Laplace, HMC,
        predictive checks).  Defaults to the backend's own model
        when it holds one (a scheduler does; a fleet router only
        knows its workers' model *spec*, so pass the model
        explicitly to run host-side stages next to a fleet).
    telemetry, live, tracer : optional
        Default to the backend's planes, so job records, gauges and
        spans land in the same streams as the fits they wrap.
    checkpoint_dir : str, optional
        Directory for per-job stage-boundary checkpoints
        (``<job_id>.json``).  Unset disables checkpointing.
    max_stage_attempts : int
        In-run retries per stage (failure after the last attempt
        fails the stage; downstream stages are skipped).
    fit_timeout_s : float, optional
        Per-fit result timeout inside fan-out stages.
    """

    def __init__(self, backend, model=None, telemetry=None,
                 live=None, tracer=None,
                 checkpoint_dir: Optional[str] = None,
                 max_stage_attempts: int = 2,
                 fit_timeout_s: Optional[float] = None):
        self.backend = backend
        backend_model = getattr(backend, "model", None)
        if model is None and hasattr(backend_model,
                                     "batched_loss_and_grad_fn"):
            model = backend_model
        self.model = model
        self.telemetry = telemetry if telemetry is not None \
            else getattr(backend, "telemetry", None)
        self.tracer = tracer if tracer is not None else (
            getattr(backend, "tracer", None)
            or getattr(backend, "_tracer", None))
        metrics = getattr(live, "metrics", live)
        if metrics is None:
            metrics = getattr(backend, "_metrics", None)
        self._metrics = metrics
        self.checkpoint_dir = checkpoint_dir
        self.max_stage_attempts = max(1, int(max_stage_attempts))
        self.fit_timeout_s = fit_timeout_s
        # The fleet router closes every request span itself (its
        # root bookkeeping is first-settle-wins on the caller's
        # context); a scheduler given an upstream context records
        # hops only, so fan-out stages add the request span.
        from .fleet import FleetRouter
        self._backend_records_request_span = isinstance(
            backend, FleetRouter)
        self._lock = make_lock("serve.jobs.JobRunner._lock")
        # Guards every concurrent touch of a job's shared `results`
        # dict (fan-out waves run one thread per ready stage) and
        # serializes checkpoint publication, so each published
        # checkpoint reflects all stages settled before it.
        self._results_lock = make_lock(
            "serve.jobs.JobRunner._results_lock")
        self._active: Dict[str, JobFuture] = {}
        self._threads: Dict[str, threading.Thread] = {}

    # ------------------------------------------------------------------ #
    # submission
    # ------------------------------------------------------------------ #
    def submit(self, job: Job) -> JobFuture:
        """Launch `job` on its own runner thread; returns the
        :class:`JobFuture` immediately."""
        future = JobFuture(job.job_id)
        thread = threading.Thread(
            target=self._run_job, args=(job, future), daemon=True,
            name=f"mgt-job-{job.job_id}")
        with self._lock:
            if job.job_id in self._active:
                raise ValueError(
                    f"job {job.job_id!r} is already running")
            self._active[job.job_id] = future
            self._threads[job.job_id] = thread
            n_active = len(self._active)
        self._gauge("multigrad_job_active", n_active,
                    help="job DAGs currently executing")
        thread.start()
        return future

    def run(self, job: Job,
            timeout: Optional[float] = None) -> JobResult:
        """Submit and block: ``submit(job).result(timeout)``."""
        return self.submit(job).result(timeout=timeout)

    # ------------------------------------------------------------------ #
    # execution
    # ------------------------------------------------------------------ #
    def _run_job(self, job: Job, future: JobFuture):
        t0 = time.time()
        try:
            restored = self._restore_checkpoint(job)
            job_ctx = self._job_context(job, restored)
            if job_ctx is not None:
                future.trace_id = job_ctx.trace_id
            results: Dict[str, StageResult] = {}
            for name, entry in restored.get("stages", {}).items():
                if entry.get("outcome") in ("ok", "restored") \
                        and any(s.name == name for s in job.stages):
                    results[name] = StageResult(
                        name=name, outcome="restored",
                        artifact=entry.get("artifact"),
                        elapsed_s=float(entry.get("elapsed_s", 0.0)),
                        attempts=int(entry.get("attempts", 0)))
                    future._stage_settled(results[name])
            self._execute_dag(job, future, job_ctx, results)
            elapsed = time.time() - t0
            ok = all(r.ok for r in results.values())
            result = JobResult(
                job_id=job.job_id, ok=ok, stages=dict(results),
                elapsed_s=round(elapsed, 6),
                trace_id=(job_ctx.trace_id if job_ctx is not None
                          else None))
            # Root span and telemetry land BEFORE the future
            # resolves: a caller waking on result() must find a
            # complete trace and an accounted job.
            if self.tracer is not None and job_ctx is not None:
                self.tracer.record(
                    job_ctx, "job", t0, time.time(),
                    ok=ok, outcome="ok" if ok else "failed",
                    job_id=job.job_id, n_stages=len(job.stages))
            self._log_job_summary(job, result)
            self._count_job("ok" if ok else "failed")
            future._set_result(result)
        except BaseException as err:  # noqa: BLE001 — runner backstop
            self._count_job("crashed")
            future._set_exception(JobFailed(
                f"job {job.job_id} runner died: {err!r}"))
        finally:
            with self._lock:
                self._active.pop(job.job_id, None)
                self._threads.pop(job.job_id, None)
                n_active = len(self._active)
            self._gauge("multigrad_job_active", n_active,
                        help="job DAGs currently executing")

    def _execute_dag(self, job: Job, future: JobFuture, job_ctx,
                     results: Dict[str, StageResult]):
        pending = [s for s in job.stages if s.name not in results]
        while pending:
            ready, blocked = [], []
            for s in pending:
                if any(d in results and not results[d].ok
                       for d in s.deps):
                    results[s.name] = StageResult(
                        name=s.name, outcome="skipped",
                        error="upstream stage failed")
                    # Count-before-settle, as in _run_stage_guarded:
                    # a dashboard woken by the stage must see it
                    # already accounted.
                    self._count_stage(job, "skipped")
                    future._stage_settled(results[s.name])
                elif all(d in results for d in s.deps):
                    ready.append(s)
                else:
                    blocked.append(s)
            pending = blocked
            if not ready:
                if pending:
                    # Unreachable for a validated DAG (Job() proved
                    # acyclicity, and _run_stage_guarded guarantees
                    # every executed stage lands in `results`): fail
                    # loudly instead of spinning on `while pending`.
                    raise RuntimeError(
                        f"job {job.job_id}: no runnable stage among "
                        f"pending "
                        f"{[s.name for s in pending]} — DAG "
                        "invariant broken")
                continue
            if len(ready) == 1:
                self._run_stage_guarded(job, ready[0], job_ctx,
                                        results, future)
            else:
                # Independent ready stages genuinely overlap — each
                # on its own thread, writing a distinct results key
                # (inserts are serialized by _results_lock).
                threads = []
                for stage in ready:
                    t = threading.Thread(
                        target=self._run_stage_guarded,
                        args=(job, stage, job_ctx, results, future),
                        daemon=True,
                        name=f"mgt-job-{job.job_id}-{stage.name}")
                    threads.append(t)
                    t.start()
                for t in threads:
                    t.join()

    def _run_stage_guarded(self, job: Job, stage: Stage, job_ctx,
                           results: Dict[str, StageResult],
                           future: JobFuture) -> StageResult:
        """One stage, exception-proof end to end.

        Whatever escapes the stage machinery (a tracer sink, a
        metrics backend, an unwritable ``checkpoint_dir``) must still
        record a :class:`StageResult`: a worker thread dying without
        one would either spin the DAG loop forever (dependents never
        become ready) or let the job settle ``ok`` with the stage
        silently absent from its results.
        """
        try:
            result = self._run_stage(job, stage, job_ctx, results)
        except BaseException as err:  # noqa: BLE001 — thread backstop
            result = StageResult(
                name=stage.name, outcome="failed",
                attempts=self.max_stage_attempts, error=repr(err))
        with self._results_lock:
            results[stage.name] = result
        try:
            self._count_stage(job, result.outcome)
            future._stage_settled(result)
            if result.ok:
                self._write_checkpoint(job, job_ctx, results)
        except Exception as err:
            # Bookkeeping is best-effort: the stage outcome is
            # already recorded, so a checkpoint/metrics failure must
            # not kill the worker thread (it only means a resume
            # re-runs this stage).
            self._note_bookkeeping_error(job, stage, err)
        return result

    def _run_stage(self, job: Job, stage: Stage, job_ctx,
                   results: Dict[str, StageResult]) -> StageResult:
        with self._results_lock:
            # Sibling fan-out stages insert keys concurrently; an
            # unguarded comprehension can raise "dictionary changed
            # size during iteration".
            artifacts = {name: r.artifact
                         for name, r in results.items()
                         if r.ok and r.artifact is not None}
        last_error: Optional[BaseException] = None
        for attempt in range(1, self.max_stage_attempts + 1):
            stage_ctx = job_ctx.child() if job_ctx is not None \
                else None
            rt = StageRuntime(
                job_id=job.job_id, stage=stage.name,
                backend=self.backend, model=self.model,
                artifacts=artifacts, stage_ctx=stage_ctx,
                tracer=self.tracer, telemetry=self.telemetry,
                backend_records_request_span=(
                    self._backend_records_request_span),
                fit_timeout_s=self.fit_timeout_s,
                tenant=job.tenant,
                priority_class=job.priority_class)
            t0 = time.time()
            try:
                artifact = stage.run(rt)
            except BaseException as err:  # noqa: BLE001 — retried
                last_error = err
                if self.tracer is not None and stage_ctx is not None:
                    self.tracer.record(
                        stage_ctx, "stage", t0, time.time(),
                        ok=False, stage=stage.name,
                        job_id=job.job_id, attempt=attempt,
                        error=repr(err))
                continue
            elapsed = time.time() - t0
            if self.tracer is not None and stage_ctx is not None:
                self.tracer.record(
                    stage_ctx, "stage", t0, time.time(),
                    stage=stage.name, job_id=job.job_id,
                    attempt=attempt)
            return StageResult(
                name=stage.name, outcome="ok", artifact=artifact,
                elapsed_s=round(elapsed, 6), attempts=attempt)
        return StageResult(
            name=stage.name, outcome="failed",
            elapsed_s=0.0, attempts=self.max_stage_attempts,
            error=repr(last_error))

    # ------------------------------------------------------------------ #
    # tracing / checkpoints / observability
    # ------------------------------------------------------------------ #
    def _job_context(self, job: Job, restored: dict):
        if self.tracer is None:
            return None
        trace = restored.get("trace") or {}
        trace_id, span_id = trace.get("trace_id"), trace.get("span_id")
        if trace_id and span_id:
            # A resumed job continues its ORIGINAL trace: the root
            # span is only recorded at settle, so the final waterfall
            # is one complete tree across runner generations.
            from ..telemetry.tracing import TraceContext
            return TraceContext(trace_id, span_id, None)
        return self.tracer.new_trace()

    def _checkpoint_path(self, job: Job) -> Optional[str]:
        if self.checkpoint_dir is None:
            return None
        return os.path.join(self.checkpoint_dir,
                            f"{job.job_id}.json")

    def _restore_checkpoint(self, job: Job) -> dict:
        path = self._checkpoint_path(job)
        if path is None or not os.path.exists(path):
            return {}
        try:
            with open(path) as f:
                state = json.load(f)
        except (OSError, ValueError):
            # A torn checkpoint restores nothing — the job simply
            # re-runs from the top (atomic-rename writes make this
            # unreachable short of filesystem corruption).
            return {}
        if state.get("job_id") != job.job_id:
            return {}
        return state

    def _write_checkpoint(self, job: Job, job_ctx,
                          results: Dict[str, StageResult]):
        path = self._checkpoint_path(job)
        if path is None:
            return
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        # Snapshot AND publish under the results lock: concurrent
        # fan-out writers are serialized, so the tmp file is never
        # co-written and the LAST published checkpoint always
        # reflects every stage settled before it (each writer
        # inserts its result before writing, under the same lock).
        with self._results_lock:
            stages = {}
            for r in results.values():
                if r.ok:
                    stages[r.name] = {
                        "outcome": "ok", "artifact": r.artifact,
                        "elapsed_s": r.elapsed_s,
                        "attempts": r.attempts,
                    }
            state = {
                "job_id": job.job_id,
                "t": time.time(),
                "trace": ({"trace_id": job_ctx.trace_id,
                           "span_id": job_ctx.span_id}
                          if job_ctx is not None else None),
                "stages": stages,
            }
            tmp = (f"{path}.tmp-{os.getpid()}"
                   f"-{threading.get_ident()}")
            with open(tmp, "w") as f:
                json.dump(state, f)
            os.replace(tmp, path)  # atomic: a reader sees old or new

    def _note_bookkeeping_error(self, job: Job, stage: Stage, err):
        """Best-effort telemetry for non-fatal stage bookkeeping
        failures (checkpoint IO, metrics sinks)."""
        if self.telemetry is None:
            return
        try:
            self.telemetry.log(
                "job_bookkeeping_error", job_id=job.job_id,
                stage=stage.name, error=repr(err))
        except Exception:
            pass

    def _log_job_summary(self, job: Job, result: JobResult):
        if self.telemetry is None:
            return
        stages = []
        for s in job.stages:
            r = result.stages.get(s.name)
            if r is None:
                continue
            entry = {"stage": s.name, "outcome": r.outcome,
                     "elapsed_s": r.elapsed_s,
                     "attempts": r.attempts}
            if r.artifact and "n_fits" in r.artifact:
                entry["n_fits"] = r.artifact["n_fits"]
            if r.artifact and "verdicts" in r.artifact:
                entry["verdicts"] = r.artifact["verdicts"]
            if r.error:
                entry["error"] = r.error
            stages.append(entry)
        self.telemetry.log(
            "job_summary", job_id=result.job_id, ok=result.ok,
            elapsed_s=result.elapsed_s, trace_id=result.trace_id,
            n_stages=len(job.stages), stages=stages)

    def _gauge(self, name, value, help=None, labels=None):
        if self._metrics is not None:
            self._metrics.set(name, float(value), help=help,
                              labels=labels)

    def _count_job(self, outcome: str):
        if self._metrics is not None:
            self._metrics.inc("multigrad_jobs_total",
                              help="settled job DAGs, by outcome",
                              labels={"outcome": outcome})

    def _count_stage(self, job: Job, outcome: str):
        if self._metrics is not None:
            self._metrics.inc("multigrad_job_stages_total",
                              help="settled job stages, by outcome",
                              labels={"outcome": outcome})
