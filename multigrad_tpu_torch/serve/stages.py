"""Typed stages of a posterior-pipeline job DAG (port of
:mod:`multigrad_tpu.serve.stages`).

A real posterior analysis is a *pipeline*, not a fit: Latin-hypercube
scan → multi-start ensemble → Laplace proposal → HMC refinement →
posterior-predictive checks.  This module defines each of those as a
typed :class:`Stage` a :class:`~multigrad_tpu_torch.serve.jobs.Job` composes
into a DAG; the :class:`~multigrad_tpu_torch.serve.jobs.JobRunner` resolves
dependencies and calls each ready stage's :meth:`Stage.run` with a
:class:`StageRuntime` handle.

Execution split — the MPMD-pipeline shape (PAPERS.md,
arXiv:2412.14374) over this repo's planes:

* **Fit fan-out stages** (:class:`SweepStage`, :class:`EnsembleStage`,
  :class:`FitStage`) ride the serving plane: one shared
  :class:`~multigrad_tpu_torch.serve.queue.FitConfig` per stage (stamped
  with ``job_id``/``stage``, so the burst coalesces into its own
  bucket family and — through a fleet — keys its own worker
  affinity), submitted as a burst through the runner's backend
  (:class:`~multigrad_tpu_torch.serve.scheduler.FitScheduler` or
  :class:`~multigrad_tpu_torch.serve.fleet.FleetRouter`).
* **Host-side stages** (:class:`LaplaceStage`, :class:`HmcStage`,
  :class:`PredictiveCheckStage`) run on the runner's local model, on
  its device — HMC with ``k_sharded`` resolved through
  :func:`~multigrad_tpu_torch.inference.ensemble
  .resolve_k_shard_topology` (replicated: the port has no replica axis
  yet, and ``True`` raises) — because their products are exactly
  the small host-side artifacts the pipeline flows between stages.

Artifact contract: every stage returns a **JSON-able dict** of small
host-side values — best-basin params, a Laplace covariance, HMC
diagnostics — never catalogs (only O(|y|+|params|) crossing stage
boundaries, arXiv:2204.06514).  Tensors a stage reads off the model's
device come back to the host as numpy before they enter an artifact.
JSON-ability is what makes stage-boundary checkpoints (and therefore
lost-worker recovery) trivial; consumers re-materialize arrays with
``np.asarray``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import numpy as np

from .queue import FitConfig

__all__ = ["Stage", "StageRuntime", "FitStage", "SweepStage",
           "EnsembleStage", "LaplaceStage", "HmcStage",
           "PredictiveCheckStage"]


def _numpy(x) -> np.ndarray:
    """``x`` as a float64 host array (a tensor is copied off its
    device)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=float)


def _tolist(x):
    return _numpy(x).tolist()


@dataclass
class StageRuntime:
    """What a running stage may touch — handed to :meth:`Stage.run`
    by the job runner.

    Attributes
    ----------
    backend :
        The fit backend (``FitScheduler`` or ``FleetRouter``);
        :meth:`submit` / :meth:`run_fits` wrap it.
    model :
        The runner's local model (or fused
        :class:`~multigrad_tpu_torch.core.group.OnePointGroup`) for
        host-side stages; ``None`` when the runner was built purely
        over a fleet without a local model.
    artifacts : dict
        Completed upstream stages' artifacts, by stage name.
    stage_ctx :
        This stage's span context within the job trace (``None``
        with tracing off); per-fit submits go out as its children.
    """

    job_id: str
    stage: str
    backend: Any = None
    model: Any = None
    artifacts: dict = field(default_factory=dict)
    stage_ctx: Any = None
    tracer: Any = None
    telemetry: Any = None
    #: True when the backend records each fit's ``request`` span
    #: itself on a caller-supplied context (the fleet router's
    #: first-settle-wins root); False means run_fits records them so
    #: scheduler hop spans still resolve to a parent.
    backend_records_request_span: bool = False
    fit_timeout_s: Optional[float] = None
    #: The owning job's QoS identity (multigrad_tpu_torch.serve.qos):
    #: when set, every submit this stage fans out carries the tag —
    #: NOT part of the FitConfig, so same-config fits from different
    #: tenants still share a bucket.
    tenant: Optional[str] = None
    priority_class: Optional[str] = None

    def _qos_kwargs(self) -> dict:
        if self.tenant is None and self.priority_class is None:
            return {}
        from .qos import make_tag
        return {"qos": make_tag(None, self.tenant,
                                self.priority_class, None)}

    def config(self, **kwargs) -> FitConfig:
        """A stage-stamped :class:`FitConfig`: one per stage, so the
        whole burst shares a dispatch-group (and fleet-affinity)
        identity."""
        kwargs.setdefault("job_id", self.job_id)
        kwargs.setdefault("stage", self.stage)
        return FitConfig(**kwargs)

    def submit(self, guess, config: FitConfig):
        """Submit one fit, parented into this stage's trace span."""
        kwargs = self._qos_kwargs()
        if self.stage_ctx is not None:
            kwargs["trace"] = self.stage_ctx.child()
        return self.backend.submit(np.asarray(guess, dtype=float),
                                   config=config, **kwargs)

    def run_fits(self, guesses, config: FitConfig):
        """Fan a burst of fits out through the backend and gather.

        Submits every guess (the shared ``config`` makes the burst
        bucket-coalescible), blocks for all results, and — when the
        backend does not itself close caller-supplied contexts —
        records each fit's ``request`` span so the dispatch hops
        recorded under it resolve in the merged waterfall.

        Returns ``(params, losses)`` as ``(K, ndim)`` / ``(K,)``
        numpy arrays, in submit order.  Raises the first fit's
        exception on failure (the runner's stage-retry machinery
        owns recovery).
        """
        import time as _time
        pairs = []
        qos_kwargs = self._qos_kwargs()
        for guess in guesses:
            trace = self.stage_ctx.child() \
                if self.stage_ctx is not None else None
            t0 = _time.time()
            future = self.backend.submit(
                np.asarray(guess, dtype=float), config=config,
                **qos_kwargs,
                **({"trace": trace} if trace is not None else {}))
            pairs.append((future, trace, t0))
        params, losses = [], []
        first_error = None
        for future, trace, t0 in pairs:
            try:
                result = future.result(timeout=self.fit_timeout_s)
            except BaseException as err:
                if self.tracer is not None and trace is not None \
                        and not self.backend_records_request_span:
                    self.tracer.record(trace, "request", t0,
                                       ok=False, outcome="failed",
                                       job_id=self.job_id,
                                       stage=self.stage)
                if first_error is None:
                    first_error = err
                continue
            if self.tracer is not None and trace is not None \
                    and not self.backend_records_request_span:
                self.tracer.record(trace, "request", t0,
                                   outcome="ok", job_id=self.job_id,
                                   stage=self.stage,
                                   request=result.request_id)
            params.append(np.asarray(result.params, dtype=float))
            losses.append(float(result.loss))
        if first_error is not None:
            raise first_error
        return np.asarray(params), np.asarray(losses)

    def require_model(self, stage_kind: str):
        if self.model is None:
            raise ValueError(
                f"{stage_kind} runs host-side on the runner's local "
                "model; construct JobRunner(model=...) (a FleetRouter "
                "backend carries no model of its own)")
        return self.model

    def artifact(self, dep: str) -> dict:
        if dep not in self.artifacts:
            raise KeyError(
                f"stage {self.stage!r} needs upstream artifact "
                f"{dep!r}, have {sorted(self.artifacts)}")
        return self.artifacts[dep]


@dataclass
class Stage:
    """One node of a job DAG.

    ``name`` keys the stage's artifact, checkpoint entry, trace
    label, and ``FitConfig.stage`` stamp; ``deps`` are upstream stage
    names whose artifacts :meth:`run` may read.  Subclasses override
    :meth:`run` to return the stage's JSON-able artifact dict.
    """

    name: str
    deps: Tuple[str, ...] = ()

    def __post_init__(self):
        if not self.name or not isinstance(self.name, str):
            raise ValueError("stage name must be a non-empty string")
        self.deps = tuple(str(d) for d in self.deps)

    def run(self, rt: StageRuntime) -> dict:
        raise NotImplementedError

    def _upstream_best(self, rt: StageRuntime):
        """Best-basin params from the first dep exposing one (the
        standard artifact flow: sweep → ensemble → laplace/hmc)."""
        for dep in self.deps:
            art = rt.artifacts.get(dep) or {}
            if "best_params" in art:
                return np.asarray(art["best_params"], dtype=float)
        raise KeyError(
            f"stage {self.name!r}: no dependency artifact carries "
            f"'best_params' (deps: {self.deps})")


@dataclass
class FitStage(Stage):
    """Generic fit fan-out: one served fit per row of ``guesses``."""

    guesses: Any = None
    nsteps: int = 100
    learning_rate: float = 0.01
    param_bounds: Optional[tuple] = None
    randkey: Optional[int] = None

    def run(self, rt: StageRuntime) -> dict:
        guesses = np.atleast_2d(np.asarray(self.guesses, dtype=float))
        config = rt.config(
            nsteps=self.nsteps, learning_rate=self.learning_rate,
            param_bounds=self.param_bounds, randkey=self.randkey)
        params, losses = rt.run_fits(guesses, config)
        best = int(np.argmin(losses))
        return {"params": _tolist(params), "losses": _tolist(losses),
                "best_params": _tolist(params[best]),
                "best_loss": float(losses[best]),
                "n_fits": int(len(losses))}


@dataclass
class SweepStage(Stage):
    """Latin-hypercube scan: ``n_points`` short bounded fits over the
    prior box — the cheap basin-finding pass.  ``param_bounds`` is
    required (it IS the scan box)."""

    n_points: int = 16
    nsteps: int = 30
    learning_rate: float = 0.05
    param_bounds: Optional[tuple] = None
    seed: int = 0

    def run(self, rt: StageRuntime) -> dict:
        if self.param_bounds is None:
            raise ValueError(
                f"SweepStage {self.name!r} requires param_bounds "
                "(the scan box)")
        from ..utils.util import latin_hypercube_sampler
        low = np.asarray([b[0] for b in self.param_bounds], float)
        high = np.asarray([b[1] for b in self.param_bounds], float)
        inits = latin_hypercube_sampler(low, high, len(low),
                                        self.n_points, seed=self.seed)
        config = rt.config(
            nsteps=self.nsteps, learning_rate=self.learning_rate,
            param_bounds=self.param_bounds)
        params, losses = rt.run_fits(inits, config)
        best = int(np.argmin(losses))
        return {"params": _tolist(params), "losses": _tolist(losses),
                "best_params": _tolist(params[best]),
                "best_loss": float(losses[best]),
                "n_fits": int(len(losses))}


@dataclass
class EnsembleStage(Stage):
    """Multi-start refinement: long bounded fits from the upstream
    scan's ``n_starts`` best distinct basins (falling back to the
    single upstream best scattered by ``spread`` when the upstream
    artifact carries no per-start table)."""

    n_starts: int = 4
    nsteps: int = 200
    learning_rate: float = 0.01
    param_bounds: Optional[tuple] = None
    spread: float = 0.02
    seed: int = 0

    def _inits(self, rt: StageRuntime) -> np.ndarray:
        for dep in self.deps:
            art = rt.artifacts.get(dep) or {}
            if "params" in art and "losses" in art:
                params = np.asarray(art["params"], dtype=float)
                losses = np.asarray(art["losses"], dtype=float)
                order = np.argsort(losses)[:self.n_starts]
                inits = params[order]
                if len(inits) == self.n_starts:
                    return inits
        best = self._upstream_best(rt)
        rng = np.random.default_rng(self.seed)
        return best[None, :] + self.spread * rng.standard_normal(
            (self.n_starts, best.shape[0]))

    def run(self, rt: StageRuntime) -> dict:
        config = rt.config(
            nsteps=self.nsteps, learning_rate=self.learning_rate,
            param_bounds=self.param_bounds)
        params, losses = rt.run_fits(self._inits(rt), config)
        best = int(np.argmin(losses))
        return {"params": _tolist(params), "losses": _tolist(losses),
                "best_params": _tolist(params[best]),
                "best_loss": float(losses[best]),
                "n_fits": int(len(losses))}


@dataclass
class LaplaceStage(Stage):
    """Gauss–Newton Fisher + Laplace covariance at the upstream best
    basin — the O(ndim²) host-side proposal the HMC stage warms up
    from."""

    jitter: float = 1e-6
    randkey: Optional[int] = None

    def run(self, rt: StageRuntime) -> dict:
        model = rt.require_model("LaplaceStage")
        from ..inference.fisher import fisher_information
        best = self._upstream_best(rt)
        fisher = fisher_information(model, best,
                                    randkey=self.randkey)
        cov = _numpy(fisher.covariance(jitter=self.jitter))
        stderr = _numpy(fisher.stderr(jitter=self.jitter))
        return {"best_params": _tolist(best),
                "covariance": _tolist(cov),
                "stderr": _tolist(stderr),
                "fisher": _tolist(fisher.fisher)}


@dataclass
class HmcStage(Stage):
    """Multi-chain HMC refinement around the upstream basin, warmed
    by the Laplace proposal when one is upstream (chain inits
    scattered by the Laplace stderr; inverse mass set to the Laplace
    variances).  Runs host-side on the runner's local model, on its
    device; ``k_sharded="auto"`` resolves to the replicated sampler
    (the port has no replica axis yet) and ``True`` raises."""

    num_samples: int = 300
    num_warmup: int = 200
    num_chains: int = 4
    num_leapfrog: int = 8
    step_size: float = 0.1
    target_accept: float = 0.8
    init_spread: float = 1.0
    randkey: int = 0
    keep_samples: bool = False
    k_sharded: Any = "auto"

    def _laplace(self, rt: StageRuntime) -> Optional[dict]:
        for dep in self.deps:
            art = rt.artifacts.get(dep) or {}
            if "stderr" in art:
                return art
        return None

    def run(self, rt: StageRuntime) -> dict:
        model = rt.require_model("HmcStage")
        from ..inference.ensemble import resolve_k_shard_topology
        from ..inference.hmc import run_hmc
        best = self._upstream_best(rt)
        laplace = self._laplace(rt)
        inv_mass = None
        init = best
        spread = 0.0
        if laplace is not None:
            stderr = np.asarray(laplace["stderr"], dtype=float)
            finite = np.isfinite(stderr) & (stderr > 0)
            stderr = np.where(finite, stderr, 1e-3)
            inv_mass = stderr ** 2
            rng = np.random.default_rng(self.randkey)
            init = best[None, :] + self.init_spread * stderr \
                * rng.standard_normal((self.num_chains,
                                       best.shape[0]))
        else:
            spread = self.init_spread * 1e-2
        k_sharded, _ = resolve_k_shard_topology(model, self.k_sharded)
        result = run_hmc(
            model, init, num_samples=self.num_samples,
            num_warmup=self.num_warmup, num_chains=self.num_chains,
            step_size=self.step_size, num_leapfrog=self.num_leapfrog,
            inv_mass=inv_mass, target_accept=self.target_accept,
            randkey=self.randkey, init_spread=spread,
            telemetry=rt.telemetry, k_sharded=k_sharded)
        samples = np.asarray(result.samples)
        flat = samples.reshape(-1, samples.shape[-1])
        artifact = {
            "best_params": _tolist(flat.mean(axis=0)),
            "posterior_mean": _tolist(flat.mean(axis=0)),
            "posterior_stderr": _tolist(flat.std(axis=0)),
            "rhat": _tolist(result.rhat),
            "ess": _tolist(result.ess),
            "accept_prob": _tolist(result.accept_prob),
            "divergences": _tolist(result.divergences),
            "num_chains": int(samples.shape[0]),
            "num_samples": int(samples.shape[1]),
            "k_sharded": bool(k_sharded),
        }
        if self.keep_samples:
            artifact["samples"] = _tolist(samples)
        else:
            # The predictive-check stage needs draws, not the whole
            # chain: a small thinned tail rides the artifact.
            keep = min(64, flat.shape[0])
            step = max(1, flat.shape[0] // keep)
            artifact["draws"] = _tolist(flat[::step][:keep])
        return artifact


@dataclass
class PredictiveCheckStage(Stage):
    """Posterior-predictive sanity gate: evaluate the joint loss over
    posterior draws (one batched call on the model's device) and
    verdict the
    posterior against the basin it came from.  Verdicts land in the
    artifact AND as a ``predictive_check`` telemetry record, so
    ``/status`` and the report CLI surface a failed check without
    touching the artifact store."""

    max_draws: int = 64
    #: Fail the check when fewer than this fraction of draw losses
    #: are finite.
    min_finite_frac: float = 0.99
    #: Fail when the median draw loss exceeds the loss at the
    #: posterior mean by more than this many units of scale, where
    #: ``scale = max(|loss_at_mean|, 1)`` — a posterior that wandered
    #: off its basin.  A shifted excess rather than a ratio, so the
    #: threshold keeps its teeth for negative (log-likelihood-style)
    #: losses, where any negative median would make a ratio
    #: trivially small; tighten it well below 1 for such losses.
    max_median_excess: float = 50.0

    def _draws(self, rt: StageRuntime):
        for dep in self.deps:
            art = rt.artifacts.get(dep) or {}
            for key in ("draws", "samples"):
                if key in art:
                    draws = np.asarray(art[key], dtype=float)
                    draws = draws.reshape(-1, draws.shape[-1])
                    return draws[:self.max_draws], art
        raise KeyError(
            f"stage {self.name!r}: no dependency artifact carries "
            f"posterior 'draws'/'samples' (deps: {self.deps})")

    def run(self, rt: StageRuntime) -> dict:
        from ..inference.ensemble import float32_on
        model = rt.require_model("PredictiveCheckStage")
        draws, upstream = self._draws(rt)
        mean = np.asarray(
            upstream.get("posterior_mean",
                         upstream.get("best_params")), dtype=float)
        program = model.batched_loss_and_grad_fn(False)
        batch = float32_on(np.vstack([mean[None, :], draws]),
                           model.device)
        losses, _ = program(batch, model.aux_leaves())
        losses = _numpy(losses)
        loss_at_mean = float(losses[0])
        draw_losses = losses[1:]
        finite = np.isfinite(draw_losses)
        finite_frac = float(np.mean(finite)) if draw_losses.size \
            else 0.0
        median = float(np.median(draw_losses[finite])) \
            if finite.any() else math.inf
        scale = max(abs(loss_at_mean), 1.0)
        median_excess = (median - loss_at_mean) / scale \
            if math.isfinite(median) else math.inf
        verdicts = {
            "finite": finite_frac >= self.min_finite_frac,
            "concentrated": median_excess <= self.max_median_excess,
        }
        ok = all(verdicts.values())
        artifact = {
            "ok": bool(ok),
            "verdicts": {k: bool(v) for k, v in verdicts.items()},
            "n_draws": int(draw_losses.size),
            "finite_frac": finite_frac,
            "loss_at_mean": loss_at_mean,
            "median_draw_loss": median,
            "median_excess": float(median_excess)
            if math.isfinite(median_excess) else None,
        }
        if rt.telemetry is not None:
            rt.telemetry.log(
                "predictive_check", job_id=rt.job_id,
                stage=rt.stage, **artifact)
        return artifact
