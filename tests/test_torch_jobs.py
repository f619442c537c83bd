"""The port's job pipeline (``serve/jobs.py`` + ``serve/stages.py``)
against ``tests/test_jobs.py``, on the CPU.

* DAG hygiene, stage retry, checkpoint restore and its trace, the
  bookkeeping backstops, the wire stamps and the predictive-check
  verdicts: the JAX package's cases on the port's classes (backend-free
  stages; the check over a fake model whose batched call returns canned
  losses).
* The end-to-end job on the joint SMF + wp(rp) model (256 wp(rp) and
  1,024 SMF halos: the JAX package's arrays carried into the port with
  ``aux_from_numpy``, as ``tests/test_torch_joint.py`` does) through the
  port's ``FitScheduler``: scan → ensemble → Laplace → HMC → check, one
  complete trace, the gauges and the report's ``job:`` section; then
  held stage by stage against the JAX package's ``JobRunner`` on the
  same inputs.  The scan against the JAX scan (the same
  ``latin_hypercube_sampler`` seed); the ensemble against the JAX
  ensemble run from the port's scan artifact (restored from a
  checkpoint, so both start from the same basins: the scan's two best
  losses sit within 1e-4 relative of each other here, and the packages
  may rank them differently); the Laplace covariance against the JAX
  ``fisher_information`` at the port's best; the check's losses against
  the JAX batched losses on the port's draws.  HMC is held on structure
  and finiteness only: the port's noise comes from ``torch.Generator``
  and matches the JAX sampler's in distribution only.  The JAX test's
  recovery assertion is not copied (at 256 wp(rp) halos the third
  parameter is barely constrained).
* The job over a ``FleetRouter`` of two port workers, the worker holding
  the ensemble burst SIGKILL'd mid-stage: the job settles ok with no
  stage run twice, the ensemble's rows equal solo fits, one trace.

Tolerances.  Fitted parameters atol 1e-3 (measured within 1e-4); losses
rtol 1e-2 with atol 1e-2 (measured within 5e-3 relative: near its
minimum the joint loss is a small difference the wp(rp) counts' float32
rounding moves, beyond ``test_torch_joint.py``'s 1e-3 at larger losses);
the Laplace covariance rtol 1e-3 (the JAX test's Laplace limit; measured
within 3e-6).  Served rows against solo fits: rtol 1e-6 (bit-equal on
the CPU).
"""
import json
import os
import time
from dataclasses import dataclass, field

import numpy as np
import pytest
import torch

from multigrad_tpu.models import joint as jj
from multigrad_tpu_torch.models import aux_from_numpy
from multigrad_tpu_torch.models import joint as tj
from multigrad_tpu_torch.serve import (ChaosController, EnsembleStage,
                                       FitScheduler, FleetRouter, HmcStage,
                                       Job, JobRunner, LaplaceStage,
                                       PredictiveCheckStage, Stage,
                                       SweepStage)
from multigrad_tpu_torch.serve.stages import StageRuntime
from multigrad_tpu_torch.telemetry import (JsonlSink, MemorySink,
                                           MetricsLogger)
from multigrad_tpu_torch.telemetry import report as report_cli
from multigrad_tpu_torch.telemetry import trace as trace_cli
from multigrad_tpu_torch.telemetry.tracing import Tracer

JOINT_BOUNDS = ((-3.5, -0.5), (0.02, 1.0), (-2.5, 0.5))
WP_HALOS, SMF_HALOS, SEED = 256, 1_024, 2
PARAM_ATOL, LOSS_RTOL, LOSS_ATOL, COV_RTOL, SOLO_RTOL = \
    1e-3, 1e-2, 1e-2, 1e-3, 1e-6
STAGES = ("scan", "ensemble", "laplace", "hmc", "check")


# ------------------------------------------------------------------ #
# DAG hygiene (backend-free stages)
# ------------------------------------------------------------------ #
@dataclass
class NoteStage(Stage):
    """Appends its name to a shared log and returns a tiny artifact."""

    log: list = field(default_factory=list)
    fail_times: int = 0
    payload: dict = field(default_factory=dict)

    def run(self, rt):
        self.log.append(self.name)
        if self.fail_times > 0:
            self.fail_times -= 1
            raise RuntimeError(f"{self.name} injected failure")
        return {"stage": self.name, **self.payload,
                "upstream": sorted(rt.artifacts)}


def test_job_validation():
    job = Job(stages=(NoteStage("a"), NoteStage("b", deps=("a",))))
    assert job.job_id.startswith("job-")
    assert len(Job(stages=NoteStage("solo")).stages) == 1
    with pytest.raises(ValueError, match="duplicate"):
        Job(stages=(NoteStage("x"), NoteStage("x")))
    with pytest.raises(ValueError, match="unknown"):
        Job(stages=(NoteStage("x", deps=("ghost",)),))
    with pytest.raises(ValueError, match="cycle"):
        Job(stages=(NoteStage("x", deps=("y",)),
                    NoteStage("y", deps=("x",))))
    with pytest.raises(ValueError, match="at least one"):
        Job(stages=())


def test_failed_stage_skips_dependents_and_settles():
    log, sink = [], MemorySink()
    runner = JobRunner(backend=None, telemetry=MetricsLogger(sink),
                       max_stage_attempts=1)
    result = runner.run(Job(stages=(
        NoteStage("a", log=log),
        NoteStage("boom", deps=("a",), log=log, fail_times=5),
        NoteStage("after", deps=("boom",), log=log),
        NoteStage("side", deps=("a",), log=log))), timeout=30)
    assert not result.ok
    assert result.outcomes() == {"a": "ok", "boom": "failed",
                                 "after": "skipped", "side": "ok"}
    assert "after" not in log
    assert result.stages["boom"].error is not None
    recs = [r for r in sink.records if r["event"] == "job_summary"]
    assert len(recs) == 1 and recs[0]["ok"] is False
    assert {s["stage"]: s["outcome"] for s in recs[0]["stages"]}[
        "after"] == "skipped"


def test_stage_retry_succeeds_within_job():
    log = []
    result = JobRunner(backend=None, max_stage_attempts=2).run(
        Job(stages=(NoteStage("flaky", log=log, fail_times=1),)),
        timeout=30)
    assert result.ok and result.stages["flaky"].attempts == 2
    assert log == ["flaky", "flaky"]


def test_artifacts_flow_to_dependents():
    result = JobRunner(backend=None).run(Job(stages=(
        NoteStage("up", payload={"value": 7}),
        NoteStage("down", deps=("up",)))), timeout=30)
    assert result.ok
    assert result.artifact("up")["value"] == 7
    assert result.artifact("down")["upstream"] == ["up"]


def test_duplicate_submit_rejected_while_running():
    runner = JobRunner(backend=None)
    slow = NoteStage("slow")
    orig_run = slow.run

    def stalling_run(rt):
        time.sleep(0.3)
        return orig_run(rt)

    slow.run = stalling_run
    fut = runner.submit(Job(stages=(slow,), job_id="job-dup"))
    with pytest.raises(ValueError, match="already running"):
        runner.submit(Job(stages=(NoteStage("other"),), job_id="job-dup"))
    assert fut.result(timeout=30).ok


def test_checkpoint_restores_completed_stages(tmp_path):
    trace_path = tmp_path / "trace.jsonl"
    tracer = Tracer(sink=str(trace_path), service="test")
    ckpt = str(tmp_path / "ckpt")
    log = []

    def make_job(fail_times):
        return Job(job_id="job-ck", stages=(
            NoteStage("a", log=log, payload={"value": 1}),
            NoteStage("b", deps=("a",), log=log, fail_times=fail_times)))

    runner = JobRunner(backend=None, tracer=tracer, checkpoint_dir=ckpt,
                       max_stage_attempts=1)
    r1 = runner.run(make_job(fail_times=5), timeout=30)
    assert not r1.ok and r1.stages["a"].outcome == "ok"
    with open(os.path.join(ckpt, "job-ck.json")) as f:
        state = json.load(f)
    assert set(state["stages"]) == {"a"}
    assert state["trace"]["trace_id"] == r1.trace_id
    r2 = runner.run(make_job(fail_times=0), timeout=30)
    assert r2.ok and r2.stages["a"].outcome == "restored"
    assert r2.stages["b"].outcome == "ok"
    assert log.count("a") == 1 and r2.artifact("a")["value"] == 1
    assert r2.trace_id == r1.trace_id
    mine = [s for s in trace_cli.load_spans([str(trace_path)])
            if s["trace_id"] == r2.trace_id]
    ids = {s["span_id"] for s in mine}
    assert not [s for s in mine if s.get("parent_span_id")
                and s["parent_span_id"] not in ids]


def test_unwritable_checkpoint_dir_fails_soft(tmp_path):
    blocked = tmp_path / "blocked"
    blocked.write_text("a file where the checkpoint dir should be")
    sink, log = MemorySink(), []
    result = JobRunner(backend=None, telemetry=MetricsLogger(sink),
                       checkpoint_dir=str(blocked)).run(Job(stages=(
                           NoteStage("a", log=log),
                           NoteStage("b", deps=("a",), log=log))),
                           timeout=30)
    assert result.ok and log == ["a", "b"]
    errs = [r for r in sink.records
            if r["event"] == "job_bookkeeping_error"]
    assert errs and "a" in {r["stage"] for r in errs}


def test_stage_bookkeeping_crash_records_failed_stage():
    class Ctx:
        trace_id, span_id = "t-1", "s-1"

        def child(self):
            return Ctx()

    class ExplodingTracer:
        def new_trace(self):
            return Ctx()

        def record(self, ctx, name, *a, **k):
            if name == "stage":
                raise OSError("trace sink is gone")

    log = []
    result = JobRunner(backend=None, tracer=ExplodingTracer(),
                       max_stage_attempts=1).run(Job(stages=(
                           NoteStage("a", log=log),
                           NoteStage("b", deps=("a",), log=log))),
                           timeout=30)
    assert not result.ok
    assert result.outcomes() == {"a": "failed", "b": "skipped"}
    assert "trace sink is gone" in result.stages["a"].error
    assert log == ["a"]


def test_fanout_checkpoint_reflects_all_settled_stages(tmp_path):
    @dataclass
    class SlowStage(NoteStage):
        sleep_s: float = 0.05

        def run(self, rt):
            time.sleep(self.sleep_s)
            return super().run(rt)

    ckpt = tmp_path / "ckpt"
    assert JobRunner(backend=None, checkpoint_dir=str(ckpt)).run(Job(
        job_id="job-fan", stages=(SlowStage("left"), SlowStage("right"),
                                  SlowStage("mid"))), timeout=30).ok
    with open(ckpt / "job-fan.json") as f:
        assert set(json.load(f)["stages"]) == {"left", "right", "mid"}


def test_torn_checkpoint_restores_nothing(tmp_path):
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "job-torn.json").write_text('{"job_id": "job-to')
    log = []
    assert JobRunner(backend=None, checkpoint_dir=str(ckpt)).run(Job(
        job_id="job-torn", stages=(NoteStage("a", log=log),)),
        timeout=30).ok
    assert log == ["a"]


def test_job_decorated_config_at_undecorated_worker():
    from multigrad_tpu_torch.serve.queue import FitConfig, FitResult
    from multigrad_tpu_torch.serve.wire import (config_from_wire,
                                                config_to_wire,
                                                result_from_wire,
                                                result_to_wire)
    decorated = FitConfig(nsteps=7, learning_rate=0.05,
                          param_bounds=((-3.0, 0.0), None),
                          job_id="job-abc", stage="ensemble")
    wire = config_to_wire(decorated)
    assert config_from_wire(wire) == decorated
    legacy = config_from_wire({k: v for k, v in wire.items()
                               if k not in ("job_id", "stage")})
    assert legacy == FitConfig(nsteps=7, learning_rate=0.05,
                               param_bounds=((-3.0, 0.0), None))
    result = FitResult(request_id="r1", params=np.zeros(2), loss=0.1,
                       traj=np.zeros((1, 2)), steps=1, bucket=1,
                       wait_s=0.0, fit_s=0.1, job_id="job-abc",
                       stage="scan")
    assert result_from_wire(result_to_wire(result), "r1").stage == "scan"
    back = result_from_wire({k: v for k, v in result_to_wire(result).items()
                             if k not in ("job_id", "stage")}, "r1")
    assert back.job_id is None and back.stage is None


def test_stage_stamp_separates_dispatch_groups():
    from multigrad_tpu_torch.serve.queue import FitConfig
    base = dict(nsteps=5, learning_rate=0.01)
    scan = FitConfig(**base, job_id="j", stage="scan")
    assert scan == FitConfig(**base, job_id="j", stage="scan")
    assert scan != FitConfig(**base, job_id="j", stage="ensemble")
    assert scan != FitConfig(**base)
    with pytest.raises(TypeError, match="str or None"):
        FitConfig(**base, job_id=7)


# ------------------------------------------------------------------ #
# predictive-check verdicts
# ------------------------------------------------------------------ #
class _FixedLossModel:
    """The batched call returns canned per-row losses (row 0 is the
    posterior mean by the stage's batch layout); the batch it is handed
    must be float32 on the model's device."""

    device = torch.device("cpu")

    def __init__(self, losses):
        self._losses = torch.tensor(losses, dtype=torch.float32)

    def batched_loss_and_grad_fn(self, with_key=False):
        def program(batch, aux, key=None):
            assert batch.dtype == torch.float32
            assert batch.device == self.device and key is None
            return self._losses[: batch.shape[0]], None
        return program

    def aux_leaves(self):
        return []


def _run_check(losses, **kwargs):
    stage = PredictiveCheckStage("check", deps=("hmc",), **kwargs)
    rt = StageRuntime(job_id="j", stage="check",
                      model=_FixedLossModel(losses),
                      artifacts={"hmc": {"draws": [[0.0]] * (len(losses) - 1),
                                         "posterior_mean": [0.0]}})
    return stage.run(rt)


def test_predictive_check_negative_losses_can_fail():
    art = _run_check([-1000.0] + [-1.0] * 8, max_median_excess=0.5)
    assert art["verdicts"]["concentrated"] is False and not art["ok"]
    assert art["median_excess"] == pytest.approx(0.999)
    assert _run_check([-1000.0] + [-999.5] * 8, max_median_excess=0.5)["ok"]


def test_predictive_check_positive_losses_unchanged():
    assert not _run_check([2.0] + [250.0] * 8)["verdicts"]["concentrated"]
    assert _run_check([2.0] + [2.5] * 8)["ok"]


# ------------------------------------------------------------------ #
# the whole pipeline as one job, against the JAX package's
# ------------------------------------------------------------------ #
def _np(aux):
    return {k: (np.asarray(v) if hasattr(v, "shape") else v)
            for k, v in aux.items()}


@pytest.fixture(scope="module")
def joint_pair():
    ref = jj.make_joint_smf_wprp(WP_HALOS, SMF_HALOS, comm=None, seed=SEED)
    port = tj._joint_group(*(aux_from_numpy(_np(m.aux_data), device="cpu")
                             for m in ref.models))
    return ref, port


def _stages(pkg, hmc=True):
    """The JAX test's job (its ensemble 60 steps shorter), from either
    package's stage classes."""
    out = (pkg.SweepStage("scan", n_points=4, nsteps=15, learning_rate=0.1,
                          param_bounds=JOINT_BOUNDS),
           pkg.EnsembleStage("ensemble", deps=("scan",), n_starts=2,
                             nsteps=40, learning_rate=0.02,
                             param_bounds=JOINT_BOUNDS),
           pkg.LaplaceStage("laplace", deps=("ensemble",)))
    if hmc:
        out += (pkg.HmcStage("hmc", deps=("ensemble", "laplace"),
                             num_samples=25, num_warmup=20, num_chains=2,
                             num_leapfrog=3),
                pkg.PredictiveCheckStage("check", deps=("hmc",),
                                         max_draws=16))
    return out


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got["params"]),
                               np.asarray(want["params"]), rtol=0,
                               atol=PARAM_ATOL)
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)


def test_job_pipeline_end_to_end(joint_pair, tmp_path):
    import multigrad_tpu.serve as jax_serve
    import multigrad_tpu_torch.serve as pt_serve
    from multigrad_tpu.inference.fisher import fisher_information
    from multigrad_tpu_torch.telemetry.live import LiveMetrics
    ref, port = joint_pair
    tel_path, trace_path = tmp_path / "telemetry.jsonl", tmp_path / "t.jsonl"
    telemetry = MetricsLogger(JsonlSink(str(tel_path)))
    tracer = Tracer(sink=str(trace_path), service="test")
    metrics = LiveMetrics()
    with FitScheduler(port, telemetry=telemetry, tracer=tracer) as sched:
        runner = JobRunner(sched, live=metrics,
                           checkpoint_dir=str(tmp_path / "ckpt"))
        assert runner.model is port
        fut = runner.submit(Job(job_id="job-e2e", stages=_stages(pt_serve)))
        result = fut.result(timeout=600)
    telemetry.close()

    assert result.ok
    assert result.outcomes() == dict.fromkeys(STAGES, "ok")
    assert all(r.attempts == 1 for r in result.stages.values())
    assert result.artifact("laplace")["stderr"]
    assert result.artifact("check")["ok"] and fut.stage_results["hmc"].ok
    hmc = result.artifact("hmc")
    assert hmc["num_chains"] == 2 and hmc["num_samples"] == 25
    assert np.asarray(hmc["draws"]).shape == (50, 3)
    assert np.all(np.isfinite(hmc["draws"]))
    assert all(np.isfinite(v) for k in ("rhat", "accept_prob",
                                        "posterior_mean")
               for v in hmc[k])
    assert hmc["k_sharded"] is False
    json.dumps(result.stages["hmc"].artifact)        # JSON-able

    snap = metrics.snapshot()
    assert any("ok" in labels for labels
               in snap["multigrad_jobs_total"]["samples"])
    assert "multigrad_job_stages_total" in snap
    assert "multigrad_job_active" in snap

    traces = trace_cli.group_traces(trace_cli.load_spans([str(trace_path)]))
    summary = trace_cli.trace_summary(result.trace_id,
                                      traces[result.trace_id])
    assert summary["complete"], summary
    assert summary["root"]["name"] == "job"
    assert set(summary["stages"]) == set(STAGES)
    assert all(st["ok"] for st in summary["stages"].values())
    waterfall = trace_cli.render_waterfall(result.trace_id,
                                           traces[result.trace_id])
    assert all(f"stage {s}" in waterfall for s in STAGES)
    assert "request [scan]" in waterfall

    records = report_cli.load_records(str(tel_path))
    folded = report_cli.summarize(records)
    assert folded["job"]["jobs"][0]["job_id"] == "job-e2e"
    assert folded["job"]["jobs"][0]["ok"]
    rendered = report_cli.render(folded)
    assert "job: job-e2e" in rendered
    assert "stage hmc: ok" in rendered and "check check: ok" in rendered
    checks = [r for r in records if r.get("event") == "predictive_check"]
    assert checks and checks[0]["job_id"] == "job-e2e"
    fits = [r for r in records if r.get("event") == "fit_summary"]
    assert {r.get("stage") for r in fits} >= {"scan", "ensemble"}

    # -- stage by stage against the JAX package on the same inputs ------
    ckpt = tmp_path / "jax_ckpt"
    ckpt.mkdir()
    with open(ckpt / "job-jax.json", "w") as f:
        json.dump({"job_id": "job-jax", "stages": {"scan": {
            "outcome": "ok", "artifact": result.artifact("scan"),
            "elapsed_s": 0.0, "attempts": 1}}}, f)
    with jax_serve.FitScheduler(ref) as jsched:
        jrunner = jax_serve.JobRunner(jsched, checkpoint_dir=str(ckpt))
        scan_only = jrunner.run(jax_serve.Job(
            job_id="job-scan", stages=_stages(jax_serve)[:1]), timeout=600)
        restored = jrunner.run(jax_serve.Job(
            job_id="job-jax", stages=_stages(jax_serve, hmc=False)[:2]),
            timeout=600)
    assert scan_only.ok and restored.ok
    assert restored.stages["scan"].outcome == "restored"
    _close(result.artifact("scan"), scan_only.artifact("scan"))
    _close(result.artifact("ensemble"), restored.artifact("ensemble"))

    best = np.asarray(result.artifact("ensemble")["best_params"])
    want = np.asarray(fisher_information(ref, best).covariance(jitter=1e-6))
    np.testing.assert_allclose(result.artifact("laplace")["covariance"],
                               want, rtol=COV_RTOL)

    import jax.numpy as jnp
    draws = np.asarray(hmc["draws"])[:16]
    batch = np.vstack([np.asarray(hmc["posterior_mean"])[None], draws])
    jl, _ = ref.batched_loss_and_grad_fn(False)(
        jnp.asarray(batch), ref.aux_leaves(), jnp.zeros(()))
    jl = np.asarray(jl, dtype=float)
    check = result.artifact("check")
    assert check["n_draws"] == 16 and check["finite_frac"] == 1.0
    np.testing.assert_allclose(
        [check["loss_at_mean"], check["median_draw_loss"]],
        [jl[0], np.median(jl[1:])], rtol=LOSS_RTOL, atol=LOSS_ATOL)


def test_job_over_fleet_survives_a_killed_worker(tmp_path):
    """The chip's phase 25 at the CPU's size: the job over two port
    workers serving the joint model, the worker holding the ensemble
    burst SIGKILL'd while it runs."""
    kwargs = {"num_halos": WP_HALOS, "smf_num_halos": SMF_HALOS,
              "seed": SEED, "device": "cpu"}
    local = tj.make_joint_smf_wprp(**kwargs)
    stages = (SweepStage("scan", n_points=4, nsteps=15, learning_rate=0.1,
                         param_bounds=JOINT_BOUNDS),
              EnsembleStage("ensemble", deps=("scan",), n_starts=4,
                            nsteps=120, learning_rate=0.02,
                            param_bounds=JOINT_BOUNDS),
              LaplaceStage("laplace", deps=("ensemble",)),
              HmcStage("hmc", deps=("laplace",), num_samples=5,
                       num_warmup=5, num_chains=2, num_leapfrog=2),
              PredictiveCheckStage("check", deps=("hmc",), max_draws=8))
    with FleetRouter(
            n_workers=2, device="cpu",
            model="multigrad_tpu_torch.models.joint:make_joint_smf_wprp",
            model_kwargs=kwargs, base_dir=str(tmp_path), buckets=(1, 4),
            batch_window_s=0.02, heartbeat_s=0.1, heartbeat_timeout_s=1.5,
            env=dict(os.environ, OMP_NUM_THREADS="1")) as router:
        chaos = ChaosController(router)
        killed = {}

        def holds_ensemble(r):
            for w in r.workers:
                if w.state == "up" and sum(
                        q.config.stage == "ensemble"
                        for q in list(w.inflight.values())) >= 4:
                    killed["id"] = w.id
                    return True
            return False

        fired = chaos.when(holds_ensemble,
                           lambda: chaos.kill(killed["id"]), timeout_s=120)
        runner = JobRunner(router, model=local)
        result = runner.run(Job(job_id="job-fleet", stages=stages),
                            timeout=300)
        assert fired.is_set()
        stats = router.stats
        trace_paths = router.trace_paths
        chaos.close()
    assert result.ok, result.outcomes()
    assert result.outcomes() == dict.fromkeys(STAGES, "ok")
    assert all(r.attempts == 1 for r in result.stages.values())
    assert stats["requeued"] >= 1 and stats["worker_deaths"] == 1
    ens = result.artifact("ensemble")
    scan = result.artifact("scan")
    inits = np.asarray(scan["params"])[np.argsort(scan["losses"])[:4]]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)              # the workers' one thread
    try:
        for init, row in zip(inits, ens["params"]):
            solo = local.run_adam(guess=init, nsteps=120,
                                  learning_rate=0.02,
                                  param_bounds=JOINT_BOUNDS,
                                  progress=False).numpy()
            np.testing.assert_allclose(row, solo[-1], rtol=SOLO_RTOL,
                                       atol=0)
    finally:
        torch.set_num_threads(threads)
    # Laplace ran in this process, on the local model: its artifact is
    # the Fisher matrix there, bit for bit.
    from multigrad_tpu_torch.inference import fisher_information
    fr = fisher_information(local, np.asarray(ens["best_params"]))
    assert result.artifact("laplace")["fisher"] \
        == fr.fisher.double().tolist()
    by_trace = trace_cli.group_traces(trace_cli.load_spans(trace_paths))
    summary = trace_cli.trace_summary(result.trace_id,
                                      by_trace[result.trace_id])
    assert summary["complete"], summary
    assert set(summary["stages"]) == set(STAGES)
