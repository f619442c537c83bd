"""The port's fit fleet (``serve/fleet.py`` + ``serve/chaos.py``) against
``tests/test_fleet.py``, case for case, on the CPU.

Real-process tier: a :class:`FleetRouter` over port worker subprocesses
(``python -m multigrad_tpu_torch.serve.worker --device cpu``, an SMF
model of 300 halos, one OpenMP thread each) driven by the
:class:`ChaosController` — config affinity with the ``/fleet`` view,
gauges and ``top``; SIGKILL mid-burst with 16 in flight (every future
resolves, the requeued fits equal solo fits, every merged trace
complete); SIGTERM drain; forced queue-full, then steal, then typed
shed; the heartbeat-loss requeue of a frozen worker (``slow``, as in the
JAX package).  No JAX worker is spawned: the reference for the served
values is the JAX package's ``FitScheduler`` in this process — what a
JAX router's SMF worker at the same size runs and returns verbatim over
the wire.

Unit tier: the requeue bookkeeping against in-process fake workers
(deadline, cancel, consumed poison retry, bounded requeues, typed
saturation), the scheduler's ``retried=True`` and dispatcher-death
backstop, and the ``LiveServer`` bind retry.

Tolerances.  Served against the JAX scheduler: trajectories at atol 1e-4
and losses at rtol 5e-4 plus ``|grad|_1 · 1e-4`` (the port's SMF parity
limits, ``tests/test_torch_serve.py``).  Requeued fits against solo fits
of the same guess in this process: rtol 1e-6 (bit-equal on the CPU; the
limit ``chip_smoke.py`` holds the card to).  Every wait has a limit.
"""
import contextlib
import io
import json
import os
import socket
import time
import urllib.request

import numpy as np
import pytest

from multigrad_tpu.models.smf import SMFModel as JaxSMFModel
from multigrad_tpu.models.smf import make_smf_data as jax_make_smf_data
from multigrad_tpu.serve import FitConfig as JaxFitConfig
from multigrad_tpu.serve import FitScheduler as JaxFitScheduler
import multigrad_tpu.serve.wire as jax_wire
from multigrad_tpu_torch.models import SMFModel, make_smf_data
from multigrad_tpu_torch.serve import (ChaosController, FitFailed,
                                       FitScheduler, FleetRouter,
                                       FleetSaturatedError,
                                       WorkerLostError)
from multigrad_tpu_torch.serve.fleet import FleetRequest, WorkerHandle
from multigrad_tpu_torch.serve.queue import (FitCancelled, FitConfig,
                                             FitDeadlineExceeded,
                                             FitFuture)
import multigrad_tpu_torch.serve.wire as pt_wire

N_HALOS = 300
WAIT_S = 120
TRAJ_ATOL, LOSS_RTOL, SOLO_RTOL = 1e-4, 5e-4, 1e-6
#: One OpenMP thread a worker: the rows are tiny, and 8 threads a
#: process on a shared host cost each CPU call several times its work.
ENV = dict(os.environ, OMP_NUM_THREADS="1")


def make_router(tmp_path, n_workers=2, **kw):
    kw.setdefault("model_kwargs", {"num_halos": N_HALOS})
    kw.setdefault("device", "cpu")
    kw.setdefault("buckets", (1, 4, 16))
    kw.setdefault("batch_window_s", 0.02)
    kw.setdefault("heartbeat_s", 0.1)
    kw.setdefault("heartbeat_timeout_s", 1.5)
    kw.setdefault("chaos", True)
    kw.setdefault("env", ENV)
    return FleetRouter(n_workers=n_workers, base_dir=str(tmp_path), **kw)


def affinity_home(router, config, ndim=2):
    """The worker a config's traffic lands on (rendezvous hashing over
    the batchability key)."""
    req = FleetRequest(id="probe", guess=np.zeros(ndim),
                       config=config, future=FitFuture("probe"))
    return router._affinity_order(req.key)[0]


def safe_guesses(n, lo=-2.2, hi=-1.5):
    return [np.array([lo + (hi - lo) * i / max(n - 1, 1),
                      0.4 + 0.02 * (i % 5)]) for i in range(n)]


def launch_records(path):
    with open(path) as f:
        return [r for r in map(json.loads, f)
                if r.get("event") == "kernel_launches"]


# ------------------------------------------------------------------ #
# real-process fleet: routing, affinity, /fleet plane, JAX parity
# ------------------------------------------------------------------ #
def test_fleet_serves_with_config_affinity(tmp_path):
    from multigrad_tpu_torch.telemetry import LiveServer
    from multigrad_tpu_torch.telemetry.top import collect_rows, render_rows
    live = LiveServer(port=0)
    keys = (1, 2, 3)
    try:
        with make_router(tmp_path, live=live,
                         worker_live_port=0) as router:
            configs = [FitConfig(nsteps=8, learning_rate=0.03, randkey=k)
                       for k in keys]
            futs = {k: [router.submit(g, config=cfg)
                        for g in safe_guesses(4)]
                    for k, cfg in zip(keys, configs)}
            results = {k: [f.result(timeout=WAIT_S) for f in fs]
                       for k, fs in futs.items()}
            for k, cfg in zip(keys, configs):
                home = affinity_home(router, cfg).id
                assert {r.worker for r in results[k]} == {home}
                assert all(np.isfinite(r.loss) for r in results[k])
            stats = router.stats
            assert stats["submitted"] == stats["completed"] == 12
            assert stats["workers_alive"] == 2
            assert stats["fits_per_hour"] > 0

            snap = live.metrics.snapshot()
            for gauge in ("multigrad_fleet_workers_alive",
                          "multigrad_fleet_inflight",
                          "multigrad_fleet_worker_up",
                          "multigrad_fleet_fits_per_hour"):
                assert gauge in snap, f"missing {gauge}"
            # The router handed its workers' telemetry files to the
            # LiveServer: /fleet aggregates them, one rank a worker.
            assert live.rank_paths == [w.telemetry_path
                                       for w in router.workers]
            with urllib.request.urlopen(live.url + "/fleet",
                                        timeout=10) as resp:
                fleet = json.loads(resp.read())
            assert set(map(int, fleet["ranks"])) == {0, 1}
            assert fleet["n_records"] > 0

            stats = router.stats
            for w in stats["workers"].values():
                res = w["resources"]
                assert res is not None and res["rss_bytes"] > 0
                assert res["busy_s_total"] >= 0
                assert w["live_port"] > 0
            assert stats["fleet_rss_bytes"] > 0
            busy = stats["fleet_busy_frac"]
            assert busy is None or 0.0 <= busy <= 1.0
            assert "multigrad_fleet_worker_busy_frac" \
                in live.metrics.snapshot()

            urls = [f"http://127.0.0.1:{w['live_port']}/status"
                    for w in stats["workers"].values()]
            rows = collect_rows(urls, {}, {})
            assert len(rows) == 2
            assert all(r["state"] != "down" and r["rss_bytes"] > 0
                       for r in rows)
            top = render_rows(rows).splitlines()
            assert top[0].startswith("WORKER") and len(top) == 4
            paths = [w.telemetry_path for w in router.workers]
    finally:
        live.stop()
    # Every worker logged its kernel launches: none on the CPU, whose
    # counts run their plain versions.
    for path in paths:
        recs = launch_records(path)
        assert recs and not any(recs[-1]["launches"].values())

    # The served values against the JAX package's scheduler on the same
    # guesses at the same size.
    jax_model = JaxSMFModel(aux_data=jax_make_smf_data(N_HALOS))
    for k in keys:
        with JaxFitScheduler(jax_model, buckets=(4,), start=False,
                             batch_window_s=0.0) as sched:
            jf = [sched.submit(g, config=JaxFitConfig(
                      nsteps=8, learning_rate=0.03, randkey=k))
                  for g in safe_guesses(4)]
            sched.start()
            ref = [f.result(timeout=WAIT_S) for f in jf]
        port_model = SMFModel(aux_data=make_smf_data(N_HALOS, device="cpu"))
        for got, want in zip(results[k], ref):
            np.testing.assert_allclose(got.traj, want.traj, rtol=0,
                                       atol=TRAJ_ATOL)
            _, grad = port_model.calc_loss_and_grad_from_params(got.params)
            np.testing.assert_allclose(
                got.loss, want.loss, rtol=LOSS_RTOL,
                atol=float(grad.abs().sum()) * TRAJ_ATOL)


@pytest.mark.parametrize("wire", [jax_wire, pt_wire], ids=["jax", "port"])
def test_heartbeat_resources_wire_forward_compat(wire):
    future_msg = {"resources": {"rss_bytes": 10 ** 9, "busy_frac": 0.25,
                                "gpu_temp_c": 61, "numa_domains": [0, 1]}}
    res = wire.resources_from_wire(future_msg["resources"])
    assert res["rss_bytes"] == 10 ** 9
    assert res["busy_frac"] == pytest.approx(0.25)
    assert "gpu_temp_c" not in res and "numa_domains" not in res
    assert wire.resources_from_wire(None) is None
    encoded = wire.resources_to_wire({"rss_bytes": 5, "busy_frac": 0.5,
                                      "t": 1.0})
    assert json.loads(json.dumps(encoded)) == encoded
    assert wire.resources_to_wire(None) is None


# ------------------------------------------------------------------ #
# the chaos run: SIGKILL mid-burst, nothing lost
# ------------------------------------------------------------------ #
def test_fleet_sigkill_mid_burst_loses_no_request(tmp_path):
    from multigrad_tpu_torch.telemetry import LiveServer
    from multigrad_tpu_torch.telemetry.aggregate import merge_traces
    from multigrad_tpu_torch.telemetry.trace import main as trace_main
    from multigrad_tpu_torch.telemetry.trace import trace_summary
    live = LiveServer(port=0)
    cfg = FitConfig(nsteps=60, learning_rate=0.03, randkey=7)
    guesses = safe_guesses(20)
    try:
        with make_router(tmp_path, live=live) as router:
            chaos = ChaosController(router)
            victim = affinity_home(router, cfg)
            survivor = next(w for w in router.workers
                            if w.id != victim.id)
            futs = [router.submit(g, config=cfg) for g in guesses]
            seen = {}

            def _kill():
                seen["inflight"] = len(victim.inflight)
                chaos.kill(victim.id)

            fired = chaos.when_inflight(16, _kill, worker=victim.id)
            assert fired.wait(60), "kill injection never fired"
            assert seen["inflight"] >= 16

            results = [f.result(timeout=WAIT_S) for f in futs]
            assert all(np.isfinite(r.loss) for r in results)
            requeued = [f for f in futs if f.requeues]
            assert len(requeued) >= 16
            for f in requeued:
                assert f._result.worker == survivor.id
                assert f.requeues[0]["worker"] == victim.id
                assert "lost" in f.requeues[0]["reason"]
            stats = router.stats
            assert stats["worker_deaths"] == 1
            assert stats["completed"] == 20
            assert stats.get("lost") is None
            assert stats["workers"][victim.id]["state"] == "dead"
            with open(requeued[0].requeues[0]["bundle"]) as f:
                detail = json.load(f)["detail"]
            assert detail["worker"] == victim.id
            assert set(detail["inflight"]) >= {f.request_id
                                               for f in requeued}
            assert set(detail["trace_ids"]) >= {f.trace_id
                                                for f in requeued}

            with urllib.request.urlopen(live.url + "/status",
                                        timeout=10) as resp:
                latency = json.loads(resp.read())["latency"]
            assert latency["source"] \
                == "multigrad_fleet_fit_latency_seconds"
            assert latency["count"] == 20
            assert 0 < latency["p50_s"] <= latency["p95_s"] \
                <= latency["p99_s"] <= latency["max_s"]
            all_traces = {f.trace_id for f in futs}
            assert latency["exemplar_trace"] in all_traces
            assert latency["hops"]["requeue"]["exemplar_trace"] \
                in {f.trace_id for f in requeued}
            rtt = live.metrics.snapshot()["multigrad_fleet_rpc_rtt"]
            assert f'{{worker="{survivor.id}"}}' in rtt["samples"]
            trace_paths = router.trace_paths
            e2e = {f.trace_id: f._result.wait_s + f._result.fit_s
                   for f in futs}
            chaos.close()
            assert "kill" in chaos.report()
    finally:
        live.stop()

    # The requeued fits ran from the start on the survivor: equal to
    # solo fits of the same guesses in this process.
    model = SMFModel(aux_data=make_smf_data(N_HALOS, device="cpu"))
    for f in requeued[:4]:
        solo = model.run_adam(guess=guesses[futs.index(f)], nsteps=60,
                              learning_rate=0.03, randkey=7,
                              progress=False).numpy()
        np.testing.assert_allclose(f._result.traj, solo, rtol=SOLO_RTOL,
                                   atol=0)

    assert len(trace_paths) == 3          # router + 2 workers
    by_trace = merge_traces(trace_paths)
    assert set(by_trace) >= all_traces
    killed = {f.trace_id for f in requeued}
    for f in futs:
        summary = trace_summary(f.trace_id, by_trace[f.trace_id])
        assert summary["complete"] is True, summary
        assert summary["outcome"] == "ok"
        assert summary["coverage"] >= 0.9, summary
        assert summary["elapsed_s"] \
            == pytest.approx(e2e[f.trace_id], rel=0.5, abs=2.0)
        if f.trace_id in killed:
            hop = summary["requeues"][0]
            assert hop["from"] == victim.id and hop["to"] == survivor.id
            assert hop["bundle"] is not None
            assert set(summary["services"]) \
                >= {"router", f"worker:{survivor.id}"}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert trace_main(trace_paths + ["--slowest", "20"]) == 0
    text = out.getvalue()
    assert f"{len(by_trace)} traces over 3 file(s)" in text
    assert "0 incomplete" in text
    assert f"requeue {victim.id}->{survivor.id}" in text


# ------------------------------------------------------------------ #
# graceful preemption, saturation, a frozen worker
# ------------------------------------------------------------------ #
def test_fleet_sigterm_drains_gracefully(tmp_path):
    with make_router(tmp_path) as router:
        chaos = ChaosController(router)
        cfg = FitConfig(nsteps=40, learning_rate=0.03, randkey=5)
        victim = affinity_home(router, cfg)
        probe = router.submit(np.array([-1.9, 0.5]), config=cfg)
        assert probe.result(timeout=WAIT_S).worker == victim.id
        futs = [router.submit(g, config=cfg) for g in safe_guesses(8)]
        chaos.preempt(victim.id)
        results = [f.result(timeout=WAIT_S) for f in futs]
        assert all(np.isfinite(r.loss) for r in results)
        deadline = time.time() + 30
        while victim.proc.poll() is None and time.time() < deadline:
            time.sleep(0.05)
        assert victim.proc.poll() == 0      # drained exit, not a kill
        post = router.submit(np.array([-1.8, 0.5]), config=cfg)
        assert post.result(timeout=WAIT_S).worker != victim.id
        chaos.close()
    # The drained worker logged its final launch counts.
    assert launch_records(victim.telemetry_path)


def test_fleet_queue_full_steals_then_sheds(tmp_path):
    with make_router(tmp_path) as router:
        chaos = ChaosController(router)
        cfg = FitConfig(nsteps=8, learning_rate=0.03, randkey=11)
        home = affinity_home(router, cfg)
        other = next(w for w in router.workers if w.id != home.id)
        chaos.inject_queue_full(home.id, n=1)
        stolen = router.submit(np.array([-1.9, 0.5]), config=cfg)
        assert stolen.result(timeout=WAIT_S).worker == other.id
        assert router.stats["rejected"] >= 1
        chaos.inject_queue_full(home.id, n=1)
        chaos.inject_queue_full(other.id, n=1)
        shed = router.submit(np.array([-1.9, 0.5]), config=cfg)
        with pytest.raises(FleetSaturatedError):
            shed.result(timeout=WAIT_S)
        assert router.stats["shed"] == 1
        again = router.submit(np.array([-1.9, 0.5]), config=cfg)
        assert np.isfinite(again.result(timeout=WAIT_S).loss)
        chaos.close()


@pytest.mark.slow   # waits out a real heartbeat timeout, as in the JAX suite
def test_fleet_stalled_worker_requeues(tmp_path):
    with make_router(tmp_path, heartbeat_timeout_s=1.0) as router:
        chaos = ChaosController(router)
        cfg = FitConfig(nsteps=200, learning_rate=0.03, randkey=3)
        victim = affinity_home(router, cfg)
        probe = router.submit(np.array([-1.9, 0.5]), config=cfg)
        assert probe.result(timeout=WAIT_S).worker == victim.id
        futs = [router.submit(g, config=cfg) for g in safe_guesses(6)]
        chaos.suspend(victim.id)
        results = [f.result(timeout=WAIT_S) for f in futs]
        assert all(np.isfinite(r.loss) for r in results)
        assert any(f.requeues for f in futs)
        assert router.stats["worker_deaths"] == 1
        deadline = time.time() + 10
        while victim.proc.poll() is None and time.time() < deadline:
            time.sleep(0.05)
        assert victim.proc.poll() is not None
        chaos.close()


# ------------------------------------------------------------------ #
# requeue semantics (fake workers, no subprocesses)
# ------------------------------------------------------------------ #
class FakeChan:
    def __init__(self):
        self.sent = []

    def send(self, msg):
        self.sent.append(msg)

    def close(self):
        pass

    def submits(self):
        return [m for m in self.sent if m["op"] == "submit"]


@pytest.fixture()
def fake_fleet(tmp_path):
    router = FleetRouter(n_workers=0, base_dir=str(tmp_path),
                         compile_cache=None, device="cpu",
                         heartbeat_timeout_s=1e6, max_requeues=2)
    a = WorkerHandle("w0", chan=FakeChan())
    b = WorkerHandle("w1", chan=FakeChan())
    router.workers += [a, b]
    yield router, a, b
    router.close(drain=False, timeout=0)


def _home_and_other(a, b, fut_id):
    if any(m["rid"] == fut_id for m in a.chan.submits()):
        return a, b
    return b, a


def test_requeue_respects_original_deadline(fake_fleet):
    router, a, b = fake_fleet
    fut = router.submit([-1.9, 0.5], nsteps=5, deadline_s=0.03)
    home, other = _home_and_other(a, b, fut.request_id)
    assert home.chan.submits()[0]["deadline_t"] is not None
    time.sleep(0.06)
    router._worker_lost(home, "test kill")
    with pytest.raises(FitDeadlineExceeded):
        fut.result(timeout=5)
    assert not any(m["rid"] == fut.request_id
                   for m in other.chan.submits())
    assert len(fut.requeues) == 1


def test_requeue_cancelled_future_stays_cancelled(fake_fleet):
    router, a, b = fake_fleet
    fut = router.submit([-1.9, 0.5], nsteps=5)
    home, other = _home_and_other(a, b, fut.request_id)
    fut._requeued()
    assert fut.cancel() is True
    router._worker_lost(home, "test kill")
    with pytest.raises(FitCancelled):
        fut.result(timeout=5)
    assert fut.cancelled()
    assert not any(m["rid"] == fut.request_id
                   for m in other.chan.submits())


def test_requeue_forwards_consumed_poison_retry(fake_fleet):
    router, a, b = fake_fleet
    fut = router.submit([-1.9, 0.5], nsteps=5)
    home, other = _home_and_other(a, b, fut.request_id)
    assert home.chan.submits()[0]["retried"] is False
    router._on_poison_retry(home, {"rid": fut.request_id})
    router._worker_lost(home, "test kill")
    resubmit = [m for m in other.chan.submits()
                if m["rid"] == fut.request_id]
    assert len(resubmit) == 1 and resubmit[0]["retried"] is True


def test_scheduler_submit_retried_skips_second_retry():
    model = SMFModel(aux_data=make_smf_data(N_HALOS, device="cpu"))
    with FitScheduler(model, buckets=(1,), start=False,
                      batch_window_s=0.0, retry_poisoned=True) as sched:
        fut = sched.submit(np.array([np.nan, 0.5]), nsteps=5, retried=True)
        sched.start()
        exc = fut.exception(timeout=WAIT_S)
    assert isinstance(exc, FitFailed)
    assert sched.stats.get("retried", 0) == 0


def test_requeues_bounded_by_typed_worker_lost_error(fake_fleet):
    router, a, b = fake_fleet
    router.max_requeues = 1
    fut = router.submit([-1.9, 0.5], nsteps=5)
    home, other = _home_and_other(a, b, fut.request_id)
    router._worker_lost(home, "first kill")
    assert any(m["rid"] == fut.request_id for m in other.chan.submits())
    router._worker_lost(other, "second kill")
    exc = fut.exception(timeout=5)
    assert isinstance(exc, WorkerLostError)
    assert exc.request_id == fut.request_id
    assert len(exc.requeues) == 2 and exc.requeues == fut.requeues


def test_reject_reroutes_then_typed_saturation_error(fake_fleet):
    router, a, b = fake_fleet
    fut = router.submit([-1.9, 0.5], nsteps=5)
    home, other = _home_and_other(a, b, fut.request_id)
    router._on_reject(home, {"rid": fut.request_id, "reason": "queue_full"})
    assert any(m["rid"] == fut.request_id for m in other.chan.submits())
    router._on_reject(other, {"rid": fut.request_id,
                              "reason": "queue_full"})
    with pytest.raises(FleetSaturatedError):
        fut.result(timeout=5)


def test_router_device_round_robin_and_library_dir(fake_fleet, tmp_path):
    from multigrad_tpu_torch.ops import cuda_build
    router, _, _ = fake_fleet
    assert router.devices == ["cpu"]
    assert router.compile_cache is None
    auto = FleetRouter(n_workers=0, base_dir=str(tmp_path / "auto"),
                       device=["cuda:0", "cuda:1"], trace=False,
                       env={"PATH": os.environ["PATH"]})
    try:
        assert auto.devices == ["cuda:0", "cuda:1"]
        # "auto" is this process's kernel-library directory, not a
        # fresh one: the workers load what was built here.
        assert auto.compile_cache == str(cuda_build.build_dir())
        cmds = [auto._launch_cmd(f"w{i}", i) for i in range(3)]
        assert [c[c.index("--device") + 1] for c in cmds] \
            == ["cuda:0", "cuda:1", "cuda:0"]
        assert all(c[c.index("--compile-cache") + 1] == auto.compile_cache
                   for c in cmds)
        # The router adds the repo root to PYTHONPATH and nothing else:
        # no JAX_PLATFORMS, no XLA_FLAGS.
        assert set(auto._worker_env()) == {"PATH", "PYTHONPATH"}
    finally:
        auto.close(drain=False, timeout=0)


def test_submit_message_carries_traceparent(fake_fleet):
    from multigrad_tpu_torch.telemetry.tracing import TraceContext
    router, a, b = fake_fleet
    fut = router.submit([-1.9, 0.5], nsteps=5)
    home, _ = _home_and_other(a, b, fut.request_id)
    msg = home.chan.sent[0]
    assert fut.trace_id is not None
    assert TraceContext.from_wire(msg["trace"]).trace_id == fut.trace_id
    # The decoration is strictly additive: the JAX package's fields.
    assert set(msg) - {"trace"} == {"op", "rid", "guess", "config",
                                     "deadline_t", "retried",
                                     "submitted_t"}


def test_undecorated_worker_result_still_traced(fake_fleet):
    from multigrad_tpu_torch.telemetry import trace as trace_cli
    router, a, b = fake_fleet
    fut = router.submit([-1.9, 0.5], nsteps=5)
    home, _ = _home_and_other(a, b, fut.request_id)
    router._on_result(home, {
        "rid": fut.request_id, "some_future_field": {"x": 1},
        "result": {"params": [1.0, 2.0], "loss": 0.25,
                   "traj": [[0.0, 0.0]], "steps": 5, "bucket": 1,
                   "wait_s": 0.0, "fit_s": 0.1}})
    result = fut.result(timeout=5)
    assert result.trace_id == fut.trace_id
    assert set(result.hops) == {"route", "rpc_send"}
    router.close(drain=False, timeout=0)
    summary = trace_cli.trace_summary(
        fut.trace_id, trace_cli.load_spans(router.trace_paths))
    assert summary["complete"] is True and summary["outcome"] == "ok"


def test_requeue_without_survivor_records_truthful_span(fake_fleet):
    from multigrad_tpu_torch.telemetry import trace as trace_cli
    router, a, b = fake_fleet
    fut = router.submit([-1.9, 0.5], nsteps=5)
    home, other = _home_and_other(a, b, fut.request_id)
    router._worker_lost(other, "the idle one first")
    router._worker_lost(home, "test kill")
    assert isinstance(fut.exception(timeout=5), WorkerLostError)
    router.close(drain=False, timeout=0)
    spans = trace_cli.load_spans(router.trace_paths)
    requeue = next(s for s in spans if s["name"] == "requeue")
    assert requeue["outcome"] == "not_redispatched"
    assert requeue["to_worker"] is None
    summary = trace_cli.trace_summary(fut.trace_id, [
        s for s in spans if s["trace_id"] == fut.trace_id])
    assert summary["complete"] is True and summary["outcome"] == "lost"


def test_pong_without_t0_is_ignored(fake_fleet):
    router, a, _ = fake_fleet
    router._on_pong(a, {"worker": "w0", "unknown": True})
    assert a.rpc_rtt_s is None
    router._on_pong(a, {"worker": "w0", "t0": time.time() - 0.01})
    assert a.rpc_rtt_s == pytest.approx(0.01, abs=0.25)


# ------------------------------------------------------------------ #
# the scheduler's dispatcher-death backstop, the LiveServer bind retry
# ------------------------------------------------------------------ #
def test_dispatcher_death_settles_all_futures_with_cause(tmp_path):
    model = SMFModel(aux_data=make_smf_data(N_HALOS, device="cpu"))

    class DispatcherDied(BaseException):
        pass

    sched = FitScheduler(model, buckets=(4,), start=False,
                         batch_window_s=0.0, flight_dir=str(tmp_path))
    futs = [sched.submit([-1.9 - 0.01 * i, 0.5], nsteps=5)
            for i in range(4)]

    def die(group):
        raise DispatcherDied("chaos: dispatcher thread killed")

    sched._dispatch = die
    sched.start()
    for fut in futs:
        exc = fut.exception(timeout=60)
        assert isinstance(exc, FitFailed)
        assert isinstance(exc.__cause__, DispatcherDied)
        with open(exc.bundle_path) as f:
            assert json.load(f)["reason"] == "dispatcher_died"
    with pytest.raises(RuntimeError):
        sched.submit([-1.9, 0.5], nsteps=5)


def test_live_server_bind_retry_probes_forward():
    from multigrad_tpu_torch.telemetry import LiveServer
    blocker = socket.socket()
    blocker.bind(("127.0.0.1", 0))
    base = blocker.getsockname()[1]
    s1 = s2 = None
    try:
        s1 = LiveServer(port=base)
        assert s1.port != base and base < s1.port <= base + 16
        s2 = LiveServer(port=base)
        assert s2.port not in (base, s1.port)
        with urllib.request.urlopen(f"http://127.0.0.1:{s2.port}/status",
                                    timeout=10) as resp:
            assert json.loads(resp.read())["port"] == s2.port
    finally:
        for s in (s1, s2):
            if s is not None:
                s.stop()
        blocker.close()
