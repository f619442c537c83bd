"""The port's telemetry on the fits (``multigrad_tpu_torch.telemetry``)
against the JAX package's, on the CPU.

* ``adam`` records of the SMF fit (8,192 halos, ``log_every=3``,
  ``diagnostics=True``): the same steps and keys; values rtol 1e-5
  (measured: 1.3e-6 at most), ``loss_ema_slope`` (a difference of two
  EMAs over ``log_every``) within atol 4·eps·|loss_ema|/log_every more.
  At 2 shards (a JAX comm over 2 of the 8 CPU devices against 2 gloo
  processes) the same, ``grad_noise_scale`` and ``grad_norm_shard``
  included.
* comm bytes at 2 gloo ranks: ``loss_and_grad`` equals the JAX package's
  ``measure_model_comm`` (48 bytes); the batched call (K = 3) and the
  reverse Jacobian equal the payloads the JAX package's own tests state
  (``tests/test_telemetry.py:223-238``: 3·(10 + 2)·4 and (10 + 10·2)·4
  bytes; under the installed jax its counter reads the unbatched shape
  there, and that JAX test fails).  The port's calls follow its own
  schedule (2, 2 and 1).  ``comm=None``: 0 bytes.  The streamed bytes a
  step do not depend on the catalog's size or its chunk count.
* the NaN trip: a loss ``log(p)`` that Adam drives below 0 trips at the
  same step, for the same reason, with the same records in the bundle.
* ``hmc`` records fed the JAX sampler's own ``jax.random`` draws: every
  accept decision equal, values rtol 1e-5 (step sizes and windowed
  acceptance; divergences exact).
* the ensemble's ``fit_summary``, the checkpointed tap's global step
  numbers and ``checkpoint`` spans, the streamed fit's records, spans,
  ``Heartbeat``, ``Timer`` and ``StepsPerSecond`` (as JAX
  ``tests/test_telemetry.py:329-452``), ``profiled_fit`` on the CPU.

The gloo ranks run this file as a script, so it imports no JAX at the top.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

from multigrad_tpu_torch import run_adam_scan, telemetry
from multigrad_tpu_torch.data import StreamingOnePointModel
from multigrad_tpu_torch.inference import run_multistart_adam
from multigrad_tpu_torch.inference.hmc import _sample, result_from
from multigrad_tpu_torch.models import (SMFChi2Model, SMFModel,
                                        aux_from_numpy, make_smf_data)
from multigrad_tpu_torch.telemetry import (FlightRecorder,
                                           FlightRecorderTripped, MemorySink,
                                           MetricsLogger)
from multigrad_tpu_torch.utils import profiling

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
TIMEOUT_S = 120
SMF_HALOS = 8_192
GUESS = (-1.0, 0.5)
STEPS, LOG_EVERY, LR = 12, 3, 0.02
RTOL = 1e-5
N_BINS, N_PARAMS, F32 = 10, 2, 4
LOOP_KEYS = {"t", "event", "step", "process_index"}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def new_logger(*extra_sinks, **kwargs):
    sink = MemorySink()
    return MetricsLogger(sink, *extra_sinks, **kwargs), sink


def events(records, name):
    if hasattr(records, "records"):
        records = records.records
    return [r for r in records if r["event"] == name]


def assert_records_close(got, want, log_every=LOG_EVERY):
    """The same steps and keys; values rtol 1e-5, the EMA slope with its
    cancellation's atol."""
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        assert set(g) - LOOP_KEYS == set(w) - LOOP_KEYS
        for key in set(w) - LOOP_KEYS:
            atol = 0.0
            if key == "loss_ema_slope":
                atol = 4 * np.finfo(np.float32).eps * abs(
                    w["loss_ema"]) / log_every
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL, atol=atol,
                                       err_msg=f"{key} at {w['step']}")


def _jax_smf(comm=None, cls="SMFModel"):
    from multigrad_tpu.models import smf as jax_smf
    aux = jax_smf.make_smf_data(SMF_HALOS, comm=comm)
    return getattr(jax_smf, cls)(aux_data=aux, comm=comm), aux


def _jax_records(model):
    import jax
    import jax.numpy as jnp
    from multigrad_tpu import telemetry as jax_telemetry
    sink = jax_telemetry.MemorySink()
    model.run_adam(guess=jnp.array(GUESS), nsteps=STEPS, learning_rate=LR,
                   progress=False, telemetry=jax_telemetry.MetricsLogger(
                       sink), log_every=LOG_EVERY, diagnostics=True)
    jax.effects_barrier()
    return sink.records


# --------------------------------------------------------------------- #
# adam records
# --------------------------------------------------------------------- #
def test_adam_records_match_jax():
    jm, aux = _jax_smf()
    arrays = {k: (np.asarray(v) if hasattr(v, "shape") else v)
              for k, v in aux.items()}
    pm = SMFModel(aux_data=aux_from_numpy(arrays, device=CPU))
    plain = pm.run_adam(guess=GUESS, nsteps=STEPS, learning_rate=LR,
                        progress=False)
    logger, sink = new_logger()
    traj = pm.run_adam(guess=GUESS, nsteps=STEPS, learning_rate=LR,
                       progress=False, telemetry=logger,
                       log_every=LOG_EVERY, diagnostics=True)
    assert torch.equal(traj, plain)       # monitoring changes nothing
    want = _jax_records(jm)
    got = sink.records
    assert [r["event"] for r in got][1:] == [r["event"] for r in want][1:]
    assert_records_close(events(got, "adam"), events(want, "adam"))
    assert [r["step"] for r in events(got, "adam")] == [0, 3, 6, 9]
    assert events(got, "adam")[0]["loss_ema_slope"] == 0.0
    plan = events(got, "fit_plan")[0]
    assert {k: plan[k] for k in ("kind", "nsteps", "log_every")} == {
        "kind": "adam_scan", "nsteps": STEPS, "log_every": LOG_EVERY}
    assert events(got, "fit_summary")[-1]["steps"] == STEPS
    # comm=None: no collective ran, as the JAX package counts none.
    assert events(got, "comm")[0]["bytes_per_step"] == \
        events(want, "comm")[0]["bytes_per_step"] == 0


def test_batched_fit_emits_per_member_lists():
    model = SMFModel(aux_data=make_smf_data(2_048, device=CPU))
    logger, sink = new_logger()
    run_adam_scan(lambda p, k, m: m.batched_loss_and_grad_fn()(
        p, m.aux_leaves()), torch.tensor([[-1.0, 0.5], [-1.5, 0.3]]),
        nsteps=4, fn_args=(model,), telemetry=logger, log_every=2)
    recs = events(sink, "adam")
    assert [r["step"] for r in recs] == [0, 2]
    for r in recs:
        for key in ("loss", "grad_norm", "param_norm", "update_norm"):
            assert isinstance(r[key], list) and len(r[key]) == 2


def test_tap_checkpointed_drive_numbers_steps_globally(tmp_path):
    # As JAX tests/test_telemetry.py:184: segments of 3 steps, global
    # step numbers, one checkpoint span a write.
    def loss_and_grad(p, _key):
        diff = p - 0.5
        return (diff ** 2).sum(), 2.0 * diff

    logger, sink = new_logger()
    run_adam_scan(loss_and_grad, torch.zeros(1), nsteps=12,
                  learning_rate=0.1, telemetry=logger, log_every=4,
                  checkpoint_dir=str(tmp_path), checkpoint_every=3)
    assert [r["step"] for r in events(sink, "adam")] == [0, 4, 8]
    spans = [r for r in events(sink, "span") if r["name"] == "checkpoint"]
    assert [r["step"] for r in spans] == [3, 6, 9, 12]

    # A fit preempted at step 7 resumes from the write at step 6: its
    # records go on from there, numbered globally.
    calls = []

    def preempted(p, _key):
        calls.append(1)
        if len(calls) == 8:
            raise KeyboardInterrupt
        return loss_and_grad(p, _key)

    ckpt = tmp_path / "resume"
    with pytest.raises(KeyboardInterrupt):
        run_adam_scan(preempted, torch.zeros(1), nsteps=12,
                      learning_rate=0.1, checkpoint_dir=str(ckpt),
                      checkpoint_every=3)
    logger, sink = new_logger()
    resumed = run_adam_scan(loss_and_grad, torch.zeros(1), nsteps=12,
                            learning_rate=0.1, telemetry=logger, log_every=4,
                            checkpoint_dir=str(ckpt), checkpoint_every=3)
    assert [r["step"] for r in events(sink, "adam")] == [8]
    assert [r["step"] for r in events(sink, "span")] == [9, 12]
    assert torch.equal(resumed, run_adam_scan(loss_and_grad, torch.zeros(1),
                                              nsteps=12, learning_rate=0.1))


def test_checkpointed_records_match_jax(tmp_path):
    import jax
    import jax.numpy as jnp
    from multigrad_tpu import telemetry as jax_telemetry
    from multigrad_tpu.optim.adam import run_adam_scan as jax_scan

    def loss_and_grad(p, _key):
        diff = p - 0.5
        return (diff ** 2).sum(), 2.0 * diff

    jsink = jax_telemetry.MemorySink()
    jax_scan(loss_and_grad, jnp.zeros(1), nsteps=12, learning_rate=0.1,
             telemetry=jax_telemetry.MetricsLogger(jsink), log_every=4,
             checkpoint_dir=str(tmp_path / "jax"), checkpoint_every=3)
    jax.effects_barrier()
    logger, sink = new_logger()
    run_adam_scan(loss_and_grad, torch.zeros(1), nsteps=12,
                  learning_rate=0.1, telemetry=logger, log_every=4,
                  checkpoint_dir=str(tmp_path / "port"), checkpoint_every=3)
    assert_records_close(events(sink, "adam"), events(jsink.records, "adam"))
    assert len([r for r in events(sink, "span")
                if r["name"] == "checkpoint"]) == len(
        [r for r in events(jsink.records, "span")
         if r["name"] == "checkpoint"]) == 4


# --------------------------------------------------------------------- #
# The NaN trip
# --------------------------------------------------------------------- #
def _log_loss(p, _key):
    """``log(p)``: Adam walks p down by ≈0.1 a step from 0.35, so the
    loss turns NaN at step 4."""
    return p.log().sum(), 1.0 / p


def test_nan_trip_matches_jax(tmp_path):
    import jax
    import jax.numpy as jnp
    from multigrad_tpu import telemetry as jax_telemetry
    from multigrad_tpu.optim.adam import run_adam_scan as jax_scan

    jrec = jax_telemetry.FlightRecorder(dump_dir=str(tmp_path / "jax"))
    jsink = jax_telemetry.MemorySink()
    with pytest.raises(jax_telemetry.FlightRecorderTripped) as jexc:
        jax_scan(lambda p, k: (jnp.sum(jnp.log(p)), 1.0 / p),
                 jnp.array([0.35]), nsteps=8, learning_rate=0.1,
                 telemetry=jax_telemetry.MetricsLogger(jsink, jrec),
                 log_every=2, flight=jrec)
    jax.effects_barrier()
    rec = FlightRecorder(dump_dir=str(tmp_path / "port"))
    logger, sink = new_logger(rec)
    with pytest.raises(FlightRecorderTripped) as exc:
        run_adam_scan(_log_loss, torch.tensor([0.35]), nsteps=8,
                      learning_rate=0.1, telemetry=logger, log_every=2,
                      flight=rec)
    assert exc.value.step == jexc.value.step == 4
    assert exc.value.reason == jexc.value.reason == "non_finite_adam"
    bundle = json.load(open(exc.value.bundle_path))
    jbundle = json.load(open(jexc.value.bundle_path))
    assert [(r["event"], r.get("step")) for r in bundle["ring"]] == \
        [(r["event"], r.get("step")) for r in jbundle["ring"]]
    assert bundle["detail"]["values"]["loss"] == "NaN"
    program = bundle["programs"]["adam_loss_and_grad"]
    assert program["qualname"].endswith("run_adam_scan.<locals>.fn")
    assert len(program["kernel_sources"]) == 16
    summary = events(sink, "fit_summary")[-1]
    assert summary["postmortem_bundle"] == exc.value.bundle_path
    # The fit ran to its end: every record after the trip was logged.
    assert [r["step"] for r in events(sink, "adam")] == [0, 2, 4, 6]


def test_checkpointed_fit_keeps_last_good_state_on_trip(tmp_path):
    # As JAX tests/test_observability.py:259: the write after the trip
    # never happens, so the restart state is NaN-free.
    rec = FlightRecorder(dump_dir=str(tmp_path / "pm"))
    ckpt = tmp_path / "ckpt"
    with pytest.raises(FlightRecorderTripped):
        run_adam_scan(_log_loss, torch.tensor([0.35]), nsteps=12,
                      learning_rate=0.1, flight=rec,
                      checkpoint_dir=str(ckpt), checkpoint_every=3)
    assert rec.fatal_step == 4
    bundle = json.load(open(rec.bundle_path))
    assert bundle["context"]["last_checkpoint"].endswith("adam_state.npz")
    data = np.load(str(ckpt / "adam_state.npz"), allow_pickle=True)
    for key in data.files:
        arr = np.asarray(data[key])
        if arr.dtype.kind == "f":
            assert not np.any(np.isnan(arr)), key


def test_untripped_recorder_is_quiet_and_reusable(tmp_path):
    rec = FlightRecorder(dump_dir=str(tmp_path))
    with pytest.raises(FlightRecorderTripped):
        run_adam_scan(_log_loss, torch.tensor([0.35]), nsteps=6,
                      learning_rate=0.1, flight=rec)
    rec.reset()
    out = run_adam_scan(_log_loss, torch.tensor([5.0]), nsteps=6,
                        learning_rate=0.1, flight=rec)
    assert not rec.tripped and bool(torch.isfinite(out).all())


def test_hmc_sentinel_trips_during_warmup(tmp_path):
    # sigma_frac = 0 divides the chi2 loss by zero: NaN from draw 0.
    aux = make_smf_data(2_048, device=CPU)
    aux["sigma_frac"] = 0.0
    model = SMFChi2Model(aux_data=aux)
    rec = FlightRecorder(dump_dir=str(tmp_path))
    from multigrad_tpu_torch.inference import run_hmc
    with pytest.raises(FlightRecorderTripped):
        run_hmc(model, [-2.0, 0.2], num_samples=6, num_warmup=4,
                num_chains=2, num_leapfrog=2, randkey=1, flight=rec)
    assert rec.reason == "non_finite_hmc" and rec.fatal_step == 0
    bundle = json.load(open(rec.bundle_path))
    assert "warmup_potential" in bundle["detail"]["values"]


# --------------------------------------------------------------------- #
# hmc records and the ensemble's summary
# --------------------------------------------------------------------- #
def test_hmc_records_match_jax():
    import jax
    from multigrad_tpu import telemetry as jax_telemetry
    from multigrad_tpu.inference import run_hmc as jax_run_hmc
    from test_torch_fisher import N_DIM, GaussianLinearModel, \
        _jax_gaussian_linear
    from test_torch_hmc import jax_noise, moves
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    u = rng.normal(size=(64, N_DIM)).astype(np.float32)
    target = (x.T @ u @ np.array([0.5, -0.3, 0.8], np.float32)).astype(
        np.float32)
    aux = dict(x=x, u=u, target=target,
               prec=np.diag(rng.uniform(0.5, 2.0, 4)).astype(np.float32))
    init = (np.array([0.5, -0.3, 0.8]) + 0.1 * rng.normal(size=(2, N_DIM))
            ).astype(np.float32)
    jsink = jax_telemetry.MemorySink()
    want = jax_run_hmc(_jax_gaussian_linear(aux), init, num_samples=30,
                       num_warmup=0, step_size=0.04, num_leapfrog=8,
                       randkey=3, telemetry=jax_telemetry.MetricsLogger(
                           jsink), log_every=10)
    jax.effects_barrier()
    pm = GaussianLinearModel(aux_data=aux_from_numpy(aux, device=CPU))
    program, leaves = pm.batched_loss_and_grad_fn(), pm.aux_leaves()
    logger, sink = new_logger()
    noise, _ = jax_noise(3, 2, N_DIM)
    got = result_from(_sample(
        lambda q: program(q, leaves), torch.tensor(init), noise, 0, 30, 8,
        torch.tensor(0.04), torch.ones(N_DIM), 0.8, 0.2,
        tap=telemetry.ScalarTap(logger, "hmc", 10)))
    np.testing.assert_array_equal(moves(got.samples), moves(want.samples))
    recs, jrecs = events(sink, "hmc"), events(jsink.records, "hmc")
    assert [r["step"] for r in recs] == [r["step"] for r in jrecs] == [
        10, 20, 30]
    for r, w in zip(recs, jrecs):
        assert r["divergences"] == w["divergences"]
        for key in ("accept", "step_size"):
            np.testing.assert_allclose(r[key], w[key], rtol=RTOL)
    assert recs[-1]["divergences"] == int(np.sum(got.divergences))


def test_run_hmc_records_and_summary():
    from multigrad_tpu_torch.inference import run_hmc
    model = SMFChi2Model(aux_data=make_smf_data(2_048, device=CPU))
    logger, sink = new_logger()
    res = run_hmc(model, [-2.0, 0.2], num_samples=30, num_warmup=15,
                  num_chains=2, num_leapfrog=4, telemetry=logger,
                  log_every=10, randkey=3, init_spread=0.01)
    recs = events(sink, "hmc")
    assert [r["step"] for r in recs] == [10, 20, 30]
    for r in recs:
        assert 0.0 <= r["accept"] <= 1.0 and len(r["step_size"]) == 2
    assert recs[-1]["divergences"] == int(np.sum(res.divergences))
    plan, summary = events(sink, "fit_plan")[0], events(sink,
                                                        "fit_summary")[0]
    assert (plan["kind"], plan["nsteps"], plan["num_warmup"],
            plan["num_chains"]) == ("hmc", 30, 15, 2)
    assert summary["steps"] == 30
    assert summary["divergences"] == int(np.sum(res.divergences))


def test_ensemble_fit_summary_matches_jax():
    # The linear-Gaussian model of tests/test_torch_ensemble.py, whose
    # loss the two packages compute with the same float32 ops.
    import jax
    from multigrad_tpu import telemetry as jax_telemetry
    from multigrad_tpu.inference import run_multistart_adam as jax_ens
    from test_torch_fisher import N_DIM, GaussianLinearModel, \
        _jax_gaussian_linear
    rng = np.random.default_rng(1)
    x = rng.normal(size=(32, 4)).astype(np.float32)
    u = rng.normal(size=(32, N_DIM)).astype(np.float32)
    aux = dict(x=x, u=u, target=(x.T @ u @ np.ones(N_DIM)).astype(
        np.float32), prec=np.eye(4, dtype=np.float32))
    inits = rng.normal(size=(4, N_DIM)).astype(np.float32)
    jsink = jax_telemetry.MemorySink()
    jax_ens(_jax_gaussian_linear(aux), inits=inits, nsteps=20,
            learning_rate=0.05, telemetry=jax_telemetry.MetricsLogger(jsink),
            log_every=5)
    jax.effects_barrier()
    logger, sink = new_logger()
    run_multistart_adam(GaussianLinearModel(aux_data=aux_from_numpy(
        aux, device=CPU)), inits=inits, nsteps=20, learning_rate=0.05,
        telemetry=logger, log_every=5)
    got, want = events(sink, "fit_summary"), events(jsink.records,
                                                    "fit_summary")
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert {k: got[-1][k] for k in ("steps", "n_starts", "best_start",
                                    "k_sharded")} == \
        {k: want[-1][k] for k in ("steps", "n_starts", "best_start",
                                  "k_sharded")}
    np.testing.assert_allclose(got[-1]["final_loss"], want[-1]["final_loss"],
                               rtol=RTOL)
    assert_records_close(events(sink, "adam"), events(jsink.records, "adam"),
                         log_every=5)
    assert all(len(r["loss"]) == 4 for r in events(sink, "adam"))


# --------------------------------------------------------------------- #
# The streamed fit
# --------------------------------------------------------------------- #
def _streamed_smf(n_halos, chunk_rows, comm=None):
    aux = make_smf_data(n_halos, device=CPU)
    halos = aux.pop("log_halo_masses").numpy()
    return StreamingOnePointModel(
        model=SMFModel(aux_data=aux, comm=comm),
        streams={"log_halo_masses": halos}, chunk_rows=chunk_rows)


def test_streamed_fit_emits_full_telemetry(tmp_path):
    # As JAX tests/test_telemetry.py:280, on one process.
    from multigrad_tpu_torch.telemetry import report
    path = tmp_path / "stream.jsonl"
    sm = _streamed_smf(SMF_HALOS, 2_048)
    plain = sm.run_adam(guess=GUESS, nsteps=4, progress=False)
    logger, sink = new_logger(telemetry.JsonlSink(str(path)))
    traj = sm.run_adam(guess=GUESS, nsteps=4, progress=False,
                       telemetry=logger, log_every=2, heartbeat_s=30.0,
                       diagnostics=True)
    logger.close()
    assert torch.equal(traj, plain)
    assert [r["step"] for r in events(sink, "adam")] == [0, 2]
    assert "loss_ema" in events(sink, "adam")[0]
    comm = events(sink, "comm")
    assert len(comm) == 1 and comm[0]["n_chunks"] == 4
    stream = events(sink, "stream")
    assert len(stream) == 1 and stream[0]["max_live_buffers"] <= 2
    fit = [r for r in events(sink, "span") if r["name"] == "fit"]
    assert len(fit) == 1 and fit[0]["ok"]
    plan = events(sink, "fit_plan")[0]
    assert (plan["kind"], plan["start"]) == ("adam_streamed", 0)
    summary = events(sink, "fit_summary")[0]
    assert summary["steps"] == 4 and np.isfinite(summary["final_loss"])
    assert summary["steps_per_sec"] > 0 and "overlap_frac" in summary
    assert len(report.load_records(str(path))) == len(sink.records)


def test_streamed_nan_trip_points_at_the_restart_state(tmp_path):
    aux = make_smf_data(4_096, device=CPU)
    aux["target_sumstats"] = -aux["target_sumstats"]
    halos = aux.pop("log_halo_masses").numpy()
    sm = StreamingOnePointModel(model=SMFModel(aux_data=aux),
                                streams={"log_halo_masses": halos},
                                chunk_rows=1_024)
    rec = FlightRecorder(dump_dir=str(tmp_path / "pm"))
    logger, sink = new_logger(rec)
    with pytest.raises(FlightRecorderTripped):
        sm.run_adam(guess=GUESS, nsteps=5, progress=False, telemetry=logger,
                    log_every=1, checkpoint_dir=str(tmp_path / "ckpt"),
                    flight=rec)
    assert events(sink, "fit_summary")[-1]["postmortem_bundle"] \
        == rec.bundle_path
    bundle = json.load(open(rec.bundle_path))
    assert bundle["context"]["last_checkpoint"].endswith("adam_state.npz")


# --------------------------------------------------------------------- #
# 2 gloo ranks: comm bytes and the shards' gradient noise
# --------------------------------------------------------------------- #
def _rank_main(rank, world, init_file, out_file):
    import torch.distributed as dist
    from multigrad_tpu_torch import global_comm
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    torch.set_num_threads(2)
    try:
        comm = global_comm()
        model = SMFModel(aux_data=make_smf_data(SMF_HALOS, comm=comm,
                                                device=CPU), comm=comm)
        guess = torch.tensor(GUESS)
        out = {"comm": {
            "loss_and_grad": telemetry.measure_model_comm(model, guess),
            "batched_loss_and_grad": telemetry.measure_model_comm(
                model, guess.repeat(3, 1), kind="batched_loss_and_grad"),
            "sumstats_jac_rev": telemetry.measure_model_comm(
                model, guess, kind="sumstats_jac_rev"),
            "gns": telemetry.traced_comm(model._fit_loss_and_grad_gns,
                                         guess),
            "solo": telemetry.measure_model_comm(
                SMFModel(aux_data=make_smf_data(SMF_HALOS, device=CPU)),
                guess)}}
        out["comm"] = {k: v.summary() for k, v in out["comm"].items()}
        out["streamed"] = {
            label: _streamed_smf(n, rows, comm).measure_comm(guess)
            for label, n, rows in (("small", 8_192, 2_048),
                                   ("large", 32_768, 8_192),
                                   ("many", 32_768, 1_024))}
        sink = MemorySink()
        out["traj"] = model.run_adam(
            guess=GUESS, nsteps=STEPS, learning_rate=LR, progress=False,
            telemetry=MetricsLogger(sink), log_every=LOG_EVERY,
            diagnostics=True).tolist()
        out["records"] = sink.records
        with open(out_file, "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks():
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "init")
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(2)]
        env = dict(os.environ, PYTHONPATH=REPO_ROOT, OMP_NUM_THREADS="2")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), "2",
             init_file, outs[r]], cwd=REPO_ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=TIMEOUT_S)[0].decode())
        except subprocess.TimeoutExpired:
            pytest.fail(f"a rank did not finish within {TIMEOUT_S} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, text in zip(procs, logs):
            assert p.returncode == 0, text
        return [json.load(open(o)) for o in outs]


@pytest.fixture(scope="module")
def jax_two_devices():
    import jax
    from multigrad_tpu.parallel.mesh import MeshComm
    return MeshComm(devices=jax.devices()[:2])


@pytest.mark.parametrize("kind,payload,calls", [
    ("loss_and_grad", N_BINS + N_PARAMS, 2),
    ("batched_loss_and_grad", 3 * (N_BINS + N_PARAMS), 2),
    ("sumstats_jac_rev", N_BINS + N_BINS * N_PARAMS, 1),
    ("gns", N_BINS + N_PARAMS + 1, 3), ("solo", 0, 0)])
def test_comm_bytes_at_two_ranks(ranks, kind, payload, calls):
    for r in ranks:
        assert r["comm"][kind]["total_bytes"] == payload * F32
        assert r["comm"][kind]["total_calls"] == calls
        assert set(r["comm"][kind]["calls_by_op"]) <= {"psum"}


def test_loss_and_grad_bytes_equal_jax(ranks, jax_two_devices):
    import jax.numpy as jnp
    from multigrad_tpu import telemetry as jax_telemetry
    jm, _ = _jax_smf(jax_two_devices)
    want = jax_telemetry.measure_model_comm(jm, jnp.array(GUESS))
    assert want.total_bytes == (N_BINS + N_PARAMS) * F32
    for r in ranks:
        assert r["comm"]["loss_and_grad"]["total_bytes"] == want.total_bytes
        assert r["comm"]["loss_and_grad"]["total_calls"] == want.total_calls


@pytest.mark.parametrize("label", ["small", "large", "many"])
def test_streamed_bytes_do_not_depend_on_catalog_size(ranks, label):
    # 4 chunks of 8,192 and of 32,768 halos, 32 chunks of 32,768: the
    # port reduces y and the gradient once a step whatever the chunks.
    for r in ranks:
        rec = r["streamed"][label]
        assert rec["bytes_per_step"] == (N_BINS + N_PARAMS) * F32
        assert rec["calls_per_step"] == 2
        assert rec["scope"] == "streamed_loss_and_grad_step"
    assert ranks[0]["streamed"]["many"]["n_chunks"] == 32


def test_two_shard_records_match_jax(ranks, jax_two_devices):
    jm, _ = _jax_smf(jax_two_devices)
    want = _jax_records(jm)
    got = ranks[0]["records"]
    assert_records_close(events(got, "adam"), events(want, "adam"))
    assert events(got, "adam")[-1]["grad_noise_scale"] > 0
    assert events(got, "comm")[0]["bytes_per_step"] == \
        events(want, "comm")[0]["bytes_per_step"] == 48
    # Only process 0 logs the tap; both ran the same fit.
    assert not events(ranks[1]["records"], "adam")
    assert ranks[0]["traj"] == ranks[1]["traj"]


# --------------------------------------------------------------------- #
# Spans, heartbeat, Timer, StepsPerSecond, profiled_fit
# --------------------------------------------------------------------- #
def test_spans_nest_and_record_failures():
    logger, sink = new_logger()
    with telemetry.span(logger, "outer"):
        with telemetry.span(logger, "inner"):
            pass
    with pytest.raises(RuntimeError):
        with telemetry.span(logger, "broken"):
            raise RuntimeError("boom")
    assert [(r["path"], r["depth"], r["ok"])
            for r in events(sink, "span")] == [
        ("outer/inner", 1, True), ("outer", 0, True), ("broken", 0, False)]
    with telemetry.span(None, "ignored"):
        pass


def test_heartbeat_detects_stall_and_recovery():
    logger, sink = new_logger()
    with telemetry.Heartbeat(logger, interval=0.05, stall_after=0.12) as hb:
        hb.tick(1)
        time.sleep(0.3)            # silent: the stall fires
        hb.tick(2)                 # progress: the recovery fires
        time.sleep(0.12)
    assert hb._thread is None      # stopped within its join's limit
    beats = events(sink, "heartbeat")
    assert beats and beats[0]["process"] == 0
    stalls = events(sink, "stall")
    assert len(stalls) == 1 and stalls[0]["stalled_s"] > 0.12
    assert len(events(sink, "stall_recovered")) == 1


def test_timer_records_percentiles():
    out = profiling.Timer(lambda x: x + 1.0, warmup=1)(8, torch.zeros(()))
    assert 0.0 < out["p50"] <= out["p95"]
    assert len(out["latencies"]) == 8
    assert out["n_calls"] == 8 and out["calls_per_sec"] > 0


def test_steps_per_second_reset_drops_warmup():
    meter = profiling.StepsPerSecond()
    meter.tick()
    time.sleep(0.2)
    meter.reset()
    assert meter.rate == 0.0 and meter.steps == 0
    meter.tick()
    time.sleep(0.01)
    meter.tick(4)
    assert meter.rate > 100.0


def test_profiled_fit_on_the_cpu(tmp_path):
    model = SMFModel(aux_data=make_smf_data(2_048, device=CPU))
    model.run_adam(guess=GUESS, nsteps=2, progress=False)
    logger, sink = new_logger()
    with telemetry.profiled_fit(logger, nsteps=3, log_dir=str(tmp_path),
                                device=CPU) as prof:
        model.run_adam(guess=GUESS, nsteps=3, progress=False)
    rec = prof.record
    assert prof.error is None and "error" not in rec
    assert rec["filter"] == "cpu_ops" and rec["total_device_us"] > 0
    assert rec["per_step_us"] == pytest.approx(rec["total_device_us"] / 3,
                                               rel=1e-3)
    assert rec["tunnel_rtt_ms"] > 0 and rec["top_ops"]
    assert events(sink, "profile")[0]["wall_s"] == rec["wall_s"]
    with pytest.raises(NotImplementedError, match="item 10"):
        with telemetry.profiled_fit(cost=object(), device=CPU):
            pass


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
