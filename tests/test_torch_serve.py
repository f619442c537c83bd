"""The port's serving layer (``multigrad_tpu_torch/serve/``): the
scheduler against the JAX package's and against solo fits, and the
behaviour tests of ``tests/test_serve.py`` on the port.

Fixtures mirror ``tests/test_serve.py``: the SMF model at 600 halos,
``BOUNDS = [(-5.0, 1.0), (0.01, 2.0)]`` and an exact-arithmetic model
whose data are equal powers of two.  All on the CPU, where the erf
counts run their plain versions.

Tolerances.  Served against the JAX package's ``FitScheduler`` on the
same guesses (buckets (4,), 3 requests, 20 steps at 0.05 within
``BOUNDS``, the JAX package's catalog carried over with
``aux_from_numpy``): trajectories at atol 1e-4 and losses at rtol 5e-4,
the port's SMF parity limits (``tests/test_torch_smf.py``: the two
packages round each halo's cdf differences differently, so the losses
at one point agree to 5e-4 relative and Adam's near-sign updates move a
trajectory by far less than 1e-4), the loss's limit widened by the
first-order move of the final point, ``|grad|_1 · 1e-4`` (measured: the
trajectories within 5.8e-5, the losses within 8.5e-5 absolute); the
bucket, the dispatch count, the padded rows and the completions equal.
Served against solo fits in the port: bit for bit on the exact model,
rtol 1e-6 on SMF (the rows are bit-equal on the CPU too; the limit is
the one ``chip_smoke.py`` holds the card to).  A poisoned row's
batch-mates equal a clean batch's bit for bit.
"""
import json
import os
import time
from dataclasses import dataclass, field

import numpy as np
import pytest
import torch

from multigrad_tpu.models.smf import SMFModel as JaxSMFModel
from multigrad_tpu.models.smf import make_smf_data as jax_make_smf_data
from multigrad_tpu.serve import FitConfig as JaxFitConfig
from multigrad_tpu.serve import FitScheduler as JaxFitScheduler
from multigrad_tpu.serve.scheduler import \
    FitScheduler as JaxScheduler
from multigrad_tpu_torch.core.model import OnePointModel
from multigrad_tpu_torch.models import SMFModel, aux_from_numpy, \
    make_smf_data
from multigrad_tpu_torch.ops import cuda_build
from multigrad_tpu_torch.serve import (DEFAULT_BUCKETS, FitCancelled,
                                       FitConfig, FitDeadlineExceeded,
                                       FitFailed, FitOOMError, FitScheduler,
                                       QueueFullError, cache_entries,
                                       enable_compile_cache, warmup_buckets)
from multigrad_tpu_torch.serve import scheduler as sched_mod
from multigrad_tpu_torch.telemetry import LiveSink, MemorySink, \
    MetricsLogger

CPU = "cpu"
BOUNDS = [(-5.0, 1.0), (0.01, 2.0)]
POISON = np.array([np.nan, 0.5])
TRAJ_ATOL, LOSS_RTOL, SOLO_RTOL = 1e-4, 5e-4, 1e-6


@dataclass
class ExactModel(OnePointModel):
    """Every reduction exact in float32: the data are equal powers of
    two, so partial sums are exact in any association."""

    aux_data: dict = field(default_factory=dict)

    def calc_partial_sumstats_from_params(self, params, randkey=None):
        return self.aux_data["x"].sum() * params

    def calc_loss_from_sumstats(self, sumstats, sumstats_aux=None,
                                randkey=None):
        return ((sumstats - self.aux_data["target"]) ** 2).sum()


def make_exact_model():
    n = 64
    scale = n * 2.0 ** -10
    return ExactModel(aux_data=dict(
        x=torch.full((n,), 2.0 ** -10),
        target=torch.tensor([scale * -1.5, scale * 0.4])))


def _np(aux):
    return {k: (np.asarray(v) if hasattr(v, "shape") else v)
            for k, v in aux.items()}


@pytest.fixture(scope="module")
def jax_aux():
    return jax_make_smf_data(600)


@pytest.fixture(scope="module")
def local_model():
    return SMFModel(aux_data=make_smf_data(600, device=CPU))


def _await(futures, timeout=120):
    return [f.result(timeout=timeout) for f in futures]


# ------------------------------------------------------------------ #
# served against the JAX package and against solo fits
# ------------------------------------------------------------------ #
def test_served_fits_match_jax_scheduler(jax_aux):
    rng = np.random.default_rng(7)
    guesses = np.column_stack([rng.uniform(-2.5, -1.0, 3),
                               rng.uniform(0.2, 0.8, 3)])
    kw = dict(nsteps=20, learning_rate=0.05, param_bounds=BOUNDS)
    out = {}
    for name, sched_cls, model in (
            ("jax", JaxFitScheduler, JaxSMFModel(aux_data=dict(jax_aux))),
            ("port", FitScheduler, SMFModel(aux_data=aux_from_numpy(
                _np(jax_aux), device=CPU)))):
        with sched_cls(model, buckets=(4,), start=False,
                       batch_window_s=0.0) as sched:
            futs = [sched.submit(g, **kw) for g in guesses]
            sched.start()
            out[name] = (_await(futs), sched)
    (jr, js), (pr, ps) = out["jax"], out["port"]
    port_model = ps.model
    for a, b in zip(pr, jr):
        assert a.traj.shape == b.traj.shape == (21, 2)
        np.testing.assert_allclose(a.traj, b.traj, rtol=0, atol=TRAJ_ATOL)
        # The loss moves with the final point: rtol 5e-4 for the model,
        # plus |grad|_1 times the trajectory's limit.
        _, grad = port_model.calc_loss_and_grad_from_params(a.params)
        np.testing.assert_allclose(
            a.loss, b.loss, rtol=LOSS_RTOL,
            atol=float(grad.abs().sum()) * TRAJ_ATOL)
        assert a.bucket == b.bucket == 4
    for key in ("dispatches", "rows_padded", "completed"):
        assert ps.stats[key] == js.stats[key]
    assert ps.stats["bucket_dispatches"] == js.stats["bucket_dispatches"]


def test_bucketed_results_bitwise_match_solo_fits():
    model = make_exact_model()
    guesses = [np.array([-1.0, 0.5]), np.array([-2.2, 0.3]),
               np.array([-0.5, 1.0])]
    with FitScheduler(model, buckets=(4,), start=False,
                      batch_window_s=0.0) as sched:
        futs = [sched.submit(g, nsteps=20, learning_rate=0.05,
                             param_bounds=BOUNDS) for g in guesses]
        sched.start()
        results = _await(futs)
    assert [r.bucket for r in results] == [4, 4, 4]
    for g, r in zip(guesses, results):
        solo = model.run_adam(guess=g, nsteps=20, param_bounds=BOUNDS,
                              learning_rate=0.05, progress=False).numpy()
        assert r.traj.shape == solo.shape
        assert np.array_equal(r.traj, solo)
        assert np.array_equal(r.params, solo[-1])
        assert np.isfinite(r.loss)
    stats = sched.stats
    assert stats["dispatches"] == 1
    assert stats["rows_padded"] == 1
    assert stats["completed"] == 3


def test_bucketed_smf_matches_solo(local_model):
    guesses = [np.array([-1.0, 0.5]), np.array([-2.2, 0.3]),
               np.array([-0.5, 1.0])]
    with FitScheduler(local_model, buckets=(4,), start=False,
                      batch_window_s=0.0) as sched:
        futs = [sched.submit(g, nsteps=20, learning_rate=0.05,
                             param_bounds=BOUNDS) for g in guesses]
        sched.start()
        results = _await(futs)
    for g, r in zip(guesses, results):
        solo = local_model.run_adam(
            guess=g, nsteps=20, param_bounds=BOUNDS, learning_rate=0.05,
            progress=False).numpy()
        np.testing.assert_allclose(r.traj, solo, rtol=SOLO_RTOL, atol=0)
        assert np.isfinite(r.loss)


def test_dispatch_ignores_the_callers_grad_mode(local_model):
    def serve():
        with FitScheduler(local_model, buckets=(1,), start=False,
                          batch_window_s=0.0) as sched:
            fut = sched.submit([-1.3, 0.4], nsteps=6, learning_rate=0.05)
            sched.start()
            return fut.result(timeout=120)
    plain = serve()
    with torch.no_grad():
        quiet = serve()
    assert np.array_equal(plain.traj, quiet.traj)
    assert plain.loss == quiet.loss


def test_mixed_configs_never_share_a_bucket(local_model):
    with FitScheduler(local_model, buckets=(1, 4), start=False,
                      batch_window_s=0.0) as sched:
        fa = [sched.submit([-1.0 - 0.1 * i, 0.5], nsteps=8,
                           learning_rate=0.05) for i in range(3)]
        fb = [sched.submit([-1.0 - 0.1 * i, 0.5], nsteps=4,
                           learning_rate=0.1) for i in range(2)]
        fk = sched.submit([-1.1, 0.5], nsteps=4, learning_rate=0.1,
                          randkey=7)
        sched.start()
        ra, rb = _await(fa), _await(fb)
        rk = fk.result(timeout=120)
    assert [r.traj.shape for r in ra] == [(9, 2)] * 3
    assert [r.traj.shape for r in rb] == [(5, 2)] * 2
    solo_k = local_model.run_adam(guess=[-1.1, 0.5], nsteps=4,
                                  learning_rate=0.1, randkey=7,
                                  progress=False).numpy()
    np.testing.assert_allclose(rk.traj, solo_k, rtol=SOLO_RTOL, atol=0)
    for i, r in enumerate(ra):
        solo = local_model.run_adam(guess=[-1.0 - 0.1 * i, 0.5], nsteps=8,
                                    learning_rate=0.05,
                                    progress=False).numpy()
        np.testing.assert_allclose(r.traj, solo, rtol=SOLO_RTOL, atol=0)
    assert sched.stats["dispatches"] >= 3


def test_mismatched_ndim_requests_never_share_a_bucket(local_model):
    with FitScheduler(local_model, buckets=(4,), start=False,
                      batch_window_s=0.0) as sched:
        good = sched.submit([-1.0, 0.5], nsteps=5, learning_rate=0.05)
        stray = sched.submit([-1.0, 0.5, 0.1], nsteps=5,
                             learning_rate=0.05)
        sched.start()
        r = good.result(timeout=120)
        exc = stray.exception(timeout=120)
        assert np.isfinite(r.loss)
        assert exc is not None
        assert r.traj.base is None and r.params.base is None
        later = sched.submit([-1.2, 0.5], nsteps=5, learning_rate=0.05)
        assert np.isfinite(later.result(timeout=120).loss)


# ------------------------------------------------------------------ #
# bucket quantization bounds the programs built
# ------------------------------------------------------------------ #
def test_programs_built_bounded_by_bucket_count(local_model):
    # The port's counterpart of the retrace count: the batch shapes the
    # wrapper ever sees, the (config, ndim, bucket) dispatch identities
    # and the wrappers built are bounded by the bucket count, however
    # many requests flow through.
    sched = FitScheduler(local_model, buckets=(1, 4), start=False,
                         batch_window_s=0.0)
    inner = sched._wrapper(False)
    shapes = []

    def counting(p, key, dynamic):
        shapes.append(tuple(p.shape))
        return inner(p, key, dynamic)

    sched._wrappers[False] = counting

    def burst(n, offset=0.0):
        return [sched.submit([-1.0 - 0.05 * i - offset, 0.5], nsteps=5,
                             learning_rate=0.05) for i in range(n)]

    futs = burst(11)           # groups of 4, 4, 3
    sched.start()
    _await(futs)
    first = set(shapes)
    assert first <= {(4, 2), (1, 2)}
    programs = set(sched._dispatched_programs)
    assert len(programs) <= 2
    _await(burst(8, offset=1.0))
    sched.close()
    assert set(shapes) == first
    assert sched._dispatched_programs == programs
    assert list(sched._wrappers) == [False]
    assert sched.stats["completed"] == 19


# ------------------------------------------------------------------ #
# poison isolation
# ------------------------------------------------------------------ #
def test_nan_poison_isolated_to_its_row(local_model, tmp_path):
    mates_g = [np.array([-1.0, 0.5]), np.array([-2.0, 0.3]),
               np.array([-0.7, 0.8])]
    with FitScheduler(local_model, buckets=(4,), start=False,
                      batch_window_s=0.0) as ref:
        futs = [ref.submit(g, nsteps=10, learning_rate=0.05)
                for g in [mates_g[0], np.array([-1.5, 0.6]),
                          mates_g[1], mates_g[2]]]
        ref.start()
        clean = _await(futs)

    with FitScheduler(local_model, buckets=(4,), start=False,
                      batch_window_s=0.0, retry_poisoned=False,
                      flight_dir=str(tmp_path)) as sched:
        futs = [sched.submit(g, nsteps=10, learning_rate=0.05)
                for g in [mates_g[0], POISON, mates_g[1], mates_g[2]]]
        sched.start()
        mates = [futs[i].result(timeout=120) for i in (0, 2, 3)]
        exc = futs[1].exception(timeout=120)

    assert isinstance(exc, FitFailed)
    assert exc.bundle_path and os.path.exists(exc.bundle_path)
    with open(exc.bundle_path) as f:
        bundle = json.load(f)
    assert bundle["reason"] == "non_finite_request"
    assert bundle["detail"]["request_id"] == futs[1].request_id
    assert bundle["detail"]["bucket"] == 4
    ring = bundle["detail"]["resources"]
    assert ring and ring[-1]["rss_bytes"] > 0
    # On the CPU the device fields are null (no CUDA initialised).
    assert ring[-1]["device_bytes_in_use"] is None
    for r_clean, r_poisoned in zip([clean[0], clean[2], clean[3]], mates):
        assert np.array_equal(r_poisoned.traj, r_clean.traj)
        assert r_poisoned.loss == r_clean.loss
    stats = sched.stats
    assert stats["completed"] == 3 and stats["failed"] == 1


def test_poisoned_request_retried_once_on_fresh_bucket(local_model,
                                                       tmp_path):
    with FitScheduler(local_model, buckets=(1, 4), start=False,
                      batch_window_s=0.0, retry_poisoned=True,
                      flight_dir=str(tmp_path)) as sched:
        mate = sched.submit([-1.0, 0.5], nsteps=5, learning_rate=0.05)
        poison = sched.submit(POISON, nsteps=5, learning_rate=0.05)
        sched.start()
        assert np.isfinite(mate.result(timeout=120).loss)
        exc = poison.exception(timeout=120)
    assert isinstance(exc, FitFailed) and exc.bundle_path
    stats = sched.stats
    assert stats["retried"] == 1 and stats["failed"] == 1
    assert stats["bucket_dispatches"].get(1, 0) >= 1


# ------------------------------------------------------------------ #
# deadline / cancel / backpressure / drain
# ------------------------------------------------------------------ #
def test_deadline_enforced_at_dispatch(local_model):
    sched = FitScheduler(local_model, buckets=(1, 4), start=False,
                         batch_window_s=0.0)
    doomed = sched.submit([-1.0, 0.5], nsteps=5, learning_rate=0.05,
                          deadline_s=1e-4)
    alive = sched.submit([-1.2, 0.5], nsteps=5, learning_rate=0.05)
    time.sleep(0.01)
    sched.start()
    with pytest.raises(FitDeadlineExceeded):
        doomed.result(timeout=120)
    assert np.isfinite(alive.result(timeout=120).loss)
    sched.close()
    assert sched.stats["expired"] == 1


def test_cancel_pending_request(local_model):
    sched = FitScheduler(local_model, buckets=(1, 4), start=False,
                         batch_window_s=0.0)
    victim = sched.submit([-1.0, 0.5], nsteps=5, learning_rate=0.05)
    alive = sched.submit([-1.2, 0.5], nsteps=5, learning_rate=0.05)
    assert victim.cancel() is True
    assert victim.cancelled() and victim.done()
    sched.start()
    with pytest.raises(FitCancelled):
        victim.result(timeout=120)
    assert np.isfinite(alive.result(timeout=120).loss)
    assert alive.cancel() is False
    sched.close()


def test_backpressure_bounds_the_queue(local_model):
    sched = FitScheduler(local_model, buckets=(4,), max_pending=2,
                         start=False, batch_window_s=0.0)
    f1 = sched.submit([-1.0, 0.5], nsteps=5, learning_rate=0.05)
    f2 = sched.submit([-1.1, 0.5], nsteps=5, learning_rate=0.05)
    with pytest.raises(QueueFullError):
        sched.submit([-1.2, 0.5], nsteps=5, learning_rate=0.05)
    t0 = time.perf_counter()
    with pytest.raises(QueueFullError):
        sched.submit([-1.2, 0.5], nsteps=5, learning_rate=0.05,
                     block=True, timeout=0.05)
    assert time.perf_counter() - t0 >= 0.05
    sched.start()
    _await([f1, f2])
    f3 = sched.submit([-1.2, 0.5], nsteps=5, learning_rate=0.05)
    assert np.isfinite(f3.result(timeout=120).loss)
    sched.close()


def test_graceful_drain_serves_pending_then_refuses(local_model):
    sched = FitScheduler(local_model, buckets=(1, 4), start=False,
                         batch_window_s=0.0)
    futs = [sched.submit([-1.0 - 0.1 * i, 0.5], nsteps=5,
                         learning_rate=0.05) for i in range(5)]
    sched.start()
    sched.close(drain=True)
    for f in futs:
        assert np.isfinite(f.result(timeout=1).loss)
    with pytest.raises(RuntimeError):
        sched.submit([-1.0, 0.5], nsteps=5, learning_rate=0.05)


# ------------------------------------------------------------------ #
# admission control: the JAX package's exception types
# ------------------------------------------------------------------ #
INVALID = {
    "not 1-D": dict(guess=np.zeros((2, 2)), nsteps=5),
    "empty": dict(guess=np.zeros(0), nsteps=5),
    "outside the box": dict(guess=[-10.0, 0.5], nsteps=5,
                            param_bounds=BOUNDS),
    "on the bound": dict(guess=[-5.0, 0.5], nsteps=5,
                         param_bounds=BOUNDS),
    "bounds of another ndim": dict(guess=[-1.0, 0.5], nsteps=5,
                                   param_bounds=[(-5.0, 1.0)]),
    "no steps": dict(guess=[-1.0, 0.5], nsteps=0),
    "an array key": dict(guess=[-1.0, 0.5], nsteps=5,
                         randkey=np.array([0, 1])),
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_admission_control_matches_jax(case, jax_aux, local_model):
    def raised(sched_cls, model):
        with sched_cls(model, buckets=(1,), start=False) as sched:
            try:
                sched.submit(**INVALID[case])
            except Exception as e:      # the type is what is compared
                return type(e).__name__
            return None
    jax_type = raised(JaxScheduler, JaxSMFModel(aux_data=dict(jax_aux)))
    assert jax_type is not None
    assert raised(FitScheduler, local_model) == jax_type


def test_fitconfig_validation_matches_jax():
    for kwargs in (dict(nsteps=0), dict(nsteps=5, learning_rate=-1.0),
                   dict(nsteps=5, randkey=np.array([0, 1])),
                   dict(nsteps=5, param_bounds=[(1.0, 0.0)])):
        types = []
        for cls in (JaxFitConfig, FitConfig):
            try:
                cls(**kwargs)
                types.append(None)
            except Exception as e:
                types.append(type(e).__name__)
        assert types[0] == types[1], (kwargs, types)


# ------------------------------------------------------------------ #
# ladder: "auto", the tuning table, sharded K, the memory budget
# ------------------------------------------------------------------ #
def test_bucket_ladder_resolution(local_model, tmp_path, monkeypatch):
    # "auto" resolves from the tuning table; cold, DEFAULT_BUCKETS.
    monkeypatch.setenv("MGT_TUNING_TABLE", str(tmp_path / "missing.json"))
    with FitScheduler(local_model, start=False) as sched:
        assert sched.buckets == DEFAULT_BUCKETS == (1, 4, 16, 64)
    with FitScheduler(local_model, tuning_table=str(tmp_path / "t.json"),
                      start=False) as sched:
        assert sched.buckets == DEFAULT_BUCKETS
    with pytest.raises(ValueError, match="ensemble_comm"):
        FitScheduler(local_model, k_sharded=True, start=False)
    with pytest.raises(ValueError):
        FitScheduler(local_model, buckets="fast", start=False)


@pytest.mark.parametrize("budget", [None, 10_000, 40_000, 10 ** 9])
def test_memory_budget_caps_the_ladder_as_jax(budget, jax_aux,
                                              local_model, monkeypatch):
    from multigrad_tpu_torch.inference import ensemble as ens
    config = FitConfig(nsteps=50)
    ladder = (1, 4, 16, 64)
    # The port's cap counts each row's autograd graph (4 bytes a halo,
    # 600 halos) beside the JAX package's carry: a rung is admitted when
    # the memory model's estimate of it fits the budget.
    graph = ens.row_graph_bytes(local_model)
    with FitScheduler(local_model, buckets=ladder, start=False,
                      k_budget_bytes=budget) as port:
        got = port._allowed_buckets(config, 2)
    fits = tuple(b for b in ladder if budget is None or ens
                 .ensemble_memory_model(b, 2, 50, graph_bytes=graph)
                 <= budget)
    assert got == (fits or ladder[:1])
    # With the graph term set to 0, the JAX package's ladder.
    monkeypatch.setattr(ens, "GRAPH_BYTES_PER_CATALOG_ROW", 0)
    with FitScheduler(local_model, buckets=ladder, start=False,
                      k_budget_bytes=budget) as port:
        got = port._allowed_buckets(config, 2)
    with JaxScheduler(JaxSMFModel(aux_data=dict(jax_aux)),
                      buckets=ladder, start=False,
                      k_budget_bytes=budget) as ref:
        want = ref._allowed_buckets(JaxFitConfig(nsteps=50), 2)
    assert got == want


def test_oom_settles_its_group_with_fit_oom_error(local_model, tmp_path):
    assert sched_mod._OOM_MARKERS == (
        "resource_exhausted", "out of memory", "hbm_allocator",
        "allocation failure")
    sched = FitScheduler(local_model, buckets=(4,), start=False,
                         batch_window_s=0.0, flight_dir=str(tmp_path))

    def out_of_memory(p, key, dynamic):
        raise torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 2.00 GiB")

    sched._wrappers[False] = out_of_memory
    futs = [sched.submit([-1.0 - 0.1 * i, 0.5], nsteps=5,
                         learning_rate=0.05) for i in range(3)]
    sched.start()
    errors = [f.exception(timeout=120) for f in futs]
    sched.close()
    for e in errors:
        assert isinstance(e, FitOOMError)
        assert e.bucket == 4 and e.estimated_bytes > 0
        assert isinstance(e.__cause__, torch.cuda.OutOfMemoryError)
        assert os.path.exists(e.bundle_path)
    assert sched.stats["failed"] == 3
    assert not sched_mod._is_oom(RuntimeError("the room is full"))


# ------------------------------------------------------------------ #
# warmup and the kernel-library directory
# ------------------------------------------------------------------ #
def test_warmup_buckets_entries_and_ndim_rule(local_model):
    with pytest.raises(ValueError):
        warmup_buckets(local_model, FitConfig(nsteps=3), buckets=(1,))
    entries = warmup_buckets(local_model,
                             FitConfig(nsteps=3, param_bounds=BOUNDS),
                             buckets=(4, 1))
    assert [e["bucket"] for e in entries] == [1, 4]
    for e in entries:
        assert set(e) == {"nsteps", "learning_rate", "bucket", "k_sharded",
                          "compile_s"}
        assert e["nsteps"] == 3 and e["k_sharded"] is False
        assert e["compile_s"] >= 0
    unbounded = warmup_buckets(local_model, FitConfig(nsteps=3), ndim=2,
                               buckets=(2,))
    assert [e["bucket"] for e in unbounded] == [2]


def test_scheduler_warmup_touches_no_stats_or_state(local_model):
    leaves = [t.clone() for t in local_model.aux_leaves()]
    with FitScheduler(local_model, buckets=(1, 4), start=False) as sched:
        entries = sched.warmup(FitConfig(nsteps=4, learning_rate=0.05),
                               ndim=2)
        assert [e["bucket"] for e in entries] == [1, 4]
        stats = sched.stats
        assert not stats.get("submitted") and not stats.get("dispatches")
        assert len(sched.queue) == 0
    assert all(torch.equal(a, b)
               for a, b in zip(leaves, local_model.aux_leaves()))


def test_enable_compile_cache_sets_the_library_directory(tmp_path):
    before = enable_compile_cache()
    try:
        assert before == str(cuda_build.build_dir())
        got = enable_compile_cache(str(tmp_path / "kernels"),
                                   min_compile_time_s=1.0)
        assert got == str(tmp_path / "kernels")
        assert enable_compile_cache() == got
        assert cuda_build.library_path("erf_counts.cu").parent == \
            tmp_path / "kernels"
        assert cache_entries() == 0
        (tmp_path / "kernels").mkdir()
        (tmp_path / "kernels" / "liberf_counts_0123.so").write_bytes(b"")
        (tmp_path / "kernels" / "notes.txt").write_text("not a library")
        assert cache_entries() == cache_entries(got) == 1
    finally:
        cuda_build.set_build_dir(before)
    assert str(cuda_build.build_dir()) == before


# ------------------------------------------------------------------ #
# observability wiring
# ------------------------------------------------------------------ #
def test_scheduler_gauges_and_fit_summary_records(local_model):
    sink = MemorySink()
    logger = MetricsLogger(sink)
    live = LiveSink()
    with FitScheduler(local_model, buckets=(1, 4), telemetry=logger,
                      live=live, start=False, batch_window_s=0.0) as sched:
        futs = [sched.submit([-1.0 - 0.1 * i, 0.5], nsteps=5,
                             learning_rate=0.05) for i in range(3)]
        sched.start()
        _await(futs)

    summaries = [r for r in sink.records if r["event"] == "fit_summary"]
    assert len(summaries) == 3
    ids = {f.request_id for f in futs}
    for rec in summaries:
        assert rec["request"] in ids
        assert rec["serve"] is True
        assert rec["bucket"] == 4 and rec["occupancy"] == 0.75
        assert np.isfinite(rec["final_loss"])
        assert set(rec["hops"]) == {"queue_wait", "bucket_coalesce",
                                    "dispatch", "adam_segments",
                                    "finalize"}
    dispatches = [r for r in sink.records if r["event"] == "serve_dispatch"]
    assert len(dispatches) == 1 and dispatches[0]["n_requests"] == 3
    truth = [r for r in sink.records if r["event"] == "measured_vs_modeled"]
    assert len(truth) == 1 and truth[0]["bucket"] == 4
    assert truth[0]["measured_peak_bytes"] is None  # the CPU: unmeasured
    assert truth[0]["modeled_bytes"] > 0

    snap = live.metrics.snapshot()
    for gauge in ("multigrad_serve_queue_depth",
                  "multigrad_serve_occupancy",
                  "multigrad_serve_fits_total",
                  "multigrad_serve_dispatches_total",
                  "multigrad_resource_rss_bytes"):
        assert gauge in snap, f"missing {gauge}"
    rendered = live.metrics.render()
    assert 'multigrad_serve_fits_total{outcome="ok"} 3' in rendered
    assert 'multigrad_serve_dispatches_total{bucket="4"} 1' in rendered
    logger.close()
