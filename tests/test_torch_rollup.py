"""The port's history plane (``telemetry/rollup.py`` and
``telemetry/budget.py``, copies of the JAX package's) against the
originals, and the scheduler feeding it.

One event sequence, on a fake clock, goes through each package's
``RollupStore`` (counters, gauges, distributions, fit-summary records,
a scrape of a registry, a heartbeat delta merged in, per-tenant usage)
and ``SloBudget`` (observations, sheds, burn-rate alerts): every windowed
query, delta, usage record, exported gauge and alert is equal.  All
exact: the copies do the same arithmetic in Python.  Then a port
scheduler with ``history=True`` populates its store from a served burst
and publishes the ``multigrad_rollup_*`` signals that
``autoscaler_inputs`` reads.
"""
import numpy as np
import pytest

import multigrad_tpu.telemetry as jax_tel
import multigrad_tpu.telemetry.rollup as jax_rollup
import multigrad_tpu_torch.telemetry as pt_tel
import multigrad_tpu_torch.telemetry.rollup as pt_rollup
from multigrad_tpu_torch.models import SMFModel, make_smf_data
from multigrad_tpu_torch.serve import FitScheduler
from multigrad_tpu_torch.telemetry import LiveMetrics, autoscaler_inputs

T0 = 1_000_000.0
PACKAGES = {"jax": (jax_tel, jax_rollup), "port": (pt_tel, pt_rollup)}


class FakeClock:
    def __init__(self, t=T0):
        self.t = t

    def __call__(self):
        return self.t


def _history(tel, rollup):
    """Drive one package's store and budget through the sequence; return
    everything observable."""
    clock = FakeClock()
    store = tel.RollupStore(clock=clock)
    lm = tel.LiveMetrics()
    seen = []
    rng = np.random.default_rng(5)
    for i in range(40):
        t = T0 + 7.5 * i
        store.inc(rollup.FITS, 1 + i % 3, t=t)
        store.set(rollup.BUSY_FRAC, float(0.3 + 0.01 * i), t=t)
        store.observe(rollup.QUEUE_WAIT_S, float(0.05 * i
                                                 + rng.uniform(0, 0.02)),
                      t=t)
        if i % 7 == 0:
            store.inc(rollup.SHEDS, t=t)
        store.note_usage(f"t{i % 3}", ("batch", "interactive")[i % 2],
                         fits=1, busy_s=0.125 * i, sheds=i % 5 == 0,
                         violations=i % 4 == 0, t=t)
    store.write({"event": "fit_summary", "t": T0 + 300.0,
                 "hops": {"queue_wait": 0.75}})
    store.write({"event": "resource_sample", "t": T0 + 301.0,
                 "busy_frac": 0.9})
    store.write({"event": "alert", "t": T0 + 301.0})
    store.write({"event": None})
    lm.set("multigrad_serve_queue_depth", 7.0)
    lm.set("multigrad_resource_busy_frac", 0.4)
    clock.t = T0 + 305.0
    store.scrape(lm)
    for w in (30.0, 60.0, 300.0, 3600.0):
        seen.append([store.delta(rollup.FITS, w), store.rate(rollup.FITS, w),
                     store.mean_over(rollup.BUSY_FRAC, w),
                     store.max_over(rollup.QUEUE_WAIT_S, w),
                     store.quantile_over(rollup.QUEUE_WAIT_S, 0.95, w),
                     store.trend(rollup.QUEUE_WAIT_S, w),
                     store.delta(rollup.SHEDS, w)])
    seen.append(store.take_delta())
    seen.append(store.take_delta())           # an idle interval
    clock.t = T0 + 320.0
    store.merge_delta({"fits": 4, "sheds": 1, "device_busy_s": 2.5,
                       "queue_wait_count": 4, "queue_wait_sum_s": 1.0,
                       "queue_wait_max_s": 0.5}, worker="w1")
    seen.append([store.delta("fleet.fits", 60.0),
                 store.quantile_over("fleet.queue_wait_s", 0.5, 60.0)])
    seen.append(store.usage_records())
    seen.append(sorted(map(str, store.names())))
    store.export(lm)
    seen.append(lm.render())
    seen.append(tel.autoscaler_inputs(lm, rollup=store))

    budget = tel.SloBudget("interactive", 1.0, budget=0.02, live=lm,
                           clock=clock)
    rule = tel.BurnRateAlert({"interactive": budget})
    for i in range(60):
        clock.t = T0 + 400.0 + 5.0 * i
        budget.observe(0.5 if i < 30 else 2.0, trace_id=f"tr{i}",
                       t=clock.t)
        if i % 9 == 0:
            budget.record_shed(t=clock.t)
        seen.append(rule.update({"event": "serve_dispatch",
                                 "t": clock.t}))
    seen.append(budget.snapshot())
    seen.append([budget.burn_rate(w) for w in (60.0, 300.0, 3600.0)])
    seen.append(lm.render())
    return seen


def test_history_plane_matches_jax():
    port = _history(*PACKAGES["port"])
    want = _history(*PACKAGES["jax"])
    assert len(port) == len(want)
    for i, (a, b) in enumerate(zip(port, want)):
        assert a == b, f"item {i}: {a!r} != {b!r}"
    # The sequence exercised what it claims to: windows with data, a
    # trend, and a burn-rate alert's rising edge.
    assert port[0][0] is not None and port[3][5] is not None
    assert any(isinstance(x, dict) and x.get("classes") for x in port)


def test_delta_keys_and_series_names_match_jax():
    assert pt_rollup.DELTA_KEYS == jax_rollup.DELTA_KEYS
    for name in ("FITS", "SHEDS", "DEVICE_BUSY_S", "QUEUE_WAIT_S",
                 "BUSY_FRAC", "DEFAULT_SCRAPE"):
        assert getattr(pt_rollup, name) == getattr(jax_rollup, name)


def test_scheduler_feeds_its_history_plane():
    model = SMFModel(aux_data=make_smf_data(600, device="cpu"))
    lm = LiveMetrics()
    with FitScheduler(model, buckets=(4,), start=False, batch_window_s=0.0,
                      live=lm, qos=True) as sched:
        futs = [sched.submit([-1.0 - 0.1 * i, 0.5], nsteps=5,
                             learning_rate=0.05, tenant=f"t{i % 2}")
                for i in range(3)]
        sched.start()
        for f in futs:
            assert np.isfinite(f.result(timeout=120).loss)
        store = sched.rollup
        assert store.delta(pt_rollup.FITS, 600.0) == pytest.approx(3.0)
        assert store.quantile_over(pt_rollup.QUEUE_WAIT_S, 0.95,
                                   600.0) is not None
        usage = {(r["tenant"], r["fits"]) for r in store.usage_records()}
        assert usage == {("t0", 2), ("t1", 1)}
        delta = store.take_delta()
        assert delta["fits"] == 3 and delta["device_busy_s"] > 0
        store.export(lm)
    inputs = autoscaler_inputs(lm)
    assert set(inputs) == {"busy_frac", "queue_wait_p95_s",
                           "headroom_bytes", "queue_wait_p95_trend",
                           "busy_frac_sustained", "slo_burn_rate"}
    assert inputs["queue_wait_p95_s"] is not None
    assert inputs["headroom_bytes"] is None        # the CPU: unmeasured
