"""The port's multi-tenant QoS and SLO layer (``serve/qos.py``,
``serve/slo.py``, copies of the JAX package's) against the originals.

The same submissions, in the same order, go through each package's
``FitQueue(qos=QosPolicy(...))``: the dequeue order (deficit round-robin
over tenants, EDF within a config), the shed victims, the quota rejects
and ``take_group``'s packing must be equal, request for request (ids are
the queues' own counters, equal in both).  ``parse_slo`` and
``SloMonitor`` give equal verdicts on the same latencies.  All exact: the
copies do the same arithmetic in Python.  The dequeue-against-shed race
of ``tests/test_qos.py`` is replayed through the port's copy of the
interleaving harness, with the same schedules.  A scheduler with QoS on
serves a tagged fit on the port's SMF model and files it under its
class.
"""
import time

import numpy as np
import pytest

import multigrad_tpu.serve.qos as jax_qos
import multigrad_tpu.serve.queue as jax_queue
import multigrad_tpu.serve.slo as jax_slo
import multigrad_tpu_torch.serve.qos as pt_qos
import multigrad_tpu_torch.serve.queue as pt_queue
import multigrad_tpu_torch.serve.slo as pt_slo
from multigrad_tpu_torch._lockdep import sched_point
from multigrad_tpu_torch.models import SMFModel, make_smf_data
from multigrad_tpu_torch.serve import FitScheduler, QueueFullError
from multigrad_tpu_torch.utils.testing import (default_schedules,
                                               run_interleavings)

PACKAGES = {"jax": (jax_queue, jax_qos, jax_slo),
            "port": (pt_queue, pt_qos, pt_slo)}


def _req(queue_mod, qos_mod, q, tenant=None, cls=None, deadline=None,
         nsteps=5, guess=(-1.0, 0.5)):
    rid = q.next_id()
    return queue_mod.FitRequest(
        id=rid, guess=np.asarray(guess, float),
        config=queue_mod.FitConfig(nsteps=nsteps),
        future=queue_mod.FitFuture(rid), deadline=deadline,
        qos=qos_mod.make_tag(None, tenant, cls, None))


def _outcome(req):
    """How a request's future settled: ``None`` while pending, else the
    exception's type name and its QoS fields."""
    if not req.future.done():
        return None
    exc = req.future.exception(timeout=0)
    if exc is None:
        return "ok"
    return (type(exc).__name__, getattr(exc, "priority_class", None),
            getattr(exc, "shed_for", None))


def _both(scenario):
    out = {name: scenario(*mods) for name, mods in PACKAGES.items()}
    return out["jax"], out["port"]


# ------------------------------------------------------------------ #
# dequeue order: DRR over tenants, EDF within a config
# ------------------------------------------------------------------ #
def _drr_order(queue_mod, qos_mod, slo_mod):
    q = queue_mod.FitQueue(max_pending=256, qos=qos_mod.QosPolicy(
        weights={"gold": 2.0}, quantum=1.0))
    spec = [("hog", 0)] * 12 + [("mouse", 1)] * 3 + [("gold", 2)] * 6
    for tenant, cfg in spec:
        q.submit(_req(queue_mod, qos_mod, q, tenant=tenant,
                      nsteps=5 + cfg))
    order = []
    while len(q):
        group, _ = q.take_group(3, window_s=0.0, timeout=1.0)
        order.append([(r.id, qos_mod.request_tag(r).tenant) for r in group])
    q.close()
    return order


def test_drr_dequeue_order_matches_jax():
    jax_order, port_order = _both(_drr_order)
    assert port_order == jax_order
    assert len(port_order) >= 7


def _edf_order(queue_mod, qos_mod, slo_mod):
    q = queue_mod.FitQueue(max_pending=64, qos=qos_mod.QosPolicy())
    now = time.time()
    reqs = [_req(queue_mod, qos_mod, q, deadline=now + off)
            for off in (50.0, 20.0, 80.0, 35.0, 65.0, 10.0)]
    reqs.append(_req(queue_mod, qos_mod, q, deadline=None))
    reqs += [_req(queue_mod, qos_mod, q, tenant="b", deadline=now + off)
             for off in (5.0, 90.0)]
    for r in reqs:
        q.submit(r)
    groups = []
    while len(q):
        group, _ = q.take_group(4, window_s=0.0, timeout=1.0)
        groups.append([r.id for r in group])
    q.close()
    return groups


def test_edf_packing_matches_jax():
    jax_groups, port_groups = _both(_edf_order)
    assert port_groups == jax_groups


# ------------------------------------------------------------------ #
# admission: shed victims and quota rejects
# ------------------------------------------------------------------ #
def _shed_and_quota(queue_mod, qos_mod, slo_mod):
    settled = []
    q = queue_mod.FitQueue(
        max_pending=4, qos=qos_mod.QosPolicy(tenant_quota=2),
        on_settle=lambda r, k: settled.append((r.id, k)))
    far = time.time() + 100.0
    events, reqs = [], []
    for tenant, cls, deadline in (
            ("a", "batch", None), ("a", "batch", far),
            ("a", "standard", None), ("b", "batch", far),
            ("c", "interactive", None), ("c", "interactive", far),
            ("c", "interactive", None), ("d", "standard", None),
            ("d", "interactive", far), ("e", "batch", None)):
        r = _req(queue_mod, qos_mod, q, tenant=tenant, cls=cls,
                 deadline=deadline)
        reqs.append(r)
        try:
            q.submit(r)
            events.append((r.id, "admitted"))
        except qos_mod.TenantQuotaError as e:
            events.append((r.id, "quota", e.tenant, e.queued, e.quota))
        except queue_mod.QueueFullError as e:
            events.append((r.id, type(e).__name__))
    counts = q.qos_counts()
    group, _ = q.take_group(8, window_s=0.0, timeout=1.0)
    q.close()
    return (events, settled, [_outcome(r) for r in reqs], counts,
            [r.id for r in group])


def test_shed_victims_and_quota_rejects_match_jax():
    jax_out, port_out = _both(_shed_and_quota)
    assert port_out == jax_out
    events, settled = port_out[0], port_out[1]
    assert any(e[1] == "quota" for e in events)
    assert any(kind == "shed" for _, kind in settled)


def _take_group_packing(queue_mod, qos_mod, slo_mod):
    q = queue_mod.FitQueue(max_pending=64, qos=qos_mod.QosPolicy())
    for i in range(10):
        q.submit(_req(queue_mod, qos_mod, q, tenant=f"t{i % 3}",
                      cls=("batch", "standard", "interactive")[i % 3],
                      nsteps=5 + (i % 2)))
    groups = []
    while len(q):
        group, cancelled = q.take_group(4, window_s=0.0, timeout=1.0)
        groups.append(([r.id for r in group], [r.id for r in cancelled],
                       group[0].config.nsteps))
    q.close()
    return groups


def test_take_group_packing_matches_jax():
    jax_groups, port_groups = _both(_take_group_packing)
    assert port_groups == jax_groups


# ------------------------------------------------------------------ #
# SLOs
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("text", [
    "p95 < 2 s for interactive", "P50<0.5 for class batch",
    "p99 < 0.25 s for standard", "latency should be ok", "p150 < 1 for x"])
def test_parse_slo_matches_jax(text):
    def parse(slo_mod):
        try:
            s = slo_mod.parse_slo(text)
        except ValueError:
            return "ValueError"
        return (s.priority_class, s.threshold_s, s.quantile, s.budget,
                s.describe())
    assert parse(pt_slo) == parse(jax_slo)


def _verdicts(slo_mod, budgets):
    mon = slo_mod.SloMonitor(slos=["p95 < 1.0 s for interactive",
                                   "p50 < 0.3 s for batch"],
                             budgets=budgets)
    seen = [mon.evaluate(), mon.ok()]
    rng = np.random.default_rng(3)
    for v in rng.uniform(0.05, 0.9, 30):
        mon.observe("interactive", "acme", float(v))
    seen += [mon.evaluate(), mon.ok()]
    for v in (5.0,) * 4:
        mon.observe("interactive", "acme", v)
    for v in rng.uniform(0.1, 0.5, 7):
        mon.observe("batch", "hog", float(v))
    mon.observe("standard", "hog", 9.0)
    mon.record_shed("batch", "hog")
    seen += [mon.evaluate(), mon.ok(), mon.snapshot()]
    if budgets:
        # The ledgers' time-derived fields (burn rates, the exhaustion
        # ETA) read the wall clock; the counts must agree.
        for entry in seen[-1]["classes"].values():
            budget = entry.get("budget")
            if budget is not None:
                entry["budget"] = (budget["budget"], budget["violations"])
        for ev in (seen[0], seen[2], seen[4]):
            for entry in ev.values():
                budget = entry.get("budget")
                if budget is not None:
                    entry["budget"] = (budget["budget"],
                                       budget["violations"])
    return seen


@pytest.mark.parametrize("budgets", [False, True])
def test_slo_monitor_verdicts_match_jax(budgets):
    port = _verdicts(pt_slo, budgets)
    assert port == _verdicts(jax_slo, budgets)
    assert port[1] is True and port[5] is False


# ------------------------------------------------------------------ #
# the dequeue-against-shed race, through the copied harness
# ------------------------------------------------------------------ #
def test_dequeue_vs_shed_race_never_double_settles():
    runs = []

    def build():
        state = {"took": None, "shed": [], "admitted": None}
        runs.append(state)
        q = pt_queue.FitQueue(max_pending=1, qos=pt_qos.QosPolicy(),
                              on_settle=lambda r, k:
                              state["shed"].append((r.id, k)))
        low = _req(pt_queue, pt_qos, q, cls="batch")
        q.submit(low)
        high = _req(pt_queue, pt_qos, q, cls="interactive")
        state["low_id"], state["high_id"] = low.id, high.id

        def taker():
            sched_point("pre-take")
            group, _ = q.take_group(1, window_s=0.0, timeout=2.0)
            state["took"] = tuple(r.id for r in group)

        def shedder():
            sched_point("pre-submit")
            try:
                q.submit(high)
                state["admitted"] = True
            except QueueFullError:
                state["admitted"] = False

        return [taker, shedder]

    outs = run_interleavings(build, deadlock_timeout_s=1.2,
                             timeout_s=20.0)
    # The JAX test's schedules: the harness's default set for two
    # workers, every one replayed.
    assert [o.schedule for o in outs] == [tuple(s) for s in
                                          default_schedules(2)]
    assert not any(o.deadlocked for o in outs), outs
    assert not any(o.errors for o in outs), outs
    for st in runs:
        took = st["took"] or ()
        shed_ids = [rid for rid, kind in st["shed"] if kind == "shed"]
        assert st["admitted"] is True
        low_took = st["low_id"] in took
        low_shed = st["low_id"] in shed_ids
        assert low_took != low_shed
        assert len(took) == 1
        if low_shed:
            assert took == (st["high_id"],)


# ------------------------------------------------------------------ #
# the scheduler with QoS on
# ------------------------------------------------------------------ #
def test_scheduler_qos_stats_and_slo_wiring():
    model = SMFModel(aux_data=make_smf_data(600, device="cpu"))
    with FitScheduler(model, buckets=(1,), start=False,
                      batch_window_s=0.0, qos=True,
                      slo=["p95 < 300 s for standard"]) as sched:
        fut = sched.submit([-1.0, 0.5], nsteps=5, learning_rate=0.05,
                           tenant="acme")
        sched.start()
        assert np.isfinite(fut.result(timeout=120).loss)
        ev = sched.slo.evaluate()["standard"]
        assert ev["count"] == 1
        assert ev["slo"]["ok"] is True
        assert sched.slo.ok() is True
        assert sched.stats["qos_shed"] == {"by_class": {},
                                           "by_tenant": {}}
