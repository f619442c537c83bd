"""The port's resource monitor (``telemetry/resources.py``) against the
JAX package's contract, on the CPU.

Device memory comes from the CUDA caching allocator; on the CPU, and in
any process that has not initialised CUDA, every device field is
``None`` and ``supported`` is ``False``, and nothing the monitor does
initialises CUDA.  Kernel-build accounting: a stubbed ``nvcc`` (a script
that writes its output file) makes ``ops.cuda_build.build`` report a
miss with its wall seconds, and the next build of the same source a hit.
``autoscaler_inputs``, ``measured_vs_modeled`` and the ``/status``
resources section equal the JAX package's on the same registry contents
(exact: the same arithmetic in Python).
"""
import os
import stat
import sys
import time

import pytest
import torch

import multigrad_tpu.telemetry as jax_tel
import multigrad_tpu.telemetry.resources as jax_res
import multigrad_tpu_torch.telemetry as pt_tel
import multigrad_tpu_torch.telemetry.resources as pt_res
from multigrad_tpu_torch.ops import cuda_build
from multigrad_tpu_torch.telemetry import (LiveMetrics, MemorySink,
                                           MetricsLogger, ResourceMonitor)
from multigrad_tpu_torch.telemetry.resources import (SNAPSHOT_KEYS,
                                                     compile_totals,
                                                     device_memory,
                                                     read_rss_bytes,
                                                     reset_compile_totals)
from multigrad_tpu_torch.utils.util import (add_compile_observer,
                                            remove_compile_observer)


def test_device_fields_are_null_and_cuda_stays_uninitialised():
    assert not torch.cuda.is_initialized()
    for dev in (device_memory(), device_memory("cpu"),
                device_memory(torch.device("cpu"))):
        assert dev == {"bytes_in_use": None, "peak_bytes": None,
                       "bytes_limit": None, "supported": False}
    sink = MemorySink()
    logger = MetricsLogger(sink)
    lm = LiveMetrics()
    with ResourceMonitor(live=lm, logger=logger, interval_s=0.01,
                         emit_every=1) as mon:
        with mon.dispatching():
            time.sleep(0.03)
        time.sleep(0.03)
    snap = mon.snapshot()
    assert set(snap) == set(SNAPSHOT_KEYS) == set(jax_res.SNAPSHOT_KEYS)
    assert snap["device_bytes_in_use"] is None
    assert snap["device_peak_bytes"] is None
    assert snap["device_bytes_limit"] is None
    assert snap["rss_bytes"] == pytest.approx(read_rss_bytes(), rel=0.5)
    assert mon.degraded
    notes = [r for r in sink.records
             if r["event"] == "resource_monitor_degraded"]
    assert len(notes) == 1
    assert lm.value("multigrad_resource_device_bytes_in_use") is None
    assert lm.value("multigrad_resource_busy_seconds_total") > 0
    assert not torch.cuda.is_initialized()
    logger.close()


def test_kernel_build_observer_counts_a_miss_then_a_hit(tmp_path,
                                                       monkeypatch):
    # A stand-in for nvcc: writes the library named after -o.
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        "time.sleep(0.05)\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'wb').write(b'not a real library')\n")
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(fake))
    seen = []

    def observer(key, seconds, hit):
        seen.append((key, hit, seconds))

    before = cuda_build.build_dir()
    ResourceMonitor(interval_s=60.0).close()   # installs its observer
    add_compile_observer(observer)
    add_compile_observer(observer)             # registered once
    reset_compile_totals()
    try:
        cuda_build.set_build_dir(tmp_path / "libs")
        (path,) = cuda_build.build(("erf_counts.cu",))
        assert path.exists() and path.parent == tmp_path / "libs"
        after_miss = compile_totals()
        cuda_build.build(("erf_counts.cu",))
        after_hit = compile_totals()
    finally:
        cuda_build.set_build_dir(before)
        remove_compile_observer(observer)
        remove_compile_observer(observer)      # absent: a no-op
    assert [(k, h) for k, h, _ in seen] == [("erf_counts.cu", False),
                                            ("erf_counts.cu", True)]
    assert seen[0][2] >= 0.05 and seen[1][2] == 0.0
    assert (after_miss["misses"], after_miss["hits"],
            after_miss["count"]) == (1, 0, 1)
    assert after_miss["seconds"] >= 0.05
    assert (after_hit["misses"], after_hit["hits"]) == (1, 1)
    assert after_hit["seconds"] == after_miss["seconds"]
    reset_compile_totals()


def _registry(tel, with_rollup):
    lm = tel.LiveMetrics()
    lm.set("multigrad_resource_busy_frac", 0.8)
    lm.set("multigrad_resource_device_bytes_limit", 16 * 2 ** 30)
    lm.set("multigrad_resource_device_peak_bytes", 10 * 2 ** 30)
    lm.set("multigrad_resource_uptime_seconds", 12.5)
    lm.set("multigrad_resource_rss_bytes", 3 * 2 ** 30)
    lm.set("multigrad_serve_queue_depth", 4)
    for v in (0.01, 0.05, 0.2):
        lm.observe("multigrad_serve_hop_seconds", v,
                   labels={"hop": "queue_wait"})
        lm.observe("multigrad_serve_hop_seconds", 9.0,
                   labels={"hop": "dispatch"})
    lm.set("multigrad_slo_budget_burn_rate", 2.5,
           labels={"priority_class": "interactive"})
    lm.set("multigrad_slo_budget_burn_rate", 0.5,
           labels={"priority_class": "batch"})
    if with_rollup:
        lm.set("multigrad_rollup_queue_wait_p95_s", 0.125)
        lm.set("multigrad_rollup_queue_wait_trend", 0.001)
        lm.set("multigrad_rollup_busy_frac_sustained", 0.6)
    return lm


@pytest.mark.parametrize("with_rollup", [False, True])
def test_autoscaler_inputs_match_jax(with_rollup):
    for empty in (pt_tel.LiveMetrics(), jax_tel.LiveMetrics()):
        assert set(pt_res.autoscaler_inputs(empty).values()) == {None}
    got = pt_res.autoscaler_inputs(_registry(pt_tel, with_rollup))
    want = jax_res.autoscaler_inputs(_registry(jax_tel, with_rollup))
    assert got == want
    assert got["headroom_bytes"] == 6 * 2 ** 30
    assert got["slo_burn_rate"] == 2.5


def test_status_resources_section_matches_jax():
    def section(tel):
        sink = tel.LiveSink(_registry(tel, True))
        return sink.status()["resources"]
    assert section(pt_tel) == section(jax_tel)


@pytest.mark.parametrize("measured, modeled", [
    (1000, 1000), (1500, 1000), (None, 1000), (7.2e9, 26240), (5, 0)])
def test_measured_vs_modeled_matches_jax(measured, modeled):
    assert pt_res.measured_vs_modeled(measured, modeled) == \
        jax_res.measured_vs_modeled(measured, modeled)


def test_busy_hooks_reentrant_and_ring_bounded():
    mon = ResourceMonitor(interval_s=60.0, capacity=4)
    mon.sample()
    with mon.dispatching():
        with mon.dispatching():
            time.sleep(0.03)
    busy = mon.busy_seconds
    assert 0.02 <= busy < 1.0
    for _ in range(6):
        sample = mon.sample()
    assert 0.0 <= sample["busy_frac"] <= 1.0
    assert len(mon.ring()) == 4
    mon.close()
    assert not torch.cuda.is_initialized()
    assert os.path.exists("/proc/self/statm") == (read_rss_bytes()
                                                  is not None)
