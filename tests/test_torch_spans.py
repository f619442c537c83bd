"""The port's spans as profiler ranges (``telemetry/spans.py``): a span
opens ``mgt.<name>`` while a ``torch.profiler`` session runs, on every
thread, and nothing at all without one; the Adam loop's step and update
ranges and the history model's scan range, in the forward, the
checkpoint's recompute and (by sequence number) the backward.  On the
CPU profiler; no JAX."""
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multigrad_tpu_torch.models import SMFModel, make_smf_data
from multigrad_tpu_torch.models.galhalo_hist import (
    TRUTH, GalhaloHistModel, make_galhalo_hist_data)
from multigrad_tpu_torch.telemetry import spans
from multigrad_tpu_torch.telemetry.spans import span

CPU = "cpu"
NODE = "autograd::engine::evaluate_function: "


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def raw_events(prof):
    return list(prof.profiler.kineto_results.events())


def ranges(prof, name):
    """``(start_ns, end_ns, thread)`` of the host ranges called ``name``."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(),
                   e.start_thread_id())
                  for e in raw_events(prof) if e.name() == name)


def inside(outer, t):
    return any(s <= t < e for s, e, _ in outer)


@pytest.fixture
def counted(monkeypatch):
    """Every ``record_function`` a span opens, by the thread that opened
    it."""
    real = torch.autograd.profiler.record_function
    calls = []

    def record_function(name, *args):
        calls.append((name, threading.get_ident()))
        return real(name, *args)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        record_function)
    return calls


def test_span_opens_a_range_only_under_a_profile(counted):
    with span(None, "x"):
        pass
    assert counted == []
    # No profiler, no logger: one shared, reusable no-op context.
    assert span(None, "x") is span(None, "y")
    with cpu_profile() as prof:
        with span(None, "x"):
            torch.ones(3).sum()
    assert [name for name, _ in counted] == ["mgt.x"]
    assert len(ranges(prof, "mgt.x")) == 1
    with span(None, "x"):
        pass
    assert len(counted) == 1


def test_span_with_a_logger_still_records_under_a_profile(counted):
    records = []

    class Logger:
        def log(self, kind, **fields):
            records.append((kind, fields["path"]))
    with cpu_profile() as prof:
        with span(Logger(), "outer"):
            with span(Logger(), "inner"):
                pass
    assert records == [("span", "outer/inner"), ("span", "outer")]
    (outer,) = ranges(prof, "mgt.outer")
    (inner,) = ranges(prof, "mgt.inner")
    assert outer[0] <= inner[0] and inner[1] <= outer[1]


def test_span_on_a_thread_started_before_the_profile(counted):
    """The gate is the process-wide flag: a thread that was running
    before the profile began opens its range too."""
    go, done = threading.Event(), threading.Event()

    def work():
        go.wait(10)
        with span(None, "worker"):
            pass
        done.set()
    t = threading.Thread(target=work)
    t.start()
    with cpu_profile():
        go.set()
        assert done.wait(10)
    t.join(10)
    assert [(name, ident) for name, ident in counted] == [
        ("mgt.worker", t.ident)]


def test_run_adam_opens_a_step_and_an_update_a_step():
    model = SMFModel(aux_data=make_smf_data(2_048, device=CPU))
    with cpu_profile() as prof:
        model.run_adam(guess=(-1.0, 0.5), nsteps=4, progress=False)
    steps = ranges(prof, "mgt.adam.step")
    updates = ranges(prof, "mgt.adam.update")
    assert len(steps) == 4 and len(updates) == 4
    for s, e, thread in steps:
        held = [u for u in updates if s <= u[0] and u[1] <= e]
        assert len(held) == 1 and held[0][2] == thread


def hist_model(n=4_000, chunk=1_000):
    return GalhaloHistModel(aux_data=make_galhalo_hist_data(
        num_halos=n, chunk_size=chunk, device=CPU))


def test_history_scan_ranges_in_forward_recompute_and_backward():
    model = hist_model()
    guess = torch.tensor([float(x) for x in TRUTH]) + 0.05
    nsteps, chunks = 2, 4
    with cpu_profile() as prof:
        model.run_adam(guess=guess, nsteps=nsteps, learning_rate=1e-3,
                       progress=False)
    scans = ranges(prof, "mgt.hist.cumsum")
    steps = ranges(prof, "mgt.adam.step")
    # A step: each chunk's forward, and its recompute in the backward.
    assert len(scans) == 2 * chunks * nsteps
    assert all(inside(steps, s) for s, _, _ in scans)
    evs = raw_events(prof)
    forward = {}
    for e in evs:
        if e.name() == "aten::cumsum" and e.sequence_nr() >= 0 \
                and e.fwd_thread_id() == 0:
            forward[(e.sequence_nr(), e.start_thread_id())] = e.start_ns()
    nodes = [e for e in evs if e.name() == NODE + "CumsumBackward0"]
    assert len(nodes) == chunks * nsteps
    for n in nodes:
        start = forward[(n.sequence_nr(), n.fwd_thread_id())]
        assert inside(scans, start)


def test_trajectories_equal_with_the_profiler_on_and_off():
    guess = torch.tensor([float(x) for x in TRUTH]) + 0.05
    model = hist_model(n=2_000, chunk=500)
    off = model.run_adam(guess=guess, nsteps=3, learning_rate=1e-3,
                         progress=False)
    with cpu_profile():
        on = model.run_adam(guess=guess, nsteps=3, learning_rate=1e-3,
                            progress=False)
    assert torch.equal(on, off)
    smf = SMFModel(aux_data=make_smf_data(2_048, device=CPU))
    off = smf.run_adam(guess=(-1.0, 0.5), nsteps=5, progress=False)
    with cpu_profile():
        on = smf.run_adam(guess=(-1.0, 0.5), nsteps=5, progress=False)
    assert torch.equal(on, off)


def test_the_flag_is_the_profilers_own():
    """The gate reads ``torch.autograd.profiler``'s process-wide flag,
    which a profile sets on entry and clears on exit."""
    assert spans._profiler() is torch.autograd.profiler
    assert not torch.autograd.profiler._is_profiler_enabled
    with cpu_profile():
        assert torch.autograd.profiler._is_profiler_enabled
    assert not torch.autograd.profiler._is_profiler_enabled
