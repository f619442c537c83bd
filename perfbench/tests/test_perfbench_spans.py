"""The span table of a traced window (``core/spans.py``) on synthetic
event lists: the three rules that attribute a device event to a range,
the host's blocked time taken out of its work, nesting across threads;
the three readings of the table and the metric files that take them;
the table of a CPU profile, and the one a traced window keeps; and the
window's summary, unchanged by the program's ranges."""
from types import SimpleNamespace

import pytest

from perfbench.core import spans
from perfbench.core.spans import NODE, Event, table_of
from perfbench.core.registry import Benchmark
from perfbench.core.trace import WINDOW, Window, summarize

MAIN, AUTOGRAD, OTHER = 1, 2, 3


def host(name, start, end, thread=MAIN, corr=0, seq=-1, fwd=0, linked=0):
    return Event(name, False, start, end, thread, corr, linked, seq, fwd)


def kernel(start, end, linked, name="k"):
    return Event(name, True, start, end, 0, 0, linked, -1, 0)


def step_events():
    """One step on the main thread: its forward (a scan inside a range),
    its backward on the autograd thread (the scan's node, another node,
    and a recompute's scan range), and a launch from a third thread."""
    return [
        host("mgt.adam.step", 0, 10_000, corr=1),
        # Rule 1: an operation inside the scan range, on its thread.
        host("mgt.hist.cumsum", 100, 200),
        host("aten::cumsum", 110, 150, corr=11, seq=7),
        kernel(1_000, 1_400, linked=11, name="scan"),
        host("aten::mul", 300, 320, corr=12, seq=8),
        kernel(1_400, 1_450, linked=12),
        # The recompute's scan range, on the autograd thread: held by the
        # step across threads.
        host("mgt.hist.cumsum", 4_000, 4_100, thread=AUTOGRAD),
        host("aten::cumsum", 4_010, 4_050, thread=AUTOGRAD, corr=21, seq=3),
        kernel(4_200, 4_600, linked=21, name="scan"),
        # Rule 2: the scan's backward node points at the forward scan.
        host(NODE + "CumsumBackward0", 5_000, 5_100, thread=AUTOGRAD,
             seq=7, fwd=MAIN),
        host("aten::cumsum", 5_010, 5_050, thread=AUTOGRAD, corr=22),
        kernel(5_200, 5_500, linked=22, name="scan"),
        # Rule 2 for another node: its forward operation lies in the
        # step, outside the scan.
        host(NODE + "MulBackward0", 5_600, 5_700, thread=AUTOGRAD,
             seq=8, fwd=MAIN),
        host("aten::mul", 5_610, 5_650, thread=AUTOGRAD, corr=23),
        kernel(5_700, 5_760, linked=23),
        # Rule 3: no range on its thread, no node: the step holds it.
        host("aten::copy_", 6_000, 6_010, thread=OTHER, corr=31),
        kernel(6_100, 6_120, linked=31),
        # The update, nested in the step on its thread.
        host("mgt.adam.update", 9_000, 9_500),
        host("aten::add", 9_010, 9_020, corr=41),
        kernel(9_600, 9_610, linked=41),
        # Outside every range: attributed nowhere.
        host("aten::item", 20_000, 20_010, corr=51),
        kernel(20_100, 20_200, linked=51),
        # The device's annotation of a range (linked to the range) is not
        # device work.
        Event("mgt.adam.step", True, 1_000, 9_610, 0, 0, 1, -1, 0),
    ]


def test_each_rule_attributes_its_kernels():
    table = table_of(step_events())
    assert set(table) == {"mgt.adam.step", "mgt.adam.step/mgt.hist.cumsum",
                          "mgt.adam.step/mgt.adam.update"}
    scan = table["mgt.adam.step/mgt.hist.cumsum"]
    # Forward 400 (rule 1), recompute 400 (rule 1, its own thread),
    # backward 300 (rule 2).
    assert scan["count"] == 2
    assert scan["device_s"] == pytest.approx(1_100e-9)
    update = table["mgt.adam.step/mgt.adam.update"]
    assert update["device_s"] == pytest.approx(10e-9)
    # The step holds them all, its own 50 + 60 + 20 beside them; the
    # annotation and the kernel launched outside every range are left out.
    assert table["mgt.adam.step"]["device_s"] == pytest.approx(
        (1_100 + 10 + 50 + 60 + 20) * 1e-9)


def test_rule_order_prefers_the_operations_own_thread():
    """An operation inside a range on its own thread stays there, even
    under a backward node whose forward lies in another range."""
    evs = [
        host("mgt.outer", 0, 1_000),
        host("mgt.a", 10, 50),
        host("aten::f", 20, 30, seq=4),
        host("mgt.b", 200, 400, thread=AUTOGRAD),
        host(NODE + "FBackward0", 190, 480, thread=AUTOGRAD, seq=4,
             fwd=MAIN),
        host("aten::x", 210, 220, thread=AUTOGRAD, corr=2),
        kernel(500, 600, linked=2),
        host("aten::z", 430, 440, thread=AUTOGRAD, corr=4),
        kernel(700, 770, linked=4),
    ]
    table = table_of(evs)
    # aten::x lies in mgt.b on its own thread (rule 1); aten::z, after
    # mgt.b closed, under the node whose forward lies in mgt.a (rule 2).
    assert table["mgt.outer/mgt.b"]["device_s"] == pytest.approx(100e-9)
    assert table["mgt.outer/mgt.a"]["device_s"] == pytest.approx(70e-9)
    assert table["mgt.outer"]["device_s"] == pytest.approx(170e-9)


def test_blocked_time_is_taken_out_of_host_work():
    evs = [
        host("mgt.adam.step", 0, 1_000),
        host("mgt.adam.update", 100, 200),
        # Two overlapping waits, on threads of their own: 400 in all.
        Event("Command Buffer Full", False, 300, 600, 77, 0, 0, -1, 0),
        host("cudaStreamSynchronize", 500, 700, thread=78),
        # One across the update's end: 20 of it inside the update.
        host("cudaEventSynchronize", 180, 250),
        # After both: no part of it counts.
        host("cudaMemcpyAsync", 2_000, 2_100),
    ]
    table = table_of(evs)
    step = table["mgt.adam.step"]
    assert step["host_s"] == pytest.approx(1_000e-9)
    assert step["host_work_s"] == pytest.approx((1_000 - 400 - 70) * 1e-9)
    update = table["mgt.adam.step/mgt.adam.update"]
    assert update["host_s"] == pytest.approx(100e-9)
    assert update["host_work_s"] == pytest.approx(80e-9)


def test_nesting_gives_paths_and_sums_device_time_upward():
    evs = [
        host("mgt.fit", 0, 10_000),
        host("mgt.adam.step", 10, 4_000),
        host("mgt.adam.step", 5_000, 9_000),
        host("mgt.hist.cumsum", 100, 200, corr=1),
        kernel(300, 400, linked=1),
        host("mgt.hist.cumsum", 6_000, 6_100, thread=AUTOGRAD, corr=2),
        kernel(6_200, 6_400, linked=2),
        # The final loss's scan: under the fit, outside every step.
        host("mgt.hist.cumsum", 9_500, 9_600, corr=3),
        kernel(9_700, 9_800, linked=3),
    ]
    table = table_of(evs)
    inner = table["mgt.fit/mgt.adam.step/mgt.hist.cumsum"]
    assert inner["count"] == 2
    assert inner["device_s"] == pytest.approx(300e-9)
    assert table["mgt.fit/mgt.hist.cumsum"]["device_s"] == \
        pytest.approx(100e-9)
    assert table["mgt.fit/mgt.adam.step"]["device_s"] == \
        pytest.approx(300e-9)
    assert table["mgt.fit"]["device_s"] == pytest.approx(400e-9)
    ctx = SimpleNamespace(trace={"spans": table}, on_card=True)
    # 300 ns over two steps; the loss's scan left out.
    assert spans.device_ms_per(ctx, "mgt.hist.cumsum", per="mgt.adam.step") \
        == pytest.approx(150e-6)
    assert spans.host_work_ms(ctx, "mgt.adam.step") == pytest.approx(
        (3_990 + 4_000) / 2 * 1e-6)


#: The three readings of the table, as a metric would take them.
READINGS = {
    "adam.step_host_ms": lambda ctx: spans.host_work_ms(ctx, "mgt.adam.step"),
    "adam.update_host_ms":
        lambda ctx: spans.host_work_ms(ctx, "mgt.adam.update"),
    "hist.cumsum_ms_per_step": lambda ctx: spans.device_ms_per(
        ctx, "mgt.hist.cumsum", per="mgt.adam.step"),
}


def read(name, trace, on_card=True):
    return READINGS[name](SimpleNamespace(trace=trace, on_card=on_card))


@pytest.mark.parametrize("name", sorted(READINGS))
def test_readers_give_none_without_their_spans(name):
    assert read(name, {"spans": {}}) is None
    assert read(name, {}) is None
    table = table_of(step_events())
    assert read(name, {"spans": table}, on_card=False) is None
    assert read(name, {"spans": {"mgt.other": table["mgt.adam.step"]}}) \
        is None


def test_readers_read_the_table():
    table = table_of(step_events())
    trace = {"spans": table}
    assert read("adam.step_host_ms", trace) == pytest.approx(10_000e-6)
    assert read("adam.update_host_ms", trace) == pytest.approx(500e-6)
    assert read("hist.cumsum_ms_per_step", trace) == pytest.approx(1_100e-6)


def test_summarize_is_unchanged_for_a_recorded_list():
    """A window's summary of a recorded event list, as the accepted
    benchmark gives it (spans open or not)."""
    evs = [(n, d, s * 1000, e * 1000) for n, d, s, e in [
        ("perfbench.window", False, 1000, 9000),
        ("spin_kernel", True, 500, 900),
        ("aten::mul", False, 1100, 1400),
        ("mgt.adam.step", False, 1050, 5000),
        ("mgt.adam.step", True, 1500, 4000),
        ("k_mul", True, 1500, 2500),
        ("k_add", True, 2500, 2600),
        ("aten::add", False, 2000, 2100),
        ("cudaStreamSynchronize", False, 5200, 8000),
        ("k_sum", True, 8100, 8600),
        ("k_late", True, 9500, 9700),
        ("k_tiny", True, 8601, 8605),
    ]]
    assert summarize(evs) == {
        'window_s': 0.008, 'busy_s': 0.0016040000000000002,
        'lead_in_kept': 1,
        'kernels': {'k_mul': (0.001, 1), 'k_add': (0.0001, 1),
                    'k_sum': (0.0005, 1),
                    'k_tiny': (4.000000000000001e-06, 1)},
        'device_ops': [['k_mul', 0.001], ['k_sum', 0.0005],
                       ['k_add', 0.0001], ['k_tiny', 4.000000000000001e-06]],
        'idle_gaps': [['host: cudaStreamSynchronize', 0.0055000000000000005],
                      ['host: aten::mul', 0.0005],
                      ['host: between operations', 0.000395],
                      ['gaps under 10 us', 1.0000000000000002e-06]]}


def test_table_reads_the_programs_ranges_from_a_cpu_profile():
    """On the CPU profiler: the program's spans come out of the profiler
    object as nested rows of the table, and the window's summary of the
    same profile keeps the keys it had."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from multigrad_tpu_torch.telemetry.spans import span
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(WINDOW):
            for _ in range(2):
                with span(None, "adam.step"):
                    with span(None, "adam.update"):
                        torch.ones(8).sum()
    table = table_of(spans.events(prof))
    assert set(table) == {"mgt.adam.step", "mgt.adam.step/mgt.adam.update"}
    assert table["mgt.adam.step"]["count"] == 2
    assert table["mgt.adam.step/mgt.adam.update"]["count"] == 2
    for row in table.values():
        assert 0 < row["host_work_s"] <= row["host_s"]
        assert row["device_s"] == 0
    assert set(summarize(spans.events(prof))) == {
        "window_s", "busy_s", "lead_in_kept", "kernels", "device_ops",
        "idle_gaps"}


#: The span metrics' files, and what each reads from ``step_events`` with
#: its scan range named as the history kernels' range.
SPAN_METRICS = {"adam.step_host_ms": 10_000e-6, "adam.update_host_ms": 500e-6,
                "hist.history_ms_per_step": 1_100e-6}


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_metric_files_read_the_table(name):
    import os
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    read = Benchmark(root).module("metrics", name).read
    table = table_of([e._replace(name=e.name.replace("cumsum", "history"))
                      for e in step_events()])
    assert read(SimpleNamespace(trace={"spans": table}, on_card=True)) \
        == pytest.approx(SPAN_METRICS[name])
    assert read(SimpleNamespace(trace={"spans": table}, on_card=False)) \
        is None
    assert read(SimpleNamespace(trace={"spans": {}}, on_card=True)) is None


def test_window_keeps_its_span_table_on_the_cpu():
    """A window closed on the CPU keeps the span table of the ranges
    inside its bracket, beside the summary's other keys; the ranges of a
    step run before it opened are not in it."""
    import torch

    from multigrad_tpu_torch.telemetry.spans import span
    window = Window("cpu")
    window.start()
    with span(None, "adam.step"):
        torch.ones(8).sum()
    window.open()
    for _ in range(3):
        with span(None, "adam.step"):
            with span(None, "adam.update"):
                torch.ones(8).sum()
    window.close()
    summary = window.summary
    assert set(summary) == {"window_s", "busy_s", "lead_in_kept", "kernels",
                            "device_ops", "idle_gaps", "wall_s", "spans"}
    assert summary["spans"]["mgt.adam.step"]["count"] == 3
    assert summary["spans"]["mgt.adam.step/mgt.adam.update"]["count"] == 3
    assert spans.host_work_ms(SimpleNamespace(trace=summary, on_card=False),
                              "mgt.adam.step") is None
