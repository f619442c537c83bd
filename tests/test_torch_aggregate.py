"""The port's fleet-watching telemetry: ``aggregate`` (and the ``/fleet``
view of ``LiveServer(rank_paths=)``), ``trace``, ``dashboard``,
``regress`` and ``top``.

Each is a stdlib copy of the JAX package's module, so the JAX package's
cases (``tests/test_tracing.py``, ``tests/test_observability.py``,
``tests/test_live.py``, ``tests/test_resources.py``) run here over both
packages, and the same input files give the same output from either.
``gather_to_rank0`` over ``torch.distributed`` at 2 gloo ranks is in
``tests/test_torch_distributed.py`` (its launcher harness); here, its
one-process path.  All exact: the copies do the same arithmetic.
"""
import contextlib
import io
import json
import os
import urllib.request

import pytest

import multigrad_tpu.telemetry.aggregate as jax_aggregate
import multigrad_tpu.telemetry.dashboard as jax_dashboard
import multigrad_tpu.telemetry.regress as jax_regress
import multigrad_tpu.telemetry.top as jax_top
import multigrad_tpu.telemetry.trace as jax_trace
import multigrad_tpu_torch.telemetry.aggregate as pt_aggregate
import multigrad_tpu_torch.telemetry.dashboard as pt_dashboard
import multigrad_tpu_torch.telemetry.regress as pt_regress
import multigrad_tpu_torch.telemetry.top as pt_top
import multigrad_tpu_torch.telemetry.trace as pt_trace
from multigrad_tpu_torch.telemetry import JsonlSink, MetricsLogger
from multigrad_tpu_torch.telemetry.tracing import TraceContext, new_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": dict(aggregate=jax_aggregate, dashboard=jax_dashboard,
                    regress=jax_regress, top=jax_top, trace=jax_trace),
        "port": dict(aggregate=pt_aggregate, dashboard=pt_dashboard,
                     regress=pt_regress, top=pt_top, trace=pt_trace)}
both = pytest.mark.parametrize("pkg", sorted(PKGS))


def _out(fn, *args):
    """``fn(*args)``'s return value and standard output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


def _write(path, records):
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    return str(path)


# ------------------------------------------------------------------ #
# trace: merge by trace id, completeness, coverage, the CLI
# ------------------------------------------------------------------ #
def _span(ctx, name, t0, t1, **attrs):
    return {"event": "trace_span", "t": t1, "trace_id": ctx.trace_id,
            "span_id": ctx.span_id, "parent_span_id": ctx.parent_span_id,
            "name": name, "t_start": t0, "t_end": t1, "elapsed_s": t1 - t0,
            "ok": True, "service": attrs.pop("service", None), **attrs}


def _synthetic_trace(requeue=False):
    """root [0, 10] with hops covering [0, 9.5] (union)."""
    root = new_trace()
    spans = [_span(root, "request", 0.0, 10.0, outcome="ok")]
    a, b, c = root.child(), root.child(), root.child()
    spans.append(_span(a, "route", 0.0, 0.5))
    spans.append(_span(b, "queue_wait", 0.0, 4.0))
    spans.append(_span(c, "dispatch", 4.0, 9.5, bucket=4, compiled=False,
                       worker="w1"))
    spans.append(_span(c.child(), "adam_segments", 4.0, 9.0))
    if requeue:
        spans.append(_span(root.child(), "requeue", 1.0, 3.0,
                           from_worker="w0", to_worker="w1",
                           reason="worker w0 lost", bundle="/tmp/b.json",
                           outcome="redispatched"))
    return root, spans


@both
def test_trace_summary_complete_and_union_coverage(pkg):
    trace = PKGS[pkg]["trace"]
    root, spans = _synthetic_trace()
    summary = trace.trace_summary(root.trace_id, spans)
    assert summary["complete"] is True and summary["orphans"] == []
    assert summary["elapsed_s"] == pytest.approx(10.0)
    assert summary["coverage"] == pytest.approx(0.95)
    assert summary["hops"]["dispatch"] == pytest.approx(5.5)
    assert summary["requeues"] == []
    stray = TraceContext(root.trace_id, "feedfeedfeedfeed",
                         "0000000000000000")
    bad = trace.trace_summary(root.trace_id,
                              spans + [_span(stray, "dispatch", 1.0, 2.0)])
    assert bad["complete"] is False and bad["orphans"] == ["feedfeedfeedfeed"]
    two_roots = spans + [_span(new_trace(), "request", 0.0, 1.0)]
    assert trace.trace_summary(root.trace_id, two_roots)["complete"] is False


@both
def test_requeue_waterfall_names_both_generations(pkg):
    trace = PKGS[pkg]["trace"]
    root, spans = _synthetic_trace(requeue=True)
    assert trace.trace_summary(root.trace_id, spans)["requeues"] == [
        {"from": "w0", "to": "w1", "reason": "worker w0 lost",
         "bundle": "/tmp/b.json"}]
    text = trace.render_waterfall(root.trace_id, spans)
    assert "requeue w0->w1" in text and "1 requeue(s)" in text
    dispatch = next(ln for ln in text.splitlines() if "dispatch" in ln)
    adam = next(ln for ln in text.splitlines() if "adam_segments" in ln)
    assert "K=4" in dispatch and "cached" in dispatch
    assert adam.index("adam_segments") > dispatch.index("dispatch")


def _trace_files(tmp_path):
    r1, s1 = _synthetic_trace(requeue=True)
    r2, s2 = _synthetic_trace()
    router = _write(tmp_path / "router.jsonl", s1 + [
        {"event": "trace_rtt", "t": 0.0, "worker": "w0", "rtt_s": 0.002}])
    with open(router, "a") as f:
        f.write("{torn tail line\n")
    worker = _write(tmp_path / "w0.jsonl", s2)
    return (r1, s1), (r2, s2), [router, worker]


@both
def test_trace_cli_end_to_end(pkg, tmp_path):
    trace = PKGS[pkg]["trace"]
    (r1, _), (r2, s2), files = _trace_files(tmp_path)
    rc, out = _out(trace.main, files)
    assert rc == 0
    assert "2 traces over 2 file(s): 1 with requeue hops, " \
           "0 incomplete" in out
    assert "rpc rtt median 2.00ms" in out and "requeue w0->w1" in out
    rc, out = _out(trace.main, files + ["--json"])
    payload = json.loads(out)
    assert payload["n_traces"] == 2 and payload["rpc_rtt"]["n"] == 1
    by_id = {t["trace_id"]: t for t in payload["traces"]}
    assert by_id[r1.trace_id]["complete"] is True
    assert len(by_id[r2.trace_id]["spans"]) == len(s2)
    rc, out = _out(trace.main, files + ["--trace", r2.trace_id[:10]])
    assert rc == 0 and r2.trace_id[:12] in out
    assert _out(trace.main, files + ["--trace", "zz"])[0] == 1


def test_trace_cli_same_output_both_packages(tmp_path):
    _, _, files = _trace_files(tmp_path)
    for extra in ([], ["--json"], ["--slowest", "2"]):
        assert _out(jax_trace.main, files + extra) \
            == _out(pt_trace.main, files + extra)


@both
def test_merge_traces_groups_by_trace_id(pkg, tmp_path):
    aggregate = PKGS[pkg]["aggregate"]
    r1, s1 = _synthetic_trace()
    r2, s2 = _synthetic_trace()
    p1 = _write(tmp_path / "a.jsonl", s1[:2] + s2[3:])
    p2 = _write(tmp_path / "b.jsonl", s1[2:] + s2[:3])
    merged = aggregate.merge_traces([p1, p2])
    assert set(merged) == {r1.trace_id, r2.trace_id}
    assert len(merged[r1.trace_id]) == len(s1)
    assert merged[r1.trace_id][0]["name"] == "request"


# ------------------------------------------------------------------ #
# aggregate: per-rank merge, span skew, stragglers, /fleet
# ------------------------------------------------------------------ #
def _rank_file(path, rank, t0, fit_end):
    records = [{"event": "run", "t": t0, "process_index": rank,
                "backend": "cpu"},
               {"event": "adam", "t": t0 + 0.5, "process_index": rank,
                "step": 0, "loss": 1.0},
               {"event": "span", "t": fit_end, "process_index": rank,
                "name": "fit", "path": "fit", "elapsed_s": fit_end - t0,
                "ok": True}]
    if rank == 1:
        records.append({"event": "stall", "t": t0 + 2.0,
                        "process_index": rank, "stalled_s": 3.0})
    return _write(path, records)


def _rank_files(tmp_path):
    return [_rank_file(tmp_path / "rank0.jsonl", 0, 1000.0, 1010.0),
            _rank_file(tmp_path / "rank1.jsonl", 1, 1000.0, 1019.0)]


@both
def test_aggregate_merges_and_flags_straggler(pkg, tmp_path):
    aggregate = PKGS[pkg]["aggregate"]
    paths = _rank_files(tmp_path)
    summary = aggregate.aggregate(paths, threshold_s=1.0,
                                  threshold_frac=0.2)
    assert summary["n_records"] == 7
    assert summary["ranks"][1]["stalls"] == 1
    assert summary["span_skew"]["fit"]["end_spread_s"] \
        == pytest.approx(9.0)
    (straggler,) = summary["stragglers"]
    assert straggler["rank"] == 1 and straggler["span"] == "fit"
    out_path = str(tmp_path / "merged.jsonl")
    rc, rendered = _out(aggregate.main, paths + ["--out", out_path])
    assert rc == 0 and "STRAGGLER rank 1" in rendered
    with open(out_path) as f:
        merged = [json.loads(line) for line in f]
    assert len(merged) == 7
    assert all("process_index" in rec for rec in merged)
    # One process (no group): the local records come back merged.
    local = aggregate.gather_to_rank0([{"event": "x", "t": 2.0},
                                       {"event": "y", "t": 1.0}])
    assert [r["event"] for r in local] == ["y", "x"]


@both
def test_legacy_files_without_process_index_still_merge(pkg, tmp_path):
    path = _write(tmp_path / "old.jsonl", [{"event": "run", "t": 1.0},
                                           {"event": "adam", "t": 2.0,
                                            "step": 0}])
    merged = PKGS[pkg]["aggregate"].load_rank_records([path])
    assert all(rec["process_index"] == 0 for rec in merged)


def test_aggregate_same_output_both_packages(tmp_path):
    paths = _rank_files(tmp_path)
    assert jax_aggregate.aggregate(paths) == pt_aggregate.aggregate(paths)
    for extra in ([], ["--json"]):
        assert _out(jax_aggregate.main, paths + extra) \
            == _out(pt_aggregate.main, paths + extra)


def test_live_server_serves_the_fleet_view(tmp_path):
    from multigrad_tpu_torch.telemetry import LiveServer
    paths = _rank_files(tmp_path)
    live = LiveServer(port=0, rank_paths=paths)
    bare = LiveServer(port=0)
    try:
        with urllib.request.urlopen(live.url + "/fleet", timeout=10) as r:
            fleet = json.loads(r.read())
        assert fleet == json.loads(json.dumps(
            pt_aggregate.aggregate(paths), default=str))
        assert fleet["stragglers"][0]["rank"] == 1
        # Without rank files there is no fleet view.
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bare.url + "/fleet", timeout=10)
        assert err.value.code == 404
    finally:
        live.stop()
        bare.stop()


# ------------------------------------------------------------------ #
# regress: the noise-aware gate
# ------------------------------------------------------------------ #
def _dossier(path, configs, rtt_ms):
    with open(path, "w") as f:
        json.dump({"metric": "test", "value": None, "configs": configs,
                   "tunnel_rtt_ms": rtt_ms}, f)
    return str(path)


@both
def test_regress_flags_2x_and_respects_rtt_floor(pkg, tmp_path):
    regress = PKGS[pkg]["regress"]
    prev = _dossier(tmp_path / "r1.json", {
        "smf_1e6_xla_steps_per_sec": 4000.0, "pair_1e5_fwdbwd_s_xla": 0.2,
        "galhalo": {"speedup": 2.1}}, rtt_ms=50.0)
    cur = _dossier(tmp_path / "r2.json", {
        "smf_1e6_xla_steps_per_sec": 2000.0, "pair_1e5_fwdbwd_s_xla": 0.28,
        "galhalo": {"speedup": 2.0}}, rtt_ms=40.0)
    rc, out = _out(regress.main, [prev, cur])
    assert rc == 1
    assert "REGRESSION: smf_1e6_xla_steps_per_sec" in out
    assert "(noise floor)" in out
    assert "REGRESSION: pair_1e5_fwdbwd_s_xla" not in out
    quiet = _dossier(tmp_path / "r3.json", {
        "smf_1e6_xla_steps_per_sec": 3900.0, "pair_1e5_fwdbwd_s_xla": 0.21,
        "galhalo": {"speedup": 2.05}}, rtt_ms=50.0)
    assert _out(regress.main, [prev, quiet])[0] == 0
    assert _out(regress.main, [prev, cur, "--warn-only"])[0] == 0


@both
def test_regress_null_metrics_warn_only(pkg, tmp_path):
    regress = PKGS[pkg]["regress"]
    prev = _dossier(tmp_path / "a.json", {
        "smf_1e6_xla_steps_per_sec": 100.0,
        "smf_1e9_pallas_steps_per_sec": None,
        "wprp_8192_fwdbwd_ms_xla": 4.8}, rtt_ms=10.0)
    cur = _dossier(tmp_path / "b.json", {
        "smf_1e6_xla_steps_per_sec": 101.0,
        "smf_1e9_pallas_steps_per_sec": 3.2,
        "wprp_8192_fwdbwd_ms_xla": None}, rtt_ms=10.0)
    rc, out = _out(regress.main, [prev, cur])
    assert rc == 0
    assert "warn: smf_1e9_pallas_steps_per_sec" in out
    assert "warn: wprp_8192_fwdbwd_ms_xla" in out
    r5 = regress.load_dossier(os.path.join(REPO, "BENCH_r05.json"))
    r6 = regress.load_dossier(os.path.join(REPO, "BENCH_r06.json"))
    assert r5["configs"] and r6["configs"]
    assert any(r["status"] == "null"
               for r in regress.compare_rounds(r5, r6))


@both
def test_regress_include_and_json(pkg, tmp_path):
    regress = PKGS[pkg]["regress"]
    prev = _dossier(tmp_path / "p.json", {"a_steps_per_sec": 100.0,
                                          "b_steps_per_sec": 100.0}, 1.0)
    cur = _dossier(tmp_path / "c.json", {"a_steps_per_sec": 10.0,
                                         "b_steps_per_sec": 10.0}, 1.0)
    rc, out = _out(regress.main, [prev, cur, "--include", "b_*", "--json"])
    assert rc == 1
    assert [r["metric"] for r in json.loads(out)["results"]] \
        == ["b_steps_per_sec"]


def test_regress_same_output_both_packages():
    rounds = [os.path.join(REPO, f"BENCH_r{i:02d}.json") for i in (5, 6, 13)]
    for extra in ([], ["--json"]):
        assert _out(jax_regress.main, rounds + extra) \
            == _out(pt_regress.main, rounds + extra)


# ------------------------------------------------------------------ #
# dashboard: --once / --follow renders, the tail reader
# ------------------------------------------------------------------ #
def _demo_stream(path):
    logger = MetricsLogger(JsonlSink(str(path)), run_config={"demo": True})
    logger.log("fit_plan", kind="adam_scan", nsteps=40)
    for k in range(8):
        logger.log("adam", step=5 * k, loss=4.0 / (k + 1),
                   grad_norm=1.0 / (k + 1), loss_ema=4.0 / (k + 1),
                   loss_ema_slope=-0.01)
    logger.log("comm", bytes_per_step=48, calls_per_step=2)
    logger.log("hmc", step=20, accept=0.85, divergences=[1, 0],
               step_size=[0.1, 0.2])
    logger.log("stall", stalled_s=2.0)
    logger.log("resource_sample", rss_bytes=512 * 1024 * 1024,
               busy_frac=0.75, device_bytes_in_use=None,
               compile_count=3, compile_s_total=2.5)
    logger.log("alert", rule="loss_plateau",
               message="loss EMA has plateaued", step=30)
    logger.close()
    return str(path)


@both
def test_dashboard_once_renders_structure(pkg, tmp_path):
    dashboard = PKGS[pkg]["dashboard"]
    path = _demo_stream(tmp_path / "run.jsonl")
    rc, out = _out(dashboard.main, [path, "--once"])
    assert rc == 0
    assert "step 35/40" in out
    assert "loss" in out and "|grad|" in out and "ema" in out
    assert any(ch in out for ch in dashboard.SPARK_CHARS)
    assert "steps/s" in out and "ETA" in out
    assert "comm 48 B/step" in out
    assert "hmc  draw 20" in out and "divergences=1" in out
    assert "res  rss 512.0MiB  busy 75%  compiles 3 (2.5s)" in out
    assert "STALL" in out and "ALERT [loss_plateau]" in out
    assert "records:" in out
    assert _out(dashboard.main,
                [str(tmp_path / "nope.jsonl"), "--once"])[0] == 1
    rc, out = _out(dashboard.main, [path, "--follow", "--interval", "0.01",
                                    "--max-frames", "2"])
    assert rc == 0 and out.count("records:") == 2


def test_dashboard_reads_the_ports_run_record(tmp_path):
    # The port's run record names torch, not jax: its copy of the
    # dashboard reads it; otherwise both render the same frame.
    path = _demo_stream(tmp_path / "run.jsonl")
    _, port = _out(pt_dashboard.main, [path, "--once"])
    _, ref = _out(jax_dashboard.main, [path, "--once"])
    head = next(ln for ln in port.splitlines() if ln.startswith("run "))
    import torch
    assert head.endswith(f"torch {torch.__version__}")
    assert [ln for ln in port.splitlines() if not ln.startswith("run ")] \
        == [ln for ln in ref.splitlines() if not ln.startswith("run ")]


@both
def test_dashboard_resets_fit_state_at_fit_plan_boundary(pkg):
    dashboard = PKGS[pkg]["dashboard"]
    collector = dashboard.Collector()
    collector.feed([{"event": "run", "t": 0.0},
                    {"event": "fit_plan", "t": 0.0, "nsteps": 100}])
    for k in range(5):
        collector.feed([{"event": "adam", "t": 0.1 * k, "step": k,
                         "loss": 5.0 - k}])
    collector.feed([{"event": "fit_summary", "t": 1.0, "steps": 100,
                     "final_loss": 1.0}])
    assert collector.view()["eta_s"] == 0.0
    collector.feed([{"event": "fit_plan", "t": 2.0, "nsteps": 50},
                    {"event": "adam", "t": 2.0, "step": 0, "loss": 9.0},
                    {"event": "adam", "t": 2.5, "step": 10, "loss": 8.0}])
    view = collector.view()
    assert view["summary"] is None and view["nsteps"] == 50
    assert view["loss"] == [9.0, 8.0]
    assert view["eta_s"] is not None and view["eta_s"] > 0
    out = dashboard.render(view)
    assert "done" not in out and "step 10/50" in out
    for k in range(2000):
        collector.feed([{"event": "adam", "t": 3.0 + 0.1 * k, "step": k,
                         "loss": 1.0}])
    assert len(collector.loss) <= 512


@both
def test_dashboard_rate_pairs_timestamps_with_steps(pkg):
    c = PKGS[pkg]["dashboard"].Collector()
    c.feed([{"event": "fit_plan", "nsteps": 100}])
    for k in range(10):
        c.feed([{"event": "adam", "step": k, "loss": 1.0,
                 "t": float(k) if k % 2 == 0 else None}])
    view = c.view()
    assert view["steps_per_sec"] == pytest.approx(1.0)
    assert view["eta_s"] == pytest.approx(90.0)


@both
def test_tail_reader_never_parses_partial_lines(pkg, tmp_path):
    path = tmp_path / "run.jsonl"
    reader = PKGS[pkg]["dashboard"].TailReader(str(path))
    assert reader.poll() == []
    with open(path, "w") as f:
        f.write('{"event":"adam","step":0}\n{"event":"adam"')
    assert [r["step"] for r in reader.poll()] == [0]
    assert reader.poll() == []
    with open(path, "a") as f:
        f.write(',"step":1}\n')
    assert [r["step"] for r in reader.poll()] == [1]
    with open(path, "w") as f:
        f.write('{"event":"adam","step":9}\n')
    assert [r["step"] for r in reader.poll()] == [9]


# ------------------------------------------------------------------ #
# top: per-worker columns from router stats, status URLs, JSONL
# ------------------------------------------------------------------ #
ROUTER_STATS = {"workers": {
    "w0": {"state": "up", "queue_depth": 3, "heartbeat_age_s": 0.2,
           "resources": {"busy_frac": 0.9, "rss_bytes": 2 ** 30,
                         "device_bytes_in_use": 5 * 2 ** 30,
                         "device_bytes_limit": 16 * 2 ** 30,
                         "device_peak_bytes": 6 * 2 ** 30,
                         "compile_count": 4, "compile_s_total": 12.5}},
    "w1": {"state": "lost", "queue_depth": 0, "heartbeat_age_s": 9.0,
           "resources": None}}}


@both
def test_top_renders_router_stats_per_worker(pkg):
    top = PKGS[pkg]["top"]
    rows = top._rows_from_status("router", ROUTER_STATS, now=0.0)
    assert [r["name"] for r in rows] == ["w0", "w1"]
    out = top.render_rows(rows)
    assert "WORKER" in out and "BUSY%" in out and "COMPILE" in out
    assert "90.0" in out and "1.0GiB" in out
    assert "5.0GiB/16.0GiB" in out and "4 (12.5s)" in out
    assert "w1 [lost]" in out and "-" in out.splitlines()[-1]


@both
def test_top_once_over_jsonl_stream(pkg, tmp_path):
    top = PKGS[pkg]["top"]
    path = tmp_path / "w0.jsonl"
    logger = MetricsLogger(JsonlSink(str(path)))
    logger.log("resource_sample", rss_bytes=256 * 2 ** 20, busy_frac=0.25,
               device_bytes_in_use=None, compile_count=2,
               compile_s_total=1.0)
    logger.close()
    rc, out = _out(top.main, ["--once", "--json", str(path)])
    (row,) = json.loads(out)
    assert rc == 0 and row["rss_bytes"] == 256 * 2 ** 20
    assert row["busy_frac"] == pytest.approx(0.25)
    assert row["compile_count"] == 2
    rc, out = _out(top.main, ["--once", str(path)])
    assert rc == 0 and "256.0MiB" in out and "25.0" in out
    rc, out = _out(top.main, ["--once", "--json",
                              "http://127.0.0.1:9/status", str(path)])
    rows = json.loads(out)
    assert rows[0]["state"] == "down"
    assert rows[1]["rss_bytes"] == 256 * 2 ** 20


def test_top_same_rows_both_packages():
    assert jax_top._rows_from_status("router", ROUTER_STATS, now=0.0) \
        == pt_top._rows_from_status("router", ROUTER_STATS, now=0.0)
