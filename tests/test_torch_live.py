"""The port's copies of the JAX package's stdlib telemetry modules (live,
alerts, report, the sinks), held against the originals on one record
stream, and the port's live endpoint on real HTTP during a fit.

One stream, written by hand with fixed timestamps so both packages see
the same bytes, covers every record kind the fits emit and trips every
default alert rule.  Through each package's ``LiveSink`` it gives the
same Prometheus text and ``/status``; through
``AlertEngine(default_rules())`` the same ``alert`` records (timestamps
aside); through ``report.summarize`` the same summary; through
``JsonlSink`` and ``CsvSink`` the same files, apart from the run
record's provenance keys (versions, device kind and count), which name
each package's own software.  All exact: the copies do the same
arithmetic in Python.

Every live server binds port 0 and is stopped in a ``finally``; HTTP
reads have a 10 s limit.
"""
import json
import re
import socket
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from multigrad_tpu_torch import run_adam_scan, telemetry
from multigrad_tpu_torch.models import SMFModel, make_smf_data
from multigrad_tpu_torch.telemetry import (AlertEngine, JsonlSink,
                                           LiveMetrics, LiveServer, LiveSink,
                                           MemorySink, MetricsLogger,
                                           default_rules, report, run_record)

CPU = "cpu"
HTTP_TIMEOUT_S = 10
T0 = 1_000.0
#: The run record's keys that name each package's own software and
#: devices.
PROVENANCE = ("jax_version", "jaxlib_version", "torch_version",
              "cuda_version", "backend", "device_kind", "device_count")

_META_RE = re.compile(r"^# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]*( .*)?$")
_SAMPLE_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? "
                        r"(NaN|[+-]Inf|[-+0-9.eE]+)$")


def assert_prometheus_wellformed(text):
    n = 0
    for line in text.splitlines():
        if line.startswith("#"):
            assert _META_RE.match(line), line
        elif line:
            assert _SAMPLE_RE.match(line), line
            n += 1
    assert n > 0


def stream():
    """A fit's records, then an HMC run's, with fixed timestamps: a loss
    that sits flat (plateau), a gradient spike (explosion), a
    stretch of slow steps (throughput drop), a stall and its recovery,
    and divergences piling up (divergence rate)."""
    recs = [{"event": "run", "t": T0, "backend": "cpu",
             "process_index": 0, "process_count": 1,
             "config_digest": None},
            {"event": "fit_plan", "t": T0, "kind": "adam_scan",
             "nsteps": 200, "log_every": 5},
            {"event": "comm", "t": T0, "scope": "loss_and_grad_step",
             "bytes_per_step": 48, "calls_per_step": 2,
             "bytes_by_op": {"psum": 48}, "calls_by_op": {"psum": 2}}]
    t = T0
    for k in range(40):
        t += 0.05 if k < 30 else 2.0
        loss = 0.5
        recs.append({"event": "adam", "t": t, "step": 5 * k, "loss": loss,
                     "grad_norm": 1e5 if k == 20 else 1.0,
                     "param_norm": 1.2, "update_norm": 0.01,
                     "loss_ema": loss, "loss_ema_slope": 0.0})
        if k == 25:
            recs += [{"event": "heartbeat", "t": t, "step": 125,
                      "process": 0, "since_last_tick_s": 0.1,
                      "steps_per_sec": 100.0},
                     {"event": "stall", "t": t, "step": 125, "process": 0,
                      "stalled_s": 9.0, "stall_after_s": 3.0},
                     {"event": "stall_recovered", "t": t, "step": 126,
                      "process": 0}]
    recs += [{"event": "span", "t": t, "name": "checkpoint",
              "path": "fit/checkpoint", "depth": 1, "elapsed_s": 0.01,
              "ok": True, "step": 100},
             {"event": "span", "t": t, "name": "fit", "path": "fit",
              "depth": 0, "elapsed_s": 60.0, "ok": True},
             {"event": "stream", "t": t, "bytes_streamed": 1 << 20,
              "chunks": 8, "chunks_per_sec": 4.0, "stall_fraction": 0.01,
              "overlap_frac": 0.97, "fill_s": 0.01, "max_live_buffers": 2,
              "passes": {"vjp": {"stall_fraction": 0.02,
                                 "overlap_frac": 0.97, "chunks": 4,
                                 "bytes_streamed": 1 << 19}}},
             {"event": "fit_summary", "t": t, "steps": 200,
              "steps_per_sec": 20.0, "final_loss": 0.5,
              "overlap_frac": 0.97, "pass_overlap": {"vjp": 0.97}},
             {"event": "fit_plan", "t": t, "kind": "hmc", "nsteps": 100,
              "num_warmup": 50, "num_chains": 4, "log_every": 25,
              "k_sharded": False}]
    for k, div in enumerate((0, 1, 30, 60)):
        t += 1.0
        recs.append({"event": "hmc", "t": t, "step": 25 * (k + 1),
                     "accept": 0.8 - 0.1 * k, "divergences": float(div),
                     "step_size": [0.1, 0.12, 0.11, 0.09]})
    recs.append({"event": "fit_summary", "t": t, "steps": 100,
                 "divergences": 60, "accept_prob": 0.55})
    return recs


def _jax():
    from multigrad_tpu import telemetry as jax_telemetry
    from multigrad_tpu.telemetry import report as jax_report
    return jax_telemetry, jax_report


def test_live_sink_gives_the_same_prometheus_text_and_status():
    jt, _ = _jax()
    port, ref = LiveSink(), jt.LiveSink()
    for rec in stream():
        port.write(dict(rec))
        ref.write(dict(rec))
    assert port.status(now=T0 + 500) == ref.status(now=T0 + 500)
    text = port.metrics.render()
    assert text == ref.metrics.render()
    assert_prometheus_wellformed(text)
    assert "multigrad_comm_bytes_per_step 48" in text


def test_registry_renders_as_the_jax_package():
    jt, _ = _jax()
    out = []
    for m in (LiveMetrics(), jt.LiveMetrics()):
        m.inc("demo_total", 2, help="a counter", labels={"kind": "a"})
        m.inc("demo_total", 1, labels={"kind": "b"})
        m.set("demo_gauge", 1.5, help="a gauge")
        for v in (0.003, 0.02, 0.02, 7.0):
            m.observe("demo_seconds", v, help="a histogram")
        out.append((m.render(), m.quantile("demo_seconds", 0.95)))
        with pytest.raises(ValueError):
            m.set("demo_total", 3.0)
    assert out[0] == out[1]
    assert 'demo_seconds_bucket{le="+Inf"} 4' in out[0][0]


def test_status_resources_section_matches_jax():
    # The gauges a resource monitor exports, written by hand (the port's
    # monitor comes with serving): the same section, autoscaler included.
    jt, _ = _jax()
    sinks = (LiveSink(), jt.LiveSink())
    for sink in sinks:
        m = sink.metrics
        assert "resources" not in sink.status(now=T0)
        m.set("multigrad_resource_uptime_seconds", 12.0)
        m.set("multigrad_resource_rss_bytes", 1.5e9)
        m.set("multigrad_resource_busy_frac", 0.75)
        m.set("multigrad_resource_device_bytes_limit", 8e10)
        m.set("multigrad_resource_device_peak_bytes", 3e10)
        for v in (0.01, 0.02, 0.5):
            m.observe("multigrad_serve_hop_seconds", v,
                      labels={"hop": "queue_wait"})
    got, want = (s.status(now=T0)["resources"] for s in sinks)
    assert got == want
    assert got["autoscaler"]["headroom_bytes"] == int(5e10)
    assert got["autoscaler"]["queue_wait_p95_s"] >= 0.02


def _alerts(engine_cls, rules, logger_cls, sink_cls):
    sink = sink_cls()
    engine = engine_cls(rules=rules)
    logger = logger_cls(sink)
    engine.bind_logger(logger)
    for rec in stream():
        engine.write(dict(rec))
    return [{k: v for k, v in a.items() if k != "t"} for a in engine.alerts]


def test_default_rules_fire_as_the_jax_package():
    jt, _ = _jax()
    got = _alerts(AlertEngine, default_rules(), MetricsLogger, MemorySink)
    want = _alerts(jt.AlertEngine, jt.default_rules(), jt.MetricsLogger,
                   jt.MemorySink)
    assert got == want
    assert {a["rule"] for a in got} == {
        "loss_plateau", "grad_explosion", "throughput_drop",
        "heartbeat_stall", "divergence_rate"}


def test_report_summary_matches_jax(tmp_path, capsys):
    _, jr = _jax()
    recs = stream()
    got, want = report.summarize(recs), jr.summarize(recs)
    assert got == want
    assert got["comm"]["bytes_per_step"] == 48
    path = tmp_path / "run.jsonl"
    sink = JsonlSink(str(path))
    for rec in recs:
        sink.write(rec)
    sink.close()
    assert report.main([str(path)]) == 0
    text = capsys.readouterr().out
    assert "48 bytes/step" in text and "run: torch" in text
    assert report.main([str(path), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["fit"]["steps_per_sec"] > 0
    assert report.main([str(path), "--list-runs"]) == 0
    assert "run 1" in capsys.readouterr().out


def test_sink_files_match_jax(tmp_path):
    jt, _ = _jax()
    files = {}
    for name, mod in (("port", telemetry), ("jax", jt)):
        record = mod.run_record({"seed": 1})
        record["t"] = T0
        jsonl = tmp_path / f"{name}.jsonl"
        csv = tmp_path / f"{name}.csv"
        sinks = [mod.JsonlSink(str(jsonl)),
                 mod.CsvSink(str(csv), fields=["event", "step", "loss"])]
        for rec in [record] + stream()[1:]:
            for sink in sinks:
                sink.write(rec)
        for sink in sinks:
            sink.close()
        lines = [json.loads(line) for line in open(jsonl)]
        for key in PROVENANCE:
            lines[0].pop(key, None)
        files[name] = (lines, csv.read_text())
    assert files["port"] == files["jax"]
    provenance = run_record()
    assert provenance["torch_version"] == torch.__version__
    assert provenance["backend"] == "cpu" and provenance["process_count"] == 1


# --------------------------------------------------------------------- #
# The endpoint over real HTTP
# --------------------------------------------------------------------- #
def _get(url):
    with urllib.request.urlopen(url, timeout=HTTP_TIMEOUT_S) as resp:
        return resp.status, resp.read().decode()


def test_live_http_scrape_during_a_fit():
    server = LiveServer(port=0)
    seen = {"calls": 0}
    try:
        def loss_and_grad(p, _key):
            seen["calls"] += 1
            if seen["calls"] == 10:
                seen["mid"] = (_get(server.url + "/status"),
                               _get(server.url + "/metrics"))
            return ((p - 2.0) ** 2).sum(), 2.0 * (p - 2.0)

        logger = MetricsLogger(MemorySink())
        run_adam_scan(loss_and_grad, torch.zeros(2), nsteps=30,
                      learning_rate=0.1, telemetry=logger, log_every=2,
                      live=server)
        (code, body), (mcode, text) = seen["mid"]
        status = json.loads(body)
        assert code == mcode == 200
        assert status["phase"] == "fitting" and status["nsteps"] == 30
        assert status["step"] % 2 == 0 and status["port"] == server.port
        assert_prometheus_wellformed(text)
        assert re.search(r"^multigrad_step \d", text, re.M)
        done = json.loads(_get(server.url + "/status")[1])
        assert done["phase"] == "done" and done["fit_summary"]["steps"] == 30
        assert _get(server.url + "/healthz") == (200, "ok\n")
        with pytest.raises(urllib.error.HTTPError) as missing:
            _get(server.url + "/fleet")
        assert missing.value.code == 404
    finally:
        server.stop()
    assert server.port is None


def test_live_server_that_cannot_bind_raises():
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen(1)
        with pytest.raises(OSError):
            LiveServer(port=taken.getsockname()[1], port_probe=1)


def test_live_server_fleet_view_waits_for_aggregate():
    with pytest.raises(NotImplementedError, match="item 8"):
        LiveServer(rank_paths=["rank0.jsonl"], start=False)


def test_model_fit_with_live_only_wires_a_logger():
    # As JAX tests/test_live.py:268: a monitor and no logger make an
    # owned logger, log_every defaults to 25, the comm record rides in.
    model = SMFModel(aux_data=make_smf_data(2_048, device=CPU))
    live = LiveSink()
    engine = AlertEngine()
    traj = model.run_adam(guess=(-1.0, 0.5), nsteps=30, learning_rate=0.02,
                          progress=False, live=live, alerts=engine)
    status = live.status()
    assert status["phase"] == "done" and status["step"] == 25
    assert status["comm_bytes_per_step"] == 0
    assert torch.equal(traj, model.run_adam(
        guess=(-1.0, 0.5), nsteps=30, learning_rate=0.02, progress=False))
    assert np.isfinite(status["loss"])
