"""The port's wire (``serve/wire.py``) against the JAX package's, and the
worker process behind it (``python -m multigrad_tpu_torch.serve.worker``)
on the CPU.

The wire is one protocol in both packages: the same ``FitConfig``,
``QosTag``, ``FitResult``, shed counts, resource snapshot and rollup
delta encode to the same JSON text, and each package decodes the
other's encoding to an object that encodes back to it.  A
``JsonlChannel`` of one package talks to the other's over a socket pair.
All exact (the copies do the same arithmetic in Python).

The worker runs as a subprocess with ``--device cpu`` on an SMF model of
600 halos: its READY handshake, a submit answered with a result equal
bit for bit to the in-process port scheduler's for the same guess in
the same bucket, ``drain`` answered with ``draining`` and ``drained``
and exit 0, and SIGTERM draining the same way.  Each test starts one
worker, binds port 0 and uses its own ``tmp_path``; every wait has a
limit.
"""
import json
import os
import select
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest

import multigrad_tpu.serve.qos as jax_qos
import multigrad_tpu.serve.queue as jax_queue
import multigrad_tpu.serve.wire as jax_wire
import multigrad_tpu_torch.serve.qos as pt_qos
import multigrad_tpu_torch.serve.queue as pt_queue
import multigrad_tpu_torch.serve.wire as pt_wire
from multigrad_tpu_torch.models import SMFModel, make_smf_data
from multigrad_tpu_torch.serve import FitConfig, FitScheduler
from multigrad_tpu_torch.serve.worker import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_HALOS = 600
BOUNDS = [(-5.0, 1.0), (0.01, 2.0)]
WAIT_S = 120

PACKAGES = {"jax": (jax_queue, jax_qos, jax_wire),
            "port": (pt_queue, pt_qos, pt_wire)}


# ------------------------------------------------------------------ #
# the wire, both ways
# ------------------------------------------------------------------ #
def _config(queue_mod, qos_mod, case):
    return {
        "plain": lambda: queue_mod.FitConfig(nsteps=7),
        "bounded": lambda: queue_mod.FitConfig(
            nsteps=20, learning_rate=0.05,
            param_bounds=[(-5.0, 1.0), None, (0.01, 2.0)]),
        "keyed": lambda: queue_mod.FitConfig(
            nsteps=4, learning_rate=0.1, randkey=7, const_randkey=True,
            job_id="job-1", stage="fit"),
    }[case]()


def _result(queue_mod, qos_mod, case):
    rng = np.random.default_rng(1)
    traj = rng.normal(size=(6, 2)).astype(np.float32)
    return queue_mod.FitResult(
        request_id=3, params=traj[-1].copy(), loss=float(np.float32(0.25)),
        traj=traj, steps=5, bucket=4, wait_s=0.0125, fit_s=1.5,
        retried=True, trace_id="ab" * 16,
        hops={"queue_wait": 0.001, "dispatch": 1.25},
        job_id=None, stage=None)


CODECS = {
    "config plain": ("config", "plain"),
    "config bounded": ("config", "bounded"),
    "config keyed": ("config", "keyed"),
    "qos": ("qos", None), "untagged": ("untagged", None),
    "result": ("result", None), "shed": ("shed", None),
    "resources": ("resources", None), "rollup": ("rollup", None),
}


def _encode(mods, kind, case):
    queue_mod, qos_mod, wire = mods
    if kind == "config":
        return wire.config_to_wire(_config(queue_mod, qos_mod, case))
    if kind == "qos":
        return wire.qos_to_wire(qos_mod.QosTag("acme", "interactive", 2.5))
    if kind == "untagged":
        return wire.qos_to_wire(None)
    if kind == "result":
        return wire.result_to_wire(_result(queue_mod, qos_mod, case))
    if kind == "shed":
        return wire.shed_to_wire({"by_class": {"batch": 3},
                                  "by_tenant": {"hog": 2, "mouse": 1}})
    if kind == "resources":
        return wire.resources_to_wire({
            "t": 10.5, "uptime_s": 2.0, "rss_bytes": 1 << 30,
            "device_bytes_in_use": None, "device_peak_bytes": 7.0e9,
            "device_bytes_limit": 85017493504, "busy_frac": 0.75,
            "busy_s_total": 12.25, "compile_count": 3,
            "compile_s_total": 50.0, "compile_hits": 4,
            "compile_misses": 3, "extra": "dropped"})
    return wire.rollup_to_wire({
        "t": 11.0, "span_s": 0.25, "fits": 16, "sheds": 1,
        "device_busy_s": 8.5, "queue_wait_count": 16,
        "queue_wait_sum_s": 0.5, "queue_wait_max_s": "nope"})


def _decode(mods, kind, d):
    """Decode ``d`` and encode the object again."""
    queue_mod, qos_mod, wire = mods
    if kind == "config":
        return wire.config_to_wire(wire.config_from_wire(d))
    if kind in ("qos", "untagged"):
        return wire.qos_to_wire(wire.qos_from_wire(d))
    if kind == "result":
        return wire.result_to_wire(wire.result_from_wire(d, 3))
    if kind == "shed":
        return wire.shed_to_wire(wire.shed_from_wire(d))
    if kind == "resources":
        return wire.resources_to_wire(wire.resources_from_wire(d))
    return wire.rollup_to_wire(wire.rollup_from_wire(d))


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_wire_is_one_protocol_both_ways(codec):
    kind, case = CODECS[codec]
    jax_d = _encode(PACKAGES["jax"], kind, case)
    port_d = _encode(PACKAGES["port"], kind, case)
    assert json.dumps(port_d) == json.dumps(jax_d)
    # Each package decodes the other's text to the same object.
    assert json.dumps(_decode(PACKAGES["port"], kind,
                              json.loads(json.dumps(jax_d)))) \
        == json.dumps(jax_d)
    assert json.dumps(_decode(PACKAGES["jax"], kind,
                              json.loads(json.dumps(port_d)))) \
        == json.dumps(port_d)


def test_jsonl_channels_talk_across_packages():
    a, b = socket.socketpair()
    try:
        jax_chan, port_chan = jax_wire.JsonlChannel(a), \
            pt_wire.JsonlChannel(b)
        msgs = [{"op": "submit", "rid": "r1", "guess": [-1.0, 0.5],
                 "config": pt_wire.config_to_wire(FitConfig(nsteps=5))},
                {"op": "heartbeat", "t": 1.5, "stats": {"completed": 2}}]
        for m in msgs:
            jax_chan.send(m)
        assert [port_chan.recv() for _ in msgs] == msgs
        for m in msgs:
            port_chan.send(m)
        assert [jax_chan.recv() for _ in msgs] == msgs
    finally:
        a.close()
        b.close()


def test_build_model_specs():
    model = build_model("smf", {"num_halos": N_HALOS}, device="cpu")
    assert isinstance(model, SMFModel) and model.device.type == "cpu"
    assert model.aux_leaves()[0].shape[0] == N_HALOS
    other = build_model("multigrad_tpu_torch.models:SMFModel",
                        {"aux_data": make_smf_data(64, device="cpu")})
    assert isinstance(other, SMFModel)
    with pytest.raises(ValueError, match="unknown worker model spec"):
        build_model("nope", {})


# ------------------------------------------------------------------ #
# the worker process on the CPU
# ------------------------------------------------------------------ #
def _start(tmp_path, *extra):
    cmd = [sys.executable, "-m", "multigrad_tpu_torch.serve.worker",
           "--device", "cpu", "--model", "smf",
           "--model-kwargs", json.dumps({"num_halos": N_HALOS}),
           "--buckets", "1,4", "--batch-window-s", "0",
           "--heartbeat-s", "0.1", "--flight-dir", str(tmp_path / "pm"),
           *extra]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _ready(proc):
    ready, _, _ = select.select([proc.stdout], [], [], WAIT_S)
    line = proc.stdout.readline() if ready else ""
    assert line.startswith("FLEET-WORKER-READY "), \
        (line, proc.poll(), proc.stderr.read() if proc.poll() else "")
    info = json.loads(line.split(" ", 1)[1])
    sock = socket.create_connection(("127.0.0.1", info["port"]),
                                    timeout=WAIT_S)
    return info, pt_wire.JsonlChannel(sock)


def _until(chan, ops):
    """Messages up to and including the first whose op is in ``ops``,
    heartbeats left out."""
    seen = []
    while True:
        msg = chan.recv()
        assert msg is not None, f"the worker hung up after {seen}"
        if msg["op"] != "heartbeat":
            seen.append(msg)
        if msg["op"] in ops:
            return seen


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=WAIT_S)
    proc.stdout.close()
    proc.stderr.close()


def _submit(chan, rid, guess, config):
    chan.send({"op": "submit", "rid": rid,
               "guess": [float(g) for g in guess],
               "config": pt_wire.config_to_wire(config)})


def test_worker_answers_a_submit_and_drains(tmp_path):
    config = FitConfig(nsteps=20, learning_rate=0.05, param_bounds=BOUNDS)
    guess = [-1.7, 0.45]
    proc = _start(tmp_path)
    try:
        info, chan = _ready(proc)
        assert info["id"] == "w0" and info["live_port"] is None
        _submit(chan, "r1", guess, config)
        answer = _until(chan, {"result", "error"})[-1]
        assert answer["op"] == "result" and answer["rid"] == "r1"
        chan.send({"op": "drain"})
        tail = _until(chan, {"drained"})
        assert [m["op"] for m in tail] == ["draining", "drained"]
        assert tail[-1]["stats"]["completed"] == 1
        assert proc.wait(timeout=WAIT_S) == 0
    finally:
        _stop(proc)
    got = pt_wire.result_from_wire(answer["result"], 0)
    model = SMFModel(aux_data=make_smf_data(N_HALOS, device="cpu"))
    with FitScheduler(model, buckets=(1, 4), start=False,
                      batch_window_s=0.0) as sched:
        fut = sched.submit(guess, config=config)
        sched.start()
        local = fut.result(timeout=WAIT_S)
    assert got.bucket == local.bucket == 1
    assert np.array_equal(got.traj, local.traj)
    assert np.array_equal(got.params, local.params)
    assert got.loss == local.loss


def test_worker_drains_on_sigterm(tmp_path):
    proc = _start(tmp_path)
    try:
        _, chan = _ready(proc)
        for i in range(2):
            _submit(chan, f"r{i}", [-1.5 - 0.2 * i, 0.5],
                    FitConfig(nsteps=30, learning_rate=0.05))
        # SIGTERM once both are admitted (a submit still on the wire
        # when the drain begins is rejected, for the router to place
        # elsewhere): a heartbeat counts them.
        seen = []
        while True:
            msg = chan.recv()
            assert msg is not None
            if msg["op"] != "heartbeat":
                seen.append(msg)
            elif msg["stats"]["submitted"] == 2:
                break
        proc.send_signal(signal.SIGTERM)
        seen += _until(chan, {"drained"})
        ops = [m["op"] for m in seen]
        assert ops.count("result") == 2 and ops[-1] == "drained"
        assert ops.index("draining") < ops.index("drained")
        assert seen[-1]["stats"]["completed"] == 2
        assert proc.wait(timeout=WAIT_S) == 0
    finally:
        _stop(proc)


def test_worker_refuses_a_tuning_table(tmp_path):
    # --tuning-table with --buckets auto: the worker's scheduler comes up
    # on the ladder the table holds for its model, and the READY
    # handshake reports it.
    from multigrad_tpu_torch.tune import TuningTable
    from multigrad_tpu_torch.tune.resolve import buckets_key
    table = str(tmp_path / "t.json")
    model = build_model("smf", {"num_halos": N_HALOS}, device="cpu")
    TuningTable(table).record(buckets_key(model), {"buckets": [1, 2, 8]})
    proc = _start(tmp_path, "--buckets", "auto", "--tuning-table", table)
    try:
        info, chan = _ready(proc)
        assert info["buckets"] == [1, 2, 8]
        chan.send({"op": "drain"})
        assert _until(chan, ("drained",))[-1]["op"] == "drained"
        assert proc.wait(timeout=WAIT_S) == 0
    finally:
        _stop(proc)
