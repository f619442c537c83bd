"""The port's multi-process bootstrap (``parallel/distributed.py``) and
``hybrid_comm``: the cases of ``tests/test_distributed_init.py`` with
``torch.distributed.init_process_group`` patched, the NCCL path's
``torch.cuda.set_device(LOCAL_RANK)`` with the CUDA calls patched, a
real gloo bootstrap of 2 ranks from a launcher's environment, and a
group of one process whose SMF fit makes its all-reduces (the identity)
and equals the fit without a comm bit for bit.

Each rank of the real bootstrap is a process of its own that runs this
file as a script (it imports no JAX), joined with a hard timeout, as in
``tests/test_torch_comm.py``.
"""
import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile

import pytest
import torch
import torch.distributed as dist

from multigrad_tpu_torch.parallel import distributed
from multigrad_tpu_torch.parallel import mesh

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCHER_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                 "LOCAL_RANK")
TIMEOUT_S = 120


@pytest.fixture
def fresh(monkeypatch):
    """No group, no launcher; records the calls of a patched
    ``init_process_group`` (``fresh["init"]`` sets what it does)."""
    monkeypatch.setattr(distributed, "_initialized", False)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    for name in LAUNCHER_VARS:
        monkeypatch.delenv(name, raising=False)
    seen = {"calls": [], "init": lambda *a, **k: None}

    def fake_init(*args, **kwargs):
        seen["calls"].append((args, kwargs))
        return seen["init"](*args, **kwargs)

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    return seen


@pytest.fixture
def launcher(monkeypatch):
    """The environment a launcher gives rank 1 of 2."""
    for name, value in (("MASTER_ADDR", "127.0.0.1"),
                        ("MASTER_PORT", "29511"), ("RANK", "1"),
                        ("WORLD_SIZE", "2"), ("LOCAL_RANK", "1")):
        monkeypatch.setenv(name, value)


def test_classifier_swallows_already_initialized():
    for msg in (
        "jax.distributed.initialize has already been called",
        "Distributed runtime already initialized",
        "initialize() can only be called once",
    ):
        assert distributed._is_already_initialized_error(
            RuntimeError(msg)), msg


def test_classifier_reraises_failed_bootstrap():
    for msg in (
        "Failed to initialize distributed runtime: coordinator "
        "unreachable",
        "could not connect to coordinator at 10.0.0.1:1234: timeout",
        "initialization failed",
        "failed to bind coordinator: address already in use",
        # torch's own words for a stale process on the master's port.
        "The server socket has failed to listen on any local network "
        "address. port: 29500, useIpv6: false, code: -98, name: "
        "EADDRINUSE, message: address already in use",
    ):
        assert not distributed._is_already_initialized_error(
            RuntimeError(msg)), msg


def test_initialize_swallows_already_initialized(fresh, launcher):
    def already(*args, **kwargs):
        raise RuntimeError("init_process_group has already been called")

    fresh["init"] = already
    distributed.initialize(device="cpu")  # must not raise
    assert distributed._initialized and len(fresh["calls"]) == 1


def test_initialize_reraises_failed_bootstrap(fresh, launcher):
    def unreachable(*args, **kwargs):
        raise dist.DistStoreError("could not connect to coordinator: "
                                  "timeout")

    fresh["init"] = unreachable
    with pytest.raises(RuntimeError, match="coordinator"):
        distributed.initialize(device="cpu")
    assert not distributed._initialized


def test_initialize_value_error_means_standalone(fresh, launcher):
    def no_rendezvous(*args, **kwargs):
        raise ValueError("environment variable RANK expected, but not set")

    fresh["init"] = no_rendezvous
    distributed.initialize(device="cpu")  # a single process: fine
    assert distributed._initialized


def test_initialize_is_idempotent(fresh, launcher):
    distributed.initialize(device="cpu")
    distributed.initialize(device="cpu")
    assert len(fresh["calls"]) == 1


def test_no_launcher_is_a_single_process(fresh):
    distributed.initialize()          # no card needed: nothing comes up
    assert distributed._initialized and fresh["calls"] == []
    assert (distributed.process_index(), distributed.process_count(),
            distributed.is_main_process()) == (0, 1, True)


def test_a_group_already_up_is_kept(fresh, launcher, monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    distributed.initialize(device="cpu")
    assert distributed._initialized and fresh["calls"] == []


def test_launcher_environment_and_explicit_arguments(fresh, launcher):
    timeout = datetime.timedelta(seconds=30)
    distributed.initialize(device="cpu", timeout=timeout)
    (args, kwargs), = fresh["calls"]
    assert args == ("gloo",)
    assert kwargs == dict(init_method="tcp://127.0.0.1:29511", rank=1,
                          world_size=2, timeout=timeout)
    distributed._initialized = False
    distributed.initialize("10.0.0.7:1234", 4, 3, device="cpu")
    assert fresh["calls"][1][1] == dict(init_method="tcp://10.0.0.7:1234",
                                        rank=3, world_size=4)


@pytest.mark.parametrize("local_rank,want", [("1", 1), (None, 3)])
def test_nccl_binds_the_process_to_its_card(fresh, launcher, monkeypatch,
                                            local_rank, want):
    order = []
    fresh["init"] = lambda *a, **k: order.append(("init", a[0]))
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK")
        monkeypatch.setenv("RANK", "7")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: order.append(("set_device", d)))
    distributed.initialize()
    # The card first (LOCAL_RANK, else rank % device_count), then NCCL.
    assert order == [("set_device", want), ("init", "nccl")]


def test_node_major():
    assert mesh._node_major(["a", "a", "b", "b", "c"])
    assert mesh._node_major(["a"])
    assert not mesh._node_major(["a", "b", "a"])
    assert not mesh._node_major(["a", "b", "b", "a"])


def test_hybrid_comm_single_process_and_interleaved_hosts(monkeypatch):
    comm = mesh.hybrid_comm(name="HYBRID")
    assert (comm.name, comm.rank, comm.size) == ("HYBRID", 0, 1)
    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)

    def gather(out, obj):
        out[:] = ["n0", "n1", "n0", "n1"]

    monkeypatch.setattr(dist, "all_gather_object", gather)
    with pytest.raises(ValueError, match="node-major"):
        mesh.hybrid_comm()


# --------------------------------------------------------------------- #
# A real gloo bootstrap of 2 ranks from a launcher's environment
# --------------------------------------------------------------------- #
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_one_rank_fit(out_file):
    """A group of one process: the SMF fit's all-reduces run (2 a step),
    and its trajectory equals the fit without a comm bit for bit."""
    from multigrad_tpu_torch import global_comm
    from multigrad_tpu_torch.models import SMFModel, make_smf_data
    distributed.initialize(device="cpu")
    comm = global_comm()
    model = SMFModel(aux_data=make_smf_data(1_001, comm=comm, device="cpu"),
                     comm=comm)
    alone = SMFModel(aux_data=make_smf_data(1_001, device="cpu"))
    sizes, real = [], dist.all_reduce

    def counting(tensor, *args, **kwargs):
        sizes.append(tensor.numel())
        return real(tensor, *args, **kwargs)

    dist.all_reduce = counting
    try:
        traj = model.run_adam(guess=(-1.0, 0.5), nsteps=3,
                              learning_rate=0.02, progress=False)
    finally:
        dist.all_reduce = real
    want = alone.run_adam(guess=(-1.0, 0.5), nsteps=3, learning_rate=0.02,
                          progress=False)
    out = dict(sizes=sizes, equal=bool(torch.equal(traj, want)))
    dist.destroy_process_group()
    with open(out_file, "w") as f:
        json.dump(out, f)


def _run_rank(out_file):
    from multigrad_tpu_torch import global_comm, hybrid_comm
    from multigrad_tpu_torch.parallel.collectives import (reduce_sum,
                                                          scatter_nd)
    before = dist.is_initialized()
    distributed.initialize(device="cpu")
    group = dist.group.WORLD
    distributed.initialize(device="cpu")      # a no-op
    comm = hybrid_comm()
    shard, pad = scatter_nd(torch.arange(5.0), comm=global_comm(),
                            pad_value=float("inf"), return_pad_count=True)
    out = dict(before=before, backend=dist.get_backend(),
               same_group=dist.group.WORLD is group,
               index=distributed.process_index(),
               count=distributed.process_count(),
               main=distributed.is_main_process(),
               hybrid=[comm.name, comm.rank, comm.size],
               total=reduce_sum(1.5, comm=global_comm()),
               shard=shard.tolist(), pad=pad)
    dist.destroy_process_group()
    with open(out_file, "w") as f:
        json.dump(out, f)


def _run_gather(out_file):
    """Each rank's records, one of them unstamped, gathered to rank 0 by
    ``telemetry.aggregate.gather_to_rank0`` under gloo."""
    from multigrad_tpu_torch.telemetry.aggregate import gather_to_rank0
    distributed.initialize(device="cpu")
    rank = dist.get_rank()
    records = [{"event": "span", "t": 10.0 - rank, "process_index": rank,
                "path": "fit", "elapsed_s": 1.0},
               {"event": "note", "t": 5.0 + rank, "text": "é" * (rank + 1)}]
    got = gather_to_rank0(records)
    dist.destroy_process_group()
    with open(out_file, "w") as f:
        json.dump({"rank": rank, "got": got}, f)


def _launch(kind, world):
    """``world`` ranks of this file run as a script, each given its place
    in the environment as a launcher would; their JSON results."""
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
        procs = []
        for r in range(world):
            env = dict(os.environ, PYTHONPATH=REPO_ROOT, OMP_NUM_THREADS="1",
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       RANK=str(r), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(r))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), kind, outs[r]],
                cwd=REPO_ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT))
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


def test_two_rank_gloo_bootstrap_from_the_launcher_environment():
    ranks = _launch("bootstrap", 2)
    for r, got in enumerate(ranks):
        assert not got["before"] and got["backend"] == "gloo"
        assert got["same_group"]
        assert (got["index"], got["count"], got["main"]) == (r, 2, r == 0)
        assert got["hybrid"] == ["WORLD", r, 2]
        assert got["total"] == 3.0 and got["pad"] == 1
    assert ranks[0]["shard"] == [0.0, 1.0, 2.0]
    assert ranks[1]["shard"] == [3.0, 4.0, float("inf")]


def test_one_rank_group_all_reduces_and_changes_nothing():
    (got,) = _launch("one_rank_fit", 1)
    # y (10 bins) and the gradient (2) each step: the identity, bit for
    # bit.
    assert got["sizes"] == [10, 2] * 3 and got["equal"]


def test_gather_to_rank0_over_two_gloo_ranks():
    r0, r1 = _launch("gather", 2)
    assert r1["got"] is None
    # Time-ordered across ranks; an unstamped record takes its rank.
    assert [(r["event"], r["t"], r["process_index"]) for r in r0["got"]] \
        == [("note", 5.0, 0), ("note", 6.0, 1), ("span", 9.0, 1),
            ("span", 10.0, 0)]
    assert [r["text"] for r in r0["got"] if r["event"] == "note"] \
        == ["é", "éé"]


if __name__ == "__main__":
    {"bootstrap": _run_rank,
     "one_rank_fit": _run_one_rank_fit,
     "gather": _run_gather}[sys.argv[1]](sys.argv[2])
