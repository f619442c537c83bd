"""Faults of the port against the reference, held on the CPU.

* ``reduce_sum`` of a host value under NCCL: NCCL reduces only CUDA
  tensors, so a Python scalar or a CPU tensor must go through the current
  CUDA device and come back as it came.  The backend query, the CUDA
  device and the all-reduce are patched, so no process group and no card
  are needed.
* Progress bars on process 0 only (``multigrad_tpu/utils/util.py``'s
  ``simple_grad_descent`` and ``optim/bfgs.py`` show theirs there only).
* Public signatures the port had changed, each called as the JAX
  package's tests call the reference: ``scatter_nd``'s ``root`` and
  ``return_pad_count``; ``comm`` in ``run_bfgs`` and the model's
  ``run_adam`` and ``run_bfgs``; the generic ``run_adam(f, params, data)``
  and ``run_adam_unbounded``, and ``run_adam_scan``'s ``(params, key,
  *fn_args)``.  Trajectories against the JAX package's on the same
  objective: rtol 1e-5 (optax's Adam and the port's loop are the same
  float32 ops, but XLA may contract them into FMAs).
"""
import inspect

import numpy as np
import pytest
import torch
import torch.distributed as dist

import multigrad_tpu_torch as mgtt
from multigrad_tpu_torch.core.model import OnePointModel
from multigrad_tpu_torch.models import SMFModel, make_smf_data
from multigrad_tpu_torch.parallel.collectives import reduce_sum, scatter_nd
from multigrad_tpu_torch.parallel.mesh import MeshComm
from multigrad_tpu_torch.telemetry import MemorySink, MetricsLogger
from multigrad_tpu_torch.utils import util


@pytest.fixture
def fake_group(monkeypatch):
    """A 2-rank group whose all-reduce doubles its tensor in place; yields
    a dict that records the backend to report, each ``Tensor.to`` target
    and the tensors all-reduced."""
    seen = {"backend": "nccl", "moves": [], "reduced": []}
    real_to = torch.Tensor.to

    def fake_to(self, *args, **kwargs):
        target = torch.device(args[0] if args else kwargs["device"])
        seen["moves"].append(target)
        # No card here: stand in for the CUDA copy with a CPU one.
        return self.clone() if target.type == "cuda" else real_to(self, target)

    def fake_all_reduce(tensor, op=None, group=None):
        seen["reduced"].append(tensor)
        tensor.mul_(2)

    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: seen["backend"])
    monkeypatch.setattr(dist, "all_reduce", fake_all_reduce)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(torch.Tensor, "to", fake_to)
    return seen


def test_reduce_sum_python_float_under_nccl(fake_group):
    out = reduce_sum(1.25, comm=MeshComm())
    assert fake_group["moves"] == [torch.device("cuda", 3)]
    assert len(fake_group["reduced"]) == 1
    assert type(out) is float and out == 2.5


def test_reduce_sum_cpu_tensor_under_nccl(fake_group):
    value = torch.tensor([1.0, -2.0])
    out = reduce_sum(value, comm=MeshComm())
    assert fake_group["moves"] == [torch.device("cuda", 3),
                                   torch.device("cpu")]
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert torch.equal(out, torch.tensor([2.0, -4.0]))
    assert torch.equal(value, torch.tensor([1.0, -2.0]))


def test_reduce_sum_under_gloo_stays_on_the_host(fake_group):
    fake_group["backend"] = "gloo"
    assert reduce_sum(3, comm=MeshComm()) == 6
    out = reduce_sum(torch.tensor(0.5), comm=MeshComm())
    assert fake_group["moves"] == [torch.device("cpu")]
    assert out.device.type == "cpu" and float(out) == 1.0


@pytest.mark.skipif(util.tqdm is None, reason="tqdm is not installed")
@pytest.mark.parametrize("rank", [0, 1])
def test_progress_bar_on_process_zero_only(monkeypatch, rank):
    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: rank)
    steps = util.trange(3, "Adam Gradient Descent Progress", progress=True)
    try:
        if rank == 0:
            assert not isinstance(steps, range) and len(steps) == 3
        else:
            assert steps == range(3)
    finally:
        if not isinstance(steps, range):
            steps.close()


def test_progress_bar_without_a_process_group(monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    assert util.trange(2, progress=False) == range(2)
    steps = util.trange(2, progress=True)
    assert (steps == range(2)) if util.tqdm is None else len(steps) == 2
    if not isinstance(steps, range):
        steps.close()


# --------------------------------------------------------------------- #
# Public signatures: the port's against the JAX package's
# --------------------------------------------------------------------- #
class _Rank:
    """A stand-in comm of two processes, seen from rank 1."""
    rank, size = 1, 2


def test_scatter_nd_positional_root_raises_on_a_ragged_axis():
    # scatter_nd(x, axis, comm, root): a root of 0 is no pad value.
    with pytest.raises(ValueError, match="not divisible"):
        scatter_nd(torch.arange(5.0), 0, _Rank(), 0)
    shard = scatter_nd(torch.arange(6.0), 0, _Rank(), 0)
    np.testing.assert_array_equal(shard.numpy(), [3.0, 4.0, 5.0])


def test_scatter_nd_return_pad_count():
    x = torch.arange(5.0)
    shard, pad = scatter_nd(x, comm=_Rank(), pad_value=float("inf"),
                            return_pad_count=True)
    assert pad == 1
    np.testing.assert_array_equal(shard.numpy(), [3.0, 4.0, np.inf])
    shard, pad = scatter_nd(torch.arange(6.0), comm=_Rank(),
                            return_pad_count=True)
    assert pad == 0 and shard.tolist() == [3.0, 4.0, 5.0]
    whole, pad = scatter_nd(x, return_pad_count=True)
    assert pad == 0 and whole is x


def _quadratic(p, *rest, **kwargs):
    return ((p - 1.0) ** 2).sum(), 2.0 * (p - 1.0)


def test_run_bfgs_takes_comm_in_the_sixth_slot():
    args = (_quadratic, torch.tensor([0.3, -0.2]), 50, None, None,
            MeshComm())
    result = mgtt.run_bfgs(*args, progress=False)
    np.testing.assert_allclose(result.x, [1.0, 1.0], atol=1e-5)
    again = mgtt.run_bfgs(_quadratic, torch.tensor([0.3, -0.2]),
                          maxsteps=50, comm=None, progress=False)
    np.testing.assert_array_equal(result.x, again.x)


def test_model_fits_take_comm():
    model = SMFModel(aux_data=make_smf_data(2_000, device="cpu"))
    traj = model.run_adam((-1.5, 0.4), 3, None, 0.02, None, False,
                          MeshComm(), False)
    alone = model.run_adam(guess=(-1.5, 0.4), nsteps=3, learning_rate=0.02,
                           progress=False)
    assert torch.equal(traj, alone)
    result = model.run_bfgs((-1.5, 0.4), 5, None, None, MeshComm(), False)
    assert np.all(np.isfinite(result.x))
    # The monitoring arguments that follow comm now work.
    sink = MemorySink()
    monitored = model.run_adam(guess=(-1.5, 0.4), nsteps=3,
                               learning_rate=0.02, telemetry=MetricsLogger(
                                   sink), log_every=1, progress=False)
    assert torch.equal(monitored, alone)
    assert [r["step"] for r in sink.records if r["event"] == "adam"] == [
        0, 1, 2]


def _generic(p, data, randkey=None):
    """``(loss, grad)`` of ``Σ (p - data)²`` for jnp and torch alike."""
    return ((p - data) ** 2).sum(), 2.0 * (p - data)


@pytest.mark.parametrize("bounds", [None, [(-2.0, 2.0), (0.0, 3.0)]],
                         ids=["unbounded", "bounded"])
def test_run_adam_takes_data_as_the_reference(bounds):
    import jax.numpy as jnp
    from multigrad_tpu.optim.adam import run_adam as jax_run_adam
    data = np.array([0.5, 2.0], np.float32)
    start = np.array([-1.0, 1.0], np.float32)
    want = np.asarray(jax_run_adam(_generic, jnp.asarray(start),
                                   jnp.asarray(data), nsteps=5,
                                   param_bounds=bounds, learning_rate=0.1,
                                   progress=False))
    got = mgtt.run_adam(_generic, torch.tensor(start), torch.tensor(data),
                        nsteps=5, param_bounds=bounds, learning_rate=0.1,
                        progress=False)
    assert tuple(got.shape) == (6, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # run_adam(f, p, data) keeps nsteps at its default of 100.
    assert mgtt.run_adam(_generic, torch.tensor(start), torch.tensor(data),
                         progress=False).shape[0] == 101
    if bounds is None:
        alone = mgtt.run_adam_unbounded(
            _generic, torch.tensor(start), torch.tensor(data), nsteps=5,
            learning_rate=0.1, progress=False)
        assert torch.equal(alone, got)
    else:
        with pytest.raises(ValueError, match="one entry per parameter"):
            mgtt.run_adam(_generic, torch.tensor(start),
                          torch.tensor(data), param_bounds=bounds[:1])


def test_run_adam_scan_passes_key_and_fn_args(tmp_path):
    import jax.numpy as jnp
    from multigrad_tpu.optim.adam import run_adam_scan as jax_run_adam_scan
    seen = []

    def loss_and_grad(p, key, data, scale):
        seen.append(key)
        return (scale * (p - data) ** 2).sum(), 2.0 * scale * (p - data)

    data = np.array([0.5, 2.0], np.float32)
    start = np.array([-1.0, 1.0], np.float32)
    want = np.asarray(jax_run_adam_scan(
        loss_and_grad, jnp.asarray(start), nsteps=6, learning_rate=0.1,
        fn_args=(jnp.asarray(data), 2.0)))
    seen.clear()
    got = mgtt.run_adam_scan(loss_and_grad, torch.tensor(start), nsteps=6,
                             learning_rate=0.1,
                             fn_args=(torch.tensor(data), 2.0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert seen == [0] * 6          # jax.random.key(0)'s counterpart
    seen.clear()
    mgtt.run_adam_scan(loss_and_grad, torch.tensor(start), nsteps=3,
                       randkey=5, const_randkey=True,
                       fn_args=(torch.tensor(data), 2.0))
    assert seen == [5] * 3
    kw = dict(nsteps=4, learning_rate=0.1, fn_args=(torch.tensor(data), 2.0),
              checkpoint_dir=str(tmp_path), checkpoint_every=2)
    first = mgtt.run_adam_scan(loss_and_grad, torch.tensor(start), **kw)
    assert torch.equal(first, mgtt.run_adam_scan(
        loss_and_grad, torch.tensor(start), **kw))
    with pytest.raises(ValueError, match="different training data"):
        mgtt.run_adam_scan(loss_and_grad, torch.tensor(start),
                           **(kw | {"fn_args": (torch.tensor(data), 3.0)}))
    # log_every without a logger records nothing and changes nothing.
    assert torch.equal(got, mgtt.run_adam_scan(
        loss_and_grad, torch.tensor(start), nsteps=6, learning_rate=0.1,
        log_every=5, fn_args=(torch.tensor(data), 2.0)))


def _quadratic_loss(p):
    return ((p - 1.5) ** 2).sum()


def test_simple_grad_descent_takes_value_and_grad_options():
    # The JAX package (and the reference) pass simple_grad_descent's
    # **kwargs to jax.value_and_grad: its options on the autograd path,
    # an unknown name a TypeError there, ignored on the other paths.
    import jax.numpy as jnp
    from multigrad_tpu.utils.util import simple_grad_descent as jax_sgd
    start = np.array([0.0, 3.0], np.float32)
    options = dict(argnums=0, allow_int=False, holomorphic=False)
    want = jax_sgd(_quadratic_loss, jnp.asarray(start), 4, 0.1,
                   progress=False, **options)
    got = util.simple_grad_descent(_quadratic_loss, torch.tensor(start), 4,
                                   0.1, progress=False, **options)
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params),
                               rtol=1e-6)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=1e-6)
    with pytest.raises(TypeError):
        jax_sgd(_quadratic_loss, jnp.asarray(start), 1, 0.1,
                progress=False, randkey=3)
    with pytest.raises(TypeError):
        util.simple_grad_descent(_quadratic_loss, torch.tensor(start), 1,
                                 0.1, progress=False, randkey=3)
    # A loss-and-grad callable takes the options unused, in both.
    jax_sgd(None, jnp.asarray(start), 1, 0.1, progress=False, randkey=3,
            loss_and_grad_func=lambda p: (jnp.sum(p), p))
    util.simple_grad_descent(None, torch.tensor(start), 1, 0.1,
                             progress=False, randkey=3,
                             loss_and_grad_func=lambda p: (p.sum(), p))


def test_run_multistart_adam_takes_donate_carry():
    # donate_carry is the JAX package's 11th parameter, before telemetry.
    model = SMFModel(aux_data=make_smf_data(2_000, device="cpu"))
    bounds = [(-4.0, 0.0), (0.02, 1.0)]
    by_name = mgtt.run_multistart_adam(model, bounds, n_starts=2, nsteps=3,
                                       learning_rate=0.05,
                                       donate_carry=False)
    positional = mgtt.run_multistart_adam(model, bounds, 2, 3, 0.05, None,
                                          0, None, False, True, True)
    assert torch.equal(by_name.params, positional.params)


def test_trange_takes_leave_as_the_jax_package():
    # trange(n, desc=None, leave=True): a positional third argument is
    # tqdm's leave, as in the JAX package; progress is keyword-only.
    assert util.trange(3, None, False, progress=False) == range(3)
    if util.tqdm is not None:
        bar = util.trange(2, "bars", False)
        assert bar.leave is False
        bar.close()


def _names(fn):
    return [p.name for p in inspect.signature(fn).parameters.values()]


def _resolve(package, dotted):
    """``package.dotted``: the longest importable module prefix, then
    attributes; a class stands for its constructor."""
    import importlib
    parts = dotted.split(".")
    for cut in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(
                ".".join([package] + parts[:cut]))
        except ModuleNotFoundError:
            continue
        for attr in parts[cut:]:
            obj = getattr(obj, attr)
        return obj.__init__ if inspect.isclass(obj) else obj
    raise AssertionError(dotted)


#: The telemetry names, from each port module's ``__all__`` (the port's
#: own ``profile.DeviceWindows`` aside), and ``utils.profiling``'s.
TELEMETRY_NAMES = [f"telemetry.{module}.{name}" for module, names in (
    ("metrics", ("run_record", "config_digest", "JsonlSink", "CsvSink",
                 "MemorySink", "MetricsLogger")),
    ("taps", ("ScalarTap", "make_tap", "batch_norm")),
    ("comm", ("CommCounter", "record_collective", "traced_comm",
              "measure_model_comm", "leaf_nbytes")),
    ("spans", ("span", "Heartbeat")),
    ("flight", ("FlightRecorder", "FlightRecorderTripped",
                "NonFiniteSentinel")),
    ("live", ("LiveMetrics", "LiveSink", "LiveServer", "LatencyObserver",
              "wire_monitoring")),
    ("alerts", ("AlertEngine", "AlertRule", "LossPlateau",
                "GradExplosion", "ThroughputDrop", "DivergenceRate",
                "HeartbeatStall", "default_rules")),
    ("report", ("load_records", "split_runs", "list_runs", "summarize",
                "render", "main")),
    ("profile", ("profiled_fit", "FitProfile", "summarize_device_trace",
                 "measure_rtt_floor"))) for name in names] + [
    f"utils.profiling.{name}" for name in ("Timer", "trace", "StreamStats",
                                           "StepsPerSecond")]

#: Differences by design (ROADMAP Queue 3): the port's keyword-only
#: ``comm`` of ``run_adam_streamed`` (its checkpoint's writer and
#: barrier) and ``progress`` of ``trange`` (the port's callers turn the
#: bar off there; the JAX package picks ``range`` at each call site), and
#: the memory-budget knob ``k_budget_bytes``, which comes with sharded K.
PORT_ONLY = {"optim.adam.run_adam_streamed": ["comm"],
             "utils.util.trange": ["progress"]}
JAX_ONLY = {"inference.ensemble.run_multistart_adam": ["k_budget_bytes"]}


@pytest.mark.parametrize("name", [
    "parallel.collectives.scatter_nd", "optim.bfgs.run_bfgs",
    "optim.bfgs.run_lbfgs_scan", "optim.adam.run_adam",
    "optim.adam.run_adam_unbounded", "optim.adam.run_adam_scan",
    "optim.adam.run_adam_streamed",
    "core.model.OnePointModel.run_adam", "core.model.OnePointModel.run_bfgs",
    "data.streaming.StreamingOnePointModel.run_adam",
    "inference.ensemble.run_multistart_adam",
    "inference.ensemble.run_multistart_lbfgs", "inference.hmc.run_hmc",
    "parallel.distributed.initialize", "utils.util.simple_grad_descent",
    "utils.util.trange"] + TELEMETRY_NAMES)
def test_public_signature_matches_the_jax_package(name):
    got = _names(_resolve("multigrad_tpu_torch", name))
    want = _names(_resolve("multigrad_tpu", name))
    # The port's only extra everywhere: a trailing device= (and a
    # keyword-only device before **kwargs).
    got = [n for n in got if n != "device" and n not in PORT_ONLY.get(
        name, ())]
    want = [n for n in want if n not in JAX_ONLY.get(name, ())]
    assert got == want, (got, want)
