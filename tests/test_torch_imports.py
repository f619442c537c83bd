"""The port stands alone: no JAX, no optax, nothing of ``multigrad_tpu``,
and no silent move to the CPU when CUDA is absent."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO_ROOT, "multigrad_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "optax", "multigrad_tpu")


def _python_files():
    for root, _, files in os.walk(PACKAGE):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO_ROOT, "chip_smoke.py")
    yield os.path.join(REPO_ROOT, "tools", "hist_card_vs_cpu.py")
    yield os.path.join(REPO_ROOT, "tools", "pair_kernels_ab.py")
    yield os.path.join(REPO_ROOT, "tools", "streamed_smf.py")
    yield os.path.join(REPO_ROOT, "tools", "posterior_smf.py")
    yield os.path.join(REPO_ROOT, "tools", "telemetry_smf.py")
    yield os.path.join(REPO_ROOT, "tools", "serve_smf.py")
    yield os.path.join(REPO_ROOT, "tools", "fleet_smf.py")
    yield os.path.join(REPO_ROOT, "tools", "tune_smf.py")
    yield os.path.join(REPO_ROOT, "tools", "analysis_smf.py")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import multigrad_tpu_torch, multigrad_tpu_torch.models\n"
        "import multigrad_tpu_torch.ops.binned\n"
        "import multigrad_tpu_torch.ops.fused_kernels\n"
        "import multigrad_tpu_torch.ops.cuda_build\n"
        "import multigrad_tpu_torch.models.galhalo\n"
        "import multigrad_tpu_torch.models.galhalo_hist\n"
        "import multigrad_tpu_torch.models.wprp\n"
        "import multigrad_tpu_torch.ops.pair_kernels\n"
        "import multigrad_tpu_torch.ops.pairwise\n"
        "import multigrad_tpu_torch.core.group\n"
        "import multigrad_tpu_torch.models.joint\n"
        "import multigrad_tpu_torch.ingraph\n"
        "import multigrad_tpu_torch.utils.checkpoint\n"
        "import multigrad_tpu_torch.utils.debug\n"
        "import multigrad_tpu_torch.data\n"
        "import multigrad_tpu_torch.data.source\n"
        "import multigrad_tpu_torch.data.prefetch\n"
        "import multigrad_tpu_torch.data.streaming\n"
        "import multigrad_tpu_torch.utils.profiling\n"
        "import multigrad_tpu_torch.inference.fisher\n"
        "import multigrad_tpu_torch.inference.ensemble\n"
        "import multigrad_tpu_torch.inference.hmc\n"
        "import multigrad_tpu_torch.optim._lbfgs\n"
        "import multigrad_tpu_torch.parallel.distributed\n"
        "import multigrad_tpu_torch.utils.diffdesi\n"
        "import multigrad_tpu_torch.telemetry\n"
        "import multigrad_tpu_torch.telemetry.report\n"
        "import multigrad_tpu_torch.serve, multigrad_tpu_torch.serve.worker\n"
        "import multigrad_tpu_torch.serve.wire\n"
        "import multigrad_tpu_torch.serve.fleet\n"
        "import multigrad_tpu_torch.serve.chaos\n"
        "import multigrad_tpu_torch.serve.stages\n"
        "import multigrad_tpu_torch.serve.jobs\n"
        "import multigrad_tpu_torch.telemetry.aggregate\n"
        "import multigrad_tpu_torch.telemetry.trace\n"
        "import multigrad_tpu_torch.telemetry.dashboard\n"
        "import multigrad_tpu_torch.telemetry.regress\n"
        "import multigrad_tpu_torch.telemetry.top\n"
        "import multigrad_tpu_torch.telemetry.resources\n"
        "import multigrad_tpu_torch.utils.lockdep\n"
        "import multigrad_tpu_torch.utils.testing\n"
        "import multigrad_tpu_torch.telemetry.costmodel\n"
        "import multigrad_tpu_torch.ops.kernel_costs\n"
        "import multigrad_tpu_torch.tune, multigrad_tpu_torch.tune.__main__\n"
        "import multigrad_tpu_torch.analysis\n"
        "import multigrad_tpu_torch.analysis.lint\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_no_forbidden_import_in_sources():
    files = list(_python_files())
    names = {os.path.relpath(f, PACKAGE) for f in files}
    assert {os.path.join("ops", "fused_kernels.py"),
            os.path.join("ops", "cuda_build.py"),
            os.path.join("models", "galhalo.py"),
            os.path.join("models", "galhalo_hist.py"),
            os.path.join("models", "wprp.py"),
            os.path.join("ops", "pair_kernels.py"),
            os.path.join("ops", "pairwise.py"),
            os.path.join("core", "group.py"),
            os.path.join("models", "joint.py"),
            "ingraph.py",
            os.path.join("utils", "checkpoint.py"),
            os.path.join("utils", "debug.py"),
            os.path.join("data", "__init__.py"),
            os.path.join("data", "source.py"),
            os.path.join("data", "prefetch.py"),
            os.path.join("data", "streaming.py"),
            os.path.join("utils", "profiling.py"),
            os.path.join("inference", "fisher.py"),
            os.path.join("inference", "ensemble.py"),
            os.path.join("inference", "hmc.py"),
            os.path.join("optim", "_lbfgs.py"),
            os.path.join("parallel", "distributed.py"),
            os.path.join("utils", "diffdesi.py"),
            *(os.path.join("telemetry", f"{m}.py") for m in (
                "__init__", "metrics", "spans", "taps", "comm", "flight",
                "live", "alerts", "report", "profile", "tracing", "rollup",
                "budget", "resources", "aggregate", "trace", "dashboard",
                "regress", "top")),
            *(os.path.join("serve", f"{m}.py") for m in (
                "__init__", "queue", "robustness", "qos", "slo",
                "compile_cache", "scheduler", "wire", "worker", "fleet",
                "chaos", "stages", "jobs")),
            "_lockdep.py", os.path.join("utils", "lockdep.py"),
            os.path.join("utils", "testing.py"),
            os.path.join("telemetry", "costmodel.py"),
            os.path.join("ops", "kernel_costs.py"),
            *(os.path.join("tune", f"{m}.py") for m in (
                "__init__", "__main__", "table", "space", "resolve",
                "tuner")),
            *(os.path.join("analysis", f"{m}.py") for m in (
                "__init__", "findings", "lockgraph", "concurrency",
                "settlement", "wireschema", "programs", "checks",
                "analyzer", "lint"))} <= names
    assert len(files) > 10
    for path in files:
        bad = set(_imported_roots(path)) & set(FORBIDDEN)
        assert not bad, f"{os.path.relpath(path, REPO_ROOT)} imports {bad}"


@pytest.mark.parametrize("entry", ["make_smf_data", "resolve_device",
                                   "bounds_to_arrays", "make_galhalo_data",
                                   "make_galhalo_hist_data", "make_wprp_data",
                                   "make_xi_data", "make_galaxy_mock",
                                   "make_joint_smf_wprp", "distribute_data",
                                   "simple_grad_descent", "ChunkPrefetcher",
                                   "StreamingOnePointModel", "run_hmc",
                                   "run_multistart_adam",
                                   "hmc_init_from_ensemble",
                                   "run_lbfgs_scan", "run_multistart_lbfgs",
                                   "run_adam", "run_adam_scan",
                                   "initialize", "profiled_fit",
                                   "measure_model_comm", "build_model",
                                   "tune_cli", "lint_cli"])
def test_default_device_is_cuda(entry):
    # device=None means the card: on a machine without one, the entry
    # points raise instead of computing on the CPU.
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from multigrad_tpu_torch import (ChunkPrefetcher, EnsembleResult,
                                     StreamingOnePointModel, distributed,
                                     hmc_init_from_ensemble, ingraph,
                                     run_adam, run_adam_scan, run_hmc,
                                     run_lbfgs_scan, run_multistart_adam,
                                     run_multistart_lbfgs, telemetry)
    from multigrad_tpu_torch.models import (SMFModel, make_galaxy_mock,
                                            make_galhalo_data,
                                            make_galhalo_hist_data,
                                            make_joint_smf_wprp,
                                            make_smf_data, make_wprp_data,
                                            make_xi_data)
    from multigrad_tpu_torch.optim.transforms import bounds_to_arrays
    from multigrad_tpu_torch.serve.worker import build_model
    from multigrad_tpu_torch.tune.__main__ import main as tune_main
    from multigrad_tpu_torch.analysis.lint import main as lint_main
    from multigrad_tpu_torch.utils.util import resolve_device
    call = {"make_smf_data": lambda: make_smf_data(100),
            "resolve_device": resolve_device,
            "bounds_to_arrays": lambda: bounds_to_arrays(None, 2),
            "make_galhalo_data": lambda: make_galhalo_data(100),
            "make_galhalo_hist_data": lambda: make_galhalo_hist_data(100),
            "make_wprp_data": lambda: make_wprp_data(100),
            "make_xi_data": lambda: make_xi_data(100),
            "make_galaxy_mock": lambda: make_galaxy_mock(100),
            "make_joint_smf_wprp": lambda: make_joint_smf_wprp(100),
            "distribute_data": lambda: ingraph.distribute_data(
                np.arange(4.0)),
            "simple_grad_descent": lambda: ingraph.simple_grad_descent(
                None, lambda dd, p: (p.sum(), p), guess=[0.0], nsteps=1),
            "ChunkPrefetcher": lambda: ChunkPrefetcher(
                lambda k: np.zeros(4), 2),
            # A model that holds no tensor: its chunks go to the card.
            "StreamingOnePointModel": lambda: StreamingOnePointModel(
                model=SMFModel(aux_data={"volume": 1.0}),
                streams={"log_halo_masses": np.zeros(4)}, chunk_rows=2),
            # Models and results that hold no tensor: the run goes to the
            # card.
            "run_hmc": lambda: run_hmc(SMFModel(aux_data={"volume": 1.0}),
                                       [-2.0, 0.2], num_samples=1,
                                       num_warmup=0),
            "run_multistart_adam": lambda: run_multistart_adam(
                SMFModel(aux_data={"volume": 1.0}),
                param_bounds=[(-4.0, 0.0), (0.02, 1.0)], n_starts=2,
                nsteps=1),
            "hmc_init_from_ensemble": lambda: hmc_init_from_ensemble(
                EnsembleResult(best_params=np.zeros(2), best_loss=0.0,
                               params=np.zeros((1, 2)), losses=np.zeros(1),
                               inits=np.zeros((1, 2)))),
            "run_lbfgs_scan": lambda: run_lbfgs_scan(
                lambda p: (p.sum(), p), [0.5], maxsteps=1),
            "run_multistart_lbfgs": lambda: run_multistart_lbfgs(
                SMFModel(aux_data={"volume": 1.0}),
                param_bounds=[(-4.0, 0.0), (0.02, 1.0)], n_starts=2,
                maxsteps=1),
            "run_adam": lambda: run_adam(lambda p, d: (p.sum(), p), [0.5],
                                         None, nsteps=1),
            "run_adam_scan": lambda: run_adam_scan(
                lambda p, k: (p.sum(), p), [0.5], nsteps=1),
            # A launcher's group on the card, with no card.
            "initialize": lambda: distributed.initialize("127.0.0.1:1", 1,
                                                         0),
            "profiled_fit": lambda: telemetry.profiled_fit().__enter__(),
            # A model that holds no tensor: the evaluation goes to the card.
            "measure_model_comm": lambda: telemetry.measure_model_comm(
                SMFModel(aux_data={"volume": 1.0}), [-2.0, 0.2]),
            # The worker's model: on the card unless --device says not.
            "build_model": lambda: build_model("smf", {"num_halos": 100}),
            # The tuner's CLI: its model and trials on the card.
            "tune_cli": lambda: tune_main(["--num-halos", "100"]),
            # The lint CLI: its models on the card.
            "lint_cli": lambda: lint_main(["--targets", "smf",
                                           "--num-halos", "100"]),
            }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


#: Started before anything else in a process: any import of a forbidden
#: package raises (an optional import inside a ``try`` is refused too).
BLOCKER = """import sys
FORBIDDEN = {forbidden!r}


class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError("the port must not import " + name)
        return None


sys.meta_path.insert(0, _Refuse())
"""


def test_worker_module_run_loads_no_jax(tmp_path):
    # python -m multigrad_tpu_torch.serve.worker, with every import of
    # jax, optax or multigrad_tpu refused from the first line on: it
    # comes up, serves one fit on the CPU and drains with exit 0.
    import json
    import select
    import socket

    from multigrad_tpu_torch.serve import FitConfig
    from multigrad_tpu_torch.serve.wire import JsonlChannel, config_to_wire

    (tmp_path / "sitecustomize.py").write_text(
        BLOCKER.format(forbidden=FORBIDDEN))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), REPO_ROOT]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "multigrad_tpu_torch.serve.worker",
         "--device", "cpu", "--model-kwargs", '{"num_halos": 300}',
         "--buckets", "1", "--batch-window-s", "0"],
        cwd=REPO_ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 120)
        line = proc.stdout.readline() if ready else ""
        assert line.startswith("FLEET-WORKER-READY "), \
            (line, proc.poll())
        port = json.loads(line.split(" ", 1)[1])["port"]
        chan = JsonlChannel(socket.create_connection(("127.0.0.1", port),
                                                     timeout=120))
        chan.send({"op": "submit", "rid": "r0", "guess": [-1.5, 0.4],
                   "config": config_to_wire(FitConfig(nsteps=3))})
        chan.send({"op": "drain"})
        ops = []
        while not ops or ops[-1] != "drained":
            msg = chan.recv()
            assert msg is not None, ops
            if msg["op"] != "heartbeat":
                ops.append(msg["op"])
        assert sorted(ops[:-1]) == ["draining", "result"]
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=120)
        err = proc.stderr.read()
        proc.stdout.close()
        proc.stderr.close()
    assert "must not import" not in err, err


def test_fleet_router_defaults_to_the_card(tmp_path):
    # device="cuda" unless the caller asks for the CPU: without a card
    # the worker's model build raises, and so does the router's start.
    import inspect
    from multigrad_tpu_torch.serve import FleetRouter
    assert inspect.signature(FleetRouter).parameters["device"].default \
        == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetRouter(n_workers=1, base_dir=str(tmp_path),
                    model_kwargs={"num_halos": 100}, spawn_timeout_s=120,
                    env=dict(os.environ, OMP_NUM_THREADS="1"))


def test_fleet_worker_loads_no_jax(tmp_path):
    # A worker the router spawns, with every import of jax, optax or
    # multigrad_tpu refused from its first line on, serves a fit.
    from multigrad_tpu_torch.serve import FleetRouter
    (tmp_path / "sitecustomize.py").write_text(
        BLOCKER.format(forbidden=FORBIDDEN))
    env = dict(os.environ, PYTHONPATH=str(tmp_path), OMP_NUM_THREADS="1")
    with FleetRouter(n_workers=1, device="cpu", base_dir=str(tmp_path / "f"),
                     model_kwargs={"num_halos": 300}, buckets=(1,),
                     batch_window_s=0.0, env=env) as router:
        result = router.submit([-1.5, 0.4], nsteps=3).result(timeout=120)
        log_path = router.workers[0].log_path
    assert np.isfinite(result.loss) and result.worker == "w0"
    with open(log_path) as f:
        log = f.read()
    assert "must not import" not in log, log
