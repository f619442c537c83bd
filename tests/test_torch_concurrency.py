"""The port's concurrency pass (``multigrad_tpu_torch.analysis
.concurrency`` and ``.lockgraph``, copies of the JAX package's) on the
CPU.

* The JAX suite's seeded fixtures under ``tests/fixtures/concurrency/``,
  read in place, give the same findings through the port's copy as
  through the JAX package's module.
* The port's own tree is clean, as the JAX package's is: the
  ``MetricsLogger`` sink writes carry their ``lock-ok`` justifications
  and the kernel build's lock its own (``ops/cuda_build.py``).
* The port's locks are the lockdep factories' wherever the JAX
  package's are (the logger, the live registry and sinks, the flight
  recorder, the heartbeat, the prefetcher, the stream counters), so the
  runtime shadow sees them.
* A ``MGT_LOCKDEP=1`` run of a port ``FitScheduler`` (a process of its
  own, dumping its edges at exit) records no lock-order edge that the
  static graph lacks.
"""
import os
import re
import subprocess
import sys
import textwrap

import pytest

from multigrad_tpu_torch import _lockdep
from multigrad_tpu_torch.analysis.concurrency import (THREAD_CHECK_IDS,
                                                      analyze_concurrency,
                                                      crosscheck_runtime,
                                                      lock_order_dot)
from multigrad_tpu_torch.analysis.lint import main
from multigrad_tpu_torch.analysis.lockgraph import scan_package

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO_ROOT, "tests", "fixtures", "concurrency")


@pytest.fixture(scope="module")
def port_model():
    return scan_package()


def _same_words(finding):
    """A finding as a dict, its message in the port's words: the port's
    copy names the bug classes without the JAX package's review-round
    tags, and its thread-naming message names the dumps of a stuck run
    in its own word."""
    out = finding.to_dict()
    out["message"] = re.sub(r"stuck-\w+ dumps", "stuck-run dumps", re.sub(
        r"\(the PR-\d+ ", "(the ", out["message"]))
    return out


def test_fixtures_give_the_jax_package_s_findings():
    from multigrad_tpu.analysis.concurrency import \
        analyze_concurrency as jax_analyze
    got = [_same_words(f) for f in analyze_concurrency(root=FIXTURES)]
    want = [_same_words(f) for f in jax_analyze(root=FIXTURES)]
    assert got == want
    assert {f["check"] for f in got} >= {"cond-wait-no-while",
                                         "callback-under-lock"}


def test_registry_is_the_jax_package_s():
    from multigrad_tpu.analysis.concurrency import \
        THREAD_CHECK_IDS as JAX_IDS
    assert THREAD_CHECK_IDS == JAX_IDS


def test_port_tree_is_clean(port_model):
    findings = analyze_concurrency(model=port_model)
    assert findings == [], "\n".join(str(f) for f in findings)


def test_port_lock_inventory(port_model):
    locks = port_model.locks
    assert locks["telemetry.metrics.MetricsLogger._lock"].kind == "rlock"
    assert "telemetry.metrics.MetricsLogger._lock" in \
        port_model.wildcard_sources()
    assert "serve.queue.FitQueue._lock" in locks
    assert "ops.cuda_build._LOCK" in locks
    dot = lock_order_dot(model=port_model)
    assert dot.startswith("digraph")


def test_lint_threads_target_clean(capsys):
    assert main(["--targets", "threads", "--device", "cpu"]) == 0
    assert "[threads] clean" in capsys.readouterr().out


SCHEDULER_RUN = textwrap.dedent("""
    from multigrad_tpu_torch.models import SMFModel, make_smf_data
    from multigrad_tpu_torch.serve import FitConfig, FitScheduler
    from multigrad_tpu_torch.telemetry import (FlightRecorder, MemorySink,
                                               MetricsLogger)
    from multigrad_tpu_torch.telemetry.live import LiveMetrics, LiveSink
    model = SMFModel(aux_data=make_smf_data(600, device="cpu"))
    logger = MetricsLogger(MemorySink())
    logger.add_sink(LiveSink(LiveMetrics()))
    logger.add_sink(FlightRecorder(dump_dir=None, trip_on_stall=False))
    with FitScheduler(model, buckets=(1, 4), batch_window_s=0.0,
                      start=False, telemetry=logger) as sched:
        futs = [sched.submit([-1.0 - 0.1 * i, 0.5], nsteps=5,
                             learning_rate=0.05) for i in range(3)]
        sched.start()
        for f in futs:
            f.result(timeout=60)
        sched.submit([-1.5, 0.4], nsteps=5).result(timeout=60)
""")


def test_lockdep_run_of_a_scheduler_is_covered_by_the_static_graph(
        tmp_path, port_model):
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, OMP_NUM_THREADS="1",
               **{_lockdep.ENV_FLAG: "1",
                  _lockdep.ENV_DUMP: str(tmp_path)})
    out = subprocess.run([sys.executable, "-c", SCHEDULER_RUN],
                         cwd=REPO_ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    edges, violations, loaded = _lockdep.load_edge_dumps(str(tmp_path))
    assert len(loaded) == 1
    # The logger's fan-out into the live sink and the registry under it.
    assert {("telemetry.metrics.MetricsLogger._lock",
             "telemetry.live.LiveSink._lock"),
            ("telemetry.live.LiveSink._lock",
             "telemetry.live.LiveMetrics._lock")} <= set(edges)
    assert violations == []
    assert crosscheck_runtime(str(tmp_path), model=port_model) == []
