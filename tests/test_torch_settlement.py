"""The port's settlement pass (``multigrad_tpu_torch.analysis
.settlement``, a copy of the JAX package's) on the CPU.

* The JAX suite's seeded fixtures under ``tests/fixtures/settlement/``,
  read in place, give the same findings through the port's copy as
  through the JAX package's module.
* The port's futures — ``serve/queue.py``'s ``FitFuture``,
  ``serve/jobs.py``'s ``JobFuture`` and ``serve/fleet.py``'s
  ``FleetRequest`` — come out clean: each is settled on every path, in
  the right order.
"""
import os

import pytest

from multigrad_tpu_torch.analysis.lint import main
from multigrad_tpu_torch.analysis.settlement import (SETTLE_CHECK_IDS,
                                                     analyze_settlement,
                                                     scan_settlement)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "settlement")


@pytest.fixture(scope="module")
def port_model():
    return scan_settlement()


def test_fixtures_give_the_jax_package_s_findings():
    from multigrad_tpu.analysis.settlement import \
        analyze_settlement as jax_analyze
    got = [f.to_dict() for f in analyze_settlement(root=FIXTURES)]
    want = [f.to_dict() for f in jax_analyze(root=FIXTURES)]
    assert got == want
    assert {f["check"] for f in got} == set(SETTLE_CHECK_IDS)


def test_registry_is_the_jax_package_s():
    from multigrad_tpu.analysis.settlement import \
        SETTLE_CHECK_IDS as JAX_IDS
    assert SETTLE_CHECK_IDS == JAX_IDS


def test_port_futures_are_clean(port_model):
    findings = analyze_settlement(model=port_model)
    assert findings == [], "\n".join(str(f) for f in findings)
    # The pass saw the port's futures: the two future classes' guarded
    # setters, and the settle sites of the queue, the jobs and the fleet.
    assert {(m.module, m.cls) for m in port_model.future_methods} == {
        ("serve.queue", "FitFuture"), ("serve.jobs", "JobFuture")}
    assert all(m.guarded for m in port_model.future_methods)
    assert {"serve.queue", "serve.jobs", "serve.fleet"} <= {
        r.module for r in port_model.resolves}


def test_lint_settlement_target(capsys):
    assert main(["--targets", "settlement", "--device", "cpu"]) == 0
    assert "[settlement] clean" in capsys.readouterr().out
