"""Each cell rehearsed end to end on the CPU, at small sizes on the port's
plain paths: one well-formed result line, and no module of JAX or of the
JAX package loaded.  The plain reference loads nothing of the port."""
import json
import os
import subprocess
import sys

import pytest

from perfbench.core.registry import Benchmark

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REHEARSE = os.path.join(REPO, "perfbench", "tests", "rehearse.py")
CELLS = [w["name"] for w in Benchmark(REPO).spec["workloads"]]


def rehearse(cell, seed, trace=0, fault=None, root=REPO):
    args = [sys.executable, REHEARSE, root, cell, str(seed), str(trace)]
    out = subprocess.run(args + ([fault] if fault else []), cwd=REPO,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1])


def well_formed(result, names, trace):
    assert list(result)[-1] == "checks"
    assert isinstance(result["correct"], bool)
    assert result["attempted"] >= 1 and result["failed"] == 0
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    for name, m in result["metrics"].items():
        assert name in names and isinstance(m["value"], float)
        assert m["unit"] == names[name]
    if trace:
        assert dev["window_s"] > 0 and "breakdown" in result
        assert len(result["breakdown"]["idle_gaps"]) <= 10
    else:
        assert set(result["metrics"]) == set(names)
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_rehearses_end_to_end(cell):
    bench = Benchmark(REPO)
    result, modules = rehearse(cell, 2_200_000_017)
    well_formed(result, {m["name"]: m["unit"]
                         for m in bench.end_to_end(cell)}, trace=False)
    assert result["correct"], result["checks"]
    assert result["checks"]["start_gap"]["value"] == 0
    assert modules["forbidden_modules"] == []


def test_traced_cell_rehearses():
    bench = Benchmark(REPO)
    cell = "smf_1e8.serve16"
    result, modules = rehearse(cell, 2_200_000_019, trace=1)
    well_formed(result, {m["name"]: m["unit"]
                         for m in bench.per_layer(cell)}, trace=True)
    # The scheduler's counters and spans read on the CPU too; the device
    # metrics find nothing to read there and are left out.
    assert result["metrics"]["serve.rows_per_dispatch"]["value"] == 4.0
    assert "device.idle_share.serve" not in result["metrics"]
    assert result["correct"] and modules["forbidden_modules"] == []


def test_reference_loads_nothing_of_the_program():
    code = """
import sys, torch
sys.path.insert(0, %r)
from perfbench.core import compare
from perfbench.reference import adam, hist, smf
cfg = {"num_halos": 1000, "bin_edges": {"low": 9.0, "high": 10.0, "count": 11},
       "volume_per_halo": 10.0, "truth": [-2.0, 0.2]}
x = {"log_halo_masses": torch.linspace(10, 11.3, 1000)}
ref = smf.Reference(cfg, x, torch.float64)
traj, losses, grads = adam.adam_steps(
    ref.loss_and_grad, torch.tensor([-1.0, 0.5], dtype=torch.float64), 3, 0.02)
assert len(losses) == 3
names = {m.split(".")[0] for m in sys.modules}
print(sorted(names & {"multigrad_tpu_torch", "multigrad_tpu", "jax",
                      "jaxlib", "flax"}))
""" % REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
