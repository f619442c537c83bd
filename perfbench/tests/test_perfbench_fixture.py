"""A cell, a traffic mix and a per-layer metric added as files alone.

The fixture copies ``perfbench/`` and ``BENCHMARK.json`` into a fresh
root and adds, without editing any file there: a configuration file, a
traffic mix, its limits, a reader of a new per-layer metric, and their
entries in ``BENCHMARK.json``.  The harness runs the new cell by name and
reports the new metric."""
import json
import os
import shutil

import pytest

from perfbench.core.registry import Benchmark
from perfbench.tests.test_perfbench_rehearsal import rehearse

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "smf_fixture.short"
METRIC = "fixture.fits_in_window"


@pytest.fixture
def root(tmp_path):
    shutil.copytree(os.path.join(REPO, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(REPO, "multigrad_tpu_torch"),
               tmp_path / "multigrad_tpu_torch")
    pb = tmp_path / "perfbench"
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    config = json.loads((pb / "configs" / "smf_1e8.json").read_text())
    config.update(name="smf_fixture", num_halos=50_000,
                  reduced=["num_halos"])
    (pb / "configs" / "smf_fixture.json").write_text(json.dumps(config))
    (pb / "traffic" / "adam.fixture.json").write_text(json.dumps({
        "driver": "adam", "nsteps": 20, "learning_rate": 0.02,
        "guess": {"base": [-1.5, 0.4], "low": -0.05, "high": 0.05},
        "warmup_steps": 1, "check_fits": 1}))
    (pb / "limits" / f"{CELL}.json").write_text(json.dumps(
        {"step_gap": 1e-3, "loss_gap": 1e-4}))
    (pb / "metrics" / f"{METRIC}.py").write_text(
        "def read(ctx):\n    return float(len(ctx.record.fits))\n")
    spec["configs"].append({
        "name": "smf_fixture", "source": "https://github.com/AlanPearl/multigrad",
        "file": "perfbench/configs/smf_fixture.json",
        "reduced": ["num_halos"], "why": "a test fixture"})
    spec["workloads"].append({
        "name": CELL, "config": "smf_fixture", "traffic": "adam.fixture",
        "chips": 1, "why": "a test fixture"})
    for m in spec["end_to_end"]:
        if m["name"] == "steps_per_s":
            m["workloads"].append(CELL)
    spec["per_layer"].append({
        "name": METRIC, "unit": "fits", "better": "higher",
        "source": "program_counter", "layer": "optimizer (optim/adam.py run_adam)",
        "moves": "steps_per_s", "workloads": [CELL]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return str(tmp_path)


def test_new_cell_reports_its_end_to_end_metrics(root):
    result, modules = rehearse(CELL, 2_200_000_029, root=root)
    assert set(result["metrics"]) == {"steps_per_s", "setup_s"}
    assert result["correct"], result["checks"]
    assert modules["forbidden_modules"] == []


def test_new_metric_is_read_in_its_cell_only(root):
    result, _ = rehearse(CELL, 2_200_000_031, trace=1, root=root)
    assert result["metrics"][METRIC]["value"] >= 2
    assert result["metrics"][METRIC]["unit"] == "fits"
    assert [m["name"] for m in Benchmark(root).per_layer("smf_1e9.adam")] \
        == [m["name"] for m in Benchmark(REPO).per_layer("smf_1e9.adam")]
