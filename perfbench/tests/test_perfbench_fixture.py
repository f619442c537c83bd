"""A cell, a traffic mix, a per-layer metric, and a whole new model added
as files alone.

The fixture copies ``perfbench/`` and ``BENCHMARK.json`` into a fresh
root and adds, without editing any file there:

- a configuration of the SMF model, a traffic mix, its limits, a reader
  of a new per-layer metric, and their entries in ``BENCHMARK.json``;
- a new model, ``smf_twin``: its ``programs/``, ``reference/`` and
  ``costs/`` files (the SMF ones, re-exported), its rehearsal file, a
  configuration, a traffic mix, limits, a per-layer metric that reads the
  traced window's span table, and their entries.

The harness runs the new cells by name and reports the new metrics; the
new model rehearses plainly, under its ``half`` fault and traced; every
file the copy had is byte-identical after."""
import hashlib
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
TWIN = "smf_twin"
TWIN_CELL = "smf_twin.short"
TWIN_METRIC = "twin.steps_in_window"

#: The new model's files: the SMF model's, re-exported.
TWIN_FILES = {
    "programs": "from perfbench.programs.smf import build, catalog  "
                "# noqa: F401\n",
    "reference": "from perfbench.reference.smf import Reference  "
                 "# noqa: F401\n",
    "costs": "from perfbench.costs.smf import Costs  # noqa: F401\n",
    "rehearsal": "from perfbench.rehearsal.smf import SIZES, half  "
                 "# noqa: F401\n",
}
#: A reader of the traced window's span table: the steps of run_adam's
#: loop inside the window (on the CPU too).
TWIN_READER = '''from perfbench.core.spans import select


def read(ctx):
    rows = select(ctx.trace["spans"], "mgt.adam.step")
    return float(sum(r["count"] for r in rows)) if rows else None
'''


def digests(top):
    """The SHA-256 of every file under ``top``, bytecode caches left out."""
    out = {}
    for dirpath, dirs, files in os.walk(top):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, top)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def add_cell(pb, spec, config_name, model, cell, traffic, why):
    """A configuration of ``model`` (the SMF one's sizes, 50,000 halos), a
    traffic mix of 20-step fits, the cell's limits, and their entries."""
    config = json.loads((pb / "configs" / "smf_1e8.json").read_text())
    config.update(name=config_name, model=model, num_halos=50_000,
                  reduced=["num_halos"])
    (pb / "configs" / f"{config_name}.json").write_text(json.dumps(config))
    (pb / "traffic" / f"{traffic}.json").write_text(json.dumps({
        "driver": "adam", "nsteps": 20, "learning_rate": 0.02,
        "guess": {"base": [-1.5, 0.4], "low": -0.05, "high": 0.05},
        "warmup_steps": 1, "check_fits": 1}))
    (pb / "limits" / f"{cell}.json").write_text(json.dumps(
        {"step_gap": 1e-3, "loss_gap": 1e-4}))
    spec["configs"].append({
        "name": config_name, "source": "https://github.com/AlanPearl/multigrad",
        "file": f"perfbench/configs/{config_name}.json",
        "reduced": ["num_halos"], "why": why})
    spec["workloads"].append({
        "name": cell, "config": config_name, "traffic": traffic, "chips": 1,
        "why": why})
    next(m for m in spec["end_to_end"]
         if m["name"] == "steps_per_s")["workloads"].append(cell)


def add_metric(pb, spec, name, unit, source, cell, reader):
    """A per-layer metric of ``cell`` read by ``reader``, and its entry."""
    (pb / "metrics" / f"{name}.py").write_text(reader)
    spec["per_layer"].append({
        "name": name, "unit": unit, "better": "higher", "source": source,
        "layer": "optimizer (optim/adam.py run_adam)",
        "moves": "steps_per_s", "workloads": [cell]})


@pytest.fixture
def root(tmp_path):
    shutil.copytree(os.path.join(REPO, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(REPO, "multigrad_tpu_torch"),
               tmp_path / "multigrad_tpu_torch")
    pb = tmp_path / "perfbench"
    before = digests(pb)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    add_cell(pb, spec, "smf_fixture", "smf", CELL, "adam.fixture",
             "a test fixture")
    add_metric(pb, spec, METRIC, "fits", "program_counter", CELL,
               "def read(ctx):\n    return float(len(ctx.record.fits))\n")
    # The new model: its own files, and a cell and a span metric of it.
    for kind, text in TWIN_FILES.items():
        (pb / kind / f"{TWIN}.py").write_text(text)
    add_cell(pb, spec, TWIN, TWIN, TWIN_CELL, "adam.twin",
             "a test fixture: a new model's cell")
    add_metric(pb, spec, TWIN_METRIC, "steps", "program_span", TWIN_CELL,
               TWIN_READER)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    yield str(tmp_path)
    after = digests(pb)
    assert {p: after.get(p) for p in before} == before


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


def test_new_model_rehearses_as_files_alone(root):
    """The new model's cell is correct plainly, not correct under its
    model's ``half`` fault, and traced reports the span metric: the steps
    of the traced fit, as the driver's cut sets them."""
    result, modules = rehearse(TWIN_CELL, 2_200_000_041, root=root)
    assert set(result["metrics"]) == {"steps_per_s", "setup_s"}
    assert result["correct"], result["checks"]
    assert modules["forbidden_modules"] == []
    result, _ = rehearse(TWIN_CELL, 2_200_000_043, fault="half", root=root)
    assert result["correct"] is False, result["checks"]
    result, _ = rehearse(TWIN_CELL, 2_200_000_047, trace=1, root=root)
    assert result["correct"], result["checks"]
    nsteps = Benchmark(root).module("rehearsal", "adam").CUT["nsteps"]
    assert result["metrics"][TWIN_METRIC] == {"value": float(nsteps),
                                              "unit": "steps"}
