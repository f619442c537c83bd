"""Runs of the benchmark's command on the card (``cuda`` marker): the
command line, the kernel libraries built into the checkout, the result
line and ``correct``.  Whether there is a card is decided in a fixture."""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's command runs on the card")


def run(cell, seed, trace):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", "3", "--trace", str(trace)],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_smf_cell_on_the_card(card, trace):
    result = run("smf_1e9.adam", 2_300_000_001 + trace, trace)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        for name in ("erf_fwd_roofline", "erf_bwd_roofline", "step_mfu.fit"):
            assert 0 < result["metrics"][name]["value"] <= 100


def test_no_card_means_no_result():
    """With no card visible the command exits non-zero and prints nothing
    (on a machine with or without one)."""
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "smf_1e9.adam",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_without_the_program_no_result(card, tmp_path):
    """In a directory that holds only ``BENCHMARK.json`` and the files
    under its paths, the command exits non-zero and prints nothing."""
    import shutil
    shutil.copytree(os.path.join(REPO, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "smf_1e9.adam",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
