"""``tools/hist_card_vs_cpu.py``'s references, on the CPU,
``tools/streamed_smf.py``, ``tools/posterior_smf.py``,
``tools/telemetry_smf.py`` and ``tools/analysis_smf.py`` refusing to run
without a card, and ``tools/analysis_smf.py --cpu``, phase 27's checks
rehearsed on the CPU.

``chip_smoke.py``'s phase 9 and ``tests/test_torch_cuda.py`` hold the
history model on the card against the CPU model fed the card's mean
log M*; here the feeding itself is checked, with a second CPU data set in
the card's place: the fed model's forward is exactly the other data's,
and fed its own it is exactly itself.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from multigrad_tpu_torch.models import GalhaloHistModel, make_galhalo_hist_data
from multigrad_tpu_torch.models import galhalo_hist as th
from tools.hist_card_vs_cpu import evaluate, evaluate_fed, gaps

PARAMS = np.array(th.TRUTH, np.float32) + 0.05


def test_fed_history_takes_the_given_forward():
    aux = make_galhalo_hist_data(4_000, chunk_size=1_000, device="cpu")
    other = dict(aux, time_grid=aux["time_grid"] * 1.001)
    model = GalhaloHistModel(aux_data=aux)
    block = th._mean_log_mstar_block

    fed = evaluate_fed(model, other, PARAMS)
    want = evaluate(GalhaloHistModel(aux_data=other), PARAMS)
    own = evaluate(model, PARAMS)
    np.testing.assert_array_equal(fed[0], want[0])
    assert fed[1] == want[1]
    assert gaps(fed, own)["y_rtol"] > 1e-3      # not the model's own

    same = evaluate_fed(model, aux, PARAMS)
    for a, b in zip(same, own):
        np.testing.assert_array_equal(a, b)
    assert gaps(same, own) == dict(y_rtol=0.0, loss_rel=0.0, grad_rtol=0.0)
    assert th._mean_log_mstar_block is block    # the model is restored


def test_streamed_smf_needs_a_card():
    # Its numbers are the card's: without one it exits non-zero and prints
    # no result.
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "tools/streamed_smf.py"], cwd=root,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=root))
    assert out.returncode != 0 and not out.stdout
    assert "no CUDA device" in out.stderr


def test_posterior_smf_needs_a_card():
    # As tools/streamed_smf.py: no card, no result.
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "tools/posterior_smf.py"],
                         cwd=root, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=root))
    assert out.returncode != 0 and not out.stdout
    assert "no CUDA device" in out.stderr


def test_telemetry_smf_needs_a_card():
    # As tools/streamed_smf.py: no card, no result.
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "tools/telemetry_smf.py"],
                         cwd=root, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=root))
    assert out.returncode != 0 and not out.stdout
    assert "no CUDA device" in out.stderr


def test_analysis_smf_needs_a_card():
    # As tools/streamed_smf.py: no card, no result.
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "tools/analysis_smf.py"],
                         cwd=root, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=root))
    assert out.returncode != 0 and not out.stdout
    assert "no CUDA device" in out.stderr


def test_analysis_smf_rehearses_phase_27_on_the_cpu():
    # Phase 27's checks at 20,000 halos under a gloo group: every analysis
    # clean, the gather mutation caught, no kernel launched, the analyzed
    # model's loss and gradient its reference's, the lint CLI clean.
    import json
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "tools/analysis_smf.py", "--cpu"],
                         cwd=root, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=root,
                                               OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "cpu"
    result = json.loads(lines[-2])
    assert set(result["launches"].values()) == {0}
    assert {"SMF", "history dense", "history fused", "joint",
            "batched (16, 2)", "streamed", "gather mutation",
            "lint"} == set(result["seconds"])
    assert "the gather mutation caught" in out.stdout
