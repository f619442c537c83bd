"""The CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips where
there is none.  The file imports no JAX (the GPU machine has none), so
it runs there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are those of ``chip_smoke.py``: forward max|err| within
2e-5·max|count|, gradients rtol 1e-3 with atol 1e-5·max|grad| (float32
sums over particles in another order); the fused masses, computed by the
same float32 operations in the same order, equal the plain version's to
1e-6; fused counts against dense rtol 1e-5, atol 1e-4.
"""
import numpy as np
import pytest
import torch

from multigrad_tpu_torch.models import (GalhaloHistModel, ParamTuple,
                                        SMFModel, make_galhalo_hist_data,
                                        make_smf_data)
from multigrad_tpu_torch.models.galhalo_hist import TRUTH as HIST_TRUTH
from multigrad_tpu_torch.ops import binned as tb
from multigrad_tpu_torch.ops import erf_kernels as ek
from multigrad_tpu_torch.ops import fused_kernels as fk
from multigrad_tpu_torch.ops.binned import binned_erf_counts
from tools.hist_card_vs_cpu import evaluate, evaluate_fed

pytestmark = pytest.mark.cuda
COT = np.arange(10.0, dtype=np.float32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(dev, n=100_003, n_inf=1_000, seed=0):
    rng = np.random.default_rng(seed)
    vals = rng.normal(9.5, 0.4, size=n).astype(np.float32)
    vals[-n_inf:] = np.inf
    edges = np.linspace(9, 10, 11).astype(np.float32)
    return (torch.tensor(vals, device=dev), torch.tensor(edges, device=dev),
            torch.tensor(0.2, device=dev), torch.tensor(COT, device=dev))


def _assert_close(got, want, rtol=1e-3):
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=rtol, atol=1e-5 * scale)


def test_kernels_match_plain(dev):
    v, e, s, g = _inputs(dev)
    fwd = ek.erf_counts_fwd_cuda(v, e, s.reshape(1))
    want = ek.erf_counts_fwd_plain(v, e, s)
    assert float((fwd - want).abs().max()) <= 2e-5 * float(want.abs().max())
    for got, ref in zip(ek.erf_counts_bwd_cuda(v, e, s.reshape(1), g),
                        ek.erf_counts_bwd_plain(v, e, s, g)):
        assert torch.isfinite(got).all()
        _assert_close(got, ref)


def test_forward_is_deterministic(dev):
    v, e, s, _ = _inputs(dev, n=1_000_003)
    a = ek.erf_counts_fwd_cuda(v, e, s.reshape(1))
    b = ek.erf_counts_fwd_cuda(v, e, s.reshape(1))
    assert torch.equal(a, b)


def test_autograd_launches_each_kernel_once(dev):
    v, e, s, g = _inputs(dev)
    v.requires_grad_()
    s.requires_grad_()
    before = (ek.erf_counts_fwd_cuda.launches,
              ek.erf_counts_bwd_cuda.launches)
    (binned_erf_counts(v, e, s) * g).sum().backward()
    torch.cuda.synchronize()
    assert (ek.erf_counts_fwd_cuda.launches,
            ek.erf_counts_bwd_cuda.launches) == (before[0] + 1,
                                                 before[1] + 1)
    assert torch.isfinite(v.grad).all() and torch.isfinite(s.grad)
    assert float(v.grad[-1]) == 0.0  # +inf padding is neutral


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    v, e, s, _ = _inputs(dev)
    with pytest.raises(ValueError, match="float32"):
        ek.erf_counts_fwd_cuda(v.double(), e, s.reshape(1))
    with pytest.raises(ValueError, match="contiguous"):
        ek.erf_counts_fwd_cuda(v[::2], e, s.reshape(1))
    with pytest.raises(ValueError, match="float32"):
        ek.erf_counts_fwd_cuda(v, e.cpu(), s.reshape(1))


def test_smf_on_card_matches_cpu(dev):
    params = ParamTuple(-1.0, 0.5)
    gpu = SMFModel(aux_data=make_smf_data(1_000_000, device=dev))
    cpu = SMFModel(aux_data=make_smf_data(1_000_000, device="cpu"))
    loss_g, grad_g = gpu.calc_loss_and_grad_from_params(params)
    loss_c, grad_c = cpu.calc_loss_and_grad_from_params(params)
    np.testing.assert_allclose(float(loss_g), float(loss_c), rtol=1e-4)
    _assert_close(grad_g, grad_c)


def _vec_inputs(dev, n=100_003, n_inf=1_000, n_edges=14, seed=1):
    rng = np.random.default_rng(seed)
    vals = rng.normal(9.4, 0.9, size=n).astype(np.float32)
    vals[-n_inf:] = np.inf
    sig = rng.uniform(0.1, 0.32, size=n).astype(np.float32)
    edges = np.linspace(7.0, 11.75, n_edges).astype(np.float32)
    cot = rng.normal(size=n_edges - 1).astype(np.float32)
    return tuple(torch.tensor(x, device=dev) for x in (vals, edges, sig, cot))


def test_vec_sigma_kernels_match_plain(dev):
    v, e, s, g = _vec_inputs(dev)
    fwd = ek.erf_counts_fwd_vec_cuda(v, e, s)
    want = ek.erf_counts_fwd_plain(v, e, s)
    assert float((fwd - want).abs().max()) <= 2e-5 * float(want.abs().max())
    assert torch.equal(fwd, ek.erf_counts_fwd_vec_cuda(v, e, s))
    got = ek.erf_counts_bwd_vec_cuda(v, e, s, g)
    for a, b in zip(got, ek.erf_counts_bwd_plain(v, e, s, g)):
        assert a.shape == b.shape and torch.isfinite(a).all()
        _assert_close(a, b)
    assert float(got[0][-1]) == 0.0 and float(got[2][-1]) == 0.0


@pytest.mark.parametrize("vec", [False, True])
def test_fused_kernels_match_plain(dev, vec):
    v, e, s, _ = _vec_inputs(dev, n_edges=41)
    s = s if vec else s[0].clone()
    window = tb.fused_bin_window(e, 0.32)
    start = tb.window_starts(torch.clamp(v, -1e18, 1e18), e, s, window)
    masses = fk.fused_masses_fwd_cuda(v, e, s, start, window)
    want = fk.fused_masses_fwd_plain(v, e, s, start, window)
    assert masses.shape == (window - 1, v.shape[0])
    assert float((masses - want).abs().max()) <= 1e-6
    g = torch.randn(window - 1, v.shape[0], device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    got = fk.fused_masses_bwd_cuda(v, e, s, start, window, g, True)
    for a, b in zip(got, fk.fused_masses_bwd_plain(v, e, s, start, window,
                                                   g, True)):
        assert a.shape == b.shape and torch.isfinite(a).all()
        _assert_close(a, b)


@pytest.mark.parametrize("vec", [False, True])
def test_fused_counts_match_dense(dev, vec):
    v, e, s, g = _vec_inputs(dev, n_edges=41)
    s = (s if vec else s[0].clone()).requires_grad_()
    v.requires_grad_()
    before = (fk.fused_masses_fwd_cuda.launches,
              fk.fused_masses_bwd_cuda.launches)
    fused = binned_erf_counts(v, e, s, bin_mode="fused",
                              bin_window=tb.fused_bin_window(e, 0.32))
    dense = binned_erf_counts(v, e, s)
    np.testing.assert_allclose(fused.detach().cpu().numpy(),
                               dense.detach().cpu().numpy(), rtol=1e-5,
                               atol=1e-4)
    gf = torch.autograd.grad((fused * g).sum(), (v, s))
    gd = torch.autograd.grad((dense * g).sum(), (v, s))
    for a, b in zip(gf, gd):
        _assert_close(a, b)
    assert (fk.fused_masses_fwd_cuda.launches,
            fk.fused_masses_bwd_cuda.launches) == (before[0] + 1,
                                                   before[1] + 1)


@pytest.mark.parametrize("mode", ["dense", "fused"])
def test_history_model_on_card_matches_cpu(dev, mode):
    kwargs = {} if mode == "dense" else dict(
        bin_edges=np.linspace(7.0, 11.75, 41),
        obs_indices=(5, 7, 9, 11, 13, 15), bin_mode="fused",
        sigma_max=0.32)
    # chip_smoke.py's phase 9, with its references and limits: the CPU
    # model fed the card's mean log M* at the tolerances of
    # tests/test_galhalo_hist.py:110-118; the whole CPU model at those too
    # (dense), or at loss rtol 2e-3 and gradient rtol 8e-3 (41 edges, six
    # epochs: the history's own card-versus-CPU rounding, twice the worst
    # gap of the dense path there, tools/hist_card_vs_cpu.py).
    gpu = GalhaloHistModel(aux_data=make_galhalo_hist_data(
        1_000_000, chunk_size=250_000, device=dev, **kwargs))
    cpu = GalhaloHistModel(aux_data={
        k: (x.cpu() if isinstance(x, torch.Tensor) else x)
        for k, x in gpu.aux_data.items()})
    params = np.array(HIST_TRUTH, np.float32) + 0.05
    card = evaluate(gpu, params)
    for ref, (y_rtol, loss_rtol, grad_rtol) in (
            (evaluate_fed(cpu, gpu.aux_data, params), (1e-4, 1e-3, 1e-3)),
            (evaluate(cpu, params), (1e-4, 1e-3, 1e-3) if mode == "dense"
             else (1e-4, 2e-3, 8e-3))):
        np.testing.assert_allclose(card[0], ref[0], rtol=y_rtol, atol=1e-10)
        np.testing.assert_allclose(card[1], ref[1], rtol=loss_rtol)
        np.testing.assert_allclose(card[2], ref[2], rtol=grad_rtol,
                                   atol=1e-7)
    assert float(gpu.calc_loss_from_params(list(HIST_TRUTH))) < 1e-10
