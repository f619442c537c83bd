"""The CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips where
there is none.  The file imports no JAX (the GPU machine has none), so
it runs there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are those of ``chip_smoke.py``: forward max|err| within
2e-5·max|count|, gradients rtol 1e-3 with atol 1e-5·max|grad| (float32
sums over particles in another order).
"""
import numpy as np
import pytest
import torch

from multigrad_tpu_torch.models import ParamTuple, SMFModel, make_smf_data
from multigrad_tpu_torch.ops import erf_kernels as ek
from multigrad_tpu_torch.ops.binned import binned_erf_counts

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
