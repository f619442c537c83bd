"""The port's fused (windowed) erf-CDF counts against the JAX package's.

The plain PyTorch versions of the fused CUDA kernels (what a CPU tensor
runs) are held against ``multigrad_tpu.ops.binned``'s XLA
``bin_mode="fused"`` path and the Pallas kernel
``binned_erf_counts_fused_pallas`` in interpret mode (``block_size=1024``,
N <= 4,000), on the same numpy inputs, with a scalar and a per-particle
sigma.  Tolerances are those of ``tests/test_pallas.py`` and
``tests/test_perf_opt.py``: counts ``rtol=2e-5, atol=1e-5`` against the
same function (float32 sums in another order), fused against dense
``rtol=1e-5, atol=1e-4`` (the window's cut is exact in float32, the sums
run in another order), gradients ``rtol=1e-3, atol=1e-5`` (the analytic
backward against autodiff through the erf polynomial).  The CUDA kernels
themselves are held against the plain versions in
``tests/test_torch_cuda.py``, on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrad_tpu.models.smf import SMFModel as JaxSMFModel
from multigrad_tpu.models.smf import make_smf_data as jax_make_smf_data
from multigrad_tpu.ops import binned as jb
from multigrad_tpu.ops.pallas_kernels import binned_erf_counts_fused_pallas
from multigrad_tpu_torch.models import SMFModel, aux_from_numpy
from multigrad_tpu_torch.ops import binned as tb
from multigrad_tpu_torch.ops.erf_kernels import _erf_f32
from multigrad_tpu_torch.ops.fused_kernels import (erf_counts_fused,
                                                   fused_masses_fwd_plain)

EDGES = np.linspace(7.0, 11.75, 41).astype(np.float32)   # bench.py's
SIGMA_MAX = 0.32                                          # fused config
WINDOW = 33
RNG_SEED = 11


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # The suite's workers share the machine's cores with JAX's own thread
    # pools: keep PyTorch's intra-op pool small while this module runs.
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _t(x):
    return torch.tensor(np.asarray(x))


def _inputs(n, vec, seed=RNG_SEED, n_inf=0):
    rng = np.random.default_rng(seed)
    vals = rng.normal(9.4, 0.9, size=n).astype(np.float32)
    if n_inf:
        vals[-n_inf:] = np.inf
    sig = (rng.uniform(0.05, SIGMA_MAX, size=n).astype(np.float32) if vec
           else np.float32(0.25))
    cot = rng.normal(size=EDGES.shape[0] - 1).astype(np.float32)
    return vals, sig, cot


def _jax_fused(ref):
    if ref == "xla":
        return lambda v, e, s: jb.binned_erf_counts(
            v, e, s, backend="xla", bin_mode="fused", bin_window=WINDOW)
    return lambda v, e, s: binned_erf_counts_fused_pallas(
        v, e, s, WINDOW, block_size=1024, interpret=True)


def _port_fused(v, e, s):
    return tb.binned_erf_counts(v, e, s, bin_mode="fused",
                                bin_window=WINDOW)


@pytest.mark.parametrize("edges, sigma_max", [
    (EDGES, SIGMA_MAX), (EDGES, 0.05), (np.linspace(9, 10, 11), 0.6),
    (np.linspace(9, 10, 11), 0.02), (np.geomspace(1, 30, 25), 0.5)])
def test_fused_bin_window_matches_jax(edges, sigma_max):
    edges = np.asarray(edges, np.float32)
    want = jb.fused_bin_window(edges, sigma_max)
    assert tb.fused_bin_window(edges, sigma_max) == want
    assert tb.fused_bin_window(_t(edges), sigma_max) == want
    assert tb.fused_bin_window(EDGES, SIGMA_MAX) == WINDOW


def test_fused_bin_window_rejects_bad_edges():
    with pytest.raises(ValueError, match=">= 2 edges"):
        tb.fused_bin_window(np.array([1.0]), 0.2)
    with pytest.raises(ValueError, match="strictly increasing"):
        tb.fused_bin_window(np.array([1.0, 1.0, 2.0]), 0.2)


@pytest.mark.parametrize("vec", [False, True])
@pytest.mark.parametrize("window", [2, 12, WINDOW, 41])
def test_window_starts_match_jax(vec, window):
    vals, sig, _ = _inputs(3000, vec, n_inf=7)
    vals[:5] = [6.0, 7.0, 11.75, 12.5, -np.inf]     # edges and beyond
    clip = np.clip(vals, -1e18, 1e18)
    want = jb.window_starts(jnp.asarray(clip), jnp.asarray(EDGES),
                            jnp.asarray(sig), window)
    got = tb.window_starts(_t(clip), _t(EDGES), _t(sig), window)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("vec", [False, True])
def test_scatter_bin_masses_matches_jax(vec):
    vals, sig, _ = _inputs(2000, vec)
    start = jb.window_starts(jnp.asarray(vals), jnp.asarray(EDGES),
                             jnp.asarray(sig), WINDOW)
    masses = np.random.default_rng(3).uniform(
        size=(2000, WINDOW - 1)).astype(np.float32)
    want = jb.scatter_bin_masses(jnp.asarray(masses), start, len(EDGES))
    got = tb.scatter_bin_masses(_t(masses), _t(start), len(EDGES))
    # f32 sums of the same terms in another order.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=1e-5)


@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("vec", [False, True])
def test_fused_counts_match_jax(vec, ref):
    vals, sig, _ = _inputs(4000, vec, n_inf=13)
    want = _jax_fused(ref)(jnp.asarray(vals), jnp.asarray(EDGES),
                           jnp.asarray(sig))
    got = _port_fused(_t(vals), _t(EDGES), _t(sig))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=1e-5)


@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("vec", [False, True])
def test_fused_gradients_match_jax(vec, ref):
    vals, sig, cot = _inputs(4000, vec, n_inf=13)
    fn = _jax_fused(ref)
    want = jax.grad(lambda v, e, s: jnp.sum(fn(v, e, s) * cot),
                    argnums=(0, 1, 2))(jnp.asarray(vals), jnp.asarray(EDGES),
                                       jnp.asarray(sig))
    v, e = _t(vals).requires_grad_(), _t(EDGES).requires_grad_()
    s = _t(sig).requires_grad_()
    (_port_fused(v, e, s) * _t(cot)).sum().backward()
    for ref_g, got in zip(want, (v.grad, e.grad, s.grad)):
        assert tuple(got.shape) == np.shape(ref_g)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_g),
                                   rtol=1e-3, atol=1e-5)
    np.testing.assert_array_equal(v.grad[-13:].numpy(), 0.0)


@pytest.mark.parametrize("vec", [False, True])
@pytest.mark.parametrize("window", [12, WINDOW])
def test_fused_equals_dense(vec, window):
    # With a window from fused_bin_window for the largest sigma (or
    # wider), the cut-off cdf differences are exact float32 zeros.
    vals, sig, cot = _inputs(4000, vec)
    sig = sig * 0.3 if window == 12 else sig     # W=12 covers sigma<=0.1
    assert tb.fused_bin_window(EDGES, float(np.max(sig))) <= window
    v = _t(vals).requires_grad_()
    s = _t(sig).requires_grad_()
    dense = tb.binned_erf_counts(v, _t(EDGES), s)
    fused = tb.binned_erf_counts(v, _t(EDGES), s, bin_mode="fused",
                                 bin_window=window)
    np.testing.assert_allclose(fused.detach().numpy(),
                               dense.detach().numpy(), rtol=1e-5, atol=1e-4)
    gd = torch.autograd.grad((dense * _t(cot)).sum(), (v, s))
    gf = torch.autograd.grad((fused * _t(cot)).sum(), (v, s))
    for a, b in zip(gf, gd):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-5)


@pytest.mark.parametrize("vec", [False, True])
def test_analytic_backward_matches_plain_autograd(vec):
    # The Function's analytic backward (the kernels' algebra) against
    # autograd through the plain fused counts (_bin_sums_fused), the
    # port's twin of the JAX package's XLA fused path.
    vals, sig, cot = _inputs(3000, vec, n_inf=4)
    grads = []
    for fn in (_port_fused, lambda v, e, s: tb._bin_sums_fused(
            v, e, s, WINDOW)):
        v, e = _t(vals).requires_grad_(), _t(EDGES).requires_grad_()
        s = _t(sig).requires_grad_()
        counts = fn(v, e, s)
        grads.append((counts.detach(),) + torch.autograd.grad(
            (counts * _t(cot)).sum(), (v, e, s)))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-5)


def test_masses_are_slot_major_views():
    vals, sig, _ = _inputs(500, True)
    v, e, s = _t(vals), _t(EDGES), _t(sig)
    start = tb.window_starts(v, e, s, WINDOW)
    masses = fused_masses_fwd_plain(v, e, s, start, WINDOW)
    assert tuple(masses.shape) == (WINDOW - 1, 500)
    assert masses.is_contiguous() and tuple(masses.t().shape) == \
        (500, WINDOW - 1)
    # Slot w of particle i is its mass between edges start_i + w and
    # start_i + w + 1: the slots add up to the window's cdf difference.
    first, last = e[start.long()], e[start.long() + WINDOW - 1]

    def cdf(x):
        return 0.5 * (1.0 + _erf_f32((x - v) / (np.sqrt(2.0) * s)))

    np.testing.assert_allclose(masses.sum(dim=0).numpy(),
                               (cdf(last) - cdf(first)).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_fused_error_cases():
    vals, _, _ = _inputs(64, False)
    v = _t(vals)
    with pytest.raises(ValueError, match="needs a static bin_window"):
        tb.binned_erf_counts(v, _t(EDGES), 0.2, bin_mode="fused")
    with pytest.raises(ValueError, match=r"window must be in \[2, 128\]"):
        erf_counts_fused(v, _t(EDGES), 0.2, 1)
    many = np.linspace(0, 20, 300).astype(np.float32)
    with pytest.raises(ValueError, match=r"window must be in \[2, 128\]"):
        erf_counts_fused(v, _t(many), 0.2, 200)
    with pytest.raises(ValueError, match=r"window must be in \[2, 128\]"):
        binned_erf_counts_fused_pallas(jnp.asarray(vals),
                                       jnp.asarray(many), 0.2, 200)
    with pytest.raises(ValueError, match="match values"):
        erf_counts_fused(v, _t(EDGES), torch.full((3,), 0.2), WINDOW)
    with pytest.raises(ValueError, match="bin_window must be >= 2"):
        tb._bin_sums_fused(v, _t(EDGES), 0.2, 1)
    # Unlike the dense kernel, the fused path takes more than 128 edges.
    counts = erf_counts_fused(_t(np.linspace(1, 19, 64).astype(np.float32)),
                              _t(many), 0.2, 12)
    assert counts.shape == (299,) and torch.isfinite(counts).all()


def test_smf_fused_matches_jax():
    # The SMF family on the fused path (scalar form of the fused kernels):
    # make_smf_data's window and the model's sumstats and gradient.
    aux = jax_make_smf_data(5_000, bin_mode="fused", sigma_max=0.6,
                            backend="xla")
    port = SMFModel(aux_data=aux_from_numpy(
        {k: (np.asarray(v) if hasattr(v, "shape") else v)
         for k, v in aux.items()}, device="cpu"))
    assert port.aux_data["bin_window"] == aux["bin_window"]
    from multigrad_tpu_torch.models import make_smf_data
    own = make_smf_data(5_000, bin_mode="fused", sigma_max=0.6,
                        device="cpu")
    assert own["bin_window"] == aux["bin_window"]
    assert own["sigma_max"] == aux["sigma_max"] == 0.6
    ref = JaxSMFModel(aux_data=aux)
    params = (-1.5, 0.3)
    np.testing.assert_allclose(
        port.calc_sumstats_from_params(params).numpy(),
        np.asarray(ref.calc_sumstats_from_params(jnp.asarray(params))),
        rtol=2e-5, atol=1e-9)
    loss_p, grad_p = port.calc_loss_and_grad_from_params(params)
    loss_r, grad_r = ref.calc_loss_and_grad_from_params(jnp.asarray(params))
    np.testing.assert_allclose(float(loss_p), float(loss_r), rtol=1e-4)
    np.testing.assert_allclose(grad_p.numpy(), np.asarray(grad_r),
                               rtol=1e-3, atol=1e-6)
