"""The port's erf-CDF counts against the JAX package's.

The plain PyTorch versions of the CUDA kernels (what a CPU tensor runs)
are held against ``multigrad_tpu.ops.binned.binned_erf_counts`` (XLA)
and against the Pallas kernel ``binned_erf_counts_pallas`` run in
interpret mode, on the same numpy inputs.  Tolerances are those of
``tests/test_pallas.py``: forward ``rtol=2e-5, atol=1e-5`` (f32 sums
over particles in another order), gradients ``rtol=1e-3, atol=1e-5``
(the analytic backward against autodiff through the erf polynomial),
for a scalar and for a per-particle sigma.
The CUDA kernels themselves are held against the plain versions in
``tests/test_torch_cuda.py``, which needs the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrad_tpu.ops.binned import binned_erf_counts as jax_counts
from multigrad_tpu.ops.binned import binned_density as jax_density
from multigrad_tpu.ops.binned import norm_cdf as jax_norm_cdf
from multigrad_tpu.ops.pallas_kernels import binned_erf_counts_pallas
from multigrad_tpu_torch.ops.binned import (binned_density,
                                            binned_erf_counts, norm_cdf)
from multigrad_tpu_torch.ops.erf_kernels import (ErfCounts,
                                                 erf_counts_bwd_plain,
                                                 erf_counts_fwd_plain)

EDGES = np.linspace(9, 10, 11).astype(np.float32)
COT = np.arange(10.0, dtype=np.float32)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # The suite's workers share the machine's cores with JAX's own thread
    # pools: keep PyTorch's intra-op pool small while this module runs.
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _halo_sample(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(9.5, 0.4, size=n).astype(np.float32)


def _t(x):
    return torch.tensor(np.asarray(x))


def _jax_fn(ref):
    if ref == "xla":
        return lambda v, e, s: jax_counts(v, e, s, backend="xla")
    return lambda v, e, s: binned_erf_counts_pallas(v, e, s, block_size=1024)


@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("n", [1024, 3333])
def test_forward_matches_jax(n, ref):
    vals = _halo_sample(n)
    want = _jax_fn(ref)(jnp.asarray(vals), jnp.asarray(EDGES),
                        jnp.float32(0.2))
    got = binned_erf_counts(_t(vals), _t(EDGES), 0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_gradients_match_jax(ref):
    vals = _halo_sample(4000)
    fn = _jax_fn(ref)
    g_ref = jax.grad(lambda v, e, s: jnp.sum(fn(v, e, s) * COT),
                     argnums=(0, 1, 2))(jnp.asarray(vals), jnp.asarray(EDGES),
                                        jnp.float32(0.2))
    v, e = _t(vals).requires_grad_(), _t(EDGES).requires_grad_()
    s = torch.tensor(0.2).requires_grad_()
    (binned_erf_counts(v, e, s) * _t(COT)).sum().backward()
    for want, got in zip(g_ref, (v.grad, e.grad, s.grad)):
        assert tuple(got.shape) == np.shape(want)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-3, atol=1e-5)


def test_inf_padding_neutral_with_finite_grads():
    vals = np.concatenate([_halo_sample(1000), np.full(24, np.inf,
                                                        np.float32)])
    want = jax_counts(jnp.asarray(vals[:1000]), jnp.asarray(EDGES), 0.2)
    v = _t(vals).requires_grad_()
    s = torch.tensor(0.2).requires_grad_()
    counts = binned_erf_counts(v, _t(EDGES), s)
    np.testing.assert_allclose(counts.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=1e-5)
    counts.sum().backward()
    assert torch.isfinite(v.grad).all() and torch.isfinite(s.grad)
    np.testing.assert_array_equal(v.grad[1000:].numpy(), 0.0)


def test_rejects_bad_sigma_shape():
    with pytest.raises(ValueError, match="match values"):
        binned_erf_counts(_t(_halo_sample(256)), _t(EDGES),
                          torch.full((100,), 0.2))
    with pytest.raises(ValueError, match="match values"):
        binned_erf_counts(_t(_halo_sample(256)), _t(EDGES),
                          torch.full((2, 2), 0.2))


def test_rejects_more_than_128_edges():
    edges = np.linspace(9, 10, 129).astype(np.float32)
    with pytest.raises(ValueError, match="at most 128"):
        binned_erf_counts(_t(_halo_sample(256)), _t(edges), 0.2)
    with pytest.raises(ValueError, match="at most 128"):
        binned_erf_counts_pallas(jnp.asarray(_halo_sample(256)),
                                 jnp.asarray(edges), 0.2)


def test_per_particle_sigma_not_ported():
    # Per-particle sigma is ported now: an (N,) sigma runs (here through
    # the plain version) and equals the Pallas kernel's vec_sigma path.
    vals, sig = _halo_sample(256), _vec_sigma(256)
    want = binned_erf_counts_pallas(jnp.asarray(vals), jnp.asarray(EDGES),
                                    jnp.asarray(sig), block_size=1024)
    got = binned_erf_counts(_t(vals), _t(EDGES), _t(sig))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=1e-5)


def test_fused_bin_mode_not_ported(tmp_path, monkeypatch):
    # bin_mode="auto" on the op resolves through the tuning table: dense
    # on a cold table, as in the JAX package.  chunk_size="auto" resolves
    # only at model construction; the op refuses it (a TypeError, as the
    # JAX package's op raises one).
    monkeypatch.setenv("MGT_TUNING_TABLE", str(tmp_path / "missing.json"))
    vals = _t(_halo_sample(512))
    np.testing.assert_array_equal(
        binned_erf_counts(vals, _t(EDGES), 0.2, bin_mode="auto").numpy(),
        binned_erf_counts(vals, _t(EDGES), 0.2, bin_mode="dense").numpy())
    with pytest.raises(TypeError, match="model construction"):
        binned_erf_counts(vals, _t(EDGES), 0.2, chunk_size="auto")
    with pytest.raises(ValueError, match="unknown bin_mode"):
        binned_erf_counts(_t(_halo_sample(16)), _t(EDGES), 0.2,
                          bin_mode="sparse")


# --------------------------------------------------------------------------
# Per-particle sigma (the history model's mass-dependent scatter), against
# tests/test_pallas.py's vec-sigma inputs and tolerances.
# --------------------------------------------------------------------------
def _vec_sigma(n, seed=5):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.1, 0.4, size=n).astype(np.float32)


@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("n", [1024, 3333])
def test_vec_sigma_forward_matches_jax(n, ref):
    vals, sig = _halo_sample(n), _vec_sigma(n)
    want = _jax_fn(ref)(jnp.asarray(vals), jnp.asarray(EDGES),
                        jnp.asarray(sig))
    got = binned_erf_counts(_t(vals), _t(EDGES), _t(sig))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_vec_sigma_gradients_match_jax(ref):
    vals, sig = _halo_sample(4000), _vec_sigma(4000)
    fn = _jax_fn(ref)
    g_ref = jax.grad(lambda v, e, s: jnp.sum(fn(v, e, s) * COT),
                     argnums=(0, 1, 2))(jnp.asarray(vals), jnp.asarray(EDGES),
                                        jnp.asarray(sig))
    v, e = _t(vals).requires_grad_(), _t(EDGES).requires_grad_()
    s = _t(sig).requires_grad_()
    (binned_erf_counts(v, e, s) * _t(COT)).sum().backward()
    for want, got in zip(g_ref, (v.grad, e.grad, s.grad)):
        assert tuple(got.shape) == np.shape(want)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-3, atol=1e-5)


def test_vec_sigma_padding_neutral():
    # +inf values with any finite pad sigma add nothing forward and get
    # zero (not NaN) gradients, as in test_pallas.py's padding test.
    vals = np.concatenate([_halo_sample(1000), np.full(24, np.inf,
                                                        np.float32)])
    sig = np.concatenate([_vec_sigma(1000), np.full(24, 0.3, np.float32)])
    want = jax_counts(jnp.asarray(vals[:1000]), jnp.asarray(EDGES),
                      jnp.asarray(sig[:1000]), backend="xla")
    v, s = _t(vals).requires_grad_(), _t(sig).requires_grad_()
    counts = binned_erf_counts(v, _t(EDGES), s)
    np.testing.assert_allclose(counts.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=1e-5)
    counts.sum().backward()
    assert torch.isfinite(v.grad).all() and torch.isfinite(s.grad).all()
    np.testing.assert_array_equal(v.grad[1000:].numpy(), 0.0)
    np.testing.assert_array_equal(s.grad[1000:].numpy(), 0.0)


def test_vec_sigma_chunked_plain_matches_unchunked():
    # Chunking only reorders float32 sums over particles.
    vals = np.concatenate([_halo_sample(5000), np.full(3, np.inf,
                                                       np.float32)])
    v, e, s = _t(vals), _t(EDGES), _t(_vec_sigma(5003))
    np.testing.assert_allclose(erf_counts_fwd_plain(v, e, s, 777).numpy(),
                               erf_counts_fwd_plain(v, e, s).numpy(),
                               rtol=2e-5, atol=1e-5)
    g = _t(COT)
    for a, b in zip(erf_counts_bwd_plain(v, e, s, g, 777),
                    erf_counts_bwd_plain(v, e, s, g)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_chunked_plain_matches_unchunked():
    # Chunking only reorders float32 sums over particles.
    vals = np.concatenate([_halo_sample(5000), np.full(3, np.inf,
                                                       np.float32)])
    v, e, s = _t(vals), _t(EDGES), torch.tensor(0.2)
    np.testing.assert_allclose(erf_counts_fwd_plain(v, e, s, 777).numpy(),
                               erf_counts_fwd_plain(v, e, s).numpy(),
                               rtol=2e-5, atol=1e-5)
    g = _t(COT)
    for a, b in zip(erf_counts_bwd_plain(v, e, s, g, 777),
                    erf_counts_bwd_plain(v, e, s, g)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_chunk_size_passes_through_autograd():
    vals = _halo_sample(3000)
    v = _t(vals).requires_grad_()
    s = torch.tensor(0.3).requires_grad_()
    out = binned_erf_counts(v, _t(EDGES), s, chunk_size=1000)
    (out * _t(COT)).sum().backward()
    want = jax.grad(lambda v_, s_: jnp.sum(
        jax_counts(v_, jnp.asarray(EDGES), s_, chunk_size=1000,
                   backend="xla") * COT), argnums=(0, 1))(
        jnp.asarray(vals), jnp.float32(0.3))
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(want[0]),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(float(s.grad), float(want[1]), rtol=1e-3)


def test_binned_density_matches_jax():
    vals = _halo_sample(2000, seed=3)
    want = jax_density(jnp.asarray(vals), jnp.asarray(EDGES), 0.25, 1e4,
                       backend="xla")
    got = binned_density(_t(vals), _t(EDGES), 0.25, 1e4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=1e-9)


def test_norm_cdf_matches_jax():
    x = np.linspace(-3, 3, 101).astype(np.float32)
    want = jax_norm_cdf(jnp.asarray(x), 0.3, 0.7)
    got = norm_cdf(_t(x), 0.3, 0.7)
    # 0.5 * (1 + erf) rounds at the scale of 1: a few f32 ulps of 1.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=2.5e-7)


def test_autograd_function_matches_finite_differences():
    # gradcheck in float32: the analytic backward against central
    # differences of the plain forward, at a loose f32 tolerance.
    vals = _halo_sample(64, seed=7)
    v = _t(vals).requires_grad_()
    s = torch.tensor(0.3).requires_grad_()
    out = ErfCounts.apply(v, _t(EDGES), s, None)
    (out * _t(COT)).sum().backward()
    eps = 1e-2
    f = (lambda sig: float((erf_counts_fwd_plain(
        _t(vals), _t(EDGES), torch.tensor(sig)) * _t(COT)).sum()))
    fd = (f(0.3 + eps) - f(0.3 - eps)) / (2 * eps)
    np.testing.assert_allclose(float(s.grad), fd, rtol=1e-2)


def test_erf_grid_rule():
    # The CUDA kernels' grid (ops/erf_kernels.py::erf_grid): every thread
    # takes at least four steps of four particles, as many blocks on every
    # SM, at most 16 blocks an SM.
    from multigrad_tpu_torch.ops.erf_kernels import erf_grid
    assert erf_grid(1, 132) == 132
    assert erf_grid(4096 * 132, 132) == 132
    assert erf_grid(4096 * 132 + 1, 132) == 264
    assert erf_grid(1_000_000, 132) == 264
    assert erf_grid(100_000_000, 132) == 132 * 16
