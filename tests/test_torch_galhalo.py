"""The port's static galaxy–halo model (``GalhaloModel``) against the JAX
package's, on identical inputs.

The JAX package's ``make_galhalo_data`` dict is carried into the port with
``aux_from_numpy``.  The JAX side runs its Pallas kernel in interpret mode
(``backend="pallas"``), which evaluates the same float32 erf polynomial as
the port; its XLA path evaluates XLA's own erf, which rounds differently
in the tails.  Each comparison states its float32 tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrad_tpu.models import galhalo as jg
from multigrad_tpu_torch.models import (GalhaloModel, GalhaloParams,
                                        aux_from_numpy, make_galhalo_data,
                                        mean_logsm, sample_log_halo_masses)
from multigrad_tpu_torch.models import galhalo as tg

NUM_HALOS = 4_000
GUESS = np.array(GalhaloParams(), np.float32) + np.array(
    [0.1, -0.1, 0.05, -0.05, 0.03], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # The suite's workers share the machine's cores with JAX's own thread
    # pools: keep PyTorch's intra-op pool small while this module runs.
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _to_numpy(aux):
    return {k: (np.asarray(v) if hasattr(v, "shape") else v)
            for k, v in aux.items()}


@pytest.fixture(scope="module")
def pair():
    aux = jg.make_galhalo_data(NUM_HALOS, backend="pallas")
    port = GalhaloModel(aux_data=aux_from_numpy(_to_numpy(aux), device="cpu"))
    return jg.GalhaloModel(aux_data=aux), port


def test_sample_log_halo_masses_matches_jax():
    # q_i = i / n and the inverse cdf in float32, as the JAX package
    # computes them; the two round the power law's steps apart by a few
    # ulps of log10 M (~15).
    want = np.asarray(jg.sample_log_halo_masses(20_000))
    got = sample_log_halo_masses(20_000, device="cpu").numpy()
    assert got.dtype == np.float32 and got.shape == (20_000,)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_mean_logsm_matches_jax():
    lm = np.linspace(10.0, 15.5, 301).astype(np.float32)
    for params in (jg.TRUTH, tuple(GUESS)):
        want = np.asarray(jg.mean_logsm(jnp.asarray(lm), params))
        got = mean_logsm(torch.tensor(lm), params).numpy()
        # softplus: log1p(exp(x)) against logaddexp(x, 0), a few ulps.
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)


def test_make_galhalo_data_matches_jax():
    # Same halos, edges and volume; the target through the port's erf
    # against the JAX Pallas kernel's (same polynomial, sums in another
    # order): rtol 2e-5 with an atol at 1e-6 of the largest density.
    want = _to_numpy(jg.make_galhalo_data(NUM_HALOS, backend="pallas"))
    got = make_galhalo_data(NUM_HALOS, device="cpu")
    assert set(got) == set(want) - {"backend"}
    assert got["volume"] == want["volume"]
    np.testing.assert_array_equal(got["bin_edges"].numpy(),
                                  want["bin_edges"])
    target = want["target_sumstats"]
    np.testing.assert_allclose(got["target_sumstats"].numpy(), target,
                               rtol=2e-5, atol=1e-6 * np.abs(target).max())


def test_aux_from_numpy_carries_galhalo_dicts():
    aux = _to_numpy(jg.make_galhalo_data(100, chunk_size=64))
    port = aux_from_numpy(aux, device="cpu")
    assert "backend" not in port and port["chunk_size"] == 64
    assert isinstance(port["log_halo_masses"], torch.Tensor)
    np.testing.assert_array_equal(port["log_halo_masses"].numpy(),
                                  aux["log_halo_masses"])


def test_sumstats_loss_and_grad_match_jax(pair):
    ref, port = pair
    y_ref = np.asarray(ref.calc_sumstats_from_params(jnp.asarray(GUESS)))
    y = port.calc_sumstats_from_params(GUESS).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=2e-5,
                               atol=1e-6 * np.abs(y_ref).max())
    loss_r, grad_r = ref.calc_loss_and_grad_from_params(jnp.asarray(GUESS))
    loss, grad = port.calc_loss_and_grad_from_params(GUESS)
    # The log-space loss weighs near-empty bins, where the float32 sums
    # keep fewer digits: rtol 1e-4 (loss), 1e-3 (gradient, the analytic
    # backward against autodiff).
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=1e-4)
    assert grad.shape == (5,) and torch.isfinite(grad).all()
    np.testing.assert_allclose(grad.numpy(), np.asarray(grad_r), rtol=1e-3,
                               atol=1e-6)


def test_loss_zero_at_truth_and_chunking():
    model = GalhaloModel(aux_data=make_galhalo_data(NUM_HALOS, device="cpu"))
    loss, grad = model.calc_loss_and_grad_from_params(tg.TRUTH)
    assert float(loss) == 0.0 and torch.isfinite(grad).all()
    chunked = GalhaloModel(aux_data=dict(model.aux_data, chunk_size=999))
    # Chunking only reorders the float32 sums over halos.
    np.testing.assert_allclose(
        chunked.calc_sumstats_from_params(GUESS).numpy(),
        model.calc_sumstats_from_params(GUESS).numpy(), rtol=2e-5,
        atol=1e-12)


class _Rank:
    """A stand-in comm of three processes, seen from rank 2."""
    rank, size = 2, 3


def test_shard_padding_is_neutral():
    # 4,000 halos over 3 ranks: rank 2 holds 1,332 and 2 pad halos at
    # PAD_LOGM, which add nothing to the counts or the gradient.
    aux = make_galhalo_data(NUM_HALOS, comm=_Rank(), device="cpu")
    shard = aux["log_halo_masses"]
    assert shard.shape == (1_334,)
    np.testing.assert_array_equal(shard[-2:].numpy(), tg.PAD_LOGM)
    padded = GalhaloModel(aux_data=aux)
    bare = GalhaloModel(aux_data=dict(aux, log_halo_masses=shard[:-2]))
    np.testing.assert_array_equal(
        padded.calc_sumstats_from_params(GUESS).numpy(),
        bare.calc_sumstats_from_params(GUESS).numpy())
    g_pad = padded.calc_dloss_dparams(GUESS)
    g_bare = bare.calc_dloss_dparams(GUESS)
    assert torch.isfinite(g_pad).all()
    np.testing.assert_allclose(g_pad.numpy(), g_bare.numpy(), rtol=1e-6)
