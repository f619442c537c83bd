"""The port's galaxy–halo history model (``GalhaloHistModel``) against the
JAX package's, dense and fused, on identical inputs.

The JAX package's ``make_galhalo_hist_data`` dict is carried into the port
with ``aux_from_numpy``.  The JAX side runs its Pallas kernels in
interpret mode (``backend="pallas"``): they evaluate the same float32 erf
polynomial as the port, where XLA's own erf saturates earlier in the
tails.  It runs unchunked (a rematerialized scan cannot hold an
interpret-mode kernel's effects); the port runs chunked with a ragged
tail, which the chunked-equals-unchunked test separately holds to the
JAX package's own tolerance.

Why the model-level tolerances are what they are: XLA contracts the erf
polynomial into fused multiply-adds and PyTorch's CPU ops round each step,
so each particle's cdf differs by a few float32 ulps of 1.  In the lowest
bins of the late epochs, which only far tails of the Gaussians reach,
those ulps are the whole content of the bin (``0.5·(1 + erf)`` keeps few
digits there), and the log-space loss weighs such bins like any other.
So the sumstats are held at an atol of 1e-6 of their largest value, the
gradient of a well-conditioned linear functional of the sumstats at
rtol 1e-3, and the loss and its gradient at rtol 1e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrad_tpu.models import galhalo_hist as jh
from multigrad_tpu_torch.models import (GalhaloHistModel, aux_from_numpy,
                                        make_galhalo_hist_data,
                                        mean_log_mstar, scatter_sigma)
from multigrad_tpu_torch.models import galhalo_hist as th

NUM_HALOS = 20_000
CHUNK = 3_000                    # ragged: 6 x 3,000 + 2,000
TRUTH = np.array(th.TRUTH, np.float32)
GUESS = TRUTH + 0.04
# The fused configuration here: the default 14 edges with the window of
# DEFAULT_SIGMA_MAX (W = 12 of 14, a partial window).
FUSED = dict(bin_mode="fused", sigma_max=th.DEFAULT_SIGMA_MAX)


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


def _pair(**kwargs):
    aux = jh.make_galhalo_hist_data(NUM_HALOS, backend="pallas", **kwargs)
    port = GalhaloHistModel(aux_data=dict(
        aux_from_numpy(_to_numpy(aux), device="cpu"), chunk_size=CHUNK))
    return jh.GalhaloHistModel(aux_data=aux), port


@pytest.fixture(scope="module")
def dense_pair():
    return _pair()


@pytest.fixture(scope="module")
def fused_pair():
    return _pair(**FUSED)


@pytest.fixture(scope="module")
def own_model():
    return GalhaloHistModel(aux_data=make_galhalo_hist_data(
        NUM_HALOS, chunk_size=CHUNK, device="cpu"))


# --------------------------------------------------------------------------
# The physics, function by function
# --------------------------------------------------------------------------
def test_history_functions_match_jax():
    t = np.asarray(jh.default_time_grid())
    np.testing.assert_allclose(th.default_time_grid(device="cpu").numpy(),
                               t, rtol=1e-6)
    lm = np.linspace(10.5, 15.0, 37).astype(np.float32)[:, None]
    for params in (jh.TRUTH, tuple(GUESS)):
        p = torch.tensor(params, dtype=torch.float32)
        tt, lt = torch.tensor(t)[None, :], torch.tensor(lm)
        pairs = [
            (jh.mah_alpha(t, params), th.mah_alpha(tt, p)),
            (jh.log_mh_at_t(lm, t, params), th.log_mh_at_t(lt, tt, p)),
            (jh._dlogmh_dt(lm, t, params), th._dlogmh_dt(lt, tt, p)),
            (jh.lg_sfr_efficiency(lm, params),
             th.lg_sfr_efficiency(lt, p)),
            (jh.scatter_sigma(lm[:, 0], params),
             scatter_sigma(lt[:, 0], p)),
        ]
        for want, got in pairs:
            # Elementwise float32 (sigmoid, log10, softplus) in two
            # libraries: a few ulps of values of order 1 to 15.
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy().reshape(want.shape),
                                       want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("obs", [None, (7, 12, 15), (1, 5, 9, 11, 13, 15)])
def test_mean_log_mstar_matches_jax(obs):
    lm = np.asarray(jh.sample_log_halo_masses(3_000))
    kw = {} if obs is None else dict(obs_indices=obs)
    want = np.asarray(jh.mean_log_mstar(jnp.asarray(lm),
                                        jnp.asarray(GUESS), **kw))
    got = mean_log_mstar(torch.tensor(lm), torch.tensor(GUESS), **kw)
    assert tuple(got.shape) == want.shape
    # log10 of a 16-point trapezoid of 10**x terms: a few ulps of ~10.
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_chunked_matches_unchunked(own_model):
    lm = own_model.aux_data["log_halo_masses"]
    p = torch.tensor(GUESS)
    whole = mean_log_mstar(lm, p, obs_indices=(7, 12, 15))
    for chunk in (5_000, CHUNK):        # even, then ragged
        # The same float32 ops on each halo: equal bit for bit.
        np.testing.assert_array_equal(
            mean_log_mstar(lm, p, chunk_size=chunk,
                           obs_indices=(7, 12, 15)).numpy(),
            whole.numpy())
    # Sumstats, loss and gradient, chunked (ragged) against one block: the
    # JAX package's tolerances (tests/test_galhalo_hist.py:110-118).
    block = GalhaloHistModel(aux_data=dict(own_model.aux_data,
                                           chunk_size=None))
    np.testing.assert_allclose(
        own_model.calc_sumstats_from_params(GUESS).numpy(),
        block.calc_sumstats_from_params(GUESS).numpy(), rtol=1e-4,
        atol=1e-10)
    l0, g0 = block.calc_loss_and_grad_from_params(GUESS)
    l1, g1 = own_model.calc_loss_and_grad_from_params(GUESS)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-3)
    np.testing.assert_allclose(g1.numpy(), g0.numpy(), rtol=1e-3, atol=1e-7)


def test_make_galhalo_hist_data_matches_jax():
    want = _to_numpy(jh.make_galhalo_hist_data(
        4_000, chunk_size=1_500, backend="pallas", **FUSED))
    got = make_galhalo_hist_data(4_000, chunk_size=1_500, device="cpu",
                                 **FUSED)
    assert set(got) == set(want) - {"backend"}
    for key in ("obs_indices", "volume", "chunk_size", "bin_mode",
                "bin_window", "sigma_max"):
        assert got[key] == want[key], key
    assert got["bin_window"] == 12
    # torch.linspace and jnp.linspace round a few edges apart by an ulp.
    np.testing.assert_allclose(got["bin_edges"].numpy(), want["bin_edges"],
                               rtol=2e-7)
    target = want["target_sumstats"]
    np.testing.assert_allclose(got["target_sumstats"].numpy(), target,
                               rtol=1e-4, atol=1e-6 * np.abs(target).max())


# --------------------------------------------------------------------------
# The model against the JAX package's, dense and fused
# --------------------------------------------------------------------------
def _cotangent(y):
    # Bounded weights that favour populated bins: a linear functional of
    # the sumstats whose gradient is well conditioned.
    w = np.random.default_rng(0).normal(size=y.shape)
    return (w * np.abs(y) / np.abs(y).max()).astype(np.float32)


@pytest.mark.parametrize("which", ["dense", "fused"])
def test_model_matches_jax(which, dense_pair, fused_pair):
    ref, port = dense_pair if which == "dense" else fused_pair
    y_ref = np.asarray(ref.calc_sumstats_from_params(jnp.asarray(GUESS)))
    y = port.calc_sumstats_from_params(GUESS).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=1e-4,
                               atol=1e-6 * np.abs(y_ref).max())

    cot = _cotangent(y_ref)
    vjp_ref = jax.grad(lambda q: jnp.sum(
        ref.calc_partial_sumstats_from_params(q) * cot))(jnp.asarray(GUESS))
    q = torch.tensor(GUESS, requires_grad=True)
    (vjp,) = torch.autograd.grad(
        (port.calc_partial_sumstats_from_params(q) * torch.tensor(cot))
        .sum(), q)
    np.testing.assert_allclose(vjp.numpy(), np.asarray(vjp_ref), rtol=1e-3,
                               atol=1e-6 * np.abs(vjp_ref).max())

    loss_r, grad_r = ref.calc_loss_and_grad_from_params(jnp.asarray(GUESS))
    loss, grad = port.calc_loss_and_grad_from_params(GUESS)
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=1e-2)
    np.testing.assert_allclose(grad.numpy(), np.asarray(grad_r), rtol=1e-2,
                               atol=1e-6)


def test_adam_trajectory_matches_jax(dense_pair):
    # Five steps at bench.py's learning rate from TRUTH + 0.05.  Adam's
    # steps are near lr·sign(grad) early on, so 1e-2 relative gradient
    # differences move the parameters by far less than the 5e-3 path.
    ref, port = dense_pair
    guess = TRUTH + 0.05
    want = np.asarray(ref.run_adam(guess=jnp.asarray(guess), nsteps=5,
                                   learning_rate=1e-3, progress=False))
    got = port.run_adam(guess=guess, nsteps=5, learning_rate=1e-3,
                        progress=False).numpy()
    assert got.shape == want.shape == (6, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


# --------------------------------------------------------------------------
# Invariants of the port's own model
# --------------------------------------------------------------------------
def test_loss_zero_at_truth_and_all_ten_gradients(own_model):
    loss, grad = own_model.calc_loss_and_grad_from_params(TRUTH)
    assert float(loss) < 1e-10 and torch.isfinite(grad).all()
    loss, grad = own_model.calc_loss_and_grad_from_params(GUESS + 0.01)
    assert torch.isfinite(grad).all()
    assert bool((grad.abs() > 0).all()), grad     # every parameter matters


def test_padding_neutral_forward_and_backward():
    lm = torch.cat([th.sample_log_halo_masses(2_000, device="cpu"),
                    torch.full((48,), th._PAD_LOGM)])
    p = torch.tensor(TRUTH, requires_grad=True)
    out = mean_log_mstar(lm, p)
    assert bool((out[2_000:] == th._PAD_OUT).all())
    assert bool(torch.isfinite(out[:2_000]).all())
    total = torch.where(lm > 100.0, 0.0, out).sum()
    (g,) = torch.autograd.grad(total, p)
    assert torch.isfinite(g).all()
    # Pad halos add nothing to the sumstats and their gradient.
    aux = make_galhalo_hist_data(2_000, device="cpu", **FUSED)
    padded = GalhaloHistModel(aux_data=dict(aux, log_halo_masses=lm))
    bare = GalhaloHistModel(aux_data=aux)
    for mp, mb in ((padded, bare), (GalhaloHistModel(aux_data=dict(
            padded.aux_data, bin_mode="dense")), GalhaloHistModel(
            aux_data=dict(aux, bin_mode="dense")))):
        np.testing.assert_array_equal(
            mp.calc_sumstats_from_params(GUESS).numpy(),
            mb.calc_sumstats_from_params(GUESS).numpy())
        np.testing.assert_allclose(mp.calc_dloss_dparams(GUESS).numpy(),
                                   mb.calc_dloss_dparams(GUESS).numpy(),
                                   rtol=1e-6)


def test_fused_equals_dense_through_the_model(own_model):
    fused = GalhaloHistModel(aux_data=dict(own_model.aux_data,
                                           bin_mode="fused", bin_window=12))
    # The window's cut is exact in float32; sums run in another order.
    np.testing.assert_allclose(
        fused.calc_sumstats_from_params(GUESS).numpy(),
        own_model.calc_sumstats_from_params(GUESS).numpy(), rtol=1e-4,
        atol=1e-10)


# --------------------------------------------------------------------------
# Configuration errors
# --------------------------------------------------------------------------
def test_obs_indices_errors():
    lm = th.sample_log_halo_masses(100, device="cpu")
    for bad in ((0, 7), (7, 16)):
        with pytest.raises(ValueError, match="obs_indices"):
            mean_log_mstar(lm, TRUTH, obs_indices=bad)
        with pytest.raises(ValueError, match="obs_indices"):
            make_galhalo_hist_data(100, obs_indices=bad, device="cpu")
        with pytest.raises(ValueError, match="obs_indices"):
            jh.mean_log_mstar(jnp.asarray(lm.numpy()), jnp.asarray(TRUTH),
                              obs_indices=jnp.array(bad))

    def traced(oi):
        return mean_log_mstar(lm, TRUTH, obs_indices=oi)

    # A symbolic value cannot be range-checked (JAX: a traced one).
    with pytest.raises(TypeError, match="concrete"):
        torch.fx.symbolic_trace(traced)


def test_array_obs_indices_normalized_by_model():
    aux = make_galhalo_hist_data(2_000, device="cpu")
    for form in (np.array(aux["obs_indices"]),
                 torch.tensor(aux["obs_indices"]), list(aux["obs_indices"])):
        model = GalhaloHistModel(aux_data=dict(aux, obs_indices=form))
        assert model.aux_data["obs_indices"] == (7, 12, 15)
    single = GalhaloHistModel(aux_data=dict(aux, obs_indices=np.int64(15)))
    assert single.aux_data["obs_indices"] == (15,)


def test_auto_knobs_not_ported(tmp_path, monkeypatch):
    # "auto" resolves through the tuning table at construction: on a cold
    # table to the JAX package's hand-set defaults on the same data (the
    # window derived from the default sigma_max kept), and the target is
    # the dense one.
    monkeypatch.setenv("MGT_TUNING_TABLE", str(tmp_path / "missing.json"))
    knobs = ("bin_mode", "bin_window", "chunk_size", "sigma_max")
    for kwargs in (dict(bin_mode="auto"), dict(chunk_size="auto"),
                   dict(bin_mode="auto", chunk_size="auto")):
        got = GalhaloHistModel(aux_data=make_galhalo_hist_data(
            100, device="cpu", **kwargs)).aux_data
        want = jh.GalhaloHistModel(aux_data=jh.make_galhalo_hist_data(
            100, **kwargs)).aux_data
        assert {k: got.get(k) for k in knobs} == \
            {k: want.get(k) for k in knobs}
        assert got["bin_mode"] == "dense" and got["chunk_size"] is None
        np.testing.assert_array_equal(
            got["target_sumstats"].numpy(),
            make_galhalo_hist_data(100, device="cpu")["target_sumstats"]
            .numpy())
    aux = make_galhalo_hist_data(100, device="cpu")
    model = GalhaloHistModel(aux_data=dict(aux, bin_mode="auto"))
    assert model.aux_data["bin_mode"] == "dense"
