"""The port's multi-chain HMC (``inference/hmc.py``) against the JAX
package's sampler and the closed-form Gaussian posterior (the
counterparts of ``tests/test_inference.py``'s HMC and diagnostics tests).

Parity: the port's sampler core takes its noise from a callable, which
the parity tests build from ``jax.random`` as the JAX sampler draws it
(``hmc.py:216-230`` and ``:492-496``): a fold-in of the draw index, split
three ways for the momenta, the jitter and the Metropolis uniforms; and,
for a 1-D start, the first half of a split for the scatter.

Tolerances.  The dual-averaging warmup amplifies float32 rounding: its
gain grows as sqrt(t)/0.05 a draw, and a leapfrog near its stability edge
turns a small change of step size into a large change of acceptance.
The JAX sampler itself, its start moved by one float32 ulp, moves by up
to 0.57 in its samples over 20 warmup and 30 sampling draws of the
linear-Gaussian model (``test_reference_warmup_amplifies_one_ulp``), so
no float32 port can follow it draw for draw through a long warmup.  So
the strict comparisons run (a) the sampling
phase, 30 draws at a fixed step size, and (b) 3 warmup draws and 30
samples: every accept decision equal, samples, acceptance and step sizes
within rtol 1e-4 and atol 1e-5; potentials within rtol 1e-4 and atol
1e-5 of the JAX model's loss at the port's own draws and, against the
JAX run's potentials, within that tolerance plus what the draws'
difference carries to first order, ``|∇U|·|Δq|``.  (c) The issue's full
length, 20 warmup and 30 samples, holds the port's adapted step sizes,
warmup and sampling acceptance and per-chain sample means no further
from the JAX run than the reference's own one-ulp spread: the largest
move of each among four JAX runs whose start or step size moved by one
ulp.  The SMF χ² model at 10,000 halos (5 + 10 draws, 2 chains): every
decision equal, samples rtol 1e-3 (its loss differs from the JAX
package's by up to 7e-4 relative, ``tests/test_torch_smf.py``).  The
posterior of the port's own sampler (4 chains, 400 warmup, 800 samples)
holds the closed-form mean and covariance within 3 Monte-Carlo standard
errors with R-hat < 1.05, as ``tests/test_inference.py:197-268``.  The
numpy diagnostics equal the JAX package's exactly on the same draws.
"""
import numpy as np
import pytest
import torch

from multigrad_tpu_torch.inference import (HMCResult, effective_sample_size,
                                           fisher_information, run_hmc,
                                           split_rhat)
from multigrad_tpu_torch.inference.hmc import _sample, result_from
from multigrad_tpu_torch.models import SMFChi2Model, aux_from_numpy
from test_torch_fisher import (N_DIM, GaussianLinearModel,
                               _jax_gaussian_linear)

CPU = "cpu"
CHAINS, WARMUP, SAMPLES = 4, 20, 30


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def prob():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    u = rng.normal(size=(64, N_DIM)).astype(np.float32)
    jac = x.T @ u
    prec = np.diag(rng.uniform(0.5, 2.0, 4)).astype(np.float32)
    target = (jac @ np.array([0.5, -0.3, 0.8], np.float32)).astype(
        np.float32)
    fisher = jac.T @ prec @ jac
    mle = np.linalg.solve(fisher, jac.T @ prec @ target)
    aux = dict(x=x, u=u, target=target, prec=prec)
    return dict(aux=aux, mle=mle.astype(np.float32),
                cov=np.linalg.inv(fisher),
                init=(mle[None] + 0.1 * rng.normal(size=(CHAINS, N_DIM)))
                .astype(np.float32))


@pytest.fixture(scope="module")
def models(prob):
    return (GaussianLinearModel(aux_data=aux_from_numpy(prob["aux"],
                                                        device=CPU)),
            _jax_gaussian_linear(prob["aux"]))


def jax_noise(randkey, n_chains, ndim, spread_init=None, spread=0.0):
    """The JAX sampler's draws as the port's ``noise(t)`` callable, and
    the start it scatters a 1-D ``spread_init`` into."""
    import jax
    import jax.numpy as jnp
    rng = jax.random.key(randkey)
    init = None
    if spread_init is not None:
        k_init, rng = jax.random.split(rng)
        init = jnp.asarray(spread_init)[None] + spread * jax.random.normal(
            k_init, (n_chains, ndim), jnp.float32)
        init = torch.tensor(np.asarray(init))

    def noise(t):
        k_mom, k_jit, k_acc = jax.random.split(jax.random.fold_in(rng, t), 3)
        return tuple(torch.tensor(np.asarray(a)) for a in (
            jax.random.normal(k_mom, (n_chains, ndim), jnp.float32),
            jax.random.uniform(k_jit, (n_chains,), jnp.float32),
            jax.random.uniform(k_acc, (n_chains,), jnp.float32)))
    return noise, init


def port_sample(model, init, noise, warmup, samples, leapfrog, step_size,
                inv_mass=None):
    program = model.batched_loss_and_grad_fn()
    leaves = model.aux_leaves()
    ndim = init.shape[-1]
    inv_mass = torch.ones(ndim) if inv_mass is None \
        else torch.as_tensor(inv_mass, dtype=torch.float32)
    return result_from(_sample(
        lambda q: program(q, leaves), torch.as_tensor(init), noise, warmup,
        samples, leapfrog, torch.tensor(step_size), inv_mass, 0.8, 0.2))


def moves(samples):
    """Each draw's accept decision: whether the chain moved."""
    return np.any(np.diff(np.asarray(samples), axis=1) != 0, axis=-1)


def jax_potential(jm, samples):
    """The JAX model's loss and gradient at ``(C, S, D)`` draws."""
    import jax.numpy as jnp
    flat = np.asarray(samples).reshape(-1, np.shape(samples)[-1])
    loss, grad = jm.batched_loss_and_grad_fn()(
        jnp.asarray(flat), jm.aux_leaves(), jnp.zeros(()))
    shape = np.shape(samples)[:-1]
    return np.asarray(loss).reshape(shape), np.asarray(grad).reshape(
        np.shape(samples))


def assert_close(got, want, jm, rtol=1e-4, atol=1e-5):
    np.testing.assert_array_equal(moves(got.samples), moves(want.samples))
    for name in ("samples", "step_size", "accept_prob"):
        np.testing.assert_allclose(getattr(got, name),
                                   np.asarray(getattr(want, name)),
                                   rtol=rtol, atol=atol, err_msg=name)
    u_at_got, _ = jax_potential(jm, got.samples)
    np.testing.assert_allclose(got.potential, u_at_got, rtol=rtol, atol=atol)
    _, g_at_want = jax_potential(jm, want.samples)
    carried = np.linalg.norm(g_at_want, axis=-1) * np.linalg.norm(
        got.samples - np.asarray(want.samples), axis=-1)
    wp = np.asarray(want.potential)
    assert np.all(np.abs(got.potential - wp)
                  <= atol + rtol * np.abs(wp) + carried)
    np.testing.assert_array_equal(got.divergences,
                                  np.asarray(want.divergences))


@pytest.mark.parametrize("step_size,leapfrog", [(0.04, 8), (0.02, 4)])
def test_sampling_matches_jax_strict(models, prob, step_size, leapfrog):
    from multigrad_tpu.inference import run_hmc as jax_run_hmc
    pm, jm = models
    want = jax_run_hmc(jm, prob["init"], num_samples=SAMPLES, num_warmup=0,
                       step_size=step_size, num_leapfrog=leapfrog,
                       randkey=3)
    noise, _ = jax_noise(3, CHAINS, N_DIM)
    got = port_sample(pm, prob["init"], noise, 0, SAMPLES, leapfrog,
                      step_size)
    decisions = moves(got.samples)
    assert decisions.any() and not decisions.all()  # both kinds occur
    assert_close(got, want, jm)
    np.testing.assert_allclose(got.potential, np.asarray(want.potential),
                               rtol=1e-4, atol=1e-5)
    assert np.all(np.isnan(got.warmup_accept_prob))


def test_warmup_matches_jax_strict(models, prob):
    # A 1-D start scattered by init_spread, as hmc.py:492-496 does.
    from multigrad_tpu.inference import run_hmc as jax_run_hmc
    pm, jm = models
    want = jax_run_hmc(jm, prob["mle"], num_samples=SAMPLES, num_warmup=3,
                       num_chains=CHAINS, step_size=0.1, num_leapfrog=8,
                       randkey=3, init_spread=0.1)
    noise, init = jax_noise(3, CHAINS, N_DIM, prob["mle"], 0.1)
    got = port_sample(pm, init, noise, 3, SAMPLES, 8, 0.1)
    assert moves(got.samples).any()
    assert_close(got, want, jm)
    np.testing.assert_allclose(got.warmup_accept_prob,
                               np.asarray(want.warmup_accept_prob),
                               rtol=1e-4, atol=1e-5)


def _adapted(res):
    """What the full warmup adapts and what the sampling phase draws
    with it, each as the per-chain values compared with the reference."""
    return {"step_size": np.log(np.asarray(res.step_size)),
            "warmup_accept_prob": np.asarray(res.warmup_accept_prob),
            "accept_prob": np.asarray(res.accept_prob),
            "chain_mean": np.asarray(res.samples).mean(axis=1)}


@pytest.mark.parametrize("start", ["explicit", "spread"])
def test_full_warmup_within_reference_spread(models, prob, start):
    # The issue's 20 warmup + 30 sampling draws: the port no further from
    # the JAX run than the JAX run is from itself after a one-ulp move of
    # its start or its step size (step sizes compared in log).
    from multigrad_tpu.inference import run_hmc as jax_run_hmc
    pm, jm = models
    if start == "explicit":
        q0, kw = prob["init"], {}
        (noise, _), init = jax_noise(3, CHAINS, N_DIM), prob["init"]
    else:
        q0, kw = prob["mle"], dict(num_chains=CHAINS, init_spread=0.1)
        noise, init = jax_noise(3, CHAINS, N_DIM, prob["mle"], 0.1)

    def reference(q, step_size):
        return _adapted(jax_run_hmc(
            jm, q, num_samples=SAMPLES, num_warmup=WARMUP,
            step_size=step_size, num_leapfrog=8, randkey=3, **kw))
    want = reference(q0, 0.1)
    up, down = np.float32(np.inf), np.float32(-np.inf)
    moved = [reference(np.nextafter(q0, up), 0.1),
             reference(np.nextafter(q0, down), 0.1),
             reference(q0, float(np.nextafter(np.float32(0.1), up))),
             reference(q0, float(np.nextafter(np.float32(0.1), down)))]
    got = _adapted(port_sample(pm, init, noise, WARMUP, SAMPLES, 8, 0.1))
    for name, value in got.items():
        spread = max(np.max(np.abs(m[name] - want[name])) for m in moved)
        off = np.max(np.abs(value - want[name]))
        print(f"{start} {name}: port {off:.4g}, one-ulp spread {spread:.4g}")
        assert spread > 0, name
        assert off <= spread, (name, off, spread)


def test_reference_warmup_amplifies_one_ulp(models, prob):
    # Why the strict comparisons stop at 3 warmup draws: the reference
    # against itself, its start moved by one float32 ulp, over the
    # issue's 20 warmup + 30 sampling draws.
    from multigrad_tpu.inference import run_hmc as jax_run_hmc
    _, jm = models
    kw = dict(num_samples=SAMPLES, num_warmup=WARMUP, step_size=0.1,
              num_leapfrog=8, randkey=3)
    a = jax_run_hmc(jm, prob["init"], **kw)
    b = jax_run_hmc(jm, np.nextafter(prob["init"], np.float32(np.inf)),
                    **kw)
    assert np.max(np.abs(a.samples - b.samples)) > 1e-2


def test_smf_short_run_matches_jax():
    from multigrad_tpu.inference import run_hmc as jax_run_hmc
    from multigrad_tpu.models.smf import SMFChi2Model as JaxSMFChi2Model
    from multigrad_tpu.models.smf import make_smf_data as jax_make_smf_data
    jax_aux = jax_make_smf_data(10_000)
    arrays = {k: (np.asarray(v) if hasattr(v, "shape") else v)
              for k, v in jax_aux.items()}
    pm = SMFChi2Model(aux_data=aux_from_numpy(arrays, device=CPU))
    jm = JaxSMFChi2Model(aux_data=dict(jax_aux))
    stderr = fisher_information(pm, (-2.0, 0.2)).stderr().numpy()
    rng = np.random.default_rng(1)
    init = (np.array([-2.0, 0.2]) + stderr * rng.normal(size=(2, 2))) \
        .astype(np.float32)
    want = jax_run_hmc(jm, init, num_samples=10, num_warmup=5,
                       step_size=0.5, num_leapfrog=8, randkey=5,
                       inv_mass=stderr ** 2)
    noise, _ = jax_noise(5, 2, 2)
    got = port_sample(pm, init, noise, 5, 10, 8, 0.5, stderr ** 2)
    assert moves(got.samples).any()
    np.testing.assert_array_equal(moves(got.samples), moves(want.samples))
    np.testing.assert_allclose(got.samples, np.asarray(want.samples),
                               rtol=1e-3)


# --------------------------------------------------------------------- #
# The port's own sampler: posterior, accounting, inputs
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def posterior(models, prob):
    return run_hmc(models[0], prob["mle"], num_samples=800, num_warmup=400,
                   num_chains=4, step_size=0.1, num_leapfrog=8, randkey=3,
                   init_spread=0.3)


def test_posterior_recovers_gaussian(posterior, prob):
    res = posterior
    assert isinstance(res, HMCResult)
    assert res.samples.shape == (4, 800, N_DIM)
    assert np.all(res.rhat < 1.05), res.rhat
    assert np.all(res.divergences == 0)
    sd = np.sqrt(np.diag(prob["cov"]))
    np.testing.assert_array_less(np.abs(res.mean() - prob["mle"]),
                                 3.0 * sd / np.sqrt(res.ess))
    se_cov = np.sqrt((np.outer(np.diag(prob["cov"]), np.diag(prob["cov"]))
                      + prob["cov"] ** 2) / float(np.min(res.ess)))
    np.testing.assert_array_less(np.abs(res.cov() - prob["cov"]),
                                 3.0 * se_cov)


def test_adaptation_and_accounting(posterior):
    res = posterior
    assert np.all(res.accept_prob > 0.6) and np.all(res.accept_prob < 0.99)
    assert np.all(res.warmup_accept_prob > 0.5)
    assert np.all(res.step_size > 0) and np.all(res.ess > 50)
    s = res.summary()
    assert s["num_chains"] == 4 and s["num_samples"] == 800
    assert s["min_ess"] > 0 and s["divergences"] == [0, 0, 0, 0]
    assert res.potential.shape == (4, 800)


def test_same_randkey_same_draws(models, prob):
    kw = dict(num_samples=10, num_warmup=5, num_chains=2, num_leapfrog=3,
              init_spread=0.1)
    a = run_hmc(models[0], prob["mle"], randkey=7, **kw)
    b = run_hmc(models[0], prob["mle"], randkey=7, **kw)
    c = run_hmc(models[0], prob["mle"], randkey=8, **kw)
    np.testing.assert_array_equal(a.samples, b.samples)
    assert not np.array_equal(a.samples, c.samples)


def test_chain_init_shapes_and_errors(models, prob):
    model = models[0]
    init = np.tile(prob["mle"], (2, 1)) + 0.01
    res = run_hmc(model, init, num_samples=20, num_warmup=10, num_chains=7,
                  num_leapfrog=3, randkey=0)
    assert res.samples.shape == (2, 20, N_DIM)
    with pytest.raises(ValueError, match="init must be"):
        run_hmc(model, np.zeros((2, 2, 2)), num_samples=4, num_warmup=0)
    with pytest.raises(ValueError, match="inv_mass"):
        run_hmc(model, prob["mle"], num_samples=4, num_warmup=0,
                inv_mass=np.ones((N_DIM, N_DIM)))
    with pytest.raises(ValueError, match="strictly positive"):
        run_hmc(model, prob["mle"], num_samples=4, num_warmup=0,
                inv_mass=np.array([1.0, 0.0, 1.0]))


@pytest.mark.parametrize("kwargs", [dict(k_sharded=True)],
                         ids=["k_sharded"])
def test_unported_options_raise(models, prob, kwargs):
    # Sharded chains need a replica axis: on a flat comm k_sharded=True
    # raises, naming the comm that has one (tests/test_torch_sharded_k.py
    # runs it on one).
    with pytest.raises(ValueError, match="ensemble_comm"):
        run_hmc(models[0], prob["mle"], num_samples=2, num_warmup=0,
                **kwargs)


# --------------------------------------------------------------------- #
# Diagnostics: numpy, copied from the JAX package
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("case", ["iid", "stuck", "short", "one_chain"])
def test_diagnostics_equal_jax(case):
    from multigrad_tpu.inference import effective_sample_size as jax_ess
    from multigrad_tpu.inference import split_rhat as jax_rhat
    rng = np.random.default_rng(1)
    draws = {"iid": rng.normal(size=(4, 500, 2)),
             "stuck": rng.normal(size=(4, 500, 1)) + np.array(
                 [10.0, 0.0, 0.0, 0.0])[:, None, None],
             "short": rng.normal(size=(2, 3, 2)),
             "one_chain": np.cumsum(rng.normal(size=(1, 200, 3)), axis=1)
             }[case]
    np.testing.assert_array_equal(split_rhat(draws), jax_rhat(draws))
    np.testing.assert_array_equal(effective_sample_size(draws),
                                  jax_ess(draws))


def test_diagnostics_flag_unmixed_chains():
    rng = np.random.default_rng(2)
    iid = rng.normal(size=(4, 500, 2))
    assert np.all(split_rhat(iid) < 1.02)
    assert np.all(effective_sample_size(iid) > 0.5 * 4 * 500)
    stuck = rng.normal(size=(4, 500, 1))
    stuck[0] += 10.0
    assert split_rhat(stuck)[0] > 1.5
    assert effective_sample_size(stuck)[0] < 100
