"""The port's SMF pipeline: the invariants of ``tests/test_smf_pipeline.py``
and parity with the JAX package on identical inputs.

The JAX package's ``make_smf_data`` dict is carried into the port with
``aux_from_numpy``, so both packages fit the same halos, and each
comparison states its float32 tolerance.  All on the CPU, where the
port's counts run the plain versions of its CUDA kernels.  No test here
uses a ``randkey`` against the JAX package: torch's generators do not
reproduce ``jax.random``'s draws.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrad_tpu.models.smf import SMFChi2Model as JaxSMFChi2Model
from multigrad_tpu.models.smf import SMFModel as JaxSMFModel
from multigrad_tpu.models.smf import make_smf_data as jax_make_smf_data
from multigrad_tpu.optim import transforms as jax_tr
from multigrad_tpu.utils.util import \
    latin_hypercube_sampler as jax_lhs_sampler
from multigrad_tpu.utils.util import \
    simple_grad_descent as jax_simple_grad_descent
from multigrad_tpu_torch import util
from multigrad_tpu_torch.models import (ParamTuple, SMFChi2Model, SMFModel,
                                        TARGET_SUMSTATS, aux_from_numpy,
                                        make_smf_data)
from multigrad_tpu_torch.optim import adam
from multigrad_tpu_torch.optim import transforms as tr

NUM_HALOS = 10_000
TRUTH = ParamTuple(log_shmrat=-2.0, sigma_logsm=0.2)
GUESS = ParamTuple(log_shmrat=-1.0, sigma_logsm=0.5)
BOUNDS = [(-3.0, 0.0), (0.05, 1.0)]
CPU = "cpu"


def _to_numpy(aux):
    return {k: (np.asarray(v) if hasattr(v, "shape") else v)
            for k, v in aux.items()}


def _np(x):
    return np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.fixture(scope="module")
def jax_aux():
    return jax_make_smf_data(NUM_HALOS)


@pytest.fixture(scope="module")
def pair(jax_aux):
    """(JAX model, port model) on the same halos."""
    port = SMFModel(aux_data=aux_from_numpy(_to_numpy(jax_aux), device=CPU))
    return JaxSMFModel(aux_data=dict(jax_aux)), port


@pytest.fixture(scope="module")
def model():
    # Self-consistent target, as in test_smf_pipeline.py: gradients
    # vanish at truth only against the port's own float32 sumstats.
    m = SMFModel(aux_data=make_smf_data(NUM_HALOS, device=CPU))
    m.aux_data["target_sumstats"] = m.calc_sumstats_from_params(TRUTH)
    return m


def test_golden_sumstats():
    # The golden target vector at the JAX golden test's tolerance
    # (jnp.allclose defaults: rtol=1e-5, atol=1e-8).
    m = SMFModel(aux_data=make_smf_data(NUM_HALOS, device=CPU))
    np.testing.assert_allclose(_np(m.calc_sumstats_from_params(TRUTH)),
                               TARGET_SUMSTATS, rtol=1e-5, atol=1e-8)


def test_fused_path_consistency(model):
    loss, grad = model.calc_loss_and_grad_from_params(TRUTH)
    np.testing.assert_allclose(_np(loss),
                               _np(model.calc_loss_from_params(TRUTH)),
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(_np(grad),
                               _np(model.calc_dloss_dparams(TRUTH)),
                               rtol=1e-6, atol=1e-12)


def test_gd_stays_at_truth(model):
    gd = model.run_simple_grad_descent(guess=TRUTH, nsteps=2)
    assert abs(float(gd.loss[-1])) <= 1e-8
    np.testing.assert_allclose(_np(gd.params[-1]), np.asarray(TRUTH),
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(_np(model.calc_dloss_dparams(TRUTH)), 0.0,
                               atol=1e-5)


def test_dloss_dsumstats_at_truth(model):
    sumstats = model.calc_sumstats_from_params(TRUTH)
    grad = model.calc_dloss_dsumstats(sumstats)
    assert grad.shape == sumstats.shape
    np.testing.assert_allclose(_np(grad), 0.0, atol=1e-5)


def test_full_fit_recovers_truth():
    m = SMFModel(aux_data=make_smf_data(NUM_HALOS, device=CPU))
    traj = m.run_adam(guess=GUESS, nsteps=300, learning_rate=0.02,
                      progress=False)
    assert tuple(traj.shape) == (301, 2)
    np.testing.assert_allclose(_np(traj[-1]), np.asarray(TRUTH), atol=0.02)


def test_padded_data_gradients_finite():
    # inf-padded halos (the shard padding) must leave loss and gradient
    # as they are: padded particles contribute exactly zero.
    clean = SMFModel(aux_data=make_smf_data(10_001, device=CPU))
    aux = make_smf_data(10_001, device=CPU)
    aux["log_halo_masses"], _ = util.pad_to_multiple(
        aux["log_halo_masses"], 8, pad_value=float("inf"))
    assert aux["log_halo_masses"].shape[0] == 10_008
    padded = SMFModel(aux_data=aux)
    loss_p, grad_p = padded.calc_loss_and_grad_from_params(GUESS)
    assert torch.isfinite(grad_p).all(), f"padded gradient: {grad_p}"
    loss_c, grad_c = clean.calc_loss_and_grad_from_params(GUESS)
    np.testing.assert_allclose(_np(loss_p), _np(loss_c), rtol=1e-5)
    np.testing.assert_allclose(_np(grad_p), _np(grad_c), rtol=1e-4)


@pytest.mark.parametrize("params", [TRUTH, GUESS, (-2.3, 0.35)])
def test_matches_jax_model(pair, params):
    # Each halo's bin mass is a difference of two f32 cdfs near 1, good
    # to one f32 epsilon, and the two packages round z differently; so
    # the densities agree to rtol 1e-5 plus N·eps/(volume·width).  That
    # is up to 4e-4 relative in the sparse last bins, so the log-MSE
    # loss agrees to rtol 5e-4 (atol 1e-8 at truth, where it is ~1e-9
    # noise).  The gradient: rtol 1e-3 as for the kernels, atol 2e-3,
    # the f32 noise floor at truth (the JAX model's own gradient there
    # against TARGET_SUMSTATS is (-3e-4, -1e-3)).
    jm, pm = pair
    atol = NUM_HALOS * np.finfo(np.float32).eps / (10.0 * NUM_HALOS * 0.1)
    np.testing.assert_allclose(_np(pm.calc_sumstats_from_params(params)),
                               _np(jm.calc_sumstats_from_params(params)),
                               rtol=1e-5, atol=atol)
    loss_j, grad_j = jm.calc_loss_and_grad_from_params(params)
    loss_p, grad_p = pm.calc_loss_and_grad_from_params(params)
    np.testing.assert_allclose(_np(loss_p), _np(loss_j), rtol=5e-4,
                               atol=1e-8)
    np.testing.assert_allclose(_np(grad_p), _np(grad_j), rtol=1e-3,
                               atol=2e-3)


def test_chi2_model_matches_jax(jax_aux):
    aux = dict(jax_aux, sigma_frac=0.1)
    jm = JaxSMFChi2Model(aux_data=aux)
    pm = SMFChi2Model(aux_data=aux_from_numpy(_to_numpy(aux), device=CPU))
    loss_j, grad_j = jm.calc_loss_and_grad_from_params(GUESS)
    loss_p, grad_p = pm.calc_loss_and_grad_from_params(GUESS)
    np.testing.assert_allclose(_np(loss_p), _np(loss_j), rtol=1e-4)
    np.testing.assert_allclose(_np(grad_p), _np(grad_j), rtol=1e-3)


@pytest.mark.parametrize("bounds", [None, BOUNDS],
                         ids=["unbounded", "bounded"])
def test_adam_trajectory_matches_jax(pair, bounds):
    # 20 steps of Adam from the same guess: the per-step update is
    # nearly lr·sign(grad), so the f32 differences in the gradient
    # (rtol 1e-3) move the trajectory by far less than atol=1e-4.
    jm, pm = pair
    kw = dict(guess=GUESS, nsteps=20, param_bounds=bounds,
              learning_rate=0.02, progress=False)
    traj_j = _np(jm.run_adam(**kw))
    traj_p = _np(pm.run_adam(**kw))
    assert traj_p.shape == traj_j.shape == (21, 2)
    np.testing.assert_allclose(traj_p, traj_j, rtol=0, atol=1e-4)


def test_bfgs_matches_jax(pair):
    # Both drive scipy's L-BFGS-B to the float32 noise floor; the minima
    # agree to within the f32 flatness of the loss there.
    jm, pm = pair
    res_j = jm.run_bfgs(guess=GUESS, maxsteps=100, progress=False)
    res_p = pm.run_bfgs(guess=GUESS, maxsteps=100, progress=False)
    assert res_p.fun < 1e-6
    np.testing.assert_allclose(res_p.x, res_j.x, atol=2e-3)
    np.testing.assert_allclose(res_p.x, np.asarray(TRUTH), atol=2e-3)


@pytest.mark.parametrize("bounds", [
    [(-3.0, 1.0), (0.1, 2.0)],      # two-sided
    [(-3.0, None), (0.1, None)],    # lower bound only
    [(None, 1.0), (None, 2.0)],     # upper bound only
    [None, None],                   # unbounded
], ids=["two_sided", "low_only", "high_only", "unbounded"])
def test_transforms_match_jax(bounds):
    # Elementwise f32 formulas in both packages: rtol 1e-5.
    params = np.array([-1.2, 0.7], np.float32)
    lo_j, hi_j = jax_tr.bounds_to_arrays(bounds, 2)
    lo_p, hi_p = tr.bounds_to_arrays(bounds, 2, device=CPU)
    u_j = jax_tr.transform_array(jnp.asarray(params), lo_j, hi_j)
    u_p = tr.transform_array(torch.tensor(params), lo_p, hi_p)
    np.testing.assert_allclose(_np(u_p), _np(u_j), rtol=1e-5)
    np.testing.assert_allclose(
        _np(tr.inverse_transform_array(u_p, lo_p, hi_p)),
        _np(jax_tr.inverse_transform_array(u_j, lo_j, hi_j)), rtol=1e-5)
    np.testing.assert_allclose(
        _np(tr.inverse_transform_diag_jacobian(u_p, lo_p, hi_p)),
        _np(jax_tr.inverse_transform_diag_jacobian(u_j, lo_j, hi_j)),
        rtol=1e-5)
    np.testing.assert_allclose(
        _np(tr.apply_transforms(torch.tensor(params), bounds)),
        _np(jax_tr.apply_transforms(params, bounds)), rtol=1e-5)
    for p, b in zip(params, bounds):
        np.testing.assert_allclose(
            _np(tr.transform(float(p), b, device=CPU)),
            _np(jax_tr.transform(float(p), None if b is None else tuple(b))),
            rtol=1e-5)


def test_bounds_validation():
    with pytest.raises(ValueError, match="one entry per parameter"):
        tr.bounds_to_arrays([(0, 1)], 2, device=CPU)
    lo, hi = tr.bounds_to_arrays(BOUNDS, 2, device=CPU)
    with pytest.raises(ValueError, match="strictly inside"):
        tr.check_strictly_inside(torch.tensor([0.0, 0.5]), lo, hi, BOUNDS)


def test_lhs_sampler_matches_jax():
    kw = dict(xmin=[-2.5, 0.1], xmax=[-1.5, 0.4], n_dim=2,
              num_evaluations=6, seed=7)
    np.testing.assert_array_equal(util.latin_hypercube_sampler(**kw),
                                  jax_lhs_sampler(**kw))


def test_simple_grad_descent_autograd_matches_jax():
    # A quadratic bowl through each package's own autodiff: rtol 1e-6.
    def jax_loss(p):
        return jnp.sum((p - jnp.array([1.0, -2.0])) ** 2)

    def torch_loss(p):
        return torch.sum((p - torch.tensor([1.0, -2.0])) ** 2)

    guess = np.array([0.0, 0.0], np.float32)
    j = jax_simple_grad_descent(jax_loss, jnp.asarray(guess), 5, 0.1,
                                progress=False)
    p = util.simple_grad_descent(torch_loss, torch.tensor(guess), 5, 0.1,
                                 progress=False)
    np.testing.assert_allclose(_np(p.loss), _np(j.loss), rtol=1e-6)
    np.testing.assert_allclose(_np(p.params), _np(j.params), rtol=1e-6)


class _AuxSMF(SMFModel):
    """SMF with the reference's aux flags: the sumstats' aux (the total
    count) is passed to the loss, whose own aux is a scaled copy."""

    def calc_partial_sumstats_from_params(self, params, randkey=None):
        y = super().calc_partial_sumstats_from_params(params)
        return y, y.sum()

    def calc_loss_from_sumstats(self, sumstats, sumstats_aux=None,
                                randkey=None):
        loss = super().calc_loss_from_sumstats(sumstats)
        return loss, 2.0 * sumstats_aux


def test_aux_flags_plumbing():
    aux = make_smf_data(2_000, device=CPU)
    plain = SMFModel(aux_data=aux)
    m = _AuxSMF(aux_data=aux, sumstats_func_has_aux=True,
                loss_func_has_aux=True)
    y, total = m.calc_sumstats_from_params(GUESS)
    np.testing.assert_allclose(_np(total), _np(y.sum()), rtol=1e-6)
    (loss, laux), grad = m.calc_loss_and_grad_from_params(GUESS)
    loss_0, grad_0 = plain.calc_loss_and_grad_from_params(GUESS)
    np.testing.assert_allclose(_np(laux), 2.0 * _np(total), rtol=1e-6)
    np.testing.assert_allclose(_np(loss), _np(loss_0), rtol=1e-6)
    np.testing.assert_allclose(_np(grad), _np(grad_0), rtol=1e-6)
    loss_1, laux_1 = m.calc_loss_from_params(GUESS)
    np.testing.assert_allclose(_np(loss_1), _np(loss_0), rtol=1e-6)
    gd = m.run_simple_grad_descent(guess=GUESS, nsteps=2)
    assert tuple(gd.aux.shape) == (2,)


class _NoisySMF(SMFModel):
    """SMF whose halo masses get a draw of noise from the key's
    generator: results with keys match across runs, and the JAX package
    only in distribution (torch does not reproduce jax.random)."""

    def calc_partial_sumstats_from_params(self, params, randkey=None):
        gen = torch.Generator().manual_seed(randkey)
        noise = 0.01 * torch.randn(self.aux_data["log_halo_masses"].shape,
                                   generator=gen)
        aux = dict(self.aux_data,
                   log_halo_masses=self.aux_data["log_halo_masses"] + noise)
        return SMFModel(aux_data=aux).calc_partial_sumstats_from_params(
            params)


def test_randkey_plumbing():
    m = _NoisySMF(aux_data=make_smf_data(2_000, device=CPU))
    a = m.calc_sumstats_from_params(GUESS, randkey=1)
    np.testing.assert_array_equal(_np(a), _np(
        m.calc_sumstats_from_params(GUESS, randkey=1)))
    assert not np.array_equal(_np(a), _np(
        m.calc_sumstats_from_params(GUESS, randkey=2)))
    const = m.run_adam(GUESS, nsteps=3, randkey=5, const_randkey=True,
                       progress=False)
    chain = m.run_adam(GUESS, nsteps=3, randkey=5, progress=False)
    assert torch.isfinite(const).all() and torch.isfinite(chain).all()
    np.testing.assert_array_equal(_np(chain), _np(m.run_adam(
        GUESS, nsteps=3, randkey=5, progress=False)))
    with pytest.raises(ValueError, match="const_randkey"):
        m.run_adam(GUESS, nsteps=1, const_randkey=True, progress=False)
    with pytest.raises(TypeError, match="Must be int"):
        adam.init_randkey("seed")
    k1, k2 = adam.split_key(5)
    assert k1 != k2 and (k1, k2) == adam.split_key(5)
