"""The port's multi-start Adam ensembles (``inference/ensemble.py``)
against the JAX package's and against solo fits (the counterparts of
``tests/test_inference.py:293-348``).

Tolerances.  On the linear-Gaussian model the ensemble's finals against
the JAX package's on the same starts (explicit, and drawn in the bounds
box by the same Latin-hypercube design): rtol 1e-4 (measured 1.2e-6), and
the starts equal.  Each row of an ensemble equals a solo ``run_adam`` from
its start bit for bit, on the SMF χ² model and the joint group, bounded
and not (measured on the CPU).  The memory model and K helpers equal the
JAX package's at 4-byte items.  The L-BFGS polish on the
linear-Gaussian model: the best start against the JAX package's and the
MLE at atol 1e-3 (the JAX test's limit; measured 4.8e-7 and 1.9e-6), each
start's final against the JAX package's at atol 1e-4 (measured 1.1e-6);
on the SMF χ² model each start equals a solo ``run_lbfgs_scan`` on one
row of the batched call bit for bit.  The SMF model is not held against
the JAX package's ensemble: its loss differs from the JAX package's by up
to 7e-4 relative (``tests/test_torch_smf.py``), and a start still
converging after 200 steps moves by up to 4e-3 with it.
"""
from dataclasses import dataclass, field

import numpy as np
import pytest
import torch

from multigrad_tpu_torch.core.model import OnePointModel
from multigrad_tpu_torch.inference import (EnsembleResult,
                                           batched_fit_wrapper,
                                           ensemble_memory_model,
                                           hmc_init_from_ensemble,
                                           max_k_for_budget,
                                           resolve_k_sharded,
                                           run_multistart_adam,
                                           run_multistart_lbfgs)
from multigrad_tpu_torch.inference import ensemble as ens_mod
from multigrad_tpu_torch.telemetry import (AlertEngine, LiveSink,
                                           MemorySink, MetricsLogger)
from multigrad_tpu_torch.models import (SMFChi2Model, aux_from_numpy,
                                        make_joint_smf_wprp, make_smf_data)
from test_torch_fisher import GaussianLinearModel, _jax_gaussian_linear

CPU = "cpu"
N_DIM = 3
SMF_BOUNDS = [(-4.0, 0.0), (0.02, 1.0)]


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
    return dict(aux=dict(x=x, u=u, target=target, prec=prec),
                mle=mle.astype(np.float32))


@pytest.fixture(scope="module")
def models(prob):
    return (GaussianLinearModel(aux_data=aux_from_numpy(prob["aux"],
                                                        device=CPU)),
            _jax_gaussian_linear(prob["aux"]))


@pytest.fixture(scope="module")
def smf():
    return SMFChi2Model(aux_data=make_smf_data(10_000, device=CPU))


@pytest.mark.parametrize("how", ["inits", "bounds"])
def test_ensemble_matches_jax(models, prob, how):
    from multigrad_tpu.inference import \
        run_multistart_adam as jax_run_multistart_adam
    pm, jm = models
    kw = dict(inits=np.array([[0.1, 0.2, -0.4], [-1.0, 0.5, 0.3]],
                             np.float32), bound_fits=False) \
        if how == "inits" else dict(param_bounds=[(-3.0, 3.0)] * N_DIM,
                                    n_starts=6, seed=0)
    want = jax_run_multistart_adam(jm, nsteps=300, learning_rate=0.05, **kw)
    got = run_multistart_adam(pm, nsteps=300, learning_rate=0.05, **kw)
    assert isinstance(got, EnsembleResult) and not got.k_sharded
    np.testing.assert_array_equal(got.inits.numpy(), np.asarray(want.inits))
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params),
                               rtol=1e-4)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses),
                               rtol=1e-3, atol=1e-5)
    assert got.n_starts == want.n_starts
    if how == "bounds":
        np.testing.assert_allclose(got.best_params.numpy(), prob["mle"],
                                   atol=5e-2)
        assert got.best_loss == pytest.approx(float(got.losses.min()))


@pytest.mark.parametrize("bounds", [None, SMF_BOUNDS],
                         ids=["unbounded", "bounded"])
def test_rows_equal_solo_fits(smf, bounds):
    inits = np.array([[-1.0, 0.5], [-3.0, 0.3], [-2.2, 0.15], [-1.5, 0.8]],
                     np.float32)
    ens = run_multistart_adam(smf, inits=inits, nsteps=30,
                              learning_rate=0.05, param_bounds=bounds)
    for k in range(len(inits)):
        solo = smf.run_adam(guess=inits[k], nsteps=30, learning_rate=0.05,
                            param_bounds=bounds, progress=False)
        assert torch.equal(ens.params[k], solo[-1]), k
        loss, _ = smf.calc_loss_and_grad_from_params(solo[-1])
        assert torch.equal(ens.losses[k], loss), k


def test_joint_group_ensemble_rows_equal_solo_fits():
    group = make_joint_smf_wprp(256, 1_024, comm=None, device=CPU)
    inits = np.array([[-1.8, 0.3, -0.7], [-1.7, 0.35, -0.6],
                      [-2.1, 0.25, -1.1]], np.float32)
    bounds = [(-4.0, 0.0), (0.01, 1.0), (-2.0, 0.0)]
    ens = run_multistart_adam(group, inits=inits, nsteps=10,
                              learning_rate=0.02, param_bounds=bounds)
    for k in range(3):
        solo = group.run_adam(guess=inits[k], nsteps=10, learning_rate=0.02,
                              param_bounds=bounds, progress=False)
        assert torch.equal(ens.params[k], solo[-1]), k


def test_best_start_skips_non_finite_losses():
    @dataclass
    class Bowl(OnePointModel):
        """A bowl around c whose loss is NaN where p[0] > 5."""
        aux_data: dict = field(default_factory=dict)

        def calc_partial_sumstats_from_params(self, params, randkey=None):
            return params - self.aux_data["c"]

        def calc_loss_from_sumstats(self, sumstats, sumstats_aux=None,
                                    randkey=None):
            loss = torch.sum(sumstats ** 2)
            return torch.where(sumstats[0] > 4.0, float("nan"), loss)

    m = Bowl(aux_data={"c": torch.tensor([1.0, 1.0])})
    ens = run_multistart_adam(m, inits=[[10.0, 10.0], [3.0, 3.0],
                                        [1.5, 1.5]], nsteps=3,
                              learning_rate=0.01)
    assert torch.isnan(ens.losses[0])
    assert int(torch.argmin(ens.losses[1:])) + 1 == 2
    assert torch.equal(ens.best_params, ens.params[2])
    assert ens.basin_spread() == pytest.approx(float(np.linalg.norm(
        ens.params[0].numpy() - ens.params[2].numpy())))


def test_ensemble_input_errors(smf):
    with pytest.raises(ValueError, match="param_bounds"):
        run_multistart_adam(smf, n_starts=2, nsteps=2)
    with pytest.raises(ValueError, match="finite"):
        run_multistart_adam(smf, param_bounds=[(None, 1.0)] * 2,
                            n_starts=2, nsteps=2)
    with pytest.raises(ValueError, match="finite"):
        run_multistart_adam(smf, param_bounds=[(-4.0, 0.0), None],
                            n_starts=2, nsteps=2)
    with pytest.raises(ValueError, match="inits must be"):
        run_multistart_adam(smf, inits=[-2.0, 0.2], nsteps=2)
    with pytest.raises(ValueError, match="const_randkey"):
        run_multistart_adam(smf, inits=[[-2.0, 0.2]], nsteps=2,
                            const_randkey=True)
    # No replica axis on a flat comm: k_sharded=True raises, naming the
    # comm that has one.
    with pytest.raises(ValueError, match="ensemble_comm"):
        run_multistart_adam(smf, inits=[[-2.0, 0.2]], nsteps=2,
                            k_sharded=True)
    # The monitoring arguments work: each gives the fit without them.
    plain = run_multistart_adam(smf, inits=[[-2.0, 0.2]], nsteps=2)
    for name, value in (("telemetry", MetricsLogger(MemorySink())),
                        ("log_every", 5), ("live", LiveSink()),
                        ("alerts", AlertEngine())):
        ens = run_multistart_adam(smf, inits=[[-2.0, 0.2]], nsteps=2,
                                  **{name: value})
        assert torch.equal(ens.params, plain.params), name


def test_sample_inits_match_jax():
    from multigrad_tpu.inference.ensemble import \
        _sample_inits as jax_sample_inits
    got = ens_mod._sample_inits(SMF_BOUNDS, 8, 2, 0)
    want = np.asarray(jax_sample_inits(SMF_BOUNDS, 8, 2, 0))
    np.testing.assert_array_equal(got.astype(np.float32), want)
    low, high = np.array(SMF_BOUNDS).T
    pad = 0.05 * (high - low)
    assert np.all(got > low + pad - 1e-12) and np.all(got < high - pad)


def test_wrapper_is_cached_on_the_model(smf):
    a = batched_fit_wrapper(smf, False)
    assert batched_fit_wrapper(smf, False) is a
    assert batched_fit_wrapper(smf, True) is not a
    rows = torch.tensor([[-2.0, 0.2], [-1.8, 0.3]])
    losses, grads = a(rows, None, smf.aux_leaves())
    want = smf.batched_loss_and_grad_fn()(rows, smf.aux_leaves())
    assert torch.equal(losses, want[0]) and torch.equal(grads, want[1])


@pytest.mark.parametrize("kw", [
    dict(k=8, ndim=2, nsteps=200), dict(k=33, ndim=10, nsteps=1000,
                                        n_replicas=4),
    dict(k=5, ndim=3, nsteps=50, n_replicas=2, catalog_bytes=1 << 30,
         n_devices=8)])
def test_memory_model_matches_jax(kw):
    from multigrad_tpu.inference import ensemble as jax_ens
    k, ndim, nsteps = kw.pop("k"), kw.pop("ndim"), kw.pop("nsteps")
    assert ensemble_memory_model(k, ndim, nsteps, **kw) == \
        jax_ens.ensemble_memory_model(k, ndim, nsteps, itemsize=4, **kw)
    for budget in (1 << 20, 1 << 30, 100):
        assert max_k_for_budget(budget, ndim, nsteps, **kw) == \
            jax_ens.max_k_for_budget(budget, ndim, nsteps, itemsize=4, **kw)


def test_k_helpers(smf):
    from multigrad_tpu.inference import ensemble as jax_ens
    for bucket, sharded, r in ((8, True, 4), (6, True, 4), (1, True, 2),
                               (8, False, 4)):
        assert ens_mod.k_shards_bucket(bucket, sharded, r) == \
            jax_ens.k_shards_bucket(bucket, sharded, r)
    rows = np.arange(10.0, dtype=np.float32).reshape(5, 2)
    padded, k = ens_mod.pad_k_to_replicas(torch.tensor(rows), 4)
    want, k_j = jax_ens.pad_k_to_replicas(rows, 4)
    assert k == k_j == 5
    np.testing.assert_array_equal(padded.numpy(), np.asarray(want))
    # A flat comm has no replica axis: "auto" resolves to replicated,
    # whatever the budget, and True raises naming ensemble_comm.
    assert resolve_k_sharded(smf, 64, 2, 10_000, k_budget_bytes=1) is False
    assert ens_mod.resolve_k_shard_topology(smf) == (False, 1)
    with pytest.raises(ValueError, match="ensemble_comm"):
        resolve_k_sharded(smf, 8, 2, 10, k_sharded=True)
    with pytest.raises(ValueError, match="k_sharded must be"):
        resolve_k_sharded(smf, 8, 2, 10, k_sharded="yes")


def test_hmc_init_from_ensemble(models, prob):
    pm, _ = models
    ens = run_multistart_adam(pm, param_bounds=[(-3.0, 3.0)] * N_DIM,
                              n_starts=4, nsteps=100, learning_rate=0.05)
    init = hmc_init_from_ensemble(ens, num_chains=5, spread=0.1, randkey=0)
    assert tuple(init.shape) == (5, N_DIM) and init.dtype == torch.float32
    d = np.linalg.norm(init.numpy() - ens.best_params.numpy(), axis=1)
    assert np.all(d > 0) and np.all(d < 2.0)
    assert torch.equal(init, hmc_init_from_ensemble(ens, num_chains=5,
                                                    spread=0.1, randkey=0))
    stderr = np.array([1e-3, 1.0, 1e3])
    scaled = hmc_init_from_ensemble(ens, num_chains=5, spread=0.1,
                                    randkey=0, stderr=stderr)
    # The same standard normals, scaled a component by spread · stderr.
    np.testing.assert_allclose(
        (scaled - ens.best_params).numpy(),
        (init - ens.best_params).numpy() * stderr, rtol=1e-4, atol=1e-6)


# --------------------------------------------------------------------- #
# The L-BFGS polish
# --------------------------------------------------------------------- #
POLISH_OFFSETS = np.array([[0.2, -0.1, 0.1], [-0.3, 0.2, -0.2]], np.float32)


def test_multistart_lbfgs_polish_matches_jax(models, prob):
    from multigrad_tpu.inference import \
        run_multistart_lbfgs as jax_run_multistart_lbfgs
    pm, jm = models
    inits = np.tile(prob["mle"], (2, 1)) + POLISH_OFFSETS
    got = run_multistart_lbfgs(pm, inits=inits, maxsteps=60)
    want = jax_run_multistart_lbfgs(jm, inits=inits, maxsteps=60)
    assert isinstance(got, EnsembleResult) and got.n_starts == 2
    np.testing.assert_allclose(got.best_params.numpy(), prob["mle"],
                               atol=1e-3)
    np.testing.assert_allclose(got.best_params.numpy(),
                               np.asarray(want.best_params), atol=1e-3)
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params),
                               atol=1e-4)
    assert got.best_loss == pytest.approx(float(got.losses.min()))
    np.testing.assert_array_equal(got.inits.numpy(), inits)


def test_multistart_lbfgs_starts_are_solo_fits(smf):
    from multigrad_tpu_torch import run_lbfgs_scan
    inits = np.array([[-1.9, 0.25], [-2.3, 0.15]], np.float32)
    ens = run_multistart_lbfgs(smf, inits=inits, maxsteps=8,
                               param_bounds=SMF_BOUNDS)
    row = ens_mod._lbfgs_polish_objective(smf, False)
    for k in range(2):
        p, losses = run_lbfgs_scan(row, torch.tensor(inits[k]), maxsteps=8,
                                   param_bounds=SMF_BOUNDS)
        assert torch.equal(ens.params[k], p) and torch.equal(
            ens.losses[k], losses[-1]), k
    # The row is the model's own loss and gradient.
    loss, grad = row(torch.tensor([-2.0, 0.2]))
    want = smf.calc_loss_and_grad_from_params(torch.tensor([-2.0, 0.2]))
    assert torch.equal(loss, want[0]) and torch.equal(grad, want[1])


def test_lbfgs_polish_objective_is_cached_on_the_model(smf):
    a = ens_mod._lbfgs_polish_objective(smf, False)
    assert ens_mod._lbfgs_polish_objective(smf, False) is a
    assert ens_mod._lbfgs_polish_objective(smf, True) is not a
    other = SMFChi2Model(aux_data=make_smf_data(1_000, device=CPU))
    assert ens_mod._lbfgs_polish_objective(other, False) is not a


def test_multistart_lbfgs_samples_or_raises(smf):
    with pytest.raises(ValueError, match="param_bounds"):
        run_multistart_lbfgs(smf, n_starts=2, maxsteps=2)
    ens = run_multistart_lbfgs(smf, param_bounds=SMF_BOUNDS, n_starts=3,
                               maxsteps=2, seed=1)
    np.testing.assert_array_equal(
        ens.inits.numpy(),
        ens_mod._sample_inits(SMF_BOUNDS, 3, 2, 1).astype(np.float32))
    assert tuple(ens.params.shape) == (3, 2) and ens.losses.shape == (3,)
