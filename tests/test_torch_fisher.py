"""The port's Fisher information and Laplace covariances against closed
forms and the JAX package (the counterparts of ``tests/test_inference.py``'s
Fisher tests).

The linear-Gaussian model (sumstats linear in the parameters, a Gaussian
loss) has every quantity in closed form: the Fisher against it and against
the JAX package's on the same numpy inputs at rtol 1e-4 (the Laplace
covariance rtol 1e-3, as the JAX test); the SMF χ² model's Fisher against
the JAX package's at rtol 1e-3 (float32 counts summed in another order,
then squared through the Jacobian); streamed against resident rtol 1e-4
(the JAX test's limit); ``mode="rev"`` against ``"fwd"`` exactly (both
are reverse mode here); a joint group's Fisher equal to the sum of its
members' to rtol 1e-6 (the same float32 ops).  All on the CPU.
"""
from dataclasses import dataclass, field

import numpy as np
import pytest
import torch

from multigrad_tpu_torch import OnePointGroup
from multigrad_tpu_torch.core.model import OnePointModel
from multigrad_tpu_torch.data import StreamingOnePointModel
from multigrad_tpu_torch.inference import (FisherResult, fisher_diagnostics,
                                           fisher_information,
                                           laplace_covariance,
                                           sumstats_jacobian)
from multigrad_tpu_torch.models import (SMFChi2Model, SMFModel,
                                        aux_from_numpy, make_joint_smf_wprp,
                                        make_smf_data)

CPU = "cpu"
N_ROWS, N_STATS, N_DIM = 64, 4, 3
SMF_HALOS = 4_000
TRUTH = np.array([-2.0, 0.2])


@dataclass
class GaussianLinearModel(OnePointModel):
    """Sumstats linear in params, Gaussian loss: y = Σ_i x_i (u_iᵀ p),
    L = ½ (y-t)ᵀ P (y-t); F = JᵀPJ with J = Σ_i x_i u_iᵀ."""

    aux_data: dict = field(default_factory=dict)

    def calc_partial_sumstats_from_params(self, params, randkey=None):
        x, u = self.aux_data["x"], self.aux_data["u"]
        return (x * (u @ params)[:, None]).sum(dim=0)

    def calc_loss_from_sumstats(self, sumstats, sumstats_aux=None,
                                randkey=None):
        r = sumstats - self.aux_data["target"]
        return 0.5 * r @ self.aux_data["prec"] @ r


def _jax_gaussian_linear(aux):
    """The JAX package's linear-Gaussian model (``tests/test_inference.py``)
    over the same numpy arrays, ``comm=None``."""
    import jax.numpy as jnp
    from multigrad_tpu.core.model import OnePointModel as JaxModel

    @dataclass
    class JaxGaussianLinearModel(JaxModel):
        aux_data: dict = field(default_factory=dict)

        def calc_partial_sumstats_from_params(self, params, randkey=None):
            x = jnp.asarray(self.aux_data["x"])
            u = jnp.asarray(self.aux_data["u"])
            return (x * (u @ params)[:, None]).sum(axis=0)

        def calc_loss_from_sumstats(self, sumstats, sumstats_aux=None,
                                    randkey=None):
            r = sumstats - jnp.asarray(self.aux_data["target"])
            return 0.5 * r @ jnp.asarray(self.aux_data["prec"]) @ r

    return JaxGaussianLinearModel(
        aux_data={k: jnp.asarray(v) for k, v in aux.items()}, comm=None)


@pytest.fixture(scope="module")
def prob():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N_ROWS, N_STATS)).astype(np.float32)
    u = rng.normal(size=(N_ROWS, N_DIM)).astype(np.float32)
    jac = x.T @ u
    prec = np.diag(rng.uniform(0.5, 2.0, N_STATS)).astype(np.float32)
    p_true = np.array([0.5, -0.3, 0.8], np.float32)
    target = (jac @ p_true).astype(np.float32)
    fisher = jac.T @ prec @ jac
    mle = np.linalg.solve(fisher, jac.T @ prec @ target)
    return dict(x=x, u=u, jac=jac, prec=prec, target=target,
                fisher=fisher, mle=mle.astype(np.float32),
                cov=np.linalg.inv(fisher))


@pytest.fixture(scope="module")
def model(prob):
    return GaussianLinearModel(aux_data=aux_from_numpy(
        {k: prob[k] for k in ("x", "u", "target", "prec")}, device=CPU))


def _dense_hessian(prob):
    jac, target, prec = (torch.tensor(prob[k])
                         for k in ("jac", "target", "prec"))

    def loss(p):
        r = jac @ p - target
        return 0.5 * r @ prec @ r
    return torch.autograd.functional.hessian(loss, torch.tensor(prob["mle"]))


@pytest.mark.parametrize("mode", ["fwd", "rev"])
def test_sumstats_jacobian_matches_dense(model, prob, mode):
    y, jac = model.calc_sumstats_and_jac_from_params(prob["mle"], mode=mode)
    assert y.dtype == jac.dtype == torch.float32
    np.testing.assert_allclose(jac.numpy(), prob["jac"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(y.numpy(), prob["jac"] @ prob["mle"],
                               rtol=1e-4, atol=1e-4)


def test_jacobian_mode_is_validated(model, prob):
    with pytest.raises(ValueError, match="mode must be"):
        model.calc_sumstats_and_jac_from_params(prob["mle"], mode="both")


def test_fisher_matches_dense_hessian_and_jax(model, prob):
    fr = fisher_information(model, prob["mle"])
    assert isinstance(fr, FisherResult)
    assert tuple(fr.fisher.shape) == (N_DIM, N_DIM)
    assert tuple(fr.sumstats_hessian.shape) == (N_STATS, N_STATS)
    np.testing.assert_allclose(fr.fisher.numpy(),
                               _dense_hessian(prob).numpy(), rtol=1e-4)
    np.testing.assert_allclose(fr.fisher.numpy(), prob["fisher"], rtol=1e-3)
    from multigrad_tpu.inference import \
        fisher_information as jax_fisher_information
    want = jax_fisher_information(_jax_gaussian_linear(
        {k: prob[k] for k in ("x", "u", "target", "prec")}), prob["mle"])
    for name in ("fisher", "jac", "sumstats", "sumstats_hessian"):
        np.testing.assert_allclose(getattr(fr, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_laplace_covariance_and_stderr(model, prob):
    fr = fisher_information(model, prob["mle"])
    np.testing.assert_allclose(fr.covariance().numpy(), prob["cov"],
                               rtol=1e-3)
    np.testing.assert_allclose(fr.stderr().numpy(),
                               np.sqrt(np.diag(prob["cov"])), rtol=1e-3)
    diag = fr.diagnostics()
    assert diag["identifiable"]
    assert np.isfinite(diag["condition_number"])


def test_laplace_jitter_matches_jax(prob):
    from multigrad_tpu.inference import \
        laplace_covariance as jax_laplace_covariance
    fisher = prob["fisher"].astype(np.float32)
    for jitter in (0.0, 1e-3):
        np.testing.assert_allclose(
            laplace_covariance(torch.tensor(fisher), jitter=jitter).numpy(),
            np.asarray(jax_laplace_covariance(fisher, jitter=jitter)),
            rtol=1e-4)


def test_laplace_pinv_fallback_on_singular():
    singular = torch.tensor(np.diag([1.0, 0.0]).astype(np.float32))
    with pytest.warns(RuntimeWarning, match="not positive definite"):
        cov = laplace_covariance(singular)
    np.testing.assert_allclose(cov.numpy(), np.diag([1.0, 0.0]), atol=1e-6)
    diag = fisher_diagnostics(singular)
    assert diag["n_unidentifiable"] == 1 and not diag["identifiable"]


@pytest.mark.parametrize("case", ["fisher", "singular", "near_singular"])
def test_fisher_diagnostics_match_jax(prob, case):
    from multigrad_tpu.inference import \
        fisher_diagnostics as jax_fisher_diagnostics
    matrix = {"fisher": prob["fisher"].astype(np.float32),
              "singular": np.diag([1.0, 0.0]).astype(np.float32),
              "near_singular": np.array([[1.0, 1.0], [1.0, 1.0 + 1e-7]],
                                        np.float32)}[case]
    got = fisher_diagnostics(torch.tensor(matrix))
    want = jax_fisher_diagnostics(matrix)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["eigvals"], want["eigvals"])
    for key in ("condition_number", "n_unidentifiable", "identifiable"):
        assert got[key] == want[key], key


def test_streaming_fisher_matches_resident(model, prob):
    """The chunk-accumulated Jacobian reproduces the resident one;
    fisher_information takes the streaming wrapper as it is."""
    aux = {k: v for k, v in model.aux_data.items() if k not in ("x", "u")}
    streamed = StreamingOnePointModel(
        model=GaussianLinearModel(aux_data=aux),
        streams={"x": prob["x"], "u": prob["u"]}, chunk_rows=16,
        pad_values=0.0)
    y_s, jac_s = sumstats_jacobian(streamed, prob["mle"])
    y_r, jac_r = sumstats_jacobian(model, prob["mle"])
    np.testing.assert_allclose(y_s.numpy(), y_r.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(jac_s.numpy(), jac_r.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert streamed.last_stats.chunks == N_ROWS // 16
    fr = fisher_information(streamed, prob["mle"])
    np.testing.assert_allclose(fr.fisher.numpy(), prob["fisher"], rtol=1e-3)


@pytest.fixture(scope="module")
def chi2_pair():
    """(JAX SMFChi2Model, port SMFChi2Model) on the same halos."""
    from multigrad_tpu.models.smf import SMFChi2Model as JaxSMFChi2Model
    from multigrad_tpu.models.smf import make_smf_data as jax_make_smf_data
    jax_aux = jax_make_smf_data(SMF_HALOS)
    port_aux = aux_from_numpy({k: (np.asarray(v) if hasattr(v, "shape")
                                   else v) for k, v in jax_aux.items()},
                              device=CPU)
    return JaxSMFChi2Model(aux_data=dict(jax_aux)), \
        SMFChi2Model(aux_data=port_aux)


def test_smf_chi2_fisher_matches_jax(chi2_pair):
    from multigrad_tpu.inference import \
        fisher_information as jax_fisher_information
    jax_model, port_model = chi2_pair
    want = jax_fisher_information(jax_model, TRUTH.astype(np.float32))
    got = fisher_information(port_model, TRUTH)
    np.testing.assert_allclose(got.jac.numpy(), np.asarray(want.jac),
                               rtol=1e-3,
                               atol=1e-6 * float(np.abs(want.jac).max()))
    np.testing.assert_allclose(got.fisher.numpy(), np.asarray(want.fisher),
                               rtol=1e-3)


def test_fisher_on_smf_model_is_sane():
    """On a nonlinear model family: symmetric, positive definite at the
    truth, and the two jac modes agree."""
    m = SMFModel(aux_data=make_smf_data(SMF_HALOS, device=CPU))
    fr = fisher_information(m, TRUTH)
    f = fr.fisher.numpy()
    np.testing.assert_array_equal(f, f.T)
    assert np.all(np.linalg.eigvalsh(f) > 0)
    assert torch.equal(fisher_information(m, TRUTH, mode="rev").fisher,
                       fr.fisher)


@pytest.mark.parametrize("chunk_rows", [512, 1_536])
def test_streamed_smf_chi2_fisher_matches_resident(chunk_rows):
    resident = SMFChi2Model(aux_data=make_smf_data(SMF_HALOS, device=CPU))
    aux = make_smf_data(SMF_HALOS, device=CPU)
    streamed = StreamingOnePointModel(
        model=SMFChi2Model(aux_data=aux),
        streams={"log_halo_masses": aux.pop("log_halo_masses").numpy()},
        chunk_rows=chunk_rows)
    want = fisher_information(resident, TRUTH)
    got = fisher_information(streamed, TRUTH)
    np.testing.assert_allclose(got.fisher.numpy(), want.fisher.numpy(),
                               rtol=1e-4)
    np.testing.assert_allclose(got.sumstats.numpy(), want.sumstats.numpy(),
                               rtol=1e-5)


@dataclass
class _SMFChi2WithAux(SMFChi2Model):
    """χ² SMF whose loss also reads an additive sumstats aux."""

    sumstats_func_has_aux: bool = True

    def calc_partial_sumstats_from_params(self, params, randkey=None):
        y = super().calc_partial_sumstats_from_params(params, randkey)
        return y, torch.sum(y)

    def calc_loss_from_sumstats(self, sumstats, sumstats_aux=None,
                                randkey=None):
        return super().calc_loss_from_sumstats(sumstats) \
            + 10.0 * sumstats_aux * torch.sum(sumstats) ** 2


def test_fisher_reads_the_sumstats_aux():
    resident = _SMFChi2WithAux(aux_data=make_smf_data(SMF_HALOS, device=CPU))
    aux = make_smf_data(SMF_HALOS, device=CPU)
    streamed = StreamingOnePointModel(
        model=_SMFChi2WithAux(aux_data=aux),
        streams={"log_halo_masses": aux.pop("log_halo_masses").numpy()},
        chunk_rows=1_000)
    want = fisher_information(resident, TRUTH)
    got = fisher_information(streamed, TRUTH)
    np.testing.assert_allclose(got.fisher.numpy(), want.fisher.numpy(),
                               rtol=1e-4)
    # The aux term's y–y Hessian, 20·aux on every entry, is in H_y: alone
    # off the diagonal (the χ² term's Hessian is diagonal).
    off = ~torch.eye(10, dtype=torch.bool)
    aux_total = float(resident.calc_sumstats_from_params(TRUTH)[1])
    np.testing.assert_allclose(want.sumstats_hessian[off].numpy(),
                               20.0 * aux_total, rtol=1e-4)


def test_group_fisher_is_sum_of_members():
    group = make_joint_smf_wprp(256, 1_024, device=CPU)
    point = np.array([-1.95, 0.25, -0.9])
    fr = fisher_information(group, point)
    members = [fisher_information(m, point) for m in group.models]
    np.testing.assert_allclose(fr.fisher.numpy(),
                               (members[0].fisher + members[1].fisher)
                               .numpy(), rtol=1e-6)
    n_wp = members[1].sumstats.numel()  # 8 DD bins and the selection
    assert tuple(fr.jac.shape) == (10 + n_wp, 3)
    # The SMF member reads slots (0, 1), the wp(rp) member slots (0, 2).
    assert bool((fr.jac[:10, 2] == 0).all()) and \
        bool((fr.jac[10:, 1] == 0).all())
    hess = fr.sumstats_hessian
    assert tuple(hess.shape) == (10 + n_wp, 10 + n_wp)
    assert bool((hess[:10, 10:] == 0).all())
    assert torch.equal(hess[10:, 10:], members[1].sumstats_hessian)
    np.testing.assert_allclose((fr.jac.T @ hess @ fr.jac).numpy(),
                               fr.fisher.numpy(), rtol=1e-4,
                               atol=1e-6 * float(fr.fisher.abs().max()))
    single = fisher_information(OnePointGroup(models=group.models[0]), point)
    assert torch.equal(single.fisher, members[0].fisher)


@pytest.mark.parametrize("policy", ["dots", "dots_with_no_batch_dims",
                                    "nothing", "everything"])
def test_scan_path_with_matrix_products(model, prob, policy):
    # The linear-Gaussian sumstats are matrix-vector products, which the
    # "dots" policies save and the others recompute: the scan path equals
    # the two-pass path bit for bit under each.
    aux = {k: v for k, v in model.aux_data.items() if k not in ("x", "u")}
    streamed = StreamingOnePointModel(
        model=GaussianLinearModel(aux_data=aux),
        streams={"x": prob["x"], "u": prob["u"]}, chunk_rows=16,
        pad_values=0.0, remat_policy=policy)
    point = prob["mle"] + 0.1
    loss, grad = streamed.calc_loss_and_grad_from_params(point)
    loss_c, grad_c = streamed.calc_loss_and_grad_scan(point)
    assert torch.equal(loss_c, loss) and torch.equal(grad_c, grad)
    _, grad_r = model.calc_loss_and_grad_from_params(point)
    np.testing.assert_allclose(grad.numpy(), grad_r.numpy(), rtol=1e-4,
                               atol=1e-4)
