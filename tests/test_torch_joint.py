"""The port's joint SMF + wp(rp) fit against the JAX package's.

The JAX package's ``make_joint_smf_wprp`` arrays (its SMF halos, its
wp(rp) mock and target) are carried into the port with
``aux_from_numpy``, so both groups compute on identical inputs
(``comm=None``); the JAX side runs its XLA counts on the CPU, the port
its plain versions.  Tolerances: loss rtol 1e-3 and gradient rtol 1e-3,
atol 1e-6 (``tests/test_torch_wprp.py``'s limits: the wp(rp) loss
amplifies the counts' float32 rounding); a member alone against the
JAX package's member at the same limits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrad_tpu.models import joint as jj
from multigrad_tpu_torch.core.group import OnePointGroup
from multigrad_tpu_torch.models import (JOINT_PARAM_NAMES, JOINT_TRUTH,
                                        SMFChi2Model, WprpModel,
                                        aux_from_numpy, make_joint_smf_wprp)
from multigrad_tpu_torch.models import joint as tj

WP_HALOS, SMF_HALOS = 256, 1_024
POINTS = (np.array([-1.8, 0.3, -0.7]), np.array([-2.1, 0.15, -1.2]),
          np.array([-1.95, 0.25, -0.9]))
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _to_numpy(aux):
    return {k: (np.asarray(v) if hasattr(v, "shape") else v)
            for k, v in aux.items()}


@pytest.fixture(scope="module")
def pair():
    ref = jj.make_joint_smf_wprp(WP_HALOS, SMF_HALOS, comm=None)
    smf_aux, wprp_aux = (aux_from_numpy(_to_numpy(m.aux_data), device=CPU)
                         for m in ref.models)
    return ref, tj._joint_group(smf_aux, wprp_aux)


def test_layout_matches_jax():
    assert JOINT_PARAM_NAMES == jj.JOINT_PARAM_NAMES
    np.testing.assert_array_equal(JOINT_TRUTH, jj.JOINT_TRUTH)


def test_structure_matches_jax(pair):
    ref, port = pair
    assert port.fused and ref.fused
    assert [type(m).__name__ for m in port.models] == [
        "ParamView(SMFChi2Model, (0, 1))", "ParamView(WprpModel, (0, 2))"]
    assert [type(m).__name__ for m in ref.models] == [
        type(m).__name__ for m in port.models]
    assert isinstance(port.models[0], SMFChi2Model)
    assert isinstance(port.models[1], WprpModel)


@pytest.mark.parametrize("point", range(len(POINTS)))
def test_group_matches_jax(pair, point):
    ref, port = pair
    params = POINTS[point]
    loss_r, grad_r = ref.calc_loss_and_grad_from_params(
        jnp.asarray(params, jnp.float32))
    loss_p, grad_p = port.calc_loss_and_grad_from_params(params)
    np.testing.assert_allclose(float(loss_p), float(loss_r), rtol=1e-3)
    np.testing.assert_allclose(grad_p.numpy(), np.asarray(grad_r), rtol=1e-3,
                               atol=1e-6)
    assert bool(torch.all(grad_p != 0))


@pytest.mark.parametrize("member", [0, 1])
def test_members_match_jax(pair, member):
    ref, port = pair
    params = POINTS[0]
    loss_r, grad_r = ref.models[member].calc_loss_and_grad_from_params(
        jnp.asarray(params, jnp.float32))
    loss_p, grad_p = port.models[member].calc_loss_and_grad_from_params(
        params)
    np.testing.assert_allclose(float(loss_p), float(loss_r), rtol=1e-3)
    np.testing.assert_allclose(grad_p.numpy(), np.asarray(grad_r), rtol=1e-3,
                               atol=1e-6)
    # The slot the member does not read has an exact zero gradient.
    assert float(grad_p[2 - member]) == 0.0


def test_group_equals_members_alone(pair):
    _, port = pair
    loss, grad = port.calc_loss_and_grad_from_params(POINTS[0])
    parts = [m.calc_loss_and_grad_from_params(POINTS[0])
             for m in port.models]
    np.testing.assert_allclose(float(loss), sum(float(p[0]) for p in parts),
                               rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(),
                               (parts[0][1] + parts[1][1]).numpy(),
                               rtol=1e-6)


@pytest.fixture(scope="module")
def own():
    """The port's own joint group, the SMF target its own sumstats at the
    truth (self-consistent, as ``tests/test_group.py`` sets it): the
    default target is the golden SMF at 10,000 halos, whose chi² at the
    truth is not 0 at another size, in either package."""
    group = make_joint_smf_wprp(WP_HALOS, SMF_HALOS, device=CPU)
    smf = group.models[0]
    smf.aux_data["target_sumstats"] = smf.calc_sumstats_from_params(
        JOINT_TRUTH)
    return group


def test_loss_at_truth_vanishes(own):
    loss, grad = own.calc_loss_and_grad_from_params(JOINT_TRUTH)
    assert float(loss) < 1e-10
    np.testing.assert_allclose(grad.numpy(), 0.0, atol=1e-6)


def test_adam_recovers_truth(own):
    traj = own.run_adam(guess=(-1.7, 0.35, -0.6), nsteps=300,
                        learning_rate=0.02,
                        param_bounds=((-4, 0), (0.01, 1), (-2, 0)),
                        progress=False)
    assert tuple(traj.shape) == (301, 3)
    np.testing.assert_allclose(traj[-1].numpy(), JOINT_TRUTH, atol=0.05)


def test_defaults():
    group = make_joint_smf_wprp(64, device=CPU, seed=3,
                                wprp_kwargs=dict(box_size=50.0))
    assert isinstance(group, OnePointGroup) and group.comm is None
    smf, wprp = group.models
    assert smf.aux_data["log_halo_masses"].shape == (4 * 64,)
    assert wprp.aux_data["box_size"] == 50.0
    assert wprp.aux_data["positions"].shape == (64, 3)
