"""The port's wp(rp) and ξ(r) clustering models against the JAX package's.

The JAX package's ``make_wprp_data`` / ``make_xi_data`` dicts (its mock,
its target) are carried into the port with ``aux_from_numpy``, so both
models compute on identical inputs (``comm=None``: one block).  The JAX
side runs its XLA pair counts on the CPU.  Tolerances: sumstats rtol 1e-4
(the same bin masks, float32 sums in another order), loss rtol 1e-3 and
gradient rtol 1e-3 (the loss is a normalised squared difference of wp
values near the target, which amplifies the counts' relative rounding),
Adam trajectories atol 1e-4.  ``make_galaxy_mock`` draws from a
``torch.Generator``, so the port's mock matches the JAX package's in
distribution only; that test states its comparison.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrad_tpu.models import wprp as jw
from multigrad_tpu_torch.models import (WprpModel, WprpParams, XiModel,
                                        aux_from_numpy, make_galaxy_mock,
                                        make_wprp_data, make_xi_data,
                                        selection_weights, shard_catalog)
from multigrad_tpu_torch.models import wprp as tw

N_HALOS = 512
BOX = 60.0
POINTS = (WprpParams(-1.9, -0.9), WprpParams(-2.05, -1.1))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _to_numpy(aux):
    return {k: (np.asarray(v) if hasattr(v, "shape") else v)
            for k, v in aux.items()}


def _pair(kind):
    if kind == "wprp":
        aux = jw.make_wprp_data(N_HALOS, BOX, seed=2)
        cls, jcls = WprpModel, jw.WprpModel
    else:
        aux = jw.make_xi_data(N_HALOS, BOX, seed=6)
        cls, jcls = XiModel, jw.XiModel
    return jcls(aux_data=aux), cls(aux_data=aux_from_numpy(_to_numpy(aux),
                                                           device="cpu"))


@pytest.fixture(scope="module", params=["wprp", "xi"])
def pair(request):
    return _pair(request.param)


def test_aux_from_numpy_drops_jax_only_keys():
    aux = _to_numpy(jw.make_wprp_data(64, BOX, seed=0))
    port = aux_from_numpy(aux, device="cpu")
    assert "ring_axis" not in port and "backend" not in port
    assert port["pimax"] == 20.0 and port["box_size"] == BOX
    assert port["positions"].shape == (64, 3)
    assert port["positions"].dtype == torch.float32


@pytest.mark.parametrize("point", range(len(POINTS)))
def test_model_matches_jax(pair, point):
    ref, port = pair
    params = POINTS[point]
    want_y = np.asarray(ref.calc_sumstats_from_params(jnp.asarray(params)))
    got_y = port.calc_sumstats_from_params(params).numpy()
    assert got_y.shape == want_y.shape
    np.testing.assert_allclose(got_y, want_y, rtol=1e-4)
    loss_r, grad_r = ref.calc_loss_and_grad_from_params(jnp.asarray(params))
    loss_p, grad_p = port.calc_loss_and_grad_from_params(params)
    np.testing.assert_allclose(float(loss_p), float(loss_r), rtol=1e-3)
    np.testing.assert_allclose(grad_p.numpy(), np.asarray(grad_r), rtol=1e-3,
                               atol=1e-6)
    assert bool(torch.all(grad_p != 0))


def test_loss_and_gradient_vanish_at_truth():
    # Own data: the target comes from the same kernel (here the plain
    # version) at the same float32 parameters, so the loss is exactly 0.
    for model in (WprpModel(aux_data=make_wprp_data(N_HALOS, BOX, seed=2,
                                                    device="cpu")),
                  XiModel(aux_data=make_xi_data(N_HALOS, BOX, seed=6,
                                                device="cpu"))):
        loss, grad = model.calc_loss_and_grad_from_params(tw.TRUTH)
        assert float(loss) < 1e-10
        np.testing.assert_allclose(grad.numpy(), 0.0, atol=1e-6)


def test_adam_trajectory_matches_jax():
    ref, port = _pair("wprp")
    guess = WprpParams(-1.8, -0.8)
    want = np.asarray(ref.run_adam(guess=jnp.asarray(guess), nsteps=15,
                                   learning_rate=0.02, progress=False))
    got = port.run_adam(guess=guess, nsteps=15, learning_rate=0.02,
                        progress=False).numpy()
    assert got.shape == want.shape == (16, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_adam_recovers_truth():
    # tests/test_pairwise.py:170-175, on the port's own mock.
    model = WprpModel(aux_data=make_wprp_data(N_HALOS, BOX, seed=2,
                                              device="cpu"))
    traj = model.run_adam(guess=WprpParams(-1.8, -0.8), nsteps=150,
                          learning_rate=0.02, progress=False)
    final = traj[-1].numpy()
    np.testing.assert_allclose(final, np.asarray(tw.TRUTH), atol=0.05)
    assert float(model.calc_loss_from_params(final)) < 1e-3


def test_row_chunk_changes_nothing_but_the_order_of_sums():
    whole = WprpModel(aux_data=make_wprp_data(N_HALOS, BOX, seed=3,
                                              device="cpu"))
    chunked = WprpModel(aux_data=make_wprp_data(N_HALOS, BOX, seed=3,
                                                row_chunk=100,
                                                device="cpu"))
    params = POINTS[0]
    np.testing.assert_allclose(
        chunked.calc_sumstats_from_params(params).numpy(),
        whole.calc_sumstats_from_params(params).numpy(), rtol=1e-6)
    np.testing.assert_allclose(
        chunked.calc_dloss_dparams(params).numpy(),
        whole.calc_dloss_dparams(params).numpy(), rtol=1e-4, atol=1e-7)


def test_selection_weights_match_jax():
    logm = np.linspace(9.5, 12.5, 41).astype(np.float32)
    for params in (tw.TRUTH, POINTS[1]):
        np.testing.assert_allclose(
            selection_weights(torch.tensor(logm), params).numpy(),
            np.asarray(jw.selection_weights(jnp.asarray(logm), params)),
            rtol=1e-6, atol=1e-7)
    # The -1e9 padding weighs exactly 0 with gradient 0.
    p = torch.tensor([-2.0, -1.0], requires_grad=True)
    w = selection_weights(torch.tensor([-1e9, 11.0]), p)
    assert float(w[0].detach()) == 0.0
    (g,) = torch.autograd.grad(w[0], p)
    assert torch.equal(g, torch.zeros(2))


def test_make_galaxy_mock_matches_in_distribution():
    # The draws are torch's, not jax.random's, so only the construction
    # and the distributions can agree: identical parent masses (not
    # random), positions inside the box, satellite masses uniform in
    # [10, 11) (means within 0.03 at 4,000 satellites, 4 sigma of the
    # mean of a uniform), satellites within a few sat_sigma of a parent,
    # and the same small-scale wp(rp) target (the first four bins, where
    # the satellites' one-halo signal makes wp > 10) to 20%: two
    # realizations of the same clustering; the larger scales are
    # dominated by the realization's noise.
    n, box = 5_000, 100.0
    pos, logm = make_galaxy_mock(n, box, seed=0, device="cpu")
    jpos, jlogm = (np.asarray(x) for x in jw.make_galaxy_mock(n, box,
                                                               seed=0))
    pos, logm = pos.numpy(), logm.numpy()
    assert pos.shape == jpos.shape and logm.shape == jlogm.shape
    assert pos.dtype == np.float32 and logm.dtype == np.float32
    n_parents = n // 5
    np.testing.assert_allclose(logm[:n_parents], jlogm[:n_parents],
                               rtol=1e-6)
    assert pos.min() >= 0.0 and pos.max() < box
    sats, jsats = logm[n_parents:], jlogm[n_parents:]
    assert 10.0 <= sats.min() and sats.max() < 11.0
    assert abs(sats.mean() - jsats.mean()) < 0.03
    host = np.arange(n - n_parents) % n_parents
    d = pos[n_parents:] - pos[host]
    d = d - box * np.round(d / box)
    assert abs(d.std() - 1.5) < 0.05 and np.abs(d).max() < 10 * 1.5
    got = make_wprp_data(n, box, device="cpu")["target_wp"].numpy()
    want = np.asarray(jw.make_wprp_data(n, box)["target_wp"])
    assert np.all(want[:4] > 10)
    np.testing.assert_allclose(got[:4], want[:4], rtol=0.2)


def test_shard_catalog_pads_neutrally():
    class _Rank:
        rank, size = 2, 3

    pos = torch.arange(30.0).reshape(10, 3)
    logm = torch.linspace(10, 12, 10)
    assert shard_catalog(pos, logm, None) == (pos, logm)
    p, m = shard_catalog(pos, logm, _Rank())
    assert p.shape == (4, 3) and m.shape == (4,)
    np.testing.assert_array_equal(p[-2:].numpy(), 0.0)
    np.testing.assert_array_equal(m[-2:].numpy(), -1e9)
