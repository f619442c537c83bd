"""The port's batched evaluation surface against solo calls and the JAX
package: ``aux_leaves``, ``loss_and_grad_fn``, ``batched_loss_and_grad_fn``
and ``run_lhs_param_scan`` on ``OnePointModel`` and the fused
``OnePointGroup``, ``simple_grad_descent_scan``, and the Adam loop on a
``(K, ndim)`` guess; gloo runs at 2 ranks count the all-reduces.

Tolerances.  A batched row equals the solo call at its parameters bit for
bit (the same ops on the same values), and so does each row of a batched
Adam fit (measured on the CPU, bounded and unbounded: the bijection's
``tan``/``atan`` of a ``(K, 2)`` tensor round as those of a ``(2,)`` one).
Against the JAX package's batched program: the linear-Gaussian model rtol
1e-5 (a few float32 products and sums); the SMF models at the limits of
their solo parity tests (``tests/test_torch_smf.py``: the counts are
summed in another order, so the log-space loss may differ by up to 5e-4
relative, the χ² loss by up to 1e-4, the gradient by up to 1e-3), since a
batched row is the solo call bit for bit, against the JAX package's
Pallas path (the kernels' erf polynomial; measured: losses within 2.1e-5,
gradients within 3.4e-5).  The LHS scan: the same float64 draw; against the JAX
package's Pallas path, sumstats rtol 1e-5 plus N·eps/(volume·width) and
losses at the same model limits (measured: densities within 7.5e-9, the
χ² loss within 1.2e-5, the log-space loss within 1.3e-4).
Gradient-descent scan: rtol 1e-6 (a quadratic bowl, the same float32
ops).  gloo at 2 ranks against 1 process: rtol 1e-6 (the
gradient with atol 1e-7, the JAX package's
``test_fused_multiprobe_matches_disjoint``: a slot whose gradient is 0 at
the truth on one process is 3e-11 on two).

The ranks run this file as a script, so it imports no JAX at the top.
"""
import os
import subprocess
import sys
import tempfile
from dataclasses import dataclass, field

import numpy as np
import pytest
import torch

from multigrad_tpu_torch import OnePointGroup, simple_grad_descent_scan
from multigrad_tpu_torch.core.model import OnePointModel
from multigrad_tpu_torch.models import (SMFChi2Model, SMFModel,
                                        aux_from_numpy, make_joint_smf_wprp,
                                        make_smf_data)
from multigrad_tpu_torch.optim.adam import _run_adam_loop

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
TIMEOUT_S = 120
SMF_HALOS, WP_HALOS = 1_025, 256
# Five rows of (log_shmrat, sigma_logsm) around the SMF truth.
SMF_ROWS = np.array([[-2.0, 0.2], [-1.8, 0.3], [-2.3, 0.35], [-1.6, 0.15],
                     [-2.1, 0.25]], np.float32)
JOINT_ROWS = np.array([[-1.8, 0.3, -0.7], [-2.0, 0.2, -1.0],
                       [-1.7, 0.35, -0.6], [-2.2, 0.25, -0.9],
                       [-1.9, 0.22, -1.2]], np.float32)
LHS = dict(xmins=[-2.1, 0.15], xmaxs=[-1.7, 0.35], n_dim=2,
           num_evaluations=8, seed=4)
# The SMF parity limits of tests/test_torch_smf.py: densities rtol 1e-5
# plus N·eps/(volume·width); the log-space loss rtol 5e-4, the χ² loss
# rtol 1e-4.
SMF_ATOL = 10_000 * np.finfo(np.float32).eps / (10.0 * 10_000 * 0.1)
LOSS_RTOL = {"SMFModel": 5e-4, "SMFChi2Model": 1e-4}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_smf_pair(cls_name, backend="auto"):
    """The JAX package's SMF model and the port's on the same halos."""
    from multigrad_tpu.models import smf as jax_smf
    jax_aux = jax_smf.make_smf_data(10_000, backend=backend)
    arrays = {k: (np.asarray(v) if hasattr(v, "shape") else v)
              for k, v in jax_aux.items()}
    port_cls = {"SMFModel": SMFModel, "SMFChi2Model": SMFChi2Model}[cls_name]
    return (getattr(jax_smf, cls_name)(aux_data=dict(jax_aux)),
            port_cls(aux_data=aux_from_numpy(arrays, device=CPU)))


def _models():
    from test_torch_fisher import GaussianLinearModel
    rng = np.random.default_rng(0)
    gauss = dict(x=rng.normal(size=(64, 4)).astype(np.float32),
                 u=rng.normal(size=(64, 3)).astype(np.float32),
                 target=rng.normal(size=4).astype(np.float32),
                 prec=np.diag(rng.uniform(0.5, 2.0, 4)).astype(np.float32))
    return {
        "SMFModel": (SMFModel(aux_data=make_smf_data(10_000, device=CPU)),
                     SMF_ROWS),
        "SMFChi2Model": (SMFChi2Model(
            aux_data=make_smf_data(10_000, device=CPU)), SMF_ROWS),
        "joint": (make_joint_smf_wprp(WP_HALOS, SMF_HALOS, comm=None,
                                      device=CPU), JOINT_ROWS),
        "gaussian": (GaussianLinearModel(
            aux_data=aux_from_numpy(gauss, device=CPU)),
            rng.normal(size=(5, 3)).astype(np.float32)),
    }


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.mark.parametrize("name", ["SMFModel", "SMFChi2Model", "joint",
                                  "gaussian"])
def test_batched_rows_equal_solo_calls(models, name):
    model, rows = models[name]
    losses, grads = model.batched_loss_and_grad_fn()(
        torch.tensor(rows), model.aux_leaves())
    assert tuple(losses.shape) == (len(rows),)
    assert tuple(grads.shape) == rows.shape
    for k, row in enumerate(rows):
        loss, grad = model.calc_loss_and_grad_from_params(row)
        assert torch.equal(losses[k], loss), (k, losses[k], loss)
        assert torch.equal(grads[k], grad), (k, grads[k], grad)
    one_loss, one_grad = model.batched_loss_and_grad_fn()(
        torch.tensor(rows[:1]), model.aux_leaves())
    assert torch.equal(one_loss, losses[:1])
    assert torch.equal(one_grad, grads[:1])


@pytest.mark.parametrize("name", ["SMFModel", "SMFChi2Model", "joint",
                                  "gaussian"])
def test_loss_and_grad_fn_equals_the_method(models, name):
    model, rows = models[name]
    loss, grad = model.loss_and_grad_fn()(torch.tensor(rows[1]),
                                          model.aux_leaves())
    want = model.calc_loss_and_grad_from_params(rows[1])
    assert torch.equal(loss, want[0]) and torch.equal(grad, want[1])


def test_batched_matches_jax_gaussian(models):
    import jax.numpy as jnp
    from test_torch_fisher import _jax_gaussian_linear
    model, rows = models["gaussian"]
    arrays = {k: v.numpy() for k, v in model.aux_data.items()}
    jm = _jax_gaussian_linear(arrays)
    want = jm.batched_loss_and_grad_fn()(jnp.asarray(rows), jm.aux_leaves(),
                                         jnp.zeros(()))
    got = model.batched_loss_and_grad_fn()(torch.tensor(rows),
                                           model.aux_leaves())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)


@pytest.mark.parametrize("name", ["SMFModel", "SMFChi2Model"])
def test_batched_matches_jax_smf(name):
    # The JAX package's Pallas path (interpret mode): with XLA's CPU erf
    # the χ² loss differs by up to 7e-4 relative at these rows.  The χ²
    # loss at the truth (row 0) is the counts' float32 noise, ~1e-7 here
    # and ~3e-5 in the JAX package, so it runs the other rows.
    import jax.numpy as jnp
    jm, pm = _jax_smf_pair(name, backend="pallas")
    rows = SMF_ROWS if name == "SMFModel" else SMF_ROWS[1:]
    loss_j, grad_j = jm.batched_loss_and_grad_fn()(
        jnp.asarray(rows), jm.aux_leaves(), jnp.zeros(()))
    loss_p, grad_p = pm.batched_loss_and_grad_fn()(torch.tensor(rows),
                                                   pm.aux_leaves())
    np.testing.assert_allclose(loss_p.numpy(), np.asarray(loss_j),
                               rtol=LOSS_RTOL[name], atol=1e-8)
    np.testing.assert_allclose(grad_p.numpy(), np.asarray(grad_j),
                               rtol=1e-3, atol=2e-3)


def test_aux_leaves_rebind_the_data():
    # The same program over another catalog's leaves equals a model built
    # on that catalog; the model's own data is left as it was.
    small = SMFChi2Model(aux_data=make_smf_data(2_000, device=CPU))
    other = make_smf_data(3_000, device=CPU)
    rebuilt = SMFChi2Model(aux_data=other)
    leaves = small.aux_leaves()
    assert [t.shape for t in leaves] == [(2_000,), (11,), (10,)]
    swapped = [other["log_halo_masses"], other["smf_bin_edges"],
               other["target_sumstats"]]
    # volume is a float, not a leaf: rebuild with the same volume.
    rebuilt.aux_data["volume"] = small.aux_data["volume"]
    got = small.batched_loss_and_grad_fn()(torch.tensor(SMF_ROWS), swapped)
    want = rebuilt.batched_loss_and_grad_fn()(torch.tensor(SMF_ROWS),
                                              rebuilt.aux_leaves())
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert small.aux_data["log_halo_masses"].shape == (2_000,)
    with pytest.raises(ValueError, match="aux leaves"):
        small.loss_and_grad_fn()(SMF_ROWS[0], leaves[:2])


def test_batched_with_key_forwards_the_seed():
    seen = []

    @dataclass
    class Keyed(OnePointModel):
        aux_data: dict = field(default_factory=dict)

        def calc_partial_sumstats_from_params(self, params, randkey=None):
            seen.append(randkey)
            return params * self.aux_data["w"]

        def calc_loss_from_sumstats(self, sumstats, sumstats_aux=None,
                                    randkey=None):
            return (sumstats ** 2).sum()

    m = Keyed(aux_data={"w": torch.tensor([1.0, 2.0])})
    losses, grads = m.batched_loss_and_grad_fn(with_key=True)(
        torch.ones(3, 2), m.aux_leaves(), 11)
    assert seen == [11, 11, 11]
    np.testing.assert_allclose(grads.numpy(), [[2.0, 8.0]] * 3)
    m.batched_loss_and_grad_fn()(torch.ones(2, 2), m.aux_leaves(), 11)
    assert seen[3:] == [None, None]


def test_batched_input_errors(models):
    # A flat comm has no replica axis: the K-partitioned program raises,
    # naming the comm that has one.
    model, rows = models["SMFModel"]
    with pytest.raises(ValueError, match="ensemble_comm"):
        model.batched_loss_and_grad_fn(k_sharded=True)
    with pytest.raises(ValueError, match=r"\(K, ndim\)"):
        model.batched_loss_and_grad_fn()(torch.tensor(rows[0]),
                                         model.aux_leaves())
    group, _ = models["joint"]
    with pytest.raises(ValueError, match="ensemble_comm"):
        group.batched_loss_and_grad_fn(k_sharded=True)


def test_unfused_group_refuses_the_programs():
    @dataclass
    class AuxModel(SMFModel):
        def calc_loss_from_sumstats(self, sumstats, sumstats_aux=None,
                                    randkey=None):
            return SMFModel.calc_loss_from_sumstats(self, sumstats), 0.0

    group = OnePointGroup(models=(
        SMFModel(aux_data=make_smf_data(1_000, device=CPU)),
        AuxModel(aux_data=make_smf_data(1_000, device=CPU),
                 loss_func_has_aux=True)))
    assert not group.fused
    for make in (group.loss_and_grad_fn, group.batched_loss_and_grad_fn):
        with pytest.raises(ValueError, match="not fused"):
            make()


def test_group_aux_leaves_are_per_member(models):
    group, _ = models["joint"]
    leaves = group.aux_leaves()
    assert len(leaves) == 2
    assert [len(m) for m in leaves] == [len(m.aux_leaves())
                                        for m in group.models]


# --------------------------------------------------------------------- #
# The Latin-hypercube scan
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("batched", [True, False],
                         ids=["batched", "per_sample"])
@pytest.mark.parametrize("name", ["SMFModel", "SMFChi2Model"])
def test_lhs_scan_matches_jax(name, batched):
    # The JAX package's Pallas path (interpret mode): the kernels' erf
    # polynomial, whose tails XLA's CPU erf does not share (the sparse
    # last bins' densities then differ by up to 2.2e-8, the log-space
    # loss by 0.8%).
    jm, pm = _jax_smf_pair(name, backend="pallas")
    params_j, ss_j, loss_j = jm.run_lhs_param_scan(**LHS, batched=batched)
    params_p, ss_p, loss_p = pm.run_lhs_param_scan(**LHS, batched=batched)
    assert params_p.dtype == np.float64
    np.testing.assert_array_equal(params_p, params_j)
    assert ss_p.shape == (8, 10) and loss_p.shape == (8,)
    np.testing.assert_allclose(ss_p, ss_j, rtol=1e-5, atol=SMF_ATOL)
    np.testing.assert_allclose(loss_p, loss_j, rtol=LOSS_RTOL[name])


def test_lhs_scan_batched_equals_per_sample(models):
    # The scan's one all-reduce of the (K, |y|) rows against the JAX
    # package's per-sample loop of solo calls: equal bit for bit.
    model, _ = models["SMFChi2Model"]
    params, sumstats, losses = model.run_lhs_param_scan(**LHS)
    with torch.no_grad():
        ys = [model.calc_sumstats_from_params(x) for x in params]
        want = [model.calc_loss_from_sumstats(y) for y in ys]
    np.testing.assert_array_equal(sumstats, torch.stack(ys).numpy())
    np.testing.assert_array_equal(losses, torch.stack(want).numpy())


@pytest.mark.parametrize("flag", ["sumstats_func_has_aux",
                                  "loss_func_has_aux"])
def test_lhs_scan_with_aux(flag):
    @dataclass
    class AuxSMF(SMFModel):
        def calc_partial_sumstats_from_params(self, params, randkey=None):
            y = SMFModel.calc_partial_sumstats_from_params(self, params)
            return (y, y.sum()) if self.sumstats_func_has_aux else y

        def calc_loss_from_sumstats(self, sumstats, sumstats_aux=None,
                                    randkey=None):
            loss = SMFModel.calc_loss_from_sumstats(self, sumstats)
            if self.sumstats_func_has_aux:
                loss = loss + 0.0 * sumstats_aux
            return (loss, sumstats.sum()) if self.loss_func_has_aux \
                else loss

    model = AuxSMF(aux_data=make_smf_data(2_000, device=CPU), **{flag: True})
    plain = SMFModel(aux_data=model.aux_data)
    want = plain.run_lhs_param_scan(**LHS)
    for batched in (True, False):
        got = model.run_lhs_param_scan(**LHS, batched=batched)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------- #
# simple_grad_descent_scan
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("has_aux", [False, True])
def test_grad_descent_scan_matches_jax(has_aux):
    import jax
    import jax.numpy as jnp
    from multigrad_tpu.utils.util import \
        simple_grad_descent_scan as jax_scan
    center = np.array([1.5, -0.5], np.float32)

    def jax_fn(p):
        loss, grad = jax.value_and_grad(
            lambda q: jnp.sum((q - center) ** 2))(p)
        return ((loss, 2.0 * loss) if has_aux else loss), grad

    def port_fn(p):
        loss = torch.sum((p - torch.tensor(center)) ** 2)
        grad = 2.0 * (p - torch.tensor(center))
        return ((loss, 2.0 * loss) if has_aux else loss), grad

    want = jax_scan(jax_fn, np.zeros(2, np.float32), 25, 0.1,
                    has_aux=has_aux)
    got = simple_grad_descent_scan(port_fn, np.zeros(2, np.float32), 25,
                                   0.1, has_aux=has_aux)
    assert tuple(got.params.shape) == (25, 2)
    assert torch.equal(got.params[0], torch.zeros(2))  # before the update
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=1e-6)
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params),
                               rtol=1e-6)
    if has_aux:
        np.testing.assert_allclose(got.aux.numpy(), np.asarray(want.aux),
                                   rtol=1e-6)
    else:
        assert len(got.aux) == len(want.aux) == 25
        assert all(float(a) == 0.0 for a in got.aux)


def test_grad_descent_scan_on_a_model(models):
    model, _ = models["SMFChi2Model"]
    res = simple_grad_descent_scan(model.calc_loss_and_grad_from_params,
                                   np.array([-1.9, 0.25], np.float32), 5,
                                   1e-12)
    loop = model.run_simple_grad_descent(np.array([-1.9, 0.25]), nsteps=5,
                                         learning_rate=1e-12)
    assert torch.equal(res.params, loop.params)
    assert torch.equal(res.loss, loop.loss)


# --------------------------------------------------------------------- #
# run_adam on a (K, ndim) guess
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("bounds", [None, [(-4.0, 0.0), (0.02, 1.0)]],
                         ids=["unbounded", "bounded"])
def test_adam_on_a_batch_is_independent_fits(models, bounds):
    model, _ = models["SMFChi2Model"]
    program = model.batched_loss_and_grad_fn()
    leaves = model.aux_leaves()
    losses_seen = []

    def batched(p):
        losses, grads = program(p, leaves)
        losses_seen.append(losses)
        return losses, grads

    inits = torch.tensor(SMF_ROWS[1:])
    traj = _run_adam_loop(batched, inits, nsteps=15, param_bounds=bounds,
                          learning_rate=0.05, progress=False, device=CPU)
    assert tuple(traj.shape) == (16, 4, 2)
    assert tuple(losses_seen[0].shape) == (4,)
    for k in range(4):
        solo = model.run_adam(guess=SMF_ROWS[1 + k], nsteps=15,
                              param_bounds=bounds, learning_rate=0.05,
                              progress=False)
        assert torch.equal(traj[:, k], solo), k


def test_adam_batch_bounds_and_checkpoint(models, tmp_path):
    model, _ = models["SMFChi2Model"]
    program = model.batched_loss_and_grad_fn()
    leaves = model.aux_leaves()

    def batched(p):
        return program(p, leaves)

    bounds = [(-4.0, 0.0), (0.02, 1.0)]
    outside = torch.tensor([[-2.0, 0.2], [-2.0, 1.5]])
    with pytest.raises(ValueError, match="strictly inside"):
        _run_adam_loop(batched, outside, nsteps=2, param_bounds=bounds,
                       progress=False)
    inits = torch.tensor(SMF_ROWS[1:])
    plain = _run_adam_loop(batched, inits, nsteps=6, param_bounds=bounds,
                           learning_rate=0.05, progress=False)
    kw = dict(nsteps=6, param_bounds=bounds, learning_rate=0.05,
              progress=False, checkpoint_dir=str(tmp_path),
              checkpoint_every=2, data=model.aux_data)
    first = _run_adam_loop(batched, inits, **kw)
    again = _run_adam_loop(batched, inits, **kw)   # a pure read
    assert torch.equal(first, plain) and torch.equal(again, plain)
    with pytest.raises(ValueError, match="different fit configuration"):
        _run_adam_loop(batched, inits + 0.01, **kw)


# --------------------------------------------------------------------- #
# gloo ranks: 2 all-reduces a batched evaluation, whatever K
# --------------------------------------------------------------------- #
def _run_rank(rank, world, init_file, out_file):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    torch.set_num_threads(2)
    try:
        _batched_rank(out_file)
    finally:
        dist.destroy_process_group()


def _count_all_reduces(fn):
    import torch.distributed as dist
    sizes = []
    real = dist.all_reduce

    def counting(tensor, *args, **kwargs):
        sizes.append(tensor.numel())
        return real(tensor, *args, **kwargs)

    dist.all_reduce = counting
    try:
        out = fn()
    finally:
        dist.all_reduce = real
    return out, sizes


def _evaluations(comm):
    """The batched SMF χ² model and joint group at K = 1 and K = 5, on
    ``comm`` (``None``: one process): ``{label: (losses, grads)}``."""
    smf = SMFChi2Model(aux_data=make_smf_data(SMF_HALOS, comm=comm,
                                              device=CPU), comm=comm)
    group = make_joint_smf_wprp(WP_HALOS, SMF_HALOS, comm=comm, device=CPU)
    out = {}
    for label, model, rows in (("smf", smf, SMF_ROWS),
                               ("joint", group, JOINT_ROWS)):
        program = model.batched_loss_and_grad_fn()
        for k in (1, 5):
            out[f"{label}{k}"] = lambda p=program, m=model, r=rows[:k]: p(
                torch.tensor(r), m.aux_leaves())
    return out


def _batched_rank(out_file):
    from multigrad_tpu_torch import global_comm
    saved = {}
    for label, fn in _evaluations(global_comm()).items():
        (losses, grads), sizes = _count_all_reduces(fn)
        saved.update({f"{label}_loss": losses.numpy(),
                      f"{label}_grad": grads.numpy(),
                      f"{label}_sizes": np.array(sizes)})
    np.savez(out_file, **saved)


@pytest.fixture(scope="module")
def ranks():
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "init")
        outs = [os.path.join(tmp, f"rank{r}.npz") for r in range(2)]
        env = dict(os.environ, PYTHONPATH=REPO_ROOT, OMP_NUM_THREADS="2")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), "2",
             init_file, outs[r]], cwd=REPO_ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=TIMEOUT_S)[0].decode())
        except subprocess.TimeoutExpired:
            pytest.fail(f"a rank did not finish within {TIMEOUT_S} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, text in zip(procs, logs):
            assert p.returncode == 0, text
        return [dict(np.load(o)) for o in outs]


@pytest.mark.parametrize("label,sizes", [
    ("smf1", [10, 2]), ("smf5", [50, 10]),
    # Every row's 10 SMF bins, 8 DD bins and selected weight, then the
    # (K, 3) joint gradient.
    ("joint1", [19, 3]), ("joint5", [95, 15])])
def test_gloo_two_all_reduces_whatever_k(ranks, label, sizes):
    for r in ranks:
        assert r[f"{label}_sizes"].tolist() == sizes


@pytest.mark.parametrize("label", ["smf1", "smf5", "joint1", "joint5"])
def test_gloo_matches_one_process(ranks, label):
    losses, grads = _evaluations(None)[label]()
    for r in ranks:
        np.testing.assert_array_equal(r[f"{label}_loss"],
                                      ranks[0][f"{label}_loss"])
        np.testing.assert_allclose(r[f"{label}_loss"], losses.numpy(),
                                   rtol=1e-6)
        np.testing.assert_allclose(r[f"{label}_grad"], grads.numpy(),
                                   rtol=1e-6, atol=1e-7)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    _run_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
