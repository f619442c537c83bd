"""The port's composition surface against the JAX package's.

Single-process counterparts of ``tests/test_group.py`` (two SMF models of
different sizes with self-consistent targets, ``comm=None``), the label
rule of ``split_subcomms``, ``all_gather`` / ``scatter_from_local``,
``utils.debug`` and ``ingraph`` (a host loop stands in for the JAX
package's in-graph ``lax.scan``; the test says so where it compares), and
gloo runs of the joint SMF + wp(rp) group: the fused path at 2 ranks
(exactly 2 all-reduces an evaluation) and the disjoint-subcomm host path
at 3 ranks (``split_subcomms(ranks_per_group=[1, 2])``).

The ranks run this file as a script, so it imports no JAX at the top:
the tests that compare with the JAX package import it inside.  Each rank
is joined with a hard timeout, so a hung collective fails the test.

Tolerances: a group against the sum of its members alone rtol 1e-6 (the
same float32 ops); against the JAX package's group on the same numpy
inputs loss rtol 1e-4 and gradient rtol 1e-3 (``tests/test_torch_smf.py``'s
model limits, float32 sums in another order); gloo runs against one
process loss rtol 1e-5, gradient rtol 1e-4, atol 1e-7 (the JAX package's
``test_fused_multiprobe_matches_disjoint``); fits recover the truth within
the JAX tests' limits.
"""
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from multigrad_tpu_torch import (OnePointGroup, all_gather, global_comm,
                                 ingraph, param_view, scatter_from_local,
                                 split_subcomms, split_subcomms_by_node)
from multigrad_tpu_torch.models import (JOINT_TRUTH, ParamTuple, SMFModel,
                                        SMFChi2Model, WprpModel,
                                        aux_from_numpy, make_joint_smf_wprp,
                                        make_smf_data, make_wprp_data)
from multigrad_tpu_torch.parallel.mesh import MeshComm, _group_labels
from multigrad_tpu_torch.utils import debug

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
TRUTH = ParamTuple(-2.0, 0.2)
TIMEOUT_S = 120
# The joint group of the gloo runs: 1,025 SMF halos (ragged over 2 ranks)
# and 256 wp(rp) halos, evaluated away from the truth.
SMF_HALOS, WP_HALOS = 1_025, 256
POINT = np.array([-1.8, 0.3, -0.7])
INGRAPH_LR, INGRAPH_STEPS = 3e-4, 50


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _smf(num_halos):
    model = SMFModel(aux_data=make_smf_data(num_halos, device=CPU))
    # Self-consistent target (tests/test_group.py): the model's own
    # float32 sumstats at the truth.
    model.aux_data["target_sumstats"] = model.calc_sumstats_from_params(
        TRUTH)
    return model


@pytest.fixture(scope="module")
def group_and_models():
    m1, m2 = _smf(10_000), _smf(20_000)
    return OnePointGroup(models=(m1, m2)), (m1, m2)


def _assert_group_sums(group, models, params):
    loss, grad = group.calc_loss_and_grad_from_params(params)
    parts = [m.calc_loss_and_grad_from_params(params) for m in models]
    np.testing.assert_allclose(float(loss), sum(float(p[0]) for p in parts),
                               rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), sum(p[1] for p in parts).numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("path", ["fused", "host"])
def test_group_sums_losses_and_grads(group_and_models, monkeypatch, path):
    group, models = group_and_models
    if path == "host":
        monkeypatch.setattr(OnePointGroup, "fused",
                            property(lambda self: False))
    assert group.fused == (path == "fused")
    _assert_group_sums(group, models, (-1.8, 0.3))


def test_single_model_group(group_and_models):
    _, (m1, _) = group_and_models
    group = OnePointGroup(models=m1)
    assert isinstance(group.models, tuple) and group.fused
    loss, _ = group.calc_loss_and_grad_from_params(TRUTH)
    np.testing.assert_allclose(
        float(loss), float(m1.calc_loss_and_grad_from_params(TRUTH)[0]),
        rtol=1e-6)


def test_group_bfgs(group_and_models):
    group, _ = group_and_models
    result = group.run_bfgs(guess=ParamTuple(-1.5, 0.4), maxsteps=100,
                            param_bounds=[(-4.0, 0.0), (0.01, 1.0)],
                            progress=False)
    assert result.fun < 1e-9
    np.testing.assert_allclose(result.x, [*TRUTH], atol=1e-3)


def test_group_adam(group_and_models):
    group, _ = group_and_models
    traj = group.run_adam(guess=ParamTuple(-1.8, 0.3), nsteps=100,
                          learning_rate=0.02, progress=False)
    assert tuple(traj.shape) == (101, 2)
    np.testing.assert_allclose(traj[-1].numpy(), [*TRUTH], atol=0.05)


def test_group_simple_gd(group_and_models):
    group, _ = group_and_models
    res = group.run_simple_grad_descent(guess=np.array([*TRUTH]), nsteps=2)
    assert abs(float(res.loss[-1])) < 1e-8
    np.testing.assert_allclose(res.params[-1].numpy(), [*TRUTH], rtol=1e-5)


def test_fused_none_comm_group_is_fused():
    m = _smf(1_000)
    group = OnePointGroup(models=(m, m))
    assert group.fused and group.comm is None


def test_shared_comm_group_is_fused_and_split_is_not():
    comm = global_comm()
    m1 = SMFModel(aux_data=make_smf_data(1_000, device=CPU), comm=comm)
    m2 = SMFModel(aux_data=make_smf_data(2_000, device=CPU),
                  comm=MeshComm())
    assert OnePointGroup(models=(m1, m2)).fused
    other = SMFModel(aux_data=m1.aux_data, comm=MeshComm(group=object()))
    disjoint = OnePointGroup(models=(m1, other))
    assert not disjoint.fused
    with pytest.raises(ValueError, match="not fused"):
        disjoint.comm


def test_fused_matches_componentwise_sum(group_and_models):
    group, models = group_and_models
    _assert_group_sums(group, models, np.array([-1.8, 0.3]))


def test_fused_adam_matches_host_loop(group_and_models, monkeypatch):
    # tests/test_group.py's test: both paths take the same steps.
    group, _ = group_and_models
    kwargs = dict(guess=ParamTuple(-1.8, 0.3), nsteps=25,
                  learning_rate=0.02, randkey=7,
                  param_bounds=[(-4.0, 0.0), (0.01, 1.0)], progress=False)
    fused = group.run_adam(**kwargs)
    monkeypatch.setattr(OnePointGroup, "fused", property(lambda self: False))
    host = group.run_adam(**kwargs)
    np.testing.assert_allclose(fused.numpy(), host.numpy(), rtol=1e-5,
                               atol=1e-7)


def test_fused_group_checkpoint_resume(group_and_models, tmp_path):
    group, _ = group_and_models
    kwargs = dict(guess=ParamTuple(-1.8, 0.3), nsteps=20,
                  learning_rate=0.02, progress=False,
                  checkpoint_dir=str(tmp_path), checkpoint_every=5)
    traj = group.run_adam(**kwargs)
    assert torch.equal(traj, group.run_adam(**kwargs))
    plain = dict(kwargs, checkpoint_dir=None)
    assert torch.equal(traj, group.run_adam(**plain))


class _AuxSMF(SMFModel):
    def calc_loss_from_sumstats(self, sumstats, sumstats_aux=None,
                                randkey=None):
        base = super().calc_loss_from_sumstats(sumstats)
        return base, torch.stack([base, 2.0 * base])


def test_aux_member_group_sums_scalar_losses(tmp_path):
    data = make_smf_data(4_000, device=CPU)
    aux_m = _AuxSMF(aux_data=data, loss_func_has_aux=True)
    plain = SMFModel(aux_data=data)
    group = OnePointGroup(models=(aux_m, plain))
    assert not group.fused
    p = ParamTuple(-1.8, 0.3)
    loss, grad = group.calc_loss_and_grad_from_params(p)
    (l_aux, _), g_aux = aux_m.calc_loss_and_grad_from_params(p)
    l_plain, g_plain = plain.calc_loss_and_grad_from_params(p)
    np.testing.assert_allclose(float(loss), float(l_aux) + float(l_plain),
                               rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), (g_aux + g_plain).numpy(),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="loss_func_has_aux"):
        group.run_adam(guess=p, nsteps=2, checkpoint_dir=str(tmp_path),
                       progress=False)


def test_group_rejects_non_models():
    with pytest.raises(TypeError, match="OnePointModel"):
        OnePointGroup(models=())
    with pytest.raises(TypeError, match="OnePointModel"):
        OnePointGroup(models=("smf",))


def test_group_matches_jax_group():
    # The JAX package's group of two SMF models and the port's, on the
    # same numpy inputs (its data, its self-consistent targets).
    import jax.numpy as jnp

    import multigrad_tpu as jmgt
    from multigrad_tpu.models.smf import SMFModel as JaxSMF
    from multigrad_tpu.models.smf import make_smf_data as jax_data

    jax_models, port_models = [], []
    for n in (10_000, 20_000):
        jm = JaxSMF(aux_data=jax_data(n))
        jm.aux_data["target_sumstats"] = jm.calc_sumstats_from_params(
            jnp.asarray(TRUTH))
        jax_models.append(jm)
        aux = {k: (np.asarray(v) if hasattr(v, "shape") else v)
               for k, v in jm.aux_data.items()}
        port_models.append(SMFModel(aux_data=aux_from_numpy(aux,
                                                            device=CPU)))
    params = np.array([-1.8, 0.3], np.float32)
    want_l, want_g = jmgt.OnePointGroup(models=tuple(jax_models)) \
        .calc_loss_and_grad_from_params(jnp.asarray(params))
    got_l, got_g = OnePointGroup(models=tuple(port_models)) \
        .calc_loss_and_grad_from_params(params)
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-4)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-3)


# --------------------------------------------------------------------- #
# param_view
# --------------------------------------------------------------------- #
def test_param_view_slices_and_scatters_grads():
    smf = _smf(4_000)
    group = OnePointGroup(models=(param_view(smf, [0, 2]),))
    joint = np.array([-1.8, 5.0, 0.3, 7.0])
    loss, grad = group.calc_loss_and_grad_from_params(joint)
    want_l, want_g = smf.calc_loss_and_grad_from_params((-1.8, 0.3))
    np.testing.assert_allclose(float(loss), float(want_l), rtol=1e-6)
    np.testing.assert_allclose(grad[[0, 2]].numpy(), want_g.numpy(),
                               rtol=1e-6)
    # Slots no member reads get an exact zero.
    assert float(grad[1]) == 0.0 and float(grad[3]) == 0.0


def test_param_view_model_standalone():
    smf = _smf(4_000)
    view = param_view(smf, [0, 1])
    assert type(view).__name__ == "ParamView(SMFModel, (0, 1))"
    assert view.aux_data is smf.aux_data and type(smf) is SMFModel
    np.testing.assert_allclose(
        view.calc_sumstats_from_params(JOINT_TRUTH).numpy(),
        smf.calc_sumstats_from_params(TRUTH).numpy(), rtol=1e-6)
    # The wrapped model still runs alone, on its own two parameters.
    assert smf.calc_sumstats_from_params(TRUTH).shape == (10,)


def test_param_view_forwards_randkey_only_when_given():
    seen = []

    class Keyed(SMFModel):
        def calc_partial_sumstats_from_params(self, params, randkey=None):
            seen.append(randkey)
            return super().calc_partial_sumstats_from_params(params)

    view = param_view(Keyed(aux_data=make_smf_data(1_000, device=CPU)),
                      [1, 0])
    view.calc_sumstats_from_params((0.2, -2.0))
    view.calc_sumstats_from_params((0.2, -2.0), randkey=3)
    assert seen == [None, 3]


def test_param_view_rejects_bad_indices():
    smf = _smf(1_000)
    with pytest.raises(ValueError, match="non-negative"):
        param_view(smf, [0, -1])
    with pytest.raises(ValueError, match="at least one index"):
        param_view(smf, [])
    view = param_view(smf, [0, 3])
    with pytest.raises(ValueError, match="out of range"):
        view.calc_sumstats_from_params(JOINT_TRUTH)


# --------------------------------------------------------------------- #
# split_subcomms, all_gather, scatter_from_local, debug, ingraph
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("size,num_groups", [(8, 5), (6, 4), (8, 2),
                                             (3, 2)])
def test_split_labels_match_jax(size, num_groups):
    # The JAX package's split over `size` of the suite's 8 CPU devices:
    # each device's group, against the port's label of each rank.
    import jax

    import multigrad_tpu as jmgt
    comm = jmgt.MeshComm(jax.devices()[:size])
    subcomms, n, _ = jmgt.split_subcomms(num_groups=num_groups, comm=comm)
    group_of = {d.id: g for g, sc in enumerate(subcomms)
                for d in sc.devices}
    want = [group_of[d.id] for d in comm.devices]
    labels, got_n = _group_labels(size, num_groups=num_groups)
    assert got_n == n == num_groups
    assert labels.tolist() == want
    if (size, num_groups) == (8, 5):
        assert np.bincount(labels).tolist() == [1, 1, 2, 2, 2]


def test_split_size_mismatch_errors():
    with pytest.raises(ValueError, match="either num_groups OR"):
        _group_labels(4, num_groups=2, ranks_per_group=[2, 2])
    with pytest.raises(ValueError, match="either num_groups OR"):
        _group_labels(4)
    with pytest.raises(ValueError, match="more subcomms"):
        _group_labels(4, num_groups=5)
    with pytest.raises(ValueError, match="must equal comm.size"):
        _group_labels(4, ranks_per_group=[1, 2])
    assert _group_labels(4, ranks_per_group=[1, 3])[0].tolist() == \
        [0, 1, 1, 1]


def test_split_without_torch_distributed():
    subcomms, n, my_group = split_subcomms(num_groups=1)
    assert (n, my_group, len(subcomms)) == (1, 0, 1)
    assert subcomms[0].size == 1 and subcomms[0].is_member
    assert split_subcomms(ranks_per_group=[1])[1] == 1
    with pytest.raises(ValueError, match="more subcomms"):
        split_subcomms(num_groups=2)
    subcomms, n, my_group = split_subcomms_by_node()
    assert (n, my_group, subcomms[0].size) == (1, 0, 1)


def test_collectives_identity_without_a_comm():
    x = torch.arange(6.0).reshape(2, 3)
    assert all_gather(x) is x and all_gather(x, comm=MeshComm()) is x
    assert torch.equal(scatter_from_local(x, MeshComm()), x)
    assert torch.equal(scatter_from_local(x.numpy(), None), x)
    assert debug.replication_spread(x, None) == 0.0
    assert debug.assert_replicated(x, MeshComm()) is x


def test_ingraph_distribute_data_single_process():
    data = np.arange(10.0)
    assert torch.equal(ingraph.distribute_data(data, device=CPU),
                       torch.arange(10.0, dtype=torch.float64))


class _Rank:
    """A stand-in comm of 4 processes, seen from rank 3."""
    rank, size = 3, 4


def test_ingraph_distribute_data_ragged_pads():
    # tests/test_ingraph.py's ragged case: 10 rows over 4 shards pad to
    # 12; the last shard holds rows 9 and the two pad rows.
    shard = ingraph.distribute_data(np.arange(10.0), comm=_Rank(),
                                    pad_value=0.0, device=CPU)
    np.testing.assert_array_equal(shard.numpy(), [9.0, 0.0, 0.0])


def _quadratic(dd, params):
    """Per-shard quadratic: |x p - t|²; additive over shards."""
    resid = dd["x"] * params[0] - dd["t"]
    return torch.sum(resid ** 2), torch.stack([torch.sum(2 * resid
                                                         * dd["x"])])


def _quadratic_data(comm=None):
    x = np.arange(1.0, 17.0, dtype=np.float32)
    return {"x": ingraph.distribute_data(x, comm=comm, device=CPU),
            "t": ingraph.distribute_data(2.0 * x, comm=comm, device=CPU)}


def test_ingraph_simple_grad_descent_converges():
    df = ingraph.simple_grad_descent(_quadratic_data(), _quadratic,
                                     guess=np.array([0.0]),
                                     learning_rate=INGRAPH_LR, nsteps=200,
                                     device=CPU)
    assert len(df) == 200 and list(df.columns) == ["loss", "params"]
    np.testing.assert_allclose(np.asarray(df["params"].iloc[-1]), [2.0],
                               atol=1e-3)
    assert df["loss"].iloc[-1] < df["loss"].iloc[0]


def test_ingraph_matches_jax_scan():
    # The port's host loop stands in for the JAX package's lax.scan: the
    # same losses and points, step for step, on the same data.
    import jax.numpy as jnp

    from multigrad_tpu import ingraph as jax_ingraph

    def jax_fn(dd, params):
        resid = dd["x"] * params[0] - dd["t"]
        return jnp.sum(resid ** 2), jnp.array(
            [jnp.sum(2.0 * resid * dd["x"])])

    x = np.arange(1.0, 17.0, dtype=np.float32)
    want = jax_ingraph.simple_grad_descent(
        {"x": x, "t": 2.0 * x}, jax_fn, guess=jnp.array([0.0]),
        learning_rate=INGRAPH_LR, nsteps=INGRAPH_STEPS, comm=None)
    got = ingraph.simple_grad_descent(
        _quadratic_data(), _quadratic, guess=np.array([0.0]),
        learning_rate=INGRAPH_LR, nsteps=INGRAPH_STEPS, device=CPU)
    # Losses to rtol 1e-5, or 1e-6 absolute once the fit has converged:
    # float32 residuals of targets up to 32 round at ~2e-6.
    np.testing.assert_allclose(np.asarray(got["loss"].tolist()),
                               np.asarray(want["loss"].tolist()), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.stack(got["params"].tolist()),
                               np.stack(want["params"].tolist()),
                               rtol=1e-5, atol=1e-7)


def test_ingraph_without_pandas(monkeypatch):
    monkeypatch.setitem(sys.modules, "pandas", None)
    out = ingraph.simple_grad_descent(_quadratic_data(), _quadratic,
                                      guess=np.array([0.0]),
                                      learning_rate=INGRAPH_LR, nsteps=5,
                                      device=CPU)
    assert set(out) == {"loss", "params"}
    assert out["loss"].shape == (5,) and out["params"].shape == (5, 1)


# --------------------------------------------------------------------- #
# gloo ranks
# --------------------------------------------------------------------- #
def _run_rank(kind, rank, world, init_file, out_file):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    torch.set_num_threads(2)
    try:
        {"fused": _fused_rank, "disjoint": _disjoint_rank}[kind](
            rank, out_file)
    finally:
        dist.destroy_process_group()


def _fused_rank(rank, out_file):
    """The joint group on one shared comm of 2 ranks, all-reduces counted;
    all_gather, scatter_from_local and ingraph over the same ranks."""
    import torch.distributed as dist
    comm = global_comm()
    group = make_joint_smf_wprp(WP_HALOS, SMF_HALOS, comm="auto", device=CPU)
    sizes = []
    real = dist.all_reduce

    def counting(tensor, *args, **kwargs):
        sizes.append(tensor.numel())
        return real(tensor, *args, **kwargs)

    dist.all_reduce = counting
    try:
        loss, grad = group.calc_loss_and_grad_from_params(POINT)
    finally:
        dist.all_reduce = real
    debug.assert_replicated((loss, grad), comm, name="joint (loss, grad)")

    x = torch.arange(6.0).reshape(2, 3) + 10 * rank
    local = scatter_from_local(np.ones((rank + 1, 3), np.float32), comm)
    try:
        scatter_from_local(torch.ones(2, rank + 2), comm)
        ragged = ""
    except ValueError as e:
        ragged = str(e)
    df = ingraph.simple_grad_descent(
        _quadratic_data(comm), _quadratic, guess=np.array([0.0]),
        learning_rate=INGRAPH_LR, nsteps=INGRAPH_STEPS, comm=comm,
        device=CPU)
    np.savez(out_file, fused=group.fused, loss=loss.numpy(),
             grad=grad.numpy(), sizes=np.array(sizes),
             gather0=all_gather(x, comm).numpy(),
             gather1=all_gather(x, comm, axis=1).numpy(),
             local=local.numpy(), ragged=ragged,
             losses=np.asarray(df["loss"].tolist()),
             points=np.stack(df["params"].tolist()))


def _disjoint_rank(rank, out_file):
    """SMF on a comm of rank 0 and wp(rp) on one of ranks 1-2; a member
    whose comm a process is not in holds no data there."""
    subcomms, n, my_group = split_subcomms(ranks_per_group=[1, 2])
    other = subcomms[1 - my_group]
    try:
        other.rank
        non_member = ""
    except ValueError as e:
        non_member = str(e)
    smf_aux = make_smf_data(SMF_HALOS, comm=subcomms[0], device=CPU) \
        if my_group == 0 else None
    wprp_aux = make_wprp_data(WP_HALOS, comm=subcomms[1], device=CPU) \
        if my_group == 1 else None
    group = OnePointGroup(models=(
        param_view(SMFChi2Model(aux_data=smf_aux, comm=subcomms[0]), [0, 1]),
        param_view(WprpModel(aux_data=wprp_aux, comm=subcomms[1]), [0, 2])))
    loss, grad = group.calc_loss_and_grad_from_params(POINT)
    world = global_comm()
    debug.assert_replicated(grad, world, name="joint gradient")
    # A rank made to diverge (in float64, where + rank is exact).
    diverged_grad = grad.double() + rank
    spread = debug.replication_spread(diverged_grad, world)
    try:
        debug.assert_replicated(diverged_grad, world, name="diverged")
        diverged = ""
    except AssertionError as e:
        diverged = str(e)
    try:
        group.run_adam(guess=POINT, nsteps=2, progress=False,
                       checkpoint_dir=os.path.dirname(out_file))
        ckpt_error = ""
    except ValueError as e:
        ckpt_error = str(e)
    traj = group.run_adam(guess=POINT, nsteps=5, learning_rate=0.02,
                          progress=False)
    halves, n_halves, _ = split_subcomms(num_groups=2)
    nodes, n_nodes, my_node = split_subcomms_by_node()
    np.savez(out_file, fused=group.fused, my_group=my_group, n=n,
             member=[c.is_member for c in subcomms],
             size=subcomms[my_group].size, sub_rank=subcomms[my_group].rank,
             non_member=non_member, loss=loss.numpy(), grad=grad.numpy(),
             spread=spread, diverged=diverged, ckpt_error=ckpt_error,
             traj=traj.numpy(), halves=[len(c.ranks) for c in halves],
             nodes=[n_nodes, my_node, nodes[0].size])


def _launch(kind, world):
    """Run this file as ``world`` rank processes of ``kind``; return each
    rank's saved arrays."""
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "init")
        outs = [os.path.join(tmp, f"rank{r}.npz") for r in range(world)]
        env = dict(os.environ, PYTHONPATH=REPO_ROOT, OMP_NUM_THREADS="2")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), kind, str(r),
             str(world), init_file, outs[r]], cwd=REPO_ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)]
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


@pytest.fixture(scope="module")
def single_group():
    """The joint group on one process (fused, comm=None)."""
    return make_joint_smf_wprp(WP_HALOS, SMF_HALOS, comm="auto", device=CPU)


@pytest.fixture(scope="module")
def fused_ranks():
    return _launch("fused", 2)


@pytest.fixture(scope="module")
def disjoint_ranks():
    return _launch("disjoint", 3)


def _assert_matches_single(ranks, single_group):
    loss, grad = single_group.calc_loss_and_grad_from_params(POINT)
    for r in ranks:
        np.testing.assert_array_equal(r["loss"], ranks[0]["loss"])
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-5)
        np.testing.assert_allclose(r["grad"], grad.numpy(), rtol=1e-4,
                                   atol=1e-7)


def test_fused_gloo_matches_single_process(fused_ranks, single_group):
    assert single_group.fused and single_group.comm is None
    assert all(bool(r["fused"]) for r in fused_ranks)
    _assert_matches_single(fused_ranks, single_group)


def test_fused_gloo_two_all_reduces_an_evaluation(fused_ranks):
    # One all-reduce of both members' sumstats (10 SMF bins + 8 DD bins +
    # the selected weight), one of the joint gradient: (19 + 3)·4 bytes.
    for r in fused_ranks:
        assert r["sizes"].tolist() == [19, 3]


def test_all_gather_and_scatter_from_local_gloo(fused_ranks):
    x = [np.arange(6.0).reshape(2, 3) + 10 * r for r in range(2)]
    for r, got in enumerate(fused_ranks):
        np.testing.assert_array_equal(got["gather0"], np.concatenate(x))
        np.testing.assert_array_equal(got["gather1"], np.concatenate(x, 1))
        assert got["local"].shape == (r + 1, 3)
        assert "differ off axis 0" in str(got["ragged"])


def test_ingraph_gloo_matches_single_process(fused_ranks):
    single = ingraph.simple_grad_descent(
        _quadratic_data(), _quadratic, guess=np.array([0.0]),
        learning_rate=INGRAPH_LR, nsteps=INGRAPH_STEPS, device=CPU)
    for r in fused_ranks:
        np.testing.assert_allclose(r["losses"],
                                   np.asarray(single["loss"].tolist()),
                                   rtol=1e-4)
        np.testing.assert_allclose(r["points"],
                                   np.stack(single["params"].tolist()),
                                   rtol=1e-5, atol=1e-7)


def test_disjoint_gloo_matches_fused_single_process(disjoint_ranks,
                                                    single_group):
    # The JAX package's test_fused_multiprobe_matches_disjoint.
    assert not any(bool(r["fused"]) for r in disjoint_ranks)
    _assert_matches_single(disjoint_ranks, single_group)


def test_disjoint_gloo_adam_matches_single_process(disjoint_ranks,
                                                   single_group):
    want = single_group.run_adam(guess=POINT, nsteps=5, learning_rate=0.02,
                                 progress=False).numpy()
    for r in disjoint_ranks:
        np.testing.assert_array_equal(r["traj"], disjoint_ranks[0]["traj"])
        np.testing.assert_allclose(r["traj"], want, rtol=0, atol=1e-5)


def test_split_subcomms_gloo_membership(disjoint_ranks):
    assert [int(r["my_group"]) for r in disjoint_ranks] == [0, 1, 1]
    assert [int(r["size"]) for r in disjoint_ranks] == [1, 2, 2]
    assert [int(r["sub_rank"]) for r in disjoint_ranks] == [0, 0, 1]
    for r in disjoint_ranks:
        assert int(r["n"]) == 2
        assert r["member"].tolist() == [int(r["my_group"]) == 0,
                                        int(r["my_group"]) == 1]
        assert "not a member" in str(r["non_member"])
        assert r["halves"].tolist() == [1, 2]
        # One host: one group of every rank.
        assert r["nodes"].tolist() == [1, 0, 3]


def test_assert_replicated_gloo(disjoint_ranks):
    for r in disjoint_ranks:
        # grad + rank differs by 2 between ranks 0 and 2.
        assert float(r["spread"]) == 2.0
        assert "replication invariant violated: diverged" in str(
            r["diverged"])


def test_disjoint_group_checkpoint_raises_gloo(disjoint_ranks):
    for r in disjoint_ranks:
        msg = str(r["ckpt_error"])
        assert "fused" in msg and "loss_func_has_aux" in msg


if __name__ == "__main__":
    _run_rank(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
              sys.argv[5])
