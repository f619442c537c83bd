"""The port's comm over ``torch.distributed``: a 2-rank gloo run of the SMF
model against the single-process run, and the world-size-1 identity.

Each rank is a process of its own that holds its shard of the halos,
as in the original MPI multigrad.  The ranks run this file as a script
(it imports no JAX) and are joined with a hard timeout, so a hung
collective fails the test instead of hanging it.
"""
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from multigrad_tpu_torch.models import ParamTuple, SMFModel, make_smf_data
from multigrad_tpu_torch.parallel.collectives import reduce_sum, scatter_nd
from multigrad_tpu_torch.parallel.mesh import MeshComm, global_comm

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_HALOS = 10_001          # ragged over 2 ranks: one inf pad halo
PARAMS = ParamTuple(-1.0, 0.5)
WORLD = 2
TIMEOUT_S = 120


def _run_rank(rank, world, init_file, out_file):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        comm = global_comm()
        model = SMFModel(aux_data=make_smf_data(NUM_HALOS, comm=comm,
                                                device="cpu"), comm=comm)
        loss, grad = model.calc_loss_and_grad_from_params(PARAMS)
        traj = model.run_adam(PARAMS, nsteps=3, learning_rate=0.02,
                              progress=False)
        np.savez(out_file, rank=comm.rank, size=comm.size,
                 shard=model.aux_data["log_halo_masses"].numpy(),
                 partial=model.calc_sumstats_from_params(
                     PARAMS, total=False).numpy(),
                 total=model.calc_sumstats_from_params(PARAMS).numpy(),
                 loss=loss.numpy(), grad=grad.numpy(), traj=traj.numpy(),
                 ones=reduce_sum(1.0, comm=comm))
    finally:
        dist.destroy_process_group()


def test_two_rank_gloo_matches_single_process():
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "init")
        outs = [os.path.join(tmp, f"rank{r}.npz") for r in range(WORLD)]
        env = dict(os.environ, PYTHONPATH=REPO_ROOT)
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(WORLD),
             init_file, outs[r]], cwd=REPO_ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(WORLD)]
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
        ranks = [dict(np.load(o)) for o in outs]

    assert [int(r["rank"]) for r in ranks] == [0, 1]
    assert all(int(r["size"]) == WORLD for r in ranks)
    assert all(float(r["ones"]) == WORLD for r in ranks)
    # Equal shards of the padded halos; the one pad halo is +inf.
    assert all(r["shard"].shape == (5001,) for r in ranks)
    assert np.isinf(ranks[1]["shard"][-1])

    single = SMFModel(aux_data=make_smf_data(NUM_HALOS, device="cpu"))
    want_total = single.calc_sumstats_from_params(PARAMS).numpy()
    loss, grad = single.calc_loss_and_grad_from_params(PARAMS)
    want_traj = single.run_adam(PARAMS, nsteps=3, learning_rate=0.02,
                                progress=False).numpy()
    # Partials add up to the total (f32 sums of two halves: rtol 2e-5,
    # as test_smf_pipeline.py), and the totals, losses, gradients and
    # Adam trajectories equal the single-process run's.
    np.testing.assert_allclose(ranks[0]["partial"] + ranks[1]["partial"],
                               ranks[0]["total"], rtol=2e-5)
    for r in ranks:
        np.testing.assert_array_equal(r["total"], ranks[0]["total"])
        np.testing.assert_allclose(r["total"], want_total, rtol=2e-5)
        np.testing.assert_allclose(r["loss"], loss.numpy(), rtol=1e-5)
        np.testing.assert_allclose(r["grad"], grad.numpy(), rtol=1e-4)
        np.testing.assert_allclose(r["traj"], want_traj, rtol=0, atol=1e-5)


def test_world_size_one_identity():
    comm = MeshComm()
    assert (comm.rank, comm.size, len(comm)) == (0, 1, 1)
    x = torch.arange(5.0)
    assert comm.psum(x) is x
    assert reduce_sum(x, comm=comm) is x
    assert reduce_sum(x) is x
    assert torch.equal(scatter_nd(x, comm=comm), x)
    model = SMFModel(aux_data=make_smf_data(2_000, device="cpu"), comm=comm)
    alone = SMFModel(aux_data=make_smf_data(2_000, device="cpu"))
    np.testing.assert_array_equal(
        model.calc_sumstats_from_params(PARAMS, total=False).numpy(),
        alone.calc_sumstats_from_params(PARAMS).numpy())


class _Rank:
    """A stand-in comm of two processes, seen from rank 1."""
    rank, size = 1, 2


def test_scatter_nd_pads_or_raises():
    x = torch.arange(5.0)
    shard = scatter_nd(x, comm=_Rank(), pad_value=float("inf"))
    np.testing.assert_array_equal(shard.numpy(), [3.0, 4.0, np.inf])
    with pytest.raises(ValueError, match="not divisible"):
        scatter_nd(x, comm=_Rank())
    np.testing.assert_array_equal(
        scatter_nd(torch.arange(6.0), comm=_Rank()).numpy(), [3, 4, 5])


if __name__ == "__main__":
    _run_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
