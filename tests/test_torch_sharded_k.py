"""Sharded K in the port: ``ensemble_comm``'s replica axis, the
K-partitioned batched fit, ensemble, HMC and served buckets, held against
the port's replicated path and the JAX package's (the port's side of
``tests/test_sharded_k.py``).

The port's side runs in gloo ranks, one process each, as the other gloo
tests run them: ONE world of 2 ranks (``ensemble_comm(2)``: R = 2, D = 1)
and ONE of 4 (R = 2, D = 2; and R = 4, D = 1 for the padded ensemble),
each running every check of its world in those processes and sending its
results back as an ``.npz`` file.  The ranks import no JAX.  The JAX side
runs here, on the 8 CPU devices ``tests/conftest.py`` gives it, on its
replicated path only: its own sharded HMC fails on the installed jax.

On the exact model (``utils.testing``: every sum exact in any order) the
sharded trajectories, chains and served rows equal the replicated ones
bit for bit (``torch.equal``); the SMF ensemble is within the JAX test's
own tolerances of the JAX package's replicated run.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

from multigrad_tpu_torch.inference import ensemble as ens
from multigrad_tpu_torch.inference import (batched_fit_wrapper,
                                           ensemble_memory_model,
                                           max_k_for_budget,
                                           resolve_k_sharded,
                                           run_multistart_adam)
from multigrad_tpu_torch.models import SMFModel, make_smf_data
from multigrad_tpu_torch.optim import adam as _adam
from multigrad_tpu_torch.parallel import MeshComm, ensemble_comm

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 150
BOUNDS = [(-5.0, 1.0), (0.01, 2.0)]
SMF_HALOS = 800
HMC_KW = dict(num_samples=25, num_warmup=10, num_leapfrog=4, step_size=0.05,
              randkey=7)
TAP_KW = dict(num_samples=20, num_warmup=5, num_leapfrog=4, step_size=0.05,
              randkey=7, log_every=5)
ENSEMBLE_KW = dict(param_bounds=BOUNDS, n_starts=6, nsteps=15, seed=3)
SERVE_STEPS, SERVE_LR = 15, 0.05
# The exact model's trajectory against the JAX package's: both hold the
# same exact sums, and the Adam arithmetic (optax's and the port's written
# out) rounds the same way to within this.
JAX_EXACT_ATOL = 1e-6


def _inits(k):
    return np.column_stack([np.linspace(-2.0, -1.0, k),
                            np.linspace(0.3, 0.8, k)]).astype(np.float32)


def _hmc_init():
    return _inits(8) * 0.1 + np.array([-0.09, 0.05], np.float32)


# --------------------------------------------------------------------- #
# the ranks (this file run as a script; no JAX)
# --------------------------------------------------------------------- #
def _smf_model(comm, arrays):
    """The SMF model over ``comm`` on the JAX package's 800-halo catalog,
    its halos sharded over the comm's data group."""
    from multigrad_tpu_torch.parallel.collectives import scatter_nd
    aux = make_smf_data(SMF_HALOS, device="cpu")
    aux["log_halo_masses"] = scatter_nd(
        torch.from_numpy(arrays["log_halo_masses"]), comm=comm,
        pad_value=np.inf)
    aux["smf_bin_edges"] = torch.from_numpy(arrays["smf_bin_edges"])
    return SMFModel(aux_data=aux, comm=comm)


def _serve(model, guesses, buckets=(8,), skew_s=0.0):
    """Serve ``guesses`` through a scheduler on ``model``; with
    ``skew_s`` the dispatcher runs from the start, rank 0 submitting one
    request at a time and the others all of theirs ``skew_s`` later."""
    import torch.distributed as dist

    from multigrad_tpu_torch.serve import FitScheduler
    skewed = skew_s > 0
    with FitScheduler(model, buckets=buckets, batch_window_s=0.0,
                      start=skewed) as sched:
        if skewed and dist.get_rank() > 0:
            time.sleep(skew_s)
        futs = []
        for g in guesses:
            futs.append(sched.submit(g, nsteps=SERVE_STEPS,
                                     learning_rate=SERVE_LR))
            if skewed and dist.get_rank() == 0:
                time.sleep(0.02)
        if not skewed:
            sched.start()
        results = [f.result(timeout=TIMEOUT_S) for f in futs]
        flag = sched.k_sharded
    return dict(traj=np.stack([r.traj for r in results]),
                loss=np.array([r.loss for r in results]),
                bucket=np.array([r.bucket for r in results]),
                k_sharded=np.array(flag))


def _hmc_records(model, sharded):
    from multigrad_tpu_torch.inference import run_hmc
    from multigrad_tpu_torch.telemetry import MemorySink, MetricsLogger
    sink = MemorySink()
    logger = MetricsLogger(sink)
    run_hmc(model, _hmc_init(), k_sharded=sharded, telemetry=logger,
            **TAP_KW)
    logger.close()
    recs = [r for r in sink.records if r["event"] == "hmc"]
    return np.array([[r["accept"], r["divergences"]] for r in recs]), \
        np.array([r["step_size"] for r in recs])


def _by_axis(cc):
    return np.array([cc.calls_by_axis.get("data", 0),
                     cc.calls_by_axis.get("replica", 0),
                     cc.bytes_by_axis.get("replica", 0)])


def _rank_checks(world, smf_file, table_dir):
    import torch.distributed as dist

    from multigrad_tpu_torch.analysis import check_k_scaling, trace_program
    from multigrad_tpu_torch.analysis.lint import main as lint_main
    from multigrad_tpu_torch.inference import run_hmc
    from multigrad_tpu_torch.parallel import global_comm
    from multigrad_tpu_torch.serve import FitConfig, warmup_buckets
    from multigrad_tpu_torch.telemetry import CommCounter, model_cost
    from multigrad_tpu_torch.tune import TuningTable, tune_buckets
    from multigrad_tpu_torch.tune.space import bucket_candidates
    from multigrad_tpu_torch.utils.testing import (bitwise_trajectory_pair,
                                                   make_exact_shard_model)
    out = {}
    gcomm, ecomm = global_comm(), ensemble_comm(2)
    out["layout"] = np.array([ecomm.rank, ecomm.size, ecomm.replica.rank,
                              ecomm.replica.size])
    try:
        ensemble_comm(3)
    except ValueError as e:
        out["three_raises"] = np.array(str(e))

    # The batched scan, replicated and K-partitioned, and the replica
    # traffic of the sharded run: the gather at the end, nothing else.
    with CommCounter() as cc:
        t_rep, t_sh = bitwise_trajectory_pair(gcomm, ecomm, device="cpu")
    out["scan_rep"], out["scan_sh"] = t_rep.numpy(), t_sh.numpy()
    m_sh = make_exact_shard_model(ecomm, device="cpu")
    with CommCounter() as cc:
        _adam.run_adam_scan(
            batched_fit_wrapper(m_sh, False, k_sharded=True),
            torch.from_numpy(_inits(8)), nsteps=12, learning_rate=0.05,
            fn_args=(m_sh.aux_leaves(),), carry_sharding=m_sh.k_sharding(2))
    out["scan_axes"] = _by_axis(cc)

    # HMC chains, replicated and sharded, and the tap's records.
    m_rep = make_exact_shard_model(gcomm, device="cpu")
    h_rep = run_hmc(m_rep, _hmc_init(), **HMC_KW)
    with CommCounter() as cc:
        h_sh = run_hmc(m_sh, _hmc_init(), k_sharded=True, **HMC_KW)
    out["hmc_axes"] = _by_axis(cc)
    for tag, h in (("rep", h_rep), ("sh", h_sh)):
        for field in ("samples", "potential", "step_size", "divergences",
                      "accept_prob"):
            out[f"hmc_{tag}_{field}"] = getattr(h, field)
    with CommCounter() as cc:
        out["tap_sh"], out["tap_sh_eps"] = _hmc_records(m_sh, True)
    out["tap_axes"] = _by_axis(cc)
    out["tap_rep"], out["tap_rep_eps"] = _hmc_records(m_rep, False)
    try:
        run_hmc(m_sh, np.array([-1.0, 0.5]), num_samples=2, num_warmup=1,
                num_chains=3, k_sharded=True)
    except ValueError as e:
        out["hmc_divisible"] = np.array(str(e))

    # A served bucket of 8, replicated and sharded; then the sharded
    # scheduler with rank 1's submissions arriving late.
    guesses = list(_inits(8))
    for tag, model in (("rep", m_rep), ("sh", m_sh)):
        for key, v in _serve(model, guesses).items():
            out[f"serve_{tag}_{key}"] = v
    for key, v in _serve(m_sh, guesses, buckets=(1, 2, 4, 8),
                         skew_s=0.3).items():
        out[f"skew_{key}"] = v

    # The SMF ensemble at R = 2, and at R = world (K padded from 6).
    arrays = dict(np.load(smf_file))
    smf_sh = _smf_model(ecomm, arrays)
    comms = {"2": ecomm}
    if world > 2:
        comms[str(world)] = ensemble_comm(world)
    for r, comm in comms.items():
        res = run_multistart_adam(_smf_model(comm, arrays), k_sharded=True,
                                  **ENSEMBLE_KW)
        out[f"smf{r}_params"] = res.params.numpy()
        out[f"smf{r}_losses"] = res.losses.numpy()
        out[f"smf{r}_meta"] = np.array([res.best_loss, res.n_starts,
                                        float(res.k_sharded)])

    # The "auto" rule on the ensemble comm and on the flat one.
    smf_flat = _smf_model(gcomm, arrays)
    auto = [run_multistart_adam(smf_sh, param_bounds=BOUNDS, n_starts=8,
                                nsteps=4, k_sharded="auto",
                                k_budget_bytes=b).k_sharded
            for b in (1, 1 << 40)]
    auto.append(resolve_k_sharded(smf_flat, 64, 2, 100, k_sharded="auto",
                                  k_budget_bytes=1))
    out["auto"] = np.array(auto)
    errors = []
    for model, knob in ((smf_flat, True), (smf_sh, "maybe")):
        try:
            run_multistart_adam(model, param_bounds=BOUNDS, n_starts=4,
                                nsteps=2, k_sharded=knob)
        except ValueError as e:
            errors.append(str(e))
    out["auto_errors"] = np.array(errors)

    # The cost model's bytes by axis; the lint target; the k-scaling
    # check on a seeded coupling.
    c8, c16 = (model_cost(smf_sh, torch.zeros((k, 2)),
                          kind="batched_loss_and_grad_sharded")
               for k in (8, 16))
    flat = model_cost(smf_flat, torch.zeros(2))
    out["cost"] = json.dumps(dict(
        c8=c8.comm_bytes_by_axis, c16=c16.comm_bytes_by_axis,
        c8_unattributed=c8.comm_bytes_unattributed,
        flat=flat.comm_bytes_by_axis, flat_bytes=flat.comm_bytes,
        flat_unattributed=flat.comm_bytes_unattributed))
    out["lint_rc"] = np.array(lint_main(
        ["--targets", "ensemble_sharded", "--num-halos", "400",
         "--device", "cpu"]))
    ks = smf_sh.k_sharding(2)

    def program(k, coupled):
        def body(params):
            rows = ks.local(params)
            if coupled:     # every row against the whole gathered batch
                rows = rows @ ks.gather(rows).T
            return ecomm.psum(rows)
        return trace_program(body, torch.zeros((k, 2)))

    out["kscale"] = np.array([
        len(check_k_scaling(program(8, c), program(16, c), program="bad",
                            scale=2)) for c in (False, True)])

    # The tuner's sharded rungs, its candidate cap; warmup.
    table = TuningTable(os.path.join(table_dir, f"t{dist.get_rank()}.json"))
    res = tune_buckets(smf_sh, np.array([-1.0, 0.5]), nsteps=3, reps=1,
                       candidates=(1, 2, 4), table=table)
    out["tune_flags"] = np.array([[c["knobs"]["bucket"], c["k_sharded"]]
                                  for c in res.candidates])
    entry = table.lookup(res.key)
    out["tune_entry"] = np.array([entry["k_sharded"], entry["n_replicas"]])
    per_row = ensemble_memory_model(1, 2, 5, graph_bytes=ens.row_graph_bytes(
        smf_sh)) - ens.row_graph_bytes(smf_sh)
    out["cands"] = np.array([
        max(bucket_candidates(smf_sh, 5, 2, k_sharded=True,
                              budget_bytes=b)) for b in (
            ens.row_graph_bytes(smf_sh) + 8 * per_row, 10 ** 12)])
    out["warm"] = np.array([
        [e["bucket"], e["k_sharded"]] for e in warmup_buckets(
            smf_sh, FitConfig(nsteps=2, param_bounds=BOUNDS),
            buckets=(1, 2), k_sharded=True)])
    return out


def _run_rank(rank, world, init_file, out_file, smf_file, table_dir):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        np.savez(out_file, **_rank_checks(world, smf_file, table_dir))
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------- #
# the worlds, one spawn each
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jax_smf():
    from multigrad_tpu.models.smf import make_smf_data as jax_make_smf_data
    return {k: np.asarray(v) for k, v in jax_make_smf_data(SMF_HALOS).items()
            if k in ("log_halo_masses", "smf_bin_edges")}


def _start(world, tmp, smf_file):
    """Start ``world`` rank processes of this file; ``(procs, outs)``."""
    base = os.path.join(tmp, f"w{world}")
    os.makedirs(base)
    outs = [os.path.join(base, f"rank{r}.npz") for r in range(world)]
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, OMP_NUM_THREADS="1",
               MGT_TUNING_TABLE=os.path.join(base, "table.json"))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         os.path.join(base, "init"), outs[r], smf_file, base],
        cwd=REPO_ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    return procs, outs


@pytest.fixture(scope="module")
def worlds(jax_smf):
    """Both worlds at once, each rank a process; each rank's arrays."""
    with tempfile.TemporaryDirectory() as tmp:
        smf_file = os.path.join(tmp, "smf.npz")
        np.savez(smf_file, **jax_smf)
        started = {w: _start(w, tmp, smf_file) for w in (2, 4)}
        procs = [p for ps, _ in started.values() for p in ps]
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
        return {w: [dict(np.load(o)) for o in outs]
                for w, (_, outs) in started.items()}


WORLDS = pytest.mark.parametrize("world", [2, 4])


# --------------------------------------------------------------------- #
# the layout
# --------------------------------------------------------------------- #
@WORLDS
def test_ensemble_comm_layout(worlds, world):
    # rank = r·D + d: the data group of replica slice r, the replica
    # group of data shard d (R = 2 in both worlds).
    d = world // 2
    for rank, out in enumerate(worlds[world]):
        assert out["layout"].tolist() == [rank % d, d, rank // d, 2]
        assert "must divide" in str(out["three_raises"])


def test_ensemble_comm_one_process():
    comm = ensemble_comm(1)
    assert comm.axes == ("data",) and comm.free_axes == ("replica",)
    assert comm.size == 1 and comm.replica.size == 1
    with pytest.raises(ValueError, match="must divide"):
        ensemble_comm(2)
    assert MeshComm().free_axes == () and MeshComm().axis is None


# --------------------------------------------------------------------- #
# the batched scan
# --------------------------------------------------------------------- #
@WORLDS
def test_batched_scan_bitwise_on_exact_model(worlds, world):
    for out in worlds[world]:
        rep, sh = torch.from_numpy(out["scan_rep"]), \
            torch.from_numpy(out["scan_sh"])
        assert rep.shape == (13, 8, 2)
        assert torch.equal(rep, sh)
    # Every process returns the whole gathered trajectory.
    assert all(np.array_equal(o["scan_sh"], worlds[world][0]["scan_sh"])
               for o in worlds[world])


@WORLDS
def test_sharded_scan_crosses_the_replica_comm_once(worlds, world):
    for out in worlds[world]:
        data, replica, nbytes = out["scan_axes"].tolist()
        # 2 all-reduces a step on the data comm, one gather of the
        # (13, 4, 2) trajectory rows on the replica comm.
        assert data == 2 * 12
        assert replica == 1 and nbytes == 13 * 4 * 2 * 4


def test_batched_scan_against_the_jax_package(worlds):
    import jax.numpy as jnp

    import multigrad_tpu as mgt
    from multigrad_tpu.inference.ensemble import \
        batched_fit_wrapper as jax_wrapper
    from multigrad_tpu.optim import adam as jax_adam
    from multigrad_tpu.utils.testing import make_exact_shard_model as jax_exact
    m = jax_exact(mgt.global_comm())
    want = np.asarray(jax_adam.run_adam_scan(
        jax_wrapper(m, False), jnp.asarray(_inits(8)), nsteps=12,
        learning_rate=0.05, progress=False, fn_args=(m.aux_leaves(),)))
    for world in (2, 4):
        got = worlds[world][0]["scan_sh"]
        np.testing.assert_allclose(got, want, rtol=0, atol=JAX_EXACT_ATOL)


# --------------------------------------------------------------------- #
# HMC
# --------------------------------------------------------------------- #
@WORLDS
def test_hmc_sharded_chains_bitwise_on_exact_model(worlds, world):
    for out in worlds[world]:
        for field in ("samples", "potential", "step_size", "divergences",
                      "accept_prob"):
            rep = torch.from_numpy(np.asarray(out[f"hmc_rep_{field}"]))
            sh = torch.from_numpy(np.asarray(out[f"hmc_sh_{field}"]))
            assert torch.equal(rep, sh), field
        assert out["hmc_sh_samples"].shape == (8, 25, 2)


@WORLDS
def test_hmc_sharded_replica_traffic(worlds, world):
    for out in worlds[world]:
        # One gather of the joined results at the end; no tap.
        assert out["hmc_axes"][1] == 1
        # With a tap: 4 records of 3 collectives (accept averaged,
        # divergences summed, step sizes gathered), then the gather.
        assert out["tap_axes"][1] == 4 * 3 + 1


@WORLDS
def test_hmc_sharded_tap_records_whole_ensemble(worlds, world):
    # Process 0 logs the records; every process joins their collectives.
    out = worlds[world][0]
    assert out["tap_sh"].shape == out["tap_rep"].shape == (4, 2)
    assert out["tap_sh_eps"].shape == (4, 8)     # the full (C,)
    np.testing.assert_array_equal(out["tap_sh"][:, 1], out["tap_rep"][:, 1])
    np.testing.assert_allclose(out["tap_sh"][:, 0], out["tap_rep"][:, 0],
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out["tap_sh_eps"], out["tap_rep_eps"])
    assert all(o["tap_sh"].size == 0 for o in worlds[world][1:])


def test_hmc_sharded_chains_divisibility(worlds):
    for out in worlds[2]:
        assert "divisible" in str(out["hmc_divisible"])


# --------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------- #
@WORLDS
def test_served_bucket_sharded_bitwise_on_exact_model(worlds, world):
    for out in worlds[world]:
        assert bool(out["serve_sh_k_sharded"])
        assert not bool(out["serve_rep_k_sharded"])
        assert torch.equal(torch.from_numpy(out["serve_rep_traj"]),
                           torch.from_numpy(out["serve_sh_traj"]))
        assert np.array_equal(out["serve_rep_loss"], out["serve_sh_loss"])
        assert out["serve_sh_bucket"].tolist() == [8] * 8
    # Every process's futures resolve with the whole rows.
    first = worlds[world][0]
    assert all(np.array_equal(o["serve_sh_traj"], first["serve_sh_traj"])
               for o in worlds[world])


@WORLDS
def test_served_bucket_with_late_submissions(worlds, world):
    # Rank 0 decides each dispatch; the others take the same requests
    # whenever theirs arrive, so the buckets and rows agree on every
    # rank, and every row equals the bucket-of-8 run's.
    first = worlds[world][0]
    for out in worlds[world]:
        assert out["skew_bucket"].tolist() == first["skew_bucket"].tolist()
        assert torch.equal(torch.from_numpy(out["skew_traj"]),
                           torch.from_numpy(first["serve_rep_traj"]))
        assert np.array_equal(out["skew_loss"], first["serve_rep_loss"])


# --------------------------------------------------------------------- #
# the SMF ensemble against the JAX package's replicated run
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jax_ensembles():
    """The JAX package's replicated ensemble on its 8 devices, through its
    XLA counts and through its Pallas kernels (interpret mode)."""
    import multigrad_tpu as mgt
    from multigrad_tpu.inference import run_multistart_adam as jax_run
    from multigrad_tpu.models.smf import SMFModel as JaxSMF
    from multigrad_tpu.models.smf import make_smf_data as jax_make_smf_data
    comm = mgt.global_comm()
    return [jax_run(JaxSMF(aux_data=jax_make_smf_data(
        SMF_HALOS, comm=comm, backend=backend), comm=comm),
        k_sharded=False, **ENSEMBLE_KW) for backend in ("xla", "pallas")]


@pytest.mark.parametrize("world,r", [(2, 2), (4, 2), (4, 4)])
def test_multistart_adam_sharded_matches_jax_replicated(worlds, jax_ensembles,
                                                       world, r):
    # The JAX test's tolerances: the same rows finite, params within 1e-4,
    # best loss within 1e-5.  One start (from log M* -4.15, loss 7.2,
    # still crawling through the erf tails at step 15) ends 1.2e-3 apart
    # in the JAX package's own two count paths; there the port is held
    # within 1e-4 of the span between them.
    xla, pallas = (np.asarray(e.params) for e in jax_ensembles)
    low = np.minimum(xla, pallas) - 1e-4
    high = np.maximum(xla, pallas) + 1e-4
    for out in worlds[world]:
        got = out[f"smf{r}_params"]
        best_loss, n_starts, sharded = out[f"smf{r}_meta"].tolist()
        assert sharded == 1.0 and n_starts == 6 and got.shape == (6, 2)
        finite_g, finite_w = np.isfinite(got).all(1), np.isfinite(xla).all(1)
        assert np.array_equal(finite_g, finite_w)
        g = got[finite_g]
        assert np.all((g >= low[finite_w]) & (g <= high[finite_w])), \
            (g, xla, pallas)
        for e in jax_ensembles:
            assert best_loss == pytest.approx(e.best_loss, abs=1e-5)


def test_multistart_adam_sharded_bitwise_across_replica_counts(worlds):
    # R = 2 (no padding) and R = 4 (K padded from 6 to 8) over one-process
    # data groups: every row the same bits.
    for out in worlds[4]:
        assert np.array_equal(out["smf2_params"], out["smf4_params"])
        assert np.array_equal(out["smf2_losses"], out["smf4_losses"])


def test_auto_rule(worlds):
    for out in worlds[2]:
        # budget 1 shards, 1 << 40 does not; a flat comm never does.
        assert out["auto"].tolist() == [True, False, False]
        flat, maybe = out["auto_errors"].tolist()
        assert "ensemble_comm" in flat and "k_sharded" in maybe


def test_auto_rule_flat_comm_in_process():
    model = SMFModel(aux_data=make_smf_data(400, device="cpu"))
    assert resolve_k_sharded(model, 64, 2, 100, k_budget_bytes=1) is False
    with pytest.raises(ValueError, match="ensemble_comm"):
        run_multistart_adam(model, param_bounds=BOUNDS, n_starts=4,
                            nsteps=2, k_sharded=True)
    with pytest.raises(ValueError, match="k_sharded"):
        resolve_k_sharded(model, 4, 2, 2, k_sharded="maybe")


# --------------------------------------------------------------------- #
# cache isolation and the memory model
# --------------------------------------------------------------------- #
def test_toggling_k_sharded_builds_siblings():
    comm = ensemble_comm(1)
    model = SMFModel(aux_data=make_smf_data(400, comm=comm, device="cpu"),
                     comm=comm)
    p_rep = model.batched_loss_and_grad_fn(False)
    p_sh = model.batched_loss_and_grad_fn(False, k_sharded=True)
    assert p_rep is not p_sh
    assert model.batched_loss_and_grad_fn(False) is p_rep
    assert model.batched_loss_and_grad_fn(False, k_sharded=True) is p_sh
    w_rep = batched_fit_wrapper(model, False)
    w_sh = batched_fit_wrapper(model, False, k_sharded=True)
    assert w_rep is not w_sh
    assert batched_fit_wrapper(model, False) is w_rep
    assert batched_fit_wrapper(model, False, k_sharded=True) is w_sh
    # A run of each leaves both cached as they were.
    inits = torch.from_numpy(_inits(4))
    for wrapper, ks in ((w_rep, None), (w_sh, model.k_sharding(2))):
        _adam.run_adam_scan(wrapper, inits, nsteps=2,
                            fn_args=(model.aux_leaves(),), carry_sharding=ks)
    assert set(model._program_cache) == {
        ("batched_loss_and_grad", False, False),
        ("batched_loss_and_grad", False, True),
        ("multistart_adam_wrapper", False, False),
        ("multistart_adam_wrapper", False, True)}


def test_flat_model_has_no_k_shard_axis():
    comm = ensemble_comm(1)
    flat = SMFModel(aux_data=make_smf_data(400, device="cpu"))
    sharded = SMFModel(aux_data=make_smf_data(400, comm=comm, device="cpu"),
                       comm=comm)
    assert flat.k_shard_axis is None and flat.k_shard_replicas == 1
    assert sharded.k_shard_axis == "replica"
    assert sharded.k_shard_replicas == 1
    with pytest.raises(ValueError, match="ensemble_comm"):
        flat.k_sharding(2)
    ks = sharded.k_sharding(2)
    assert ks.n_replicas == 1 and ks.index == 0
    with pytest.raises(ValueError, match="divisible"):
        type(ks)(type("R", (), {"size": 2, "rank": 0, "axis": "r"})())\
            .local(torch.zeros(3, 2))


def test_memory_model_arithmetic():
    per_member = 2 * 4 * (10 + 1 + ens.ENSEMBLE_STATE_ROWS)
    assert ensemble_memory_model(16, 2, 10) == 16 * per_member
    assert ensemble_memory_model(16, 2, 10, n_replicas=4) == 4 * per_member
    # The graph term: each of a process's K/R rows, and the backward's
    # one row, added once; divided by R with the rows.
    g = 1000
    assert ensemble_memory_model(16, 2, 10, graph_bytes=g) \
        == 16 * per_member + 17 * g
    assert ensemble_memory_model(16, 2, 10, n_replicas=4, graph_bytes=g) \
        == 4 * per_member + 5 * g
    assert ensemble_memory_model(0, 2, 10, graph_bytes=g) == 0
    # max K at a fixed budget scales exactly x R, with the graph term too.
    for graph in (0, g):
        budget = graph + 256 * (per_member + graph)
        assert max_k_for_budget(budget, 2, 10, graph_bytes=graph) == 256
        assert max_k_for_budget(budget, 2, 10, n_replicas=4,
                                graph_bytes=graph) == 1024
        assert ensemble_memory_model(
            256, 2, 10, graph_bytes=graph) <= budget
    assert max_k_for_budget(10, 2, 10) == 0
    assert max_k_for_budget(g, 2, 10, graph_bytes=g) == 0


def test_row_graph_bytes_counts_the_catalog_shard():
    model = SMFModel(aux_data=make_smf_data(400, device="cpu"))
    assert ens.row_graph_bytes(model) == ens.GRAPH_BYTES_PER_CATALOG_ROW * 400
    # The "auto" rule decides on the graphs: a budget of 8 rows' graphs
    # is exceeded by 8 rows (and the backward's one more).
    comm = ensemble_comm(1)
    sh = SMFModel(aux_data=make_smf_data(400, comm=comm, device="cpu"),
                  comm=comm)
    budget = 8 * ens.row_graph_bytes(sh)
    assert resolve_k_sharded(sh, 8, 2, 1, k_budget_bytes=budget) is True
    assert resolve_k_sharded(sh, 4, 2, 1, k_budget_bytes=budget) is False


# --------------------------------------------------------------------- #
# cost, analysis, tuning, warmup
# --------------------------------------------------------------------- #
@WORLDS
def test_costmodel_splits_comm_by_axis(worlds, world):
    for out in worlds[world]:
        cost = json.loads(str(out["cost"]))
        # (K/R)·(|y| + |params|)·4 on the data axis, nothing on the
        # replica axis; doubling K doubles it.  A flat comm's bytes stay
        # unattributed.
        assert cost["c8"] == {"data": (8 // 2) * 48}
        assert cost["c16"] == {"data": 2 * cost["c8"]["data"]}
        assert cost["c8_unattributed"] == 0
        assert cost["flat"] == {}
        assert cost["flat_unattributed"] == cost["flat_bytes"] == 48


def test_lint_ensemble_sharded_target_is_clean(worlds):
    assert [int(o["lint_rc"]) for o in worlds[2]] == [0, 0]


def test_k_scaling_check_catches_superlinear_coupling(worlds):
    for out in worlds[2]:
        clean, coupled = out["kscale"].tolist()
        assert clean == 0 and coupled > 0


def test_tune_buckets_measures_sharded_rungs(worlds):
    for out in worlds[2]:
        # The K = 1 singleton keeps the replicated program (the dispatch
        # rule); the rungs R divides run the K-partitioned one.
        assert out["tune_flags"].tolist() == [[1, 0], [2, 1], [4, 1]]
        assert out["tune_entry"].tolist() == [1, 2]
        # A budget of 8 replicated rows admits 16 sharded ones; no
        # budget, the sharded ladder's top rung.
        assert out["cands"].tolist() == [16, 256]


def test_warmup_buckets_sharded(worlds):
    for out in worlds[2]:
        assert out["warm"].tolist() == [[1, 0], [2, 1]]


if __name__ == "__main__":
    _run_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
              sys.argv[5], sys.argv[6])
