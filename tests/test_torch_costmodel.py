"""The port's static cost model (``multigrad_tpu_torch.telemetry
.costmodel``) against the JAX package's, on the CPU.

The port counts a program by running it on meta tensors under a counting
dispatch mode; the kernels' autograd Functions declare their own counts
(``ops/kernel_costs.py``).  Held against the JAX package's jaxpr fold on
the same numpy-seeded inputs:

* the SMF loss and gradient at 20,000 halos: ``erf`` and ``exp`` element
  counts equal (N·E each, exact), ``arg_bytes`` within the JAX test's
  bounds (``tests/test_observability.py:622-636``), no comm, the same
  ``out_bytes``;
* chunked invariance and the streamed scan's exact 2× at 2× the chunks
  (``tests/test_tune.py:319-357``); the scan's ``exp`` equal to the JAX
  package's, its ``erf`` twice it (the checkpointed chunk's recompute
  launches the erf forward kernel again);
* the history model: unchunked ``erf`` equal (N·E·K, dense, or N·W·K
  fused); chunked, the recompute of ``torch.utils.checkpoint`` doubles
  the history's ops as the JAX package's remat does (``pow`` 2×, equal
  to the JAX package's), and the erf forward kernel, which the card launches
  again in the recompute and XLA drops from it, counts 2× the JAX
  package's;
* aten conventions on a small program (a matrix product, exp, a sum):
  flops and transcendentals equal to the JAX package's;
* ``predicted_time_s`` and ``roofline_record`` equal to the JAX
  package's for the same fields and an explicit spec (exact);
* at 2 gloo ranks (this file run as a script, so it imports no JAX at
  the top): ``comm_bytes == (|y| + |params|)·4`` in 2 calls, per-shard
  erf counts, and the tuning table's model key equal to the JAX
  package's for the same global catalog over a comm of 2.
"""
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from multigrad_tpu_torch.models import (GalhaloHistModel, SMFModel,
                                        make_galhalo_hist_data,
                                        make_smf_data, make_wprp_data,
                                        WprpModel)
from multigrad_tpu_torch.models.galhalo_hist import TRUTH as HIST_TRUTH
from multigrad_tpu_torch.ops import erf_kernels as ek
from multigrad_tpu_torch.ops import fused_kernels as fk
from multigrad_tpu_torch.ops import pair_kernels as pk
from multigrad_tpu_torch.telemetry import costmodel as cm

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
GUESS = (-1.0, 0.5)
F32 = 4
N_BINS, N_PARAMS = 10, 2
E = N_BINS + 1
TIMEOUT_S = 120
RANK_HALOS = 16_384


def _jax_smf(n, **kw):
    import jax.numpy as jnp
    from multigrad_tpu.models.smf import SMFModel as JaxSMFModel
    from multigrad_tpu.models.smf import make_smf_data as jax_make_smf_data
    from multigrad_tpu.telemetry.costmodel import model_cost
    model = JaxSMFModel(aux_data=jax_make_smf_data(n, **kw))
    return model_cost(model, jnp.array(GUESS))


def test_smf_counts_match_jax():
    n = 20_000
    cost = cm.model_cost(SMFModel(aux_data=make_smf_data(n, device=CPU)),
                         GUESS)
    want = _jax_smf(n)
    assert cost.transcendentals["erf"] == want.transcendentals["erf"] \
        == n * E
    assert cost.transcendentals["exp"] == want.transcendentals["exp"] \
        == n * E
    assert cost.transcendentals.get("log", 0) < 100     # loss-side only
    assert n * F32 <= cost.arg_bytes < n * F32 + 4096
    assert cost.out_bytes == want.out_bytes == 3 * F32
    assert cost.comm_bytes == 0 and cost.comm_calls == 0
    assert cost.const_bytes == 0 and not cost.has_dynamic_trips
    # The kernels' own counts (csrc/erf_counts.cu), not the plain
    # versions' aten ops.
    assert cost.flops_by_prim["erf_counts_fwd"] == n * (29 * E + 2 * N_BINS)
    assert cost.flops_by_prim["erf_counts_bwd"] == n * 10 * E


def test_chunked_invariance_and_scan_scaling():
    import jax
    import jax.numpy as jnp
    from multigrad_tpu.models.smf import SMFModel as JaxSMFModel
    from multigrad_tpu.models.smf import make_smf_data as jax_make_smf_data
    from multigrad_tpu.telemetry.costmodel import estimate_program_cost

    n = 8192
    for chunk in (None, 1024):
        cost = cm.model_cost(SMFModel(aux_data=make_smf_data(
            n, chunk_size=chunk, device=CPU)), GUESS)
        assert cost.transcendentals["erf"] == n * 11
        assert cost.transcendentals["exp"] == n * 11

    aux = make_smf_data(n, device=CPU)
    del aux["log_halo_masses"]
    program = SMFModel(aux_data=aux).chunk_scan_loss_and_grad_fn(
        ("log_halo_masses",))

    def cost_at(n_chunks):
        stack = [torch.empty((n_chunks, 1024), device="meta")]
        return cm.estimate_program_cost(program, torch.zeros(2), stack)

    c2, c4 = cost_at(2), cost_at(4)
    assert c4.transcendentals["erf"] == 2 * c2.transcendentals["erf"]
    assert c4.transcendentals["exp"] == 2 * c2.transcendentals["exp"]

    jaux = jax_make_smf_data(n)
    del jaux["log_halo_masses"]
    jmodel = JaxSMFModel(aux_data=jaux)
    jprog = jmodel.chunk_scan_loss_and_grad_fn(("log_halo_masses",))
    want = estimate_program_cost(
        jprog, jax.ShapeDtypeStruct((2,), jnp.float32),
        [jax.ShapeDtypeStruct((2, 1024), jnp.float32)],
        jmodel.aux_leaves(), jnp.zeros(()))
    assert c2.transcendentals["exp"] == want.transcendentals["exp"] \
        == 2 * 1024 * 11
    # Each chunk's checkpointed forward runs again in the backward, and
    # with it the erf forward kernel (XLA drops the unused erf from the
    # JAX package's recompute).
    assert c2.transcendentals["erf"] == 2 * want.transcendentals["erf"] \
        == 2 * 2 * 1024 * 11


@pytest.mark.parametrize("mode", ["dense", "fused"])
def test_history_counts_against_jax(mode):
    import jax.numpy as jnp
    from multigrad_tpu.models import galhalo_hist as jh
    from multigrad_tpu.telemetry.costmodel import model_cost

    n, params = 4000, np.asarray(HIST_TRUTH) + 0.01
    got, want = {}, {}
    for chunk in (None, 1000):
        kw = dict(chunk_size=chunk, bin_mode=mode, sigma_max=0.32)
        got[chunk] = cm.model_cost(GalhaloHistModel(
            aux_data=make_galhalo_hist_data(n, device=CPU, **kw)), params)
        want[chunk] = model_cost(jh.GalhaloHistModel(
            aux_data=jh.make_galhalo_hist_data(n, **kw)),
            jnp.asarray(params))
    aux = make_galhalo_hist_data(n, device=CPU, bin_mode=mode,
                                 sigma_max=0.32)
    width = aux["bin_window"] if mode == "fused" \
        else aux["bin_edges"].shape[0]
    k = len(aux["obs_indices"])
    assert got[None].transcendentals["erf"] == \
        want[None].transcendentals["erf"] == n * width * k
    # The remat recompute counted as the JAX package counts it: the
    # history's pow (one an element of the (n, T) history, as in the JAX
    # package's program) twice over, equal to the JAX package's...
    for chunk in (None, 1000):
        assert got[chunk].transcendentals["pow"] == \
            want[chunk].transcendentals["pow"]
    assert got[1000].transcendentals["pow"] == \
        2 * got[None].transcendentals["pow"]
    # ...and the erf forward kernel, launched again in the recompute.
    assert got[1000].transcendentals["erf"] == \
        2 * want[1000].transcendentals["erf"]
    assert got[1000].arg_bytes == got[None].arg_bytes


def test_aten_conventions_match_jax():
    import jax
    import jax.numpy as jnp
    from multigrad_tpu.telemetry.costmodel import estimate_program_cost

    def jfn(a, b):
        return jnp.sum(jnp.exp(a @ b)) + jnp.sum(jnp.cumsum(a, axis=1))

    def tfn(a, b):
        return torch.sum(torch.exp(a @ b)) + torch.sum(torch.cumsum(a, 1))

    want = estimate_program_cost(jfn, jax.ShapeDtypeStruct((6, 5),
                                                           jnp.float32),
                                 jax.ShapeDtypeStruct((5, 7), jnp.float32))
    got = cm.estimate_program_cost(tfn, torch.zeros(6, 5), torch.zeros(5, 7))
    assert got.flops == want.flops
    assert got.transcendentals == want.transcendentals == {"exp": 42}
    assert got.arg_bytes == want.arg_bytes and \
        got.out_bytes == want.out_bytes
    # A captured tensor is a constant, read once.
    captured = torch.ones(3, 5)
    c = cm.estimate_program_cost(lambda a: (a * captured + captured).sum(),
                                 torch.zeros(3, 5))
    assert c.const_bytes == 3 * 5 * F32


def _same_fields(port_cost, jax_cost):
    for name in ("flops", "arg_bytes", "const_bytes", "out_bytes",
                 "comm_bytes", "comm_calls", "comm_bytes_by_axis",
                 "comm_bytes_unattributed", "transcendentals",
                 "flops_by_prim"):
        setattr(jax_cost, name, getattr(port_cost, name))
    return jax_cost


@pytest.mark.parametrize("by_axis", [{}, {"data": 4096, "hosts": 512}])
def test_predicted_time_and_roofline_record_match_jax(by_axis):
    from multigrad_tpu.telemetry import costmodel as jcm

    spec = cm.device_spec("NVIDIA H100 80GB HBM3")
    for flops, nbytes in ((4.5e10, 4e8), (1e6, 4e9)):
        cost = cm.ProgramCost(
            flops=flops, transcendentals={"erf": 7}, arg_bytes=int(nbytes),
            out_bytes=12, comm_bytes=sum(by_axis.values()) + 96,
            comm_calls=2, comm_bytes_by_axis=dict(by_axis),
            comm_bytes_unattributed=96)
        jcost = _same_fields(cost, jcm.ProgramCost())
        assert cm.predicted_time_s(cost, spec=spec) == \
            jcm.predicted_time_s(jcost, spec=spec)
        assert cm.roofline_record(cost, 2.7e-3, spec=spec, config="x") == \
            jcm.roofline_record(jcost, 2.7e-3, spec=spec, config="x")
        assert cost.record() == jcost.record()


def test_device_spec_picks_the_card():
    spec = cm.device_spec("NVIDIA H100 80GB HBM3")
    assert spec["flops_per_s"] == 67e12 and spec["hbm_bytes_per_s"] == 3.35e12
    assert spec["interconnect_bytes_per_s"] == 4.5e11
    assert spec["slow_axis_bytes_per_s"] == 5.0e10
    assert "H100 SXM" in spec["source"]
    assert spec["device_kind"] == "NVIDIA H100 80GB HBM3"
    assert set(cm.DEVICE_SPECS) == {"h100", "cpu"}
    assert cm.device_spec("cpu")["flops_per_s"] == 1.0e11
    assert cm.device_spec("TPU v5 lite")["flops_per_s"] == 1.0e11  # no TPU
    if not torch.cuda.is_available():
        assert cm.device_spec()["device_kind"] == "cpu"
    pred = cm.predicted_time_s(cm.model_cost(
        SMFModel(aux_data=make_smf_data(4096, device=CPU)), GUESS),
        device_kind="NVIDIA H100 80GB HBM3")
    assert pred["bound"] == "compute" and pred["predicted_s"] == \
        max(pred["compute_s"], pred["memory_s"])


def _raise(*args, **kwargs):
    raise AssertionError("the cost model ran a plain version")


def test_model_cost_runs_no_plain_version(monkeypatch):
    # The data (and their targets, which the plain versions compute on the
    # CPU) first; then every plain version raises, and the count of each
    # model runs none of them.
    models = [
        (SMFModel(aux_data=make_smf_data(2048, device=CPU)), GUESS,
         "erf_counts_bwd"),
        (SMFModel(aux_data=make_smf_data(2048, bin_mode="fused",
                                         sigma_max=0.3, device=CPU)), GUESS,
         "fused_counts_bwd"),
        (GalhaloHistModel(aux_data=make_galhalo_hist_data(
            1000, chunk_size=400, device=CPU)), HIST_TRUTH,
         "erf_counts_bwd_vec"),
        (WprpModel(aux_data=make_wprp_data(256, box_size=60.0, seed=2,
                                           device=CPU)), (-1.8, -0.8),
         "pair_rowgrad")]
    for module, names in ((ek, ("erf_counts_fwd_plain",
                                "erf_counts_bwd_plain")),
                          (fk, ("fused_counts_fwd_plain",
                                "fused_counts_bwd_plain")),
                          (pk, ("pair_counts_fwd_plain",
                                "pair_rowgrad_plain",
                                "pair_counts_bwd_plain"))):
        for name in names:
            monkeypatch.setattr(module, name, _raise)
    for model, guess, kernel in models:
        cost = cm.model_cost(model, guess)
        assert cost.flops_by_prim[kernel] > 0


def test_meta_outside_the_count_raises():
    v = torch.empty(100, device="meta")
    e = torch.empty(11, device="meta")
    with pytest.raises(RuntimeError, match="static cost model"):
        ek.erf_counts(v, e, torch.empty((), device="meta"))
    with pytest.raises(RuntimeError, match="static cost model"):
        fk.FusedCounts.apply(v, e, torch.empty((), device="meta"), 4)
    with pytest.raises(ValueError, match="unknown program kind"):
        cm.model_cost(SMFModel(aux_data=make_smf_data(64, device=CPU)),
                      GUESS, kind="nope")


def test_model_cost_kinds():
    model = SMFModel(aux_data=make_smf_data(1024, device=CPU))
    batched = cm.model_cost(model, np.tile(GUESS, (3, 1)),
                            kind="batched_loss_and_grad")
    assert batched.transcendentals["erf"] == 3 * 1024 * E
    assert batched.transcendentals["exp"] == 3 * 1024 * E
    jac = cm.model_cost(model, GUESS, kind="sumstats_jac_rev")
    assert jac.transcendentals["exp"] == N_BINS * 1024 * E


# --------------------------------------------------------------------- #
# Two gloo ranks
# --------------------------------------------------------------------- #
def _rank_main(rank, world, init_file, out_file):
    import torch.distributed as dist
    from multigrad_tpu_torch import global_comm
    from multigrad_tpu_torch.tune.resolve import aux_model_key
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    torch.set_num_threads(2)
    try:
        comm = global_comm()
        model = SMFModel(aux_data=make_smf_data(
            RANK_HALOS, comm=comm, sigma_max=0.6, device=CPU), comm=comm)
        cost = cm.model_cost(model, GUESS)
        out = {"cost": cost.record(),
               "key": aux_model_key("SMFModel", model.aux_data, comm)}
        with open(out_file, "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks():
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "init")
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(2)]
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
        return [json.load(open(o)) for o in outs]


def test_comm_bytes_at_two_ranks(ranks):
    for r in ranks:
        assert r["cost"]["comm_bytes"] == (N_BINS + N_PARAMS) * F32
        assert r["cost"]["comm_calls"] == 2
        assert r["cost"]["comm_bytes_unattributed"] == \
            r["cost"]["comm_bytes"]
        assert r["cost"]["transcendentals"]["erf"] == \
            (RANK_HALOS // 2) * E


def test_tuning_key_per_shard_rows_at_two_ranks(ranks):
    # A port process holds its shard: its rows count once, and the key
    # equals the JAX package's, which divides the global catalog by the
    # comm size.
    from types import SimpleNamespace

    from multigrad_tpu.models.smf import make_smf_data as jax_make_smf_data
    from multigrad_tpu.tune.resolve import aux_model_key
    want = aux_model_key("SMFModel", jax_make_smf_data(
        RANK_HALOS, sigma_max=0.6), SimpleNamespace(size=2),
        backend="cpu", device_kind="cpu")
    assert [r["key"] for r in ranks] == [want, want]
    assert "|rows2^13|" in want


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
