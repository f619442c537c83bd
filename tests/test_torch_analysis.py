"""The port's shard-safety analysis (``multigrad_tpu_torch.analysis``)
against the JAX package's, on the CPU.

The port traces a program by running it once on meta tensors in the
static cost model's counting run; the JAX package traces a jaxpr.  Held
against each other on a one-process gloo group (where every port
collective records its payload) and the JAX package's 8-device CPU mesh,
at small sizes:

* **Collective sites.**  The port's SMF ``loss_and_grad`` makes the two
  all-reduces of the paper's bound, 40 bytes of sumstats and 8 of
  gradient.  The JAX package's sumstats psum is the same 40 bytes for
  every model (the ``parallel/collectives.py`` psum: 40 SMF, 156 and 480
  history, 80 the group, 76 the joint model, 640 the 16-row bucket).
  Its gradient is reduced otherwise: under ``shard_map``'s replication
  typing jax reduces the cotangent of each replicated value the shard's
  code reads (two 4-byte scalars for the SMF's two parameters; for the
  history model seven scalars and two (1, 16) time-grid rows), where the
  port reduces the whole gradient in one all-reduce of ``4·ndim`` bytes.
  Pre-vma jax reduces the gradient in one psum of ``4·ndim`` bytes, as
  the port does.  Vma-era jax names its reductions ``psum_invariant``,
  which the JAX package's own ``collect_collectives`` does not list, so
  the JAX side is read here with both names, its sumstats psums told
  from the gradient's by their width.  The joint model's wp(rp) ring is an
  identity at one process, so the port has none of the JAX package's
  three ``ppermute`` sites there (``tests/test_torch_group.py`` runs the
  ring across gloo ranks).
* **Verdicts.**  For every model target of the lint the port's findings
  under the four ported checks equal the JAX package's (both clean);
  ``ensemble_sharded`` waits for sharded K and ``group_mpmd`` needs two
  processes, so the port's lint skips both.
* **Mutations**, each caught in both packages with the same check id,
  severity and message words: a model that gathers its catalog
  (comm-scaling, ``"all_gather"``, ``"SCALES"``, the site in this file),
  a float64 leak (``"float64"``), a 1 MiB captured constant
  (``"1.0 MB"``, cleared at a 2 MiB threshold) and a K-coupled batched
  program (k-scaling).
* A trace launches no kernel, runs no plain version and reads no data (a
  NaN catalog gives the same trace); ``analyze_fit``,
  ``analyze_streaming``, ``assert_clean``, ``check_shard_safety`` on the
  three model classes, and the lint CLI with ``--device cpu``.
"""
import json
from dataclasses import dataclass, field

import numpy as np
import pytest
import torch
import torch.distributed as dist

from multigrad_tpu_torch import OnePointModel, StreamingOnePointModel
from multigrad_tpu_torch.analysis import (ERROR, WARNING, analyze,
                                          analyze_fit, analyze_model,
                                          analyze_program, analyze_streaming,
                                          assert_clean, check_k_scaling,
                                          collect_collectives, trace_program)
from multigrad_tpu_torch.analysis.lint import (ALL_TARGETS, MODEL_TARGETS,
                                               _build_targets, main)
from multigrad_tpu_torch.core.group import OnePointGroup
from multigrad_tpu_torch.models import SMFModel, make_smf_data
from multigrad_tpu_torch.ops import erf_kernels as ek
from multigrad_tpu_torch.ops import fused_kernels as fk
from multigrad_tpu_torch.ops import pair_kernels as pk
from multigrad_tpu_torch.parallel.mesh import MeshComm
from multigrad_tpu_torch.telemetry.costmodel import _program, meta_params

NUM_HALOS = 800
CHECKS = ("comm-scaling", "k-scaling", "dtype-promotion", "captured-const")
#: The model targets the port's lint builds on one process.
PORT_TARGETS = tuple(t for t in MODEL_TARGETS
                     if t not in ("ensemble_sharded", "group_mpmd"))


@pytest.fixture(scope="module")
def comm(tmp_path_factory):
    init = tmp_path_factory.mktemp("gloo") / "init"
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=0,
                            world_size=1)
    try:
        yield MeshComm()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def port_targets(comm):
    return {name: (obj, params, extra[0] if extra else {})
            for name, obj, params, *extra in _build_targets(
                PORT_TARGETS, NUM_HALOS, "cpu")}


@pytest.fixture(scope="module")
def jax_targets():
    from multigrad_tpu.analysis.lint import _build_targets as jax_build
    return {name: (obj, params, extra[0] if extra else {})
            for name, obj, params, *extra in jax_build(MODEL_TARGETS,
                                                       NUM_HALOS)}


def _jax_sites(model, params, kind):
    """``(op, bytes, shape)`` of every collective of a JAX model's program
    (a fused group's joint program), ``psum_invariant`` read as
    ``psum``."""
    import jax
    import jax.numpy as jnp
    from multigrad_tpu.analysis.jaxprs import abstractify, walk_eqns
    from multigrad_tpu.core.group import OnePointGroup as JaxGroup
    key = jax.ShapeDtypeStruct((), jnp.float32)
    p = abstractify(jnp.asarray(params))
    if isinstance(model, JaxGroup):
        program = model._get_fused_program(False)
        aux = tuple([abstractify(leaf) for leaf in m.aux_leaves()]
                    for m in model.models)
    else:
        program = model._build_program(kind, False)
        aux = [abstractify(leaf) for leaf in model.aux_leaves()]
    closed = jax.make_jaxpr(program)(p, aux, key)
    return [(eqn.primitive.name.replace("psum_invariant", "psum"),
             sum(v.aval.size * v.aval.dtype.itemsize for v in eqn.invars),
             tuple(eqn.invars[0].aval.shape))
            for eqn, _, _ in walk_eqns(closed)
            if eqn.primitive.name in ("psum", "psum_invariant",
                                      "all_gather", "ppermute")]


#: Each target's members' sumstats lengths: what tells a JAX sumstats
#: psum from its gradient's, which pre-vma jax reduces in one psum of
#: the gradient and vma-era jax in one a replicated value read.
SUMSTATS = {"smf": (10,), "smf_fused": (10,), "galhalo_hist": (39,),
            "galhalo_hist_fused": (120,), "group": (10, 10),
            "joint_smf_wprp": (10, 9), "serve_bucket": (10,)}


def _port_sites(obj, params, kind):
    program = obj.loss_and_grad_fn(False) if isinstance(obj, OnePointGroup) \
        else _program(obj, kind, False)
    trace = trace_program(program, meta_params(params), obj.aux_leaves(),
                          None)
    return [(s.op, s.executed_bytes) for s in collect_collectives(trace)]


# --------------------------------------------------------------------- #
# Collective sites against the JAX package's
# --------------------------------------------------------------------- #
def test_smf_sites_are_the_paper_bound(port_targets, jax_targets):
    from multigrad_tpu.analysis import collect_collectives as jax_collect
    from multigrad_tpu.analysis import trace_program as jax_trace
    model, params, _ = port_targets["smf"]
    sites = _port_sites(model, params, "loss_and_grad")
    assert sites == [("psum", 10 * 4), ("psum", 2 * 4)]
    assert sorted(b for _, b in sites) == [8, 40]
    jmodel, jparams, _ = jax_targets["smf"]
    jsites = _jax_sites(jmodel, jparams, "loss_and_grad")
    # The sumstats' 40 bytes and the gradient's 8, in one psum (pre-vma
    # jax) or one a parameter (vma-era): 48 bytes an evaluation, both.
    assert [op for op, _, _ in jsites] == ["psum"] * len(jsites)
    assert [b for _, b, shape in jsites if shape == (10,)] == [40]
    assert sum(b for _, b, _ in jsites) == sum(b for _, b in sites) == 48
    # The JAX package's own collect_collectives: [8, 40] where jax names
    # its psums psum, nothing where it names them psum_invariant.
    import jax
    import jax.numpy as jnp
    from multigrad_tpu.analysis.jaxprs import abstractify, walk_eqns
    closed = jax_trace(jmodel._build_program("loss_and_grad", False),
                       jax.ShapeDtypeStruct((2,), jnp.float32),
                       [abstractify(leaf) for leaf in jmodel.aux_leaves()],
                       jax.ShapeDtypeStruct((), jnp.float32))
    names = {eqn.primitive.name for eqn, _, _ in walk_eqns(closed)}
    own = sorted(s.executed_bytes for s in jax_collect(closed))
    assert own == ([8, 40] if "psum" in names else [])


@pytest.mark.parametrize("name", list(SUMSTATS))
def test_sites_match_jax_site_for_site(name, port_targets, jax_targets):
    obj, params, extra = port_targets[name]
    kind = extra.get("kinds", ("loss_and_grad",))[0]
    jobj, jparams, _ = jax_targets[name]
    jsites = _jax_sites(jobj, jparams, kind)
    # The JAX sumstats all-reduces, one a member (a (K, |y|) one for the
    # bucket), against the port's one joined all-reduce of them all.
    jax_y = [b for op, b, shape in jsites
             if op == "psum" and shape and shape[-1] in SUMSTATS[name]]
    assert len(jax_y) == len(SUMSTATS[name])
    grad_bytes = 4 * int(np.prod(tuple(params.shape)))
    assert _port_sites(obj, params, kind) == [("psum", sum(jax_y)),
                                              ("psum", grad_bytes)]
    # The ring: three ppermutes in the JAX package's joint program, an
    # identity at one process in the port.
    assert [op for op, _, _ in jsites].count("ppermute") == \
        (3 if name == "joint_smf_wprp" else 0)


# --------------------------------------------------------------------- #
# Verdicts against the JAX package's, every model target of the lint
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", PORT_TARGETS)
def test_verdicts_match_jax(name, port_targets, jax_targets):
    from multigrad_tpu.analysis import analyze as jax_analyze
    obj, params, extra = port_targets[name]
    got = analyze(obj, params, checks=CHECKS, **extra)
    jobj, jparams, jextra = jax_targets[name]
    want = jax_analyze(jobj, jparams, checks=CHECKS, **jextra)
    assert [(f.check, f.severity) for f in got] == \
        [(f.check, f.severity) for f in want] == []


def test_lint_targets_are_the_jax_package_s():
    from multigrad_tpu.analysis.lint import ALL_TARGETS as JAX_ALL
    from multigrad_tpu.analysis.lint import MODEL_TARGETS as JAX_MODELS
    assert MODEL_TARGETS == JAX_MODELS and ALL_TARGETS == JAX_ALL


# --------------------------------------------------------------------- #
# Mutations: each caught in both packages
# --------------------------------------------------------------------- #
@dataclass
class GatherModel(OnePointModel):
    """BROKEN: all-gathers its catalog, an O(data) collective."""

    aux_data: dict = field(default_factory=dict)

    def calc_partial_sumstats_from_params(self, params, randkey=None):
        full = self.comm.all_gather(self.aux_data["x"])
        return torch.stack([torch.sum(full * params[0]), torch.sum(params)])

    def calc_loss_from_sumstats(self, sumstats, sumstats_aux=None,
                                randkey=None):
        return torch.sum(sumstats ** 2)


def _jax_gather_model():
    import jax.numpy as jnp
    from jax import lax

    import multigrad_tpu as mgt
    from multigrad_tpu import OnePointModel as JaxModel

    @dataclass
    class JaxGatherModel(JaxModel):
        aux_data: dict = field(default_factory=dict)

        def calc_partial_sumstats_from_params(self, params, randkey=None):
            full = lax.all_gather(jnp.asarray(self.aux_data["x"]), "shards",
                                  tiled=True)
            return jnp.array([jnp.sum(full * params[0]), jnp.sum(params)])

        def calc_loss_from_sumstats(self, sumstats, sumstats_aux=None,
                                    randkey=None):
            return jnp.sum(sumstats ** 2)

    jcomm = mgt.global_comm()
    return JaxGatherModel(
        aux_data={"x": mgt.scatter_nd(jnp.ones(64), comm=jcomm)},
        comm=jcomm)


def _one_finding(findings, check):
    hits = [f for f in findings if f.check == check]
    assert len(hits) == 1, findings
    return hits[0]


def test_gather_mutation_caught_in_both(comm):
    from multigrad_tpu.analysis import analyze_model as jax_analyze_model
    import jax.numpy as jnp
    port = _one_finding(analyze_model(
        GatherModel(aux_data={"x": torch.ones(64)}, comm=comm),
        torch.zeros(2), kinds=("loss_and_grad",)), "comm-scaling")
    jax = _one_finding(jax_analyze_model(
        _jax_gather_model(), jnp.zeros(2), kinds=("loss_and_grad",)),
        "comm-scaling")
    for f in (port, jax):
        assert f.severity == ERROR
        assert "all_gather" in f.message and "SCALES" in f.message
    assert "test_torch_analysis.py" in port.where
    assert "256 B -> 512 B" in port.message


def test_assert_clean_raises_with_report(comm):
    with pytest.raises(AssertionError, match="comm-scaling"):
        assert_clean(GatherModel(aux_data={"x": torch.ones(64)}, comm=comm),
                     torch.zeros(2), kinds=("loss_and_grad",))


def test_dtype_promotion_caught_in_both():
    import jax
    import jax.numpy as jnp
    from multigrad_tpu.analysis import check_dtype_promotion, trace_program \
        as jax_trace

    def leaky(x):
        return torch.sum(x.to(torch.float64) * 2.0)

    port = analyze_program(leaky, torch.zeros(4), program="leaky")
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        closed = jax_trace(jax.jit(lambda x: jnp.sum(
            jnp.asarray(x, jnp.float64) * np.float64(2.0))),
            jax.ShapeDtypeStruct((4,), jnp.float32))
        want = check_dtype_promotion(closed, "leaky",
                                     expected_dtype=jnp.float32)
    finally:
        jax.config.update("jax_enable_x64", x64)
    for findings in (port, want):
        assert findings
        assert all(f.check == "dtype-promotion" and f.severity == ERROR
                   for f in findings)
        assert any("float64" in f.message for f in findings)
    assert analyze_program(lambda x: torch.sum(x * 2.0),
                           torch.zeros(4)) == []


def test_captured_const_caught_in_both():
    import jax
    import jax.numpy as jnp
    from multigrad_tpu.analysis import analyze_program as jax_program
    big = torch.ones(1 << 18)          # 1 MiB of float32
    jbig = jnp.ones((1 << 18,))

    def cap(x):
        return torch.sum(big * x)

    port = analyze_program(cap, torch.tensor(1.0), program="cap")
    want = jax_program(jax.jit(lambda x: jnp.sum(jbig * x)), 1.0,
                       program="cap")
    for findings in (port, want):
        assert [(f.check, f.severity) for f in findings] == \
            [("captured-const", WARNING)]
        assert "1.0 MB" in findings[0].message
    assert "test_torch_analysis.py" in port[0].where
    assert analyze_program(cap, torch.tensor(1.0),
                           const_threshold=1 << 21) == []


@dataclass
class KCoupledModel(OnePointModel):
    """BROKEN: its batched program all-reduces a (K, K, ndim) interaction
    of the members."""

    aux_data: dict = field(default_factory=dict)

    def calc_partial_sumstats_from_params(self, params, randkey=None):
        return torch.stack([torch.sum(self.aux_data["x"] * params[0]),
                            torch.sum(params)])

    def calc_loss_from_sumstats(self, sumstats, sumstats_aux=None,
                                randkey=None):
        return torch.sum(sumstats ** 2)

    def batched_loss_and_grad_fn(self, with_key=False, k_sharded=False):
        inner = super().batched_loss_and_grad_fn(with_key, k_sharded)

        def program(params, aux_leaves, key=None):
            losses, grads = inner(params, aux_leaves, key)
            pairs = self.comm.psum(params[:, None, :] - params[None, :, :])
            return losses + 0.0 * pairs.sum((1, 2)), grads
        return program


def test_k_coupled_program_caught_in_both(comm):
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    import multigrad_tpu as mgt
    from multigrad_tpu.analysis import check_k_scaling as jax_k_scaling
    from multigrad_tpu.analysis import trace_program as jax_trace

    port = _one_finding(analyze_model(
        KCoupledModel(aux_data={"x": torch.ones(64)}, comm=comm),
        torch.zeros((4, 2)), kinds=("batched_loss_and_grad",), k_scale=2),
        "k-scaling")
    from multigrad_tpu.parallel._shard_map_compat import PRE_VMA, shard_map
    jcomm = mgt.global_comm()
    unchecked = {} if PRE_VMA else {"check_vma": False}
    coupled = jax.jit(shard_map(
        lambda p: lax.psum(p[:, None, :] - p[None, :, :], "shards"),
        mesh=jcomm.mesh, in_specs=(P(),), out_specs=P(), **unchecked))
    want = _one_finding(jax_k_scaling(
        jax_trace(coupled, jax.ShapeDtypeStruct((4, 2), jnp.float32)),
        jax_trace(coupled, jax.ShapeDtypeStruct((8, 2), jnp.float32)),
        program="coupled", scale=2), "k-scaling")
    for f in (port, want):
        assert f.severity == ERROR
        assert "SUPER-linearly" in f.message and "x4.00 > x2" in f.message
    # The same pair of programs through the port's check directly.
    def port_coupled(p):
        return comm.psum(p[:, None, :] - p[None, :, :])
    assert check_k_scaling(trace_program(port_coupled, torch.zeros(4, 2)),
                           trace_program(port_coupled, torch.zeros(8, 2)),
                           scale=2)[0].check == "k-scaling"
    # An uncoupled batched program is clean.
    assert analyze_model(SMFModel(aux_data=make_smf_data(
        NUM_HALOS, comm=comm, device="cpu"), comm=comm), torch.zeros((4, 2)),
        kinds=("batched_loss_and_grad",), k_scale=2) == []


# --------------------------------------------------------------------- #
# A trace runs nothing and reads no data
# --------------------------------------------------------------------- #
def _raise(*args, **kwargs):
    raise AssertionError("a plain version ran inside a trace")


def _launch_counts():
    return {name: fn.launches for mod in (ek, fk, pk)
            for name, fn in vars(mod).items() if hasattr(fn, "launches")}


def test_trace_launches_nothing_and_reads_no_data(comm, port_targets,
                                                  monkeypatch):
    model, params, _ = port_targets["smf"]
    program = _program(model, "loss_and_grad", False)
    before = _launch_counts()
    for mod in (ek, fk, pk):
        for name in dir(mod):
            if name.endswith("_plain"):
                monkeypatch.setattr(mod, name, _raise)
    trace = trace_program(program, meta_params(params), model.aux_leaves(),
                          None)
    assert _launch_counts() == before
    nan_leaves = [torch.full_like(leaf, float("nan"))
                  for leaf in model.aux_leaves()]
    nan_trace = trace_program(program, meta_params(params), nan_leaves, None)
    assert nan_trace.ops == trace.ops
    assert nan_trace.collectives == trace.collectives
    assert trace.consts == [] and trace.cost.const_bytes == 0
    # The kernels declared their counts in the same run.
    assert trace.cost.transcendentals["erf"] == NUM_HALOS * 11


# --------------------------------------------------------------------- #
# The rest of the surface
# --------------------------------------------------------------------- #
def test_analyze_fit_and_randkey_variants(port_targets):
    model, params, _ = port_targets["smf"]
    assert analyze_fit(model, params, nsteps=3) == []
    assert analyze_fit(model, params, nsteps=2, randkey=7) == []
    assert analyze_model(model, params, randkey=7,
                         kinds=("loss_and_grad",)) == []


def test_analyze_streaming_sees_the_stream_s_two_all_reduces(comm):
    from multigrad_tpu_torch.analysis.analyzer import analyze_streaming
    aux = make_smf_data(NUM_HALOS, device="cpu")
    halos = aux.pop("log_halo_masses").numpy()
    sm = StreamingOnePointModel(model=SMFModel(aux_data=aux, comm=comm),
                                streams={"log_halo_masses": halos},
                                chunk_rows=200)
    assert analyze_streaming(sm, torch.zeros(2)) == []
    model = sm.model
    scan = model.chunk_scan_loss_and_grad_fn(("log_halo_masses",))
    trace = trace_program(scan, meta_params((0.0, 0.0)),
                          [torch.empty((2, 200))])
    assert [(s.op, s.executed_bytes) for s in
            collect_collectives(trace)] == [("psum", 40), ("psum", 8)]
    assert sm.check_shard_safety(torch.zeros(2),
                                 include_scan_path=False) == []


def test_check_shard_safety_one_call(comm, port_targets):
    smf, params, _ = port_targets["smf"]
    assert smf.check_shard_safety(params) == []
    group, _, _ = port_targets["group"]
    assert group.check_shard_safety(params) == []
    stream, _, _ = port_targets["streaming"]
    assert stream.check_shard_safety(params) == []
    assert OnePointGroup(models=(smf,)).check_shard_safety(params) == []


# --------------------------------------------------------------------- #
# CLI
# --------------------------------------------------------------------- #
def test_lint_cli_clean_exit(comm, capsys):
    rc = main(["--targets", "smf", "--json", "--num-halos", "400",
               "--device", "cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out == {"findings": [], "clean": True}


def test_lint_cli_subset_of_checks(comm, capsys):
    rc = main(["--targets", "smf,threads", "--checks",
               "comm-scaling,dtype-promotion", "--num-halos", "400",
               "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[smf] clean" in out and "[threads]" not in out


def test_lint_cli_rejects_unknown_and_unported(capsys):
    for argv in (["--targets", "nope"], ["--checks", "nope"],
                 ["--checks", "replication"],
                 ["--checks", "callback-in-scan"]):
        with pytest.raises(SystemExit) as exc:
            main(argv + ["--device", "cpu"])
        assert exc.value.code == 2
    assert "not ported" in capsys.readouterr().err


def test_lint_cli_json_carries_findings(comm, capsys, tmp_path):
    bad = tmp_path / "protocol.json"
    bad.write_text(json.dumps({"version": 1, "codecs": {},
                               "messages": {}}))
    rc = main(["--targets", "wire", "--json", "--manifest", str(bad),
               "--device", "cpu"])
    assert rc == 1
    out = json.loads(capsys.readouterr().out)
    assert out["clean"] is False
    assert {f["check"] for f in out["findings"]} == {"wire-manifest-drift"}
