"""Orchestration: trace a model's programs and run the checks (port of
the JAX package's ``analysis/analyzer.py``).

Entry points, from lowest to highest level:

* :func:`analyze_program` — one callable, one trace, the program-level
  checks.
* :func:`analyze_model` — an :class:`~multigrad_tpu_torch.core.model
  .OnePointModel`: traces each program kind (the cost model's, over
  meta copies of ``aux_leaves()`` bound through ``_with_leaves``), runs
  the program-level checks, and — the headline — traces each again with
  the catalog leaves scaled, to prove the O(|sumstats| + |params|)
  communication bound statically
  (:func:`~multigrad_tpu_torch.analysis.checks.check_comm_invariance`).
* :func:`analyze_streaming` — a :class:`~multigrad_tpu_torch.data
  .streaming.StreamingOnePointModel`: the same for its chunk programs,
  whose catalog axis is the chunk's row count.
* :func:`analyze_group` — an :class:`~multigrad_tpu_torch.core.group
  .OnePointGroup`: the fused joint program, or the members' programs.
* :func:`analyze_fit` — ``nsteps`` of the Adam step.
* :func:`analyze` — type dispatch over the above; :func:`assert_clean`
  — its pytest form.

Every trace runs the program once on meta tensors (see
:mod:`.programs`): no data is read, no kernel launches and nothing is
allocated on the card, so a model that lives on the card is analyzed
where it stands.

**The catalog leaves.**  The JAX package scales the aux dimensions
sharded over the model's comm.  The port has no shardings: each process
holds its own shard.  So the catalog leaves are the tensor leaves whose
leading dimension equals the per-process catalog rows — the largest
leading dimension among the leaves, the rule of
:func:`~multigrad_tpu_torch.tune.table.catalog_rows` — and only that
dimension scales; in a group the rule applies member by member.  A
small leaf (targets, bin edges) whose length happens to equal the
catalog's would scale with it, so a model whose catalog is as short as
its edges cannot be analyzed this way.  Where no leaf qualifies, the
comm-scaling check has no axis to vary.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..telemetry.costmodel import _program, meta_params
from .checks import (DEFAULT_CONST_THRESHOLD, PROGRAM_CHECKS,
                     check_comm_invariance, check_k_scaling)
from .findings import Finding, format_findings
from .programs import trace_program

__all__ = ["analyze", "analyze_program", "analyze_model",
           "analyze_streaming", "analyze_group", "analyze_fit",
           "assert_clean", "DEFAULT_KINDS"]

# The programs analyzed by default: the paper's headline program plus
# the Jacobian path the inference subsystem builds on.
DEFAULT_KINDS = ("loss_and_grad", "sumstats_jac_rev")


def _run_program_checks(trace, program: str, checks, expected_dtype,
                        const_threshold) -> List[Finding]:
    extra = {
        "dtype-promotion": {"expected_dtype": expected_dtype},
        "captured-const": {"threshold_bytes": const_threshold},
    }
    findings: List[Finding] = []
    for check_id, fn in PROGRAM_CHECKS.items():
        if checks is not None and check_id not in checks:
            continue
        findings.extend(fn(trace, program, **extra.get(check_id, {})))
    return findings


def analyze_program(fn, *args, program: str = "program",
                    checks: Optional[Sequence[str]] = None,
                    expected_dtype=None,
                    const_threshold: int = DEFAULT_CONST_THRESHOLD
                    ) -> List[Finding]:
    """Trace ``fn(*args)`` on meta copies of its tensor arguments and run
    the program-level checks (``checks`` restricts them to a subset of
    check ids)."""
    trace = trace_program(fn, *args)
    return _run_program_checks(trace, program, checks, expected_dtype,
                               const_threshold)


# --------------------------------------------------------------------- #
# Catalog-axis scaling (the comm-scaling re-trace)
# --------------------------------------------------------------------- #
def _scaled_aux(leaves, scale: int) -> tuple:
    """Meta copies of ``leaves`` with the catalog leaves' leading
    dimension scaled ``scale``× (see the module docstring for which
    leaves are the catalog); ``(leaves, n_scaled)``."""
    rows = max((int(leaf.shape[0]) for leaf in leaves
                if isinstance(leaf, torch.Tensor) and leaf.dim()),
               default=0)
    out, n_scaled = [], 0
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor) and leaf.dim() \
                and int(leaf.shape[0]) == rows:
            out.append(torch.empty((rows * scale,) + tuple(leaf.shape[1:]),
                                   dtype=leaf.dtype, device="meta"))
            n_scaled += 1
        else:
            out.append(leaf)
    return out, n_scaled


def _key(randkey):
    if randkey is None:
        return None
    from ..optim.adam import init_randkey
    return init_randkey(randkey)


def analyze_model(model, params, kinds: Sequence[str] = DEFAULT_KINDS,
                  randkey=None, checks: Optional[Sequence[str]] = None,
                  scale: int = 2, expected_dtype=None,
                  const_threshold: int = DEFAULT_CONST_THRESHOLD,
                  k_scale: Optional[int] = None) -> List[Finding]:
    """Statically verify an ``OnePointModel``'s programs.

    For each program kind (``"loss_and_grad"``,
    ``"batched_loss_and_grad"``, ``"sumstats_jac_rev"``): run the
    program-level checks on its trace, then — for a model with a comm —
    trace it again with the catalog leaves scaled ``scale``× and require
    every collective's payload unchanged (the static proof of the
    O(|sumstats|+|params|) bound, naming the offending collective's
    source site on failure).  Under a process group every collective
    records its payload, one process too; without one the comm reduces
    nothing and the check has no site to compare.

    Parameters
    ----------
    model : OnePointModel
    params : tensor or array-like
        A parameter vector, or a ``(K, ndim)`` batch (only its shape is
        read).
    kinds : sequence of str
        Program kinds (the cost model's).
    randkey : optional
        Trace the randkey-taking program variants.
    checks : sequence of str, optional
        Restrict to these check ids (default: all).
    scale : int
        Catalog growth factor for the comm-scaling re-trace.
    k_scale : int, optional
        For batched ``(K, ndim)`` programs: ALSO trace with K grown
        ``k_scale``× and require every collective payload to grow at
        most linearly (:func:`~multigrad_tpu_torch.analysis.checks
        .check_k_scaling`).  Requires 2-D ``params``.
    """
    label = type(model).__name__
    with_key = randkey is not None
    key = _key(randkey)
    p = meta_params(params)
    leaves = model.aux_leaves()

    findings: List[Finding] = []
    run_comm = checks is None or "comm-scaling" in checks
    run_k = k_scale is not None \
        and (checks is None or "k-scaling" in checks)
    if run_k and p.dim() != 2:
        raise ValueError(
            f"k_scale needs (K, ndim) params, got shape {tuple(p.shape)}")
    scaled, n_scaled = None, 0
    if run_comm and model.comm is not None:
        scaled, n_scaled = _scaled_aux(leaves, scale)

    for kind in kinds:
        program = _program(model, kind, with_key)
        prog_label = f"{label}:{kind}"
        trace = trace_program(program, p, leaves, key)
        findings.extend(_run_program_checks(
            trace, prog_label, checks, expected_dtype, const_threshold))
        if n_scaled:
            findings.extend(check_comm_invariance(
                trace, trace_program(program, p, scaled, key),
                program=prog_label, scale=scale))
        if run_k:
            p_k = torch.empty((p.shape[0] * int(k_scale), p.shape[1]),
                              dtype=p.dtype, device="meta")
            findings.extend(check_k_scaling(
                trace, trace_program(program, p_k, leaves, key),
                program=prog_label, scale=int(k_scale)))
    return findings


def analyze_streaming(sm, params, randkey=None,
                      checks: Optional[Sequence[str]] = None,
                      scale: int = 2, expected_dtype=None,
                      const_threshold: int = DEFAULT_CONST_THRESHOLD,
                      include_scan_path: bool = True) -> List[Finding]:
    """Statically verify a ``StreamingOnePointModel``'s chunk programs.

    The streamed algebra's catalog axis is the chunk's row count — an
    argument shape, not stored data — so the comm-scaling proof needs no
    second catalog: each chunk program is traced on meta chunks of this
    process's ``shard_rows`` rows and of ``scale`` times that, with the
    model's resident leaves as meta arguments, and every collective
    payload must be the same.

    Covers ``chunk_sumstats`` and ``chunk_vjp`` (the two-pass stream's
    programs: the port adds the chunks' partials up on the device and
    all-reduces the totals once a pass, so these two hold no collective)
    and, with ``include_scan_path``, ``chunk_scan`` (two chunks resident
    on the device, under the stream's ``remat_policy``), which holds the
    streamed step's two all-reduces.
    """
    model = sm.model
    label = f"Streaming[{type(model).__name__}]"
    with_key = randkey is not None
    key = _key(randkey)
    p = meta_params(params)
    aux = model.aux_leaves()
    names = sm._names
    rows = sm.plan().shard_rows
    run_comm = (checks is None or "comm-scaling" in checks) \
        and sm.comm is not None

    def chunk(n_rows, lead=()):
        out = []
        for name in names:
            row = sm.streams[name].read(0, 1)
            out.append(torch.empty(
                lead + (n_rows,) + tuple(row.shape[1:]),
                dtype=torch.from_numpy(row[:0]).dtype, device="meta"))
        return out

    findings: List[Finding] = []

    def run(program, build_args, prog_label):
        trace = trace_program(program, *build_args(rows))
        findings.extend(_run_program_checks(
            trace, prog_label, checks, expected_dtype, const_threshold))
        if run_comm:
            findings.extend(check_comm_invariance(
                trace, trace_program(program, *build_args(rows * scale)),
                program=prog_label, scale=scale))
        return trace

    def sumstats(params, chunk_, aux_, key_=None):
        return model._with_leaves(aux_).chunk_sumstats_fn(
            names, with_key)(params, chunk_, key_)

    def vjp(params, chunk_, aux_, ct, key_=None):
        return model._with_leaves(aux_).chunk_vjp_fn(
            names, with_key)(params, chunk_, ct, key_)

    total = run(sumstats, lambda r: (p, chunk(r), aux, key),
                f"{label}:chunk_sumstats").out
    # chunk_vjp takes the cotangent dL/dy, of the sumstats' shape.
    ct = total[0] if model.sumstats_func_has_aux else total
    run(vjp, lambda r: (p, chunk(r), aux, ct, key), f"{label}:chunk_vjp")

    if include_scan_path:
        def scan(params, stacks, aux_, key_=None):
            return model._with_leaves(aux_).chunk_scan_loss_and_grad_fn(
                names, with_key, remat_policy=sm.remat_policy)(
                    params, stacks, key_)

        # Two stacked chunks: the per-chunk body is the same, so any
        # size dependence shows at two.
        run(scan, lambda r: (p, chunk(r, (2,)), aux, key),
            f"{label}:chunk_scan")
    return findings


def analyze_group(group, params, randkey=None,
                  checks: Optional[Sequence[str]] = None,
                  scale: int = 2, expected_dtype=None,
                  const_threshold: int = DEFAULT_CONST_THRESHOLD,
                  comm_allow_linear: Sequence[str] = ()
                  ) -> List[Finding]:
    """Statically verify an ``OnePointGroup``.

    A fused group is checked as its ONE joint program (what runs); the
    comm-scaling re-trace scales every member's catalog leaves together.
    A group on disjoint comms runs one program per member, so each
    member this process belongs to is analyzed on its own.

    ``comm_allow_linear`` forwards to :func:`~multigrad_tpu_torch
    .analysis.checks.check_comm_invariance`: collective ops held to an
    at-most-linear catalog bound (the joint SMF + wp(rp) likelihood's
    ring, ``"ppermute"``).
    """
    from ..core.group import _runs_here

    label = f"Group[{','.join(type(m).__name__ for m in group.models)}]"
    if not group.fused:
        findings: List[Finding] = []
        for m in group.models:
            if not _runs_here(m):
                continue
            findings.extend(analyze_model(
                m, params, kinds=("loss_and_grad",), randkey=randkey,
                checks=checks, scale=scale, expected_dtype=expected_dtype,
                const_threshold=const_threshold))
        return findings

    with_key = randkey is not None
    key = _key(randkey)
    p = meta_params(params)
    program = group.loss_and_grad_fn(with_key)
    prog_label = f"{label}:fused_loss_and_grad"
    base = group.aux_leaves()
    trace = trace_program(program, p, base, key)
    findings = _run_program_checks(trace, prog_label, checks,
                                   expected_dtype, const_threshold)

    scaled, n_scaled = [], 0
    for m, leaves in zip(group.models, base):
        if m.comm is None:
            scaled.append(leaves)
            continue
        s, n = _scaled_aux(leaves, scale)
        scaled.append(s)
        n_scaled += n
    if (checks is None or "comm-scaling" in checks) and n_scaled:
        findings.extend(check_comm_invariance(
            trace, trace_program(program, p, tuple(scaled), key),
            program=prog_label, scale=scale,
            allow_linear=comm_allow_linear))
    return findings


def analyze_fit(model, params, nsteps: int = 3,
                learning_rate: float = 0.01, randkey=None,
                const_randkey: bool = False, tap=None,
                checks: Optional[Sequence[str]] = None,
                expected_dtype=None,
                const_threshold: int = DEFAULT_CONST_THRESHOLD
                ) -> List[Finding]:
    """Statically verify ``nsteps`` of a model's Adam fit.

    The fit's host loop (``optim.adam._run_adam_loop``) reads the host
    at every step — the bias corrections are host floats, the keys host
    integers, the bounds are checked there — so this traces the step
    body alone, ``nsteps`` times over, with those host values worked out
    first as the loop works them out: the model's loss and gradient, the
    bounds bijection (open bounds, as in the JAX package) and
    ``optim.adam.adam_update``, the update the loop makes.  ``tap`` is
    accepted for the JAX package's signature: the port's taps copy
    records off the card between steps and add no op to the step.
    """
    from ..optim.adam import (_wrap_bounded, adam_update,
                              bias_corrections, split_key)

    del tap
    label = f"{type(model).__name__}:adam_scan[{nsteps}]"
    with_key = randkey is not None
    key = _key(randkey)
    keys = []
    for _ in range(nsteps):
        if key is None:
            keys.append({})
        elif const_randkey:
            keys.append({"randkey": key})
        else:
            key, step_key = split_key(key)
            keys.append({"randkey": step_key})
    corrections = [bias_corrections(step) for step in range(nsteps)]
    p = meta_params(params)
    ndim = p.shape[-1]
    program = model.loss_and_grad_fn(with_key)

    def fit(u, low, high, aux_leaves):
        def loss_and_grad(params, randkey=None):
            return program(params, aux_leaves, randkey)

        fn = _wrap_bounded(loss_and_grad, low, high)
        mu, nu = torch.zeros_like(u), torch.zeros_like(u)
        for step in range(nsteps):
            out = fn(u, **keys[step])
            u, mu, nu, _ = adam_update(u, out[1], mu, nu,
                                       corrections[step], learning_rate)
        return u

    bound = torch.empty((ndim,), dtype=torch.float32, device="meta")
    trace = trace_program(fit, p, bound, bound, model.aux_leaves())
    return _run_program_checks(trace, label, checks, expected_dtype,
                               const_threshold)


def analyze(obj, params, **kwargs) -> List[Finding]:
    """Type dispatch over the ``analyze_*`` family: an ``OnePointModel``
    (subclasses included), a ``StreamingOnePointModel`` or an
    ``OnePointGroup``; ``kwargs`` go to the matching analyzer."""
    from ..core.group import OnePointGroup
    from ..core.model import OnePointModel
    from ..data.streaming import StreamingOnePointModel

    if isinstance(obj, StreamingOnePointModel):
        return analyze_streaming(obj, params, **kwargs)
    if isinstance(obj, OnePointGroup):
        return analyze_group(obj, params, **kwargs)
    if isinstance(obj, OnePointModel):
        return analyze_model(obj, params, **kwargs)
    raise TypeError(
        "analyze() wants an OnePointModel, StreamingOnePointModel or "
        f"OnePointGroup, got {type(obj).__name__}")


def assert_clean(obj, params, **kwargs) -> None:
    """Assert that the shard-safety analyzer finds nothing: one line a
    model family in a test suite ::

        from multigrad_tpu_torch.analysis import assert_clean
        assert_clean(model, params)

    and a change that breaks the communication bound, leaks float64 or
    captures a catalog fails with the full findings report.
    """
    findings = analyze(obj, params, **kwargs)
    if findings:
        raise AssertionError(
            "shard-safety analysis found problems:\n"
            + format_findings(findings))
