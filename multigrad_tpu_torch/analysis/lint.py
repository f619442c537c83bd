"""Shard-safety lint CLI: static verification as a CI gate (port of the
JAX package's ``analysis/lint.py``).

Runs the analyzer (:mod:`multigrad_tpu_torch.analysis`) over the shipped
model families and the AST passes over the package's own source, and
exits non-zero on findings.  Every program runs on meta tensors: the
models are built on ``--device`` (the card by default) and nothing is
launched or allocated there by the analysis.

Usage::

    python -m multigrad_tpu_torch.analysis.lint               # the card
    python -m multigrad_tpu_torch.analysis.lint --device cpu
    python -m multigrad_tpu_torch.analysis.lint --targets smf,streaming
    python -m multigrad_tpu_torch.analysis.lint --json

    # the AST passes (no models)
    python -m multigrad_tpu_torch.analysis.lint --targets threads
    python -m multigrad_tpu_torch.analysis.lint --targets settlement,wire
    python -m multigrad_tpu_torch.analysis.lint --targets wire \\
        --emit-protocol multigrad_tpu_torch/analysis/protocol.json

Under a launcher (``MASTER_ADDR``, ``RANK``, ``WORLD_SIZE``) the CLI
brings up the process group through
:func:`~multigrad_tpu_torch.parallel.distributed.initialize`, so the
models' comms record their collectives and the comm-scaling check has
sites to compare; a single process with no launcher runs every check
with comms that reduce nothing.  ``group_mpmd`` and ``ensemble_sharded``
need a launcher's world of at least 2 processes (a replica axis of 2 over
:func:`~multigrad_tpu_torch.parallel.ensemble_comm`): below that both say
so on stderr and are skipped.

stdlib-argparse only; exit status 0 = clean, 1 = findings, 2 = usage.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

import numpy as np
import torch

from .analyzer import analyze
from .checks import CHECK_IDS, DEFAULT_CONST_THRESHOLD, NOT_PORTED
from .findings import ERROR


def _build_targets(names, num_halos: int, device="cuda"):
    """Build the shipped model families to verify, on ``device``.

    Yields ``(name, obj, params[, analyze_kwargs])`` tuples; each is built
    only when asked for.
    """
    from ..core.group import OnePointGroup
    from ..data.streaming import StreamingOnePointModel
    from ..models.galhalo_hist import (GalhaloHistModel, TRUTH,
                                       make_galhalo_hist_data)
    from ..models.smf import SMFChi2Model, SMFModel, make_smf_data
    from ..parallel.mesh import global_comm, split_subcomms

    comm = global_comm()
    params2 = torch.zeros(2)

    def smf_data(**kwargs):
        return make_smf_data(num_halos, comm=comm, device=device, **kwargs)

    if "smf" in names:
        yield "smf", SMFModel(aux_data=smf_data(), comm=comm), params2
    if "smf_chi2" in names:
        yield "smf_chi2", SMFChi2Model(aux_data=smf_data(), comm=comm), \
            params2
    if "smf_fused" in names:
        # The fused windowed counts (bin_mode="fused"), held to the same
        # comm bound as the dense kernel.
        from ..ops.binned import fused_bin_window
        window = fused_bin_window(np.linspace(9, 10, 11), 0.6)
        yield "smf_fused", SMFModel(
            aux_data=smf_data(bin_mode="fused", bin_window=window),
            comm=comm), params2
    if "galhalo_hist" in names:
        yield "galhalo_hist", GalhaloHistModel(
            aux_data=make_galhalo_hist_data(num_halos, comm=comm,
                                            device=device),
            comm=comm), torch.tensor(TRUTH, dtype=torch.float32)
    if "galhalo_hist_fused" in names:
        from ..ops.binned import fused_bin_window
        edges = np.linspace(7.0, 11.75, 41)
        yield "galhalo_hist_fused", GalhaloHistModel(
            aux_data=make_galhalo_hist_data(
                num_halos, comm=comm, bin_edges=edges, bin_mode="fused",
                bin_window=fused_bin_window(edges, 0.3), device=device),
            comm=comm), torch.tensor(TRUTH, dtype=torch.float32)
    if "ensemble_sharded" in names:
        # The sharded-K ensemble path: a (K, ndim) batch partitioned over
        # the replica axis of an (R, D) ensemble comm.  Two static
        # proofs: catalog comm-scaling (the rows' O(|y| + |params|)
        # data-axis bound untouched by catalog growth) and k-scaling
        # (doubling K scales every payload at most linearly).
        if comm.size < 2:
            print("lint: skipping ensemble_sharded (needs >= 2 processes "
                  "for a replica axis)", file=sys.stderr)
        else:
            from ..parallel.mesh import ensemble_comm
            ecomm = ensemble_comm(2)
            yield ("ensemble_sharded", SMFModel(
                aux_data=make_smf_data(num_halos, comm=ecomm,
                                       device=device), comm=ecomm),
                torch.zeros((8, 2)),
                dict(kinds=("batched_loss_and_grad_sharded",), k_scale=2))
    if "serve_bucket" in names:
        # The scheduler's bucketed dispatch: K tenants' fits through ONE
        # (K, ndim) batched program, whose all-reduces carry (K, |y|)
        # and (K, |params|) whatever the catalog.
        yield ("serve_bucket", SMFModel(aux_data=smf_data(), comm=comm),
               torch.zeros((16, 2)),
               dict(kinds=("batched_loss_and_grad",)))
    if "streaming" in names:
        aux = make_smf_data(num_halos, device=device)
        log_mh = aux.pop("log_halo_masses").cpu().numpy()
        yield "streaming", StreamingOnePointModel(
            model=SMFModel(aux_data=aux, comm=comm),
            streams={"log_halo_masses": log_mh},
            chunk_rows=max(comm.size, num_halos // 4)), params2
    if "group" in names:
        # Fused: two members on ONE comm -> one joint program.
        yield "group", OnePointGroup(models=(
            SMFModel(aux_data=smf_data(), comm=comm),
            SMFChi2Model(aux_data=smf_data(), comm=comm))), params2
    if "group_mpmd" in names:
        # Members on DISJOINT sub-comms -> per-member programs.  Needs
        # >= 2 processes to split.
        if comm.size < 2:
            print("lint: skipping group_mpmd (needs >= 2 processes)",
                  file=sys.stderr)
        else:
            subcomms, _, _ = split_subcomms(num_groups=2, comm=comm)
            yield "group_mpmd", OnePointGroup(models=tuple(
                cls(aux_data=make_smf_data(num_halos, comm=sub,
                                           device=device), comm=sub)
                for cls, sub in ((SMFModel, subcomms[0]),
                                 (SMFChi2Model, subcomms[1])))), params2
    if "joint_smf_wprp" in names:
        # The joint SMF chi2 + wp(rp) likelihood fused on one comm
        # through param views: O(|y_smf| + |y_wprp| + |params|) on the
        # wire whatever either member holds.
        from ..models.joint import make_joint_smf_wprp
        yield ("joint_smf_wprp",
               make_joint_smf_wprp(num_halos=min(num_halos, 512),
                                   comm=comm, device=device),
               torch.zeros(3),
               # The wp(rp) member's ring is a DECLARED neighbour
               # exchange (O(rows-per-shard) by construction); every
               # reduction still meets the exact bound.
               dict(comm_allow_linear=("ppermute",)))


#: The model families :func:`_build_targets` builds.
MODEL_TARGETS = ("smf", "smf_chi2", "smf_fused", "galhalo_hist",
                 "galhalo_hist_fused", "ensemble_sharded",
                 "serve_bucket", "streaming", "group", "group_mpmd",
                 "joint_smf_wprp")
#: All lint targets: the model families plus the AST passes over the
#: package's own source (threads, settlement, wire).
ALL_TARGETS = MODEL_TARGETS + ("threads", "settlement", "wire")


def _run_threads_target(args, checks=None) -> list:
    """The concurrency pass: an AST scan of the package (lock-order
    graph, condition waits, blocking calls and callbacks under locks,
    shared writes, thread names, allowlist verification), with the
    optional lockdep cross-check and DOT export."""
    from .concurrency import (analyze_concurrency, crosscheck_runtime,
                              lock_order_dot, scan_package)
    model = scan_package()
    findings = list(analyze_concurrency(model=model, checks=checks))
    if args.runtime_edges:
        findings.extend(crosscheck_runtime(args.runtime_edges,
                                           model=model))
    if args.dot:
        with open(args.dot, "w") as f:
            f.write(lock_order_dot(model=model))
        print(f"[threads] lock-order graph -> {args.dot}",
              file=sys.stderr)
    return findings


def _run_settlement_target(checks=None) -> list:
    """The settlement pass: every future the serve layer mints is
    settled on every path, in the right order."""
    from .settlement import analyze_settlement
    return list(analyze_settlement(checks=checks))


def _run_wire_target(args, checks=None) -> list:
    """The wire-schema pass: extract the codec and message schema from
    the serve modules, check writer/reader key symmetry and known-keys
    readers, and diff against the port's ``analysis/protocol.json``.
    ``--emit-protocol`` writes the extracted schema (``-`` for stdout)
    and skips the drift diff for that run."""
    from .wireschema import analyze_wire, dump_schema, extract_schema
    model = extract_schema()
    if args.emit_protocol:
        payload = dump_schema(model.schema)
        if args.emit_protocol == "-":
            sys.stdout.write(payload)
        else:
            with open(args.emit_protocol, "w", encoding="utf-8") as f:
                f.write(payload)
            print(f"[wire] protocol manifest -> {args.emit_protocol}",
                  file=sys.stderr)
        if checks is None:
            checks = ["wire-key-asymmetry", "wire-reader-splat"]
        else:
            checks = [c for c in checks if c != "wire-manifest-drift"]
    return list(analyze_wire(model=model, checks=checks,
                             manifest_path=args.manifest))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m multigrad_tpu_torch.analysis.lint",
        description="Static shard-safety verification of the shipped "
                    "models (every program runs on meta tensors).")
    parser.add_argument(
        "--targets", default=",".join(ALL_TARGETS),
        help=f"comma list from {{{','.join(ALL_TARGETS)}}} "
             "(default: all)")
    parser.add_argument(
        "--checks", default=None,
        help=f"comma list from {{{','.join(CHECK_IDS)}}} and the AST "
             "passes' check ids (default: all)")
    parser.add_argument(
        "--num-halos", type=int, default=800,
        help="catalog size of the models built (default 800)")
    parser.add_argument(
        "--scale", type=int, default=2,
        help="catalog growth factor for the comm-scaling re-trace "
             "(default 2)")
    parser.add_argument(
        "--const-threshold", type=int, default=DEFAULT_CONST_THRESHOLD,
        help="captured-constant size threshold in bytes "
             "(default 1 MiB)")
    parser.add_argument(
        "--randkey", type=int, default=None,
        help="also trace the randkey-taking program variants")
    parser.add_argument(
        "--dot", default=None, metavar="PATH",
        help="write the lock-order graph as Graphviz DOT (threads "
             "target)")
    parser.add_argument(
        "--runtime-edges", default=None, metavar="PATH",
        help="lockdep dump file (or directory of lockdep-*.json dumps "
             "from a MGT_LOCKDEP=1 run) to cross-check against the "
             "static lock graph (threads target)")
    parser.add_argument(
        "--manifest", default=None, metavar="PATH",
        help="wire-protocol manifest to diff against (wire target; "
             "default: the port's analysis/protocol.json)")
    parser.add_argument(
        "--emit-protocol", default=None, metavar="PATH",
        help="write the extracted wire schema as a protocol manifest "
             "('-' for stdout) and skip the drift diff for this run "
             "(wire target; the manifest-bump workflow)")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable findings on stdout")
    parser.add_argument(
        "--device", default="cuda",
        help="where the models are built (default cuda; the analysis "
             "itself runs on meta tensors)")
    args = parser.parse_args(argv)

    targets = [t.strip() for t in args.targets.split(",") if t.strip()]
    unknown = set(targets) - set(ALL_TARGETS)
    if unknown:
        parser.error(f"unknown targets {sorted(unknown)}")
    # --checks spans every registry: program check ids apply to the model
    # targets, thread/settle/wire ids to their passes.  A selection that
    # names only one side runs nothing on the others; an id in no
    # registry is a usage error, and so is a JAX check the port does not
    # run.
    from .concurrency import THREAD_CHECK_IDS
    from .settlement import SETTLE_CHECK_IDS
    from .wireschema import WIRE_CHECK_IDS
    checks = thread_checks = settle_checks = wire_checks = None
    if args.checks is not None:
        selected = [c.strip() for c in args.checks.split(",")
                    if c.strip()]
        not_ported = [c for c in selected if c in NOT_PORTED]
        if not_ported:
            parser.error("; ".join(
                f"check {c!r} is not ported ({NOT_PORTED[c]})"
                for c in not_ported))
        bad = set(selected) - set(CHECK_IDS) - set(THREAD_CHECK_IDS) \
            - set(SETTLE_CHECK_IDS) - set(WIRE_CHECK_IDS)
        if bad:
            parser.error(f"unknown checks {sorted(bad)}")
        checks = [c for c in selected if c in CHECK_IDS]
        thread_checks = [c for c in selected if c in THREAD_CHECK_IDS]
        settle_checks = [c for c in selected if c in SETTLE_CHECK_IDS]
        wire_checks = [c for c in selected if c in WIRE_CHECK_IDS]

    all_findings: List = []

    def report(name, findings):
        all_findings.extend(findings)
        if not args.json:
            status = "clean" if not findings \
                else f"{len(findings)} finding(s)"
            print(f"[{name}] {status}")
            for f in findings:
                print(f"    {f}")

    def static_pass(name, selected_checks, run):
        if selected_checks is None or selected_checks:
            report(name, run(selected_checks))

    if "threads" in targets:
        static_pass("threads", thread_checks,
                    lambda c: _run_threads_target(args, checks=c))
    if "settlement" in targets:
        static_pass("settlement", settle_checks,
                    lambda c: _run_settlement_target(checks=c))
    if "wire" in targets:
        static_pass("wire", wire_checks,
                    lambda c: _run_wire_target(args, checks=c))
    targets = [t for t in targets if t in MODEL_TARGETS]
    if checks is not None and not checks:
        targets = []          # a run of the AST passes' checks only
    # Under a launcher (and with no group yet) the models' comms need the
    # launcher's group; otherwise the process state is left as it is.
    import torch.distributed as dist
    own_group = False
    if targets and not dist.is_initialized() and any(
            name in os.environ for name in ("MASTER_ADDR", "RANK",
                                            "WORLD_SIZE")):
        from ..parallel.distributed import initialize
        initialize(device=args.device)
        own_group = dist.is_initialized()
    try:
        for name, obj, params, *extra in _build_targets(
                targets, args.num_halos, args.device):
            report(name, analyze(obj, params, checks=checks,
                                 scale=args.scale, randkey=args.randkey,
                                 const_threshold=args.const_threshold,
                                 **(extra[0] if extra else {})))
    finally:
        if own_group:            # the launcher's group this run brought up
            dist.destroy_process_group()

    if args.json:
        print(json.dumps({
            "findings": [f.to_dict() for f in all_findings],
            "clean": not all_findings,
        }, indent=2))
    elif all_findings:
        n_err = sum(1 for f in all_findings if f.severity == ERROR)
        print(f"-- {len(all_findings)} finding(s), {n_err} error(s)")
    else:
        print("clean: no findings")
    return 1 if all_findings else 0


if __name__ == "__main__":
    sys.exit(main())
