"""Static shard-safety analysis (port of :mod:`multigrad_tpu.analysis`).

The paper's central claim — loss-and-grad communication of
O(|sumstats| + |params|) bytes, whatever the catalog's size — is
measured at run time by :mod:`multigrad_tpu_torch.telemetry.comm`.  This
package proves it without running anything on the card: each program is
run once on ``meta`` tensors, in the static cost model's counting run
(:mod:`.programs`), and a registry of checks reads the trace:

=================  ====================================================
``comm-scaling``   every collective's payload is the same when the
                   catalog leaves grow — the static proof of the
                   O(|y|+|params|) bound, naming the offending
                   collective's source site on failure
``k-scaling``      batched (K, ndim) programs' collective payloads
                   grow at most linearly when K grows
``dtype-promotion``  floating values wider than the working precision
                   (float64 leaks)
``captured-const``  large tensors a program reads without taking them
                   as an argument
=================  ====================================================

The JAX package's ``replication`` and ``callback-in-scan`` checks are
not ported (:data:`~.checks.NOT_PORTED`): the port has no ``shard_map``
and no in-graph host callbacks.

The program checks prove what the *programs* do; the concurrency layer
(:mod:`.concurrency` + :mod:`.lockgraph`, the ``threads`` lint target)
proves what the *threads around them* do — lock-order cycles, unguarded
condition waits, blocking calls and user callbacks under locks,
cross-thread writes with no common lock — cross-checked at run time by
the lockdep shadow (:mod:`multigrad_tpu_torch._lockdep`).
:mod:`.settlement` (the ``settlement`` target) proves every future the
serving stack mints is settled on every path, and :mod:`.wireschema`
(the ``wire`` target) extracts the fleet's wire protocol from the
source and gates its drift against the port's own
``analysis/protocol.json``.  These three read the source only (``ast``):
they are copies of the JAX package's, pointed at this package.

Entry points: :func:`analyze` / :func:`assert_clean` (tests),
``check_shard_safety`` on ``OnePointModel``, ``OnePointGroup`` and
``StreamingOnePointModel`` (one call a model),
:func:`analyze_concurrency`, :func:`analyze_settlement`,
:func:`analyze_wire` / :func:`extract_schema`, and the CI gate
``python -m multigrad_tpu_torch.analysis.lint``.
"""
from .findings import ERROR, WARNING, Finding, format_findings  # noqa
from .checks import (CHECK_IDS, DEFAULT_CONST_THRESHOLD,  # noqa
                     PROGRAM_CHECKS, check_captured_consts,
                     check_comm_invariance, check_dtype_promotion,
                     check_k_scaling)
from .programs import (CollectiveSite, collect_collectives,  # noqa
                       trace_program, walk_eqns)
from .analyzer import (analyze, analyze_fit, analyze_group,  # noqa
                       analyze_model, analyze_program,
                       analyze_streaming, assert_clean)
from .concurrency import (THREAD_CHECK_IDS,  # noqa
                          analyze_concurrency, crosscheck_runtime,
                          lock_order_dot)
from .lockgraph import ConcurrencyModel, scan_package, to_dot  # noqa
from .settlement import (SETTLE_CHECK_IDS,  # noqa
                         analyze_settlement, scan_settlement)
from .wireschema import (PROTOCOL_VERSION, WIRE_CHECK_IDS,  # noqa
                         analyze_wire, diff_schema, dump_schema,
                         extract_schema, protocol_markdown)

__all__ = [
    "Finding", "ERROR", "WARNING", "format_findings",
    "analyze", "analyze_model", "analyze_streaming", "analyze_group",
    "analyze_fit", "analyze_program", "assert_clean",
    "check_comm_invariance", "check_k_scaling",
    "check_dtype_promotion", "check_captured_consts", "CHECK_IDS",
    "PROGRAM_CHECKS", "DEFAULT_CONST_THRESHOLD",
    "CollectiveSite", "collect_collectives", "trace_program",
    "walk_eqns",
    "analyze_concurrency", "crosscheck_runtime", "lock_order_dot",
    "THREAD_CHECK_IDS", "ConcurrencyModel", "scan_package", "to_dot",
    "analyze_settlement", "scan_settlement", "SETTLE_CHECK_IDS",
    "analyze_wire", "extract_schema", "dump_schema", "diff_schema",
    "protocol_markdown", "WIRE_CHECK_IDS", "PROTOCOL_VERSION",
]
