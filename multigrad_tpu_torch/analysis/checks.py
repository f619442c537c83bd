"""The shard-safety check registry (port of the JAX package's
``analysis/checks.py``).

Each check is a pure function over program traces
(:class:`~multigrad_tpu_torch.analysis.programs.ProgramTrace`) returning
:class:`~multigrad_tpu_torch.analysis.findings.Finding` lists, with the
JAX package's check ids, severities and message words.  Program-level
checks (:data:`PROGRAM_CHECKS`) take one trace; comm-scaling and
k-scaling take a *pair* of traces of the same program.
:func:`~multigrad_tpu_torch.analysis.analyzer.analyze_model` decides
which programs are traced and which checks run.

Two of the JAX package's six checks are not here: ``replication``
reads ``shard_map`` outputs (the port has no ``shard_map``: each process
holds its shard, and the all-reduces are explicit), and
``callback-in-scan`` reads in-graph host callbacks (the port's taps
copy records off the card between steps; see
:data:`~.programs.CALLBACK_PRIMS`).

Writing a custom check
----------------------
A program-level check is ``fn(trace, program_label) -> list[Finding]``::

    from multigrad_tpu_torch.analysis import checks

    def check_no_ppermute(trace, program):
        return [Finding("no-ppermute", ERROR, "ppermute is banned",
                        program, site.where)
                for site in collect_collectives(trace)
                if site.op == "ppermute"]

    checks.PROGRAM_CHECKS["no-ppermute"] = check_no_ppermute
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from .findings import ERROR, WARNING, Finding
from .programs import collect_collectives, iter_consts, walk_eqns

__all__ = ["check_dtype_promotion", "check_captured_consts",
           "check_comm_invariance", "check_k_scaling",
           "PROGRAM_CHECKS", "CHECK_IDS", "NOT_PORTED",
           "DEFAULT_CONST_THRESHOLD"]

# Captured tensors of at least this many bytes are flagged.  1 MiB
# passes every shipped model's edge and target vectors while catching
# any accidentally captured catalog.
DEFAULT_CONST_THRESHOLD = 1 << 20

#: The JAX package's checks the port does not run, and why.
NOT_PORTED = {
    "replication": "the port has no shard_map: each process holds its "
                   "own shard and every all-reduce is an explicit "
                   "collective call",
    "callback-in-scan": "the port has no in-graph host callbacks: its "
                        "taps copy records off the card between steps",
}


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _wider(dtype, expected: torch.dtype) -> bool:
    return (dtype.is_floating_point or dtype.is_complex) \
        and dtype.itemsize > expected.itemsize


# --------------------------------------------------------------------- #
# dtype promotion
# --------------------------------------------------------------------- #
def check_dtype_promotion(closed, program: str = "",
                          expected_dtype=None) -> List[Finding]:
    """Flag floating values wider than the working precision.

    ``expected_dtype`` defaults to float32, the params' dtype.  Any op
    output or captured constant with a wider floating dtype is a silent
    upcast: a float64 leaf or scalar that reaches the loss path promotes
    the whole gradient chain to float64, which runs at half the H100's
    FP32 rate and doubles the bytes it moves.  One finding per distinct
    op and source site, so a single leak does not bury the report.
    """
    expected = torch.float32 if expected_dtype is None else expected_dtype
    out = []
    seen = set()
    for op, path, _ in walk_eqns(closed):
        for dtype in op.dtypes:
            if not _wider(dtype, expected):
                continue
            key = (op.name, op.where)
            if key in seen:
                continue
            seen.add(key)
            out.append(Finding(
                "dtype-promotion", ERROR,
                f"{op.name} produces {_dtype_name(dtype)} but the "
                f"working precision is {_dtype_name(expected)}: an "
                "upcast is widening the compute (on the card at half "
                "the FP32 rate, with twice the bytes)",
                program=program, where=op.where, path="/".join(path)))
    for const, path in iter_consts(closed):
        if not _wider(const.dtype, expected):
            continue
        out.append(Finding(
            "dtype-promotion", ERROR,
            f"captured constant of dtype {_dtype_name(const.dtype)} "
            f"(shape {const.shape}) exceeds the working precision "
            f"{_dtype_name(expected)}",
            program=program, where=const.where, path=path))
    return out


# --------------------------------------------------------------------- #
# captured-constant bloat
# --------------------------------------------------------------------- #
def check_captured_consts(closed, program: str = "",
                          threshold_bytes: int = DEFAULT_CONST_THRESHOLD
                          ) -> List[Finding]:
    """Flag large tensors the program reads without taking them as an
    argument.

    Data must enter a program as an *argument* (the model's aux leaves,
    rebound through ``_with_leaves``): a captured tensor stays the same
    whatever data the program is given, so an ensemble, a stream or a
    scaled copy of the catalog silently reads the old one, and it holds
    its memory on the card for as long as the program lives.
    """
    out = []
    for const, path in iter_consts(closed):
        if const.nbytes < threshold_bytes:
            continue
        out.append(Finding(
            "captured-const", WARNING,
            f"program closes over a {const.nbytes / 1e6:.1f} MB constant "
            f"(shape {const.shape}, dtype {_dtype_name(const.dtype)}): "
            "pass it as an argument (model aux_data) instead of "
            "capturing it",
            program=program, where=const.where, path=path))
    return out


# --------------------------------------------------------------------- #
# communication-scaling invariance (the paper's bound)
# --------------------------------------------------------------------- #
def check_comm_invariance(closed_base, closed_scaled, program: str = "",
                          scale: int = 2,
                          allow_linear: Sequence[str] = ()
                          ) -> List[Finding]:
    """Prove every collective's payload independent of catalog size.

    ``closed_base``/``closed_scaled`` are traces of the SAME program with
    the catalog leaves scaled by ``scale``.  Pairs the collective sites
    in the order they ran (fixed for a fixed program) and flags any site
    whose per-execution payload changed — a collective that moves
    O(data) bytes, breaking the O(|sumstats| + |params|) bound.  Both
    traces run on meta tensors: nothing executes on a device.

    ``allow_linear`` names collective ops (``"ppermute"``) that are
    declared ring exchanges: a pair-counting member's ring moves
    O(rows-per-shard) by construction, so those sites are held to an
    at-most-linear bound; every reduction still meets the exact one.
    """
    base = collect_collectives(closed_base)
    scaled = collect_collectives(closed_scaled)
    out = []
    if len(base) != len(scaled):
        return [Finding(
            "comm-scaling", ERROR,
            f"collective COUNT changes with catalog size: {len(base)} "
            f"sites at base size vs {len(scaled)} at {scale}x — the "
            "communication schedule itself is data-dependent",
            program=program)]
    for site_b, site_s in zip(base, scaled):
        if site_b.op != site_s.op:
            out.append(Finding(
                "comm-scaling", ERROR,
                f"collective schedule diverges with catalog size: "
                f"{site_b.op} at base size vs {site_s.op} at "
                f"{scale}x in the same position",
                program=program, where=site_s.where, path=site_s.path))
            continue
        if site_b.op in allow_linear:
            if site_s.executed_bytes > site_b.executed_bytes * scale:
                grew = site_s.executed_bytes \
                    / max(site_b.executed_bytes, 1)
                out.append(Finding(
                    "comm-scaling", ERROR,
                    f"{site_b.op} payload grows SUPER-linearly with "
                    f"the catalog: {site_b.executed_bytes} B -> "
                    f"{site_s.executed_bytes} B per execution when "
                    f"the catalog grows {scale}x (x{grew:.2f}) — a "
                    "declared ring exchange may move at most "
                    "O(rows-per-shard)",
                    program=program, where=site_s.where,
                    path=site_s.path))
            continue
        if site_b.executed_bytes != site_s.executed_bytes:
            grew = site_s.executed_bytes / max(site_b.executed_bytes, 1)
            out.append(Finding(
                "comm-scaling", ERROR,
                f"{site_b.op} payload SCALES with the catalog: "
                f"{site_b.executed_bytes} B -> "
                f"{site_s.executed_bytes} B per execution when the "
                f"catalog grows {scale}x (x{grew:.2f}) — this "
                "collective moves O(data) and breaks the "
                "O(|sumstats|+|params|) communication bound",
                program=program, where=site_s.where, path=site_s.path))
    return out


# --------------------------------------------------------------------- #
# ensemble K-axis scaling
# --------------------------------------------------------------------- #
def check_k_scaling(closed_base, closed_scaled, program: str = "",
                    scale: int = 2) -> List[Finding]:
    """Prove a batched ``(K, ndim)`` program's comm scales at most
    linearly in K.

    ``closed_base``/``closed_scaled`` are traces of the SAME batched
    program at K and ``scale · K`` rows.  Doubling the ensemble may at
    most double each collective's payload; a site that grows faster (a
    cross-member coupling: a gathered ``(K, K)`` interaction, an
    all-gather of the whole batch per member) or a K-dependent schedule
    is flagged.  Sites that do not grow are fine: the bound is an upper
    envelope.
    """
    base = collect_collectives(closed_base)
    scaled = collect_collectives(closed_scaled)
    if len(base) != len(scaled):
        return [Finding(
            "k-scaling", ERROR,
            f"collective COUNT changes with ensemble width: "
            f"{len(base)} sites at K vs {len(scaled)} at {scale}·K — "
            "the communication schedule itself depends on K, so "
            "comm grows with ensemble width",
            program=program)]
    out = []
    for site_b, site_s in zip(base, scaled):
        if site_b.op != site_s.op:
            out.append(Finding(
                "k-scaling", ERROR,
                f"collective schedule diverges with ensemble width: "
                f"{site_b.op} at K vs {site_s.op} at {scale}·K in "
                "the same position",
                program=program, where=site_s.where,
                path=site_s.path))
            continue
        if site_s.executed_bytes > scale * site_b.executed_bytes:
            grew = site_s.executed_bytes / max(site_b.executed_bytes,
                                               1)
            out.append(Finding(
                "k-scaling", ERROR,
                f"{site_b.op} payload grows SUPER-linearly in the "
                f"ensemble width: {site_b.executed_bytes} B -> "
                f"{site_s.executed_bytes} B per execution when K "
                f"grows {scale}x (x{grew:.2f} > x{scale}) — a "
                "cross-member coupling is hiding in the batched "
                "program, breaking the K·O(|y|+|params|) comm bound",
                program=program, where=site_s.where,
                path=site_s.path))
    return out


# Registry: program-level checks, run by analyze_program on every
# traced program.  comm-scaling and k-scaling need two traces and are
# run by analyze_model.
PROGRAM_CHECKS = {
    "dtype-promotion": check_dtype_promotion,
    "captured-const": check_captured_consts,
}

CHECK_IDS = ("comm-scaling", "k-scaling") + tuple(PROGRAM_CHECKS)
