"""Cross-rank telemetry aggregation: merge, skew, stragglers (a copy of
:mod:`multigrad_tpu.telemetry.aggregate`; :func:`gather_to_rank0` goes
over ``torch.distributed``).

Under several processes every process writes its own JSONL stream
(rank-gated taps write on process 0 only, but spans, heartbeats,
stream counters and stalls are per-host facts).  This module turns a
pile of per-rank files into one fleet view::

    python -m multigrad_tpu_torch.telemetry.aggregate rank*.jsonl
    python -m multigrad_tpu_torch.telemetry.aggregate --json rank*.jsonl
    python -m multigrad_tpu_torch.telemetry.aggregate --out merged.jsonl ...

Every record carries ``process_index`` (stamped by
:class:`~multigrad_tpu_torch.telemetry.MetricsLogger` since the flight-
recorder PR), so merged streams stay attributable.  The aggregation:

* **per-rank summary** — record counts, wall span, heartbeat/stall
  totals per process;
* **span skew** — for every span path that appears on ≥ 2 ranks, the
  start/end spread across ranks (span records carry exit time ``t``
  and ``elapsed_s``, so both endpoints are reconstructible);
* **straggler detection** — ranks whose span end lags the fleet
  median by more than ``threshold_s`` (default) or
  ``threshold_frac`` × the median duration, whichever is larger —
  the pjit-pod debugging workflow's first question ("which host is
  late?") answered from artifact files alone.

The CLI path is pure stdlib (same caveat as ``telemetry.report``:
``-m`` imports the package and therefore torch; run the file directly
on a torch-less triage box).  :func:`gather_to_rank0` is the in-job
collection helper: it ships each process's records to process 0 over
``torch.distributed``, for jobs whose hosts lack a shared filesystem.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Sequence

__all__ = ["load_rank_records", "merge_records", "rank_summary",
           "span_skew", "find_stragglers", "gather_to_rank0",
           "aggregate", "merge_traces", "main"]


def _load_jsonl(path: str) -> list:
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except ValueError:
                continue            # truncated tail: skip, don't die
    return records


def load_rank_records(paths: Sequence[str]) -> list:
    """Read per-rank JSONL files into one stamped record list.

    Records missing ``process_index`` (pre-stamp streams) inherit it
    from their file's run record, else the file's position in
    ``paths`` — so legacy files still merge deterministically.
    """
    merged = []
    for i, path in enumerate(paths):
        records = _load_jsonl(path)
        default = i
        for rec in records:
            if rec.get("event") == "run" \
                    and rec.get("process_index") is not None:
                default = rec["process_index"]
                break
        for rec in records:
            if rec.get("process_index") is None:
                rec = dict(rec, process_index=default)
            merged.append(rec)
    return merged


def merge_records(records: list) -> list:
    """Stable time-ordered merge (records without ``t`` sort last,
    preserving their relative order)."""
    return sorted(records, key=lambda r: (r.get("t") is None,
                                          r.get("t") or 0.0))


def rank_summary(records: list) -> dict:
    """Per-rank record accounting: counts, wall span, liveness."""
    by_rank: dict = {}
    for rec in records:
        rank = rec.get("process_index", 0)
        cur = by_rank.setdefault(rank, {
            "records": 0, "first_t": None, "last_t": None,
            "heartbeats": 0, "stalls": 0, "events": {}})
        cur["records"] += 1
        t = rec.get("t")
        if t is not None:
            cur["first_t"] = t if cur["first_t"] is None \
                else min(cur["first_t"], t)
            cur["last_t"] = t if cur["last_t"] is None \
                else max(cur["last_t"], t)
        event = rec.get("event", "?")
        cur["events"][event] = cur["events"].get(event, 0) + 1
        if event == "heartbeat":
            cur["heartbeats"] += 1
        elif event == "stall":
            cur["stalls"] += 1
    for cur in by_rank.values():
        if cur["first_t"] is not None and cur["last_t"] is not None:
            cur["wall_s"] = round(cur["last_t"] - cur["first_t"], 3)
    return by_rank


def _median(values: List[float]) -> float:
    values = sorted(values)
    n = len(values)
    mid = n // 2
    return values[mid] if n % 2 else 0.5 * (values[mid - 1]
                                            + values[mid])


def span_skew(records: list) -> dict:
    """Cross-rank start/end spread per span path.

    Only spans seen on ≥ 2 distinct ranks are reported (a rank-0-only
    span has no skew to measure).  Multiple occurrences of a path on
    one rank keep the LAST one — the steady-state occurrence, which
    is what straggler analysis wants.
    """
    per_path: dict = {}
    for rec in records:
        if rec.get("event") != "span":
            continue
        t = rec.get("t")
        elapsed = rec.get("elapsed_s")
        if t is None or elapsed is None:
            continue
        path = rec.get("path", rec.get("name", "?"))
        rank = rec.get("process_index", 0)
        per_path.setdefault(path, {})[rank] = {
            "start": t - elapsed, "end": t,
            "elapsed_s": elapsed}
    out = {}
    for path, ranks in per_path.items():
        if len(ranks) < 2:
            continue
        starts = [v["start"] for v in ranks.values()]
        ends = [v["end"] for v in ranks.values()]
        out[path] = {
            "ranks": sorted(ranks),
            "start_spread_s": round(max(starts) - min(starts), 4),
            "end_spread_s": round(max(ends) - min(ends), 4),
            "median_elapsed_s": round(_median(
                [v["elapsed_s"] for v in ranks.values()]), 4),
            "per_rank": {r: {"start": round(v["start"], 4),
                             "end": round(v["end"], 4),
                             "elapsed_s": round(v["elapsed_s"], 4)}
                         for r, v in sorted(ranks.items())},
        }
    return out


def find_stragglers(skew: dict, threshold_s: float = 1.0,
                    threshold_frac: float = 0.2) -> list:
    """Ranks whose span END lags the fleet median.

    A rank straggles on a span when ``end - median(end)`` exceeds
    ``max(threshold_s, threshold_frac · median_elapsed)`` — the
    absolute floor keeps sub-second jitter quiet, the fractional
    term scales with long spans.  Returns a list of findings.
    """
    findings = []
    for path, info in skew.items():
        ends = {r: v["end"] for r, v in info["per_rank"].items()}
        med = _median(list(ends.values()))
        limit = max(threshold_s,
                    threshold_frac * info["median_elapsed_s"])
        for rank, end in sorted(ends.items()):
            lag = end - med
            if lag > limit:
                findings.append({
                    "span": path, "rank": rank,
                    "lag_s": round(lag, 4),
                    "limit_s": round(limit, 4),
                    "median_end": round(med, 4)})
    return findings


def aggregate(paths: Sequence[str], threshold_s: float = 1.0,
              threshold_frac: float = 0.2) -> dict:
    """The whole pipeline: load → merge → summarize → skew →
    stragglers (the CLI's machine-readable output)."""
    merged = merge_records(load_rank_records(paths))
    skew = span_skew(merged)
    return {
        "files": list(paths),
        "n_records": len(merged),
        "n_traces": len({r.get("trace_id") for r in merged
                         if r.get("event") == "trace_span"
                         and r.get("trace_id")}),
        "ranks": rank_summary(merged),
        "span_skew": skew,
        "stragglers": find_stragglers(skew, threshold_s,
                                      threshold_frac),
    }


def merge_traces(paths: Sequence[str]) -> dict:
    """Merge per-process trace JSONLs by ``trace_id``.

    The cross-process assembly step of distributed request tracing
    (:mod:`.tracing`): the router and every fleet worker write their
    own ``trace_span`` stream; grouping the union by ``trace_id``
    reconstructs each request's full hop waterfall — including a
    SIGKILL'd worker's partial spans next to the survivor's, since
    the line-atomic per-process files survive the death.  Returns
    ``{trace_id: [span records sorted by start]}``; render with
    ``python -m multigrad_tpu_torch.telemetry.trace`` (whose
    :func:`~multigrad_tpu_torch.telemetry.trace.trace_summary` adds the
    completeness/coverage verdicts).
    """
    from .trace import group_traces, load_spans
    return group_traces(load_spans(paths))


def gather_to_rank0(records: list) -> Optional[list]:
    """Collect every process's records onto process 0 in-job.

    Serializes the local records to JSON bytes and all-gathers them
    as padded uint8 tensors over ``torch.distributed`` (no shared
    filesystem needed): the lengths first, then the buffers, on the
    card under NCCL and on the CPU under gloo.  Returns the merged
    stamped list on process 0 and ``None`` elsewhere; with no process
    group, or a world of one, the local records come back merged.
    """
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return merge_records([dict(r) for r in records])

    import numpy as np
    import torch

    device = torch.device("cpu")
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size()
    blob = json.dumps(records).encode()
    n = torch.tensor([len(blob)], dtype=torch.int64, device=device)
    lengths = [torch.zeros_like(n) for _ in range(world)]
    dist.all_gather(lengths, n)
    lengths = [int(x.item()) for x in lengths]
    pad = max(lengths)
    buf = torch.zeros(pad, dtype=torch.uint8)
    buf[:len(blob)] = torch.from_numpy(
        np.frombuffer(blob, np.uint8).copy())
    buf = buf.to(device)
    gathered = [torch.zeros_like(buf) for _ in range(world)]
    dist.all_gather(gathered, buf)
    if dist.get_rank() != 0:
        return None
    merged = []
    for rank, (length, row) in enumerate(zip(lengths, gathered)):
        recs = json.loads(bytes(row[:length].cpu().numpy()).decode())
        for rec in recs:
            if rec.get("process_index") is None:
                rec = dict(rec, process_index=rank)
            merged.append(rec)
    return merge_records(merged)


def render(summary: dict) -> str:
    """Human-readable fleet view of :func:`aggregate`'s output."""
    lines = [f"{len(summary['files'])} rank files, "
             f"{summary['n_records']} records"
             + (f", {summary['n_traces']} request traces "
                "(render: python -m multigrad_tpu_torch.telemetry.trace)"
                if summary.get("n_traces") else "")]
    for rank, cur in sorted(summary["ranks"].items()):
        events = "  ".join(f"{k}={v}" for k, v
                           in sorted(cur["events"].items()))
        wall = cur.get("wall_s")
        lines.append(
            f"rank {rank}: {cur['records']} records"
            + (f" over {wall}s" if wall is not None else "")
            + (f", {cur['stalls']} stalls" if cur["stalls"] else "")
            + f"  [{events}]")
    for path, info in sorted(summary["span_skew"].items()):
        lines.append(
            f"span {path}: end spread {info['end_spread_s']}s over "
            f"ranks {info['ranks']} "
            f"(median {info['median_elapsed_s']}s)")
    if summary["stragglers"]:
        for s in summary["stragglers"]:
            lines.append(
                f"STRAGGLER rank {s['rank']} on span {s['span']}: "
                f"{s['lag_s']}s behind the median "
                f"(limit {s['limit_s']}s)")
    else:
        lines.append("no stragglers detected")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m multigrad_tpu_torch.telemetry.aggregate",
        description="Merge per-rank telemetry JSONLs; detect span "
                    "skew and stragglers.")
    parser.add_argument("paths", nargs="+",
                        help="per-rank telemetry .jsonl files")
    parser.add_argument("--json", action="store_true",
                        help="emit the aggregate as JSON")
    parser.add_argument("--out", default=None,
                        help="also write the merged stamped stream "
                             "to this JSONL path")
    parser.add_argument("--threshold-s", type=float, default=1.0,
                        help="absolute straggler lag floor (s)")
    parser.add_argument("--threshold-frac", type=float, default=0.2,
                        help="straggler lag as a fraction of the "
                             "median span duration")
    args = parser.parse_args(argv)
    try:
        summary = aggregate(args.paths, args.threshold_s,
                            args.threshold_frac)
    except OSError as e:
        print(str(e), file=sys.stderr)
        return 1
    if args.out:
        merged = merge_records(load_rank_records(args.paths))
        with open(args.out, "w") as f:
            for rec in merged:
                f.write(json.dumps(rec, separators=(",", ":")) + "\n")
    if args.json:
        print(json.dumps(summary, indent=1, default=str))
    else:
        print(render(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
