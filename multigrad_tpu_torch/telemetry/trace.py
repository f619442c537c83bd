"""Trace waterfalls from per-process trace JSONLs (a copy of
:mod:`multigrad_tpu.telemetry.trace`).

::

    python -m multigrad_tpu_torch.telemetry.trace router.trace.jsonl w*.trace.jsonl
    python -m multigrad_tpu_torch.telemetry.trace ... --slowest 3
    python -m multigrad_tpu_torch.telemetry.trace ... --trace 1f3c2a
    python -m multigrad_tpu_torch.telemetry.trace ... --json

Merges the ``trace_span`` records the fleet router, the workers'
schedulers, and single-process :class:`~multigrad_tpu_torch.serve
.scheduler.FitScheduler`\\ s wrote (one JSONL per process, see
:mod:`.tracing`) by ``trace_id`` and renders each request's journey
as a parent-linked waterfall: every hop (``route`` → ``rpc_send`` →
``queue_wait`` → ``bucket_coalesce`` → ``dispatch`` →
``adam_segments`` → ``finalize`` → ``result_return``), one explicit
``requeue`` hop per worker generation a chaos-killed request
migrated across, span offsets and durations against the root
``request`` span, and a **coverage** figure — the fraction of the
request's end-to-end latency accounted for by the union of its
child spans (union, not sum: overlapping spans like ``queue_wait``
⊇ ``bucket_coalesce`` are counted once).

Per-trace **completeness** is checked structurally: exactly one
root span and every ``parent_span_id`` resolving within the trace —
the invariant the chaos suite asserts for SIGKILL'd requests.
``trace_rtt`` records (the router's heartbeat-RPC round-trip
samples) annotate the output as the wall-clock noise floor.

This module is pure stdlib and self-contained.  NB: the ``-m``
invocation still imports ``multigrad_tpu_torch`` (and therefore torch)
on the way in — on a triage box without torch, run the file directly::

    python path/to/multigrad_tpu_torch/telemetry/trace.py *.trace.jsonl
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence

__all__ = ["load_records", "load_spans", "group_traces",
           "trace_summary", "span_coverage", "render_waterfall",
           "render_summary_line", "main"]

TRACE_EVENT = "trace_span"      # kept in sync with .tracing


def load_records(paths: Sequence[str]) -> list:
    """Read JSONL files, skipping blank/unparseable lines (a
    SIGKILL'd worker leaves at most one torn tail line)."""
    records = []
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except ValueError:
                    continue
    return records


def load_spans(paths: Sequence[str]) -> list:
    """The ``trace_span`` records of a set of per-process files."""
    return [r for r in load_records(paths)
            if r.get("event") == TRACE_EVENT
            and r.get("trace_id") and r.get("span_id")]


def group_traces(spans: list) -> Dict[str, list]:
    """Merge spans by ``trace_id``; each trace's spans sorted by
    start time (root-first on ties, so waterfalls render stably)."""
    traces: Dict[str, list] = {}
    for span in spans:
        traces.setdefault(span["trace_id"], []).append(span)
    for spans_ in traces.values():
        spans_.sort(key=lambda s: (s.get("t_start") or 0.0,
                                   s.get("parent_span_id") is not None,
                                   s.get("t_end") or 0.0))
    return traces


def _interval_union(intervals: List[tuple]) -> float:
    """Total length of the union of [start, end) intervals."""
    total = 0.0
    cur_start = cur_end = None
    for start, end in sorted(intervals):
        if end <= start:
            continue
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def _root_of(spans: list) -> Optional[dict]:
    roots = [s for s in spans if s.get("parent_span_id") is None]
    return roots[0] if len(roots) == 1 else None


def span_coverage(spans: list) -> Optional[float]:
    """Fraction of the root span's window covered by the union of
    its descendant spans (clipped to the root window).  ``None``
    without a root or with a zero-length root."""
    root = _root_of(spans)
    if root is None:
        return None
    r0, r1 = root.get("t_start"), root.get("t_end")
    if r0 is None or r1 is None or r1 <= r0:
        return None
    intervals = []
    for s in spans:
        if s is root:
            continue
        t0, t1 = s.get("t_start"), s.get("t_end")
        if t0 is None or t1 is None:
            continue
        t0, t1 = max(t0, r0), min(t1, r1)
        if t1 > t0:
            intervals.append((t0, t1))
    return _interval_union(intervals) / (r1 - r0)


def trace_summary(trace_id: str, spans: list) -> dict:
    """Structural summary of one merged trace: root/elapsed, span
    and hop accounting, requeue hops, services touched, and the
    completeness verdict (exactly one root, every parent id
    resolving within the trace, no zero-span trace)."""
    ids = {s["span_id"] for s in spans}
    orphans = [s["span_id"] for s in spans
               if s.get("parent_span_id") is not None
               and s["parent_span_id"] not in ids]
    root = _root_of(spans)
    n_roots = sum(1 for s in spans
                  if s.get("parent_span_id") is None)
    requeues = [s for s in spans if s.get("name") == "requeue"]
    hops: Dict[str, float] = {}
    for s in spans:
        if s is root:
            continue
        name = s.get("name", "?")
        hops[name] = hops.get(name, 0.0) + (s.get("elapsed_s") or 0.0)
    # Job-DAG traces (serve.jobs): roll hops up per pipeline stage —
    # each ``stage`` span's subtree is one stage attempt.
    stages: Dict[str, dict] = {}
    for s in spans:
        if s.get("name") != "stage" or not s.get("stage"):
            continue
        entry = stages.setdefault(
            s["stage"], {"elapsed_s": 0.0, "attempts": 0, "ok": True})
        entry["elapsed_s"] += s.get("elapsed_s") or 0.0
        entry["attempts"] += 1
        entry["ok"] = entry["ok"] and bool(s.get("ok", True))
    return {
        "trace_id": trace_id,
        "n_spans": len(spans),
        "root": root,
        "elapsed_s": (root["t_end"] - root["t_start"])
        if root else None,
        "outcome": (root or {}).get("outcome"),
        "complete": bool(spans) and n_roots == 1 and not orphans,
        "orphans": orphans,
        "n_roots": n_roots,
        "coverage": span_coverage(spans),
        "hops": hops,
        "stages": stages,
        "requeues": [{"from": s.get("from_worker"),
                      "to": s.get("to_worker"),
                      "reason": s.get("reason"),
                      "bundle": s.get("bundle")} for s in requeues],
        "services": sorted({s.get("service") for s in spans
                            if s.get("service")}),
        "bundles": sorted({s.get("bundle") for s in spans
                           if s.get("bundle")}),
    }


def _fmt_s(v, nd=3):
    return "-" if v is None else f"{v:.{nd}f}s"


def _span_label(span: dict) -> str:
    """One human-readable token per hop; the requeue label names
    both worker generations (``requeue w0->w1``) — the line the
    chaos CI greps for."""
    name = span.get("name", "?")
    if name == "requeue":
        to = span.get("to_worker") or "lost"
        return f"requeue {span.get('from_worker', '?')}->{to}"
    parts = [name]
    # Job-DAG spans carry their pipeline position in the label, so a
    # multi-stage waterfall reads scan/ensemble/… at a glance.
    if name == "job" and span.get("job_id"):
        parts.append(str(span["job_id"]))
    if name == "stage" and span.get("stage"):
        parts.append(str(span["stage"]))
        if (span.get("attempt") or 1) > 1:
            parts.append(f"attempt={span['attempt']}")
    if name == "request" and span.get("stage"):
        parts.append(f"[{span['stage']}]")
    if span.get("worker"):
        parts.append(str(span["worker"]))
    if name == "dispatch":
        if span.get("bucket") is not None:
            parts.append(f"K={span['bucket']}")
        if span.get("compiled") is not None:
            parts.append("compiled" if span["compiled"] else "cached")
    if name == "rpc_send" and (span.get("attempts") or 1) > 1:
        parts.append(f"attempts={span['attempts']}")
    if not span.get("ok", True):
        parts.append("FAILED")
    return " ".join(parts)


def render_summary_line(summary: dict) -> str:
    cov = summary.get("coverage")
    parts = [f"trace {summary['trace_id'][:12]}",
             _fmt_s(summary["elapsed_s"]),
             f"{summary['n_spans']} spans",
             "coverage " + (f"{cov:.0%}" if cov is not None
                            else "-")]
    if summary.get("outcome"):
        parts.append(f"outcome={summary['outcome']}")
    if summary.get("stages"):
        parts.append(f"{len(summary['stages'])} stage(s)")
    if summary["requeues"]:
        parts.append(f"{len(summary['requeues'])} requeue(s)")
    parts.append("complete" if summary["complete"]
                 else "INCOMPLETE")
    return "  ".join(parts)


def render_waterfall(trace_id: str, spans: list,
                     width: int = 30) -> str:
    """One trace as an indented, bar-charted waterfall."""
    summary = trace_summary(trace_id, spans)
    lines = [render_summary_line(summary)]
    root = summary["root"]
    if root is None:
        lines.append("  (no single root span — cannot anchor the "
                     "waterfall; spans listed flat)")
        r0, dur = None, None
    else:
        r0 = root["t_start"]
        dur = max(root["t_end"] - r0, 1e-9)

    by_parent: Dict[Optional[str], list] = {}
    for s in spans:
        by_parent.setdefault(s.get("parent_span_id"), []).append(s)

    def depth_of(span, seen=()):
        parent = span.get("parent_span_id")
        if parent is None or span["span_id"] in seen:
            return 0
        parents = [s for s in spans if s["span_id"] == parent]
        if not parents:
            return 1
        return 1 + depth_of(parents[0],
                            seen + (span["span_id"],))

    def emit(span):
        t0, t1 = span.get("t_start"), span.get("t_end")
        elapsed = span.get("elapsed_s") or 0.0
        if r0 is not None and t0 is not None and t1 is not None:
            off = max(0, min(width - 1,
                             int((t0 - r0) / dur * width)))
            end = max(off + 1, min(width,
                                   int(round((t1 - r0) / dur
                                             * width))))
            bar = " " * off + "#" * (end - off) \
                + " " * (width - end)
            rel = f"+{t0 - r0:8.3f}s"
        else:
            bar = "?" * width
            rel = "        ?"
        indent = "  " * depth_of(span)
        label = indent + _span_label(span)
        svc = span.get("service")
        lines.append(f"  {rel} {_fmt_s(elapsed):>10}  |{bar}|  "
                     f"{label}"
                     + (f"  @{svc}" if svc else ""))

    # Pre-order walk: each span's children (by start time) directly
    # under it; orphans appended at the end so nothing is hidden.
    emitted = set()

    def walk(span):
        if span["span_id"] in emitted:
            return
        emitted.add(span["span_id"])
        emit(span)
        for child in sorted(by_parent.get(span["span_id"], []),
                            key=lambda s: s.get("t_start") or 0.0):
            walk(child)

    for span in sorted(by_parent.get(None, []),
                       key=lambda s: s.get("t_start") or 0.0):
        walk(span)
    for span in spans:
        if span["span_id"] not in emitted:
            walk(span)
    return "\n".join(lines)


def _rtt_floor(records: list) -> Optional[dict]:
    rtts = sorted(r.get("rtt_s") for r in records
                  if r.get("event") == "trace_rtt"
                  and isinstance(r.get("rtt_s"), (int, float)))
    if not rtts:
        return None
    return {"n": len(rtts),
            "median_s": rtts[len(rtts) // 2],
            "max_s": rtts[-1]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m multigrad_tpu_torch.telemetry.trace",
        description="Merge per-process trace JSONLs by trace_id and "
                    "render per-request waterfalls.")
    parser.add_argument("paths", nargs="+",
                        help="trace .jsonl files (router + workers)")
    parser.add_argument("--slowest", type=int, default=1,
                        metavar="N",
                        help="render full waterfalls for the N "
                             "slowest traces (default 1; 0 = "
                             "summary lines only)")
    parser.add_argument("--trace", default=None, metavar="ID",
                        help="render one trace (id prefix match)")
    parser.add_argument("--json", action="store_true",
                        help="emit merged traces + summaries as JSON")
    args = parser.parse_args(argv)

    try:
        records = load_records(args.paths)
    except OSError as e:
        print(str(e), file=sys.stderr)
        return 1
    spans = [r for r in records if r.get("event") == TRACE_EVENT
             and r.get("trace_id") and r.get("span_id")]
    traces = group_traces(spans)
    if not traces:
        print("no trace_span records found", file=sys.stderr)
        return 1
    summaries = sorted(
        (trace_summary(tid, tspans)
         for tid, tspans in traces.items()),
        key=lambda s: -(s["elapsed_s"] or 0.0))
    rtt = _rtt_floor(records)

    if args.trace is not None:
        matches = [tid for tid in traces
                   if tid.startswith(args.trace)]
        if len(matches) != 1:
            print(f"--trace {args.trace!r} matches {len(matches)} "
                  f"traces (need exactly 1)", file=sys.stderr)
            return 1
        print(render_waterfall(matches[0], traces[matches[0]]))
        return 0

    if args.json:
        print(json.dumps({
            "files": list(args.paths),
            "n_traces": len(traces),
            "rpc_rtt": rtt,
            "traces": [{**s, "root": None,
                        "spans": traces[s["trace_id"]]}
                       for s in summaries],
        }, indent=1, default=str))
        return 0

    incomplete = [s for s in summaries if not s["complete"]]
    requeued = [s for s in summaries if s["requeues"]]
    print(f"{len(traces)} traces over {len(args.paths)} file(s): "
          f"{len(requeued)} with requeue hops, "
          f"{len(incomplete)} incomplete"
          + (f"; rpc rtt median {rtt['median_s'] * 1e3:.2f}ms "
             f"(n={rtt['n']})" if rtt else ""))
    for s in summaries:
        print(render_summary_line(s))
    for s in summaries[:max(0, args.slowest)]:
        print()
        print(render_waterfall(s["trace_id"],
                               traces[s["trace_id"]]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
