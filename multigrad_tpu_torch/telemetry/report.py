"""Terminal summary of a telemetry JSONL stream (a copy of
:mod:`multigrad_tpu.telemetry.report` that reads the port's run record).

::

    python -m multigrad_tpu_torch.telemetry.report run.jsonl [more.jsonl ...]

Renders the record stream a fit/sampler/bench run produced
(:mod:`.metrics`) as a short human-readable report: provenance, the
fit's loss evolution and steps/s, HMC acceptance/divergences, the
collective-traffic accounting (the O(|sumstats|+|params|) check), the
streaming pipeline's stall fraction, span timings, and any stall
events.

This module is pure stdlib.  NB: the ``-m`` invocation above still
executes ``multigrad_tpu_torch/__init__`` (and therefore imports torch)
on the way in — on a triage box without torch, run the file directly
instead, it is self-contained::

    python path/to/multigrad_tpu_torch/telemetry/report.py run.jsonl
"""
from __future__ import annotations

import argparse
import json
import sys

__all__ = ["load_records", "split_runs", "list_runs", "summarize",
           "render", "main"]


def load_records(path: str) -> list:
    """Read a JSONL record stream, skipping unparseable lines (a
    truncated tail from a crashed run must not kill the report)."""
    records = []
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


def _first(v):
    """Scalar view of a tap value (batched fits emit lists)."""
    if isinstance(v, list):
        return v[0] if v else None
    return v


def _fmt(v, nd=4):
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}g}"
    return str(v)


def split_runs(records: list) -> list:
    """Split a stream at its ``run`` headers into per-run record
    lists.  Records before the first header (a headerless legacy
    stream) form their own leading run."""
    runs: list = []
    current: list = []
    for rec in records:
        if rec.get("event") == "run" and current:
            runs.append(current)
            current = []
        current.append(rec)
    if current:
        runs.append(current)
    return runs


def list_runs(records: list) -> list:
    """One summary row per run in a (possibly appended) stream —
    index, start time, record/event counts, final loss — so appended
    runs stay discoverable (the ``--list-runs`` CLI view)."""
    rows = []
    for i, run in enumerate(split_runs(records)):
        events: dict = {}
        final_loss = steps = None
        for rec in run:
            events[rec.get("event", "?")] = \
                events.get(rec.get("event", "?"), 0) + 1
            if rec.get("event") == "adam":
                final_loss = _first(rec.get("loss"))
                steps = rec.get("step")
            elif rec.get("event") == "fit_summary":
                if rec.get("final_loss") is not None:
                    final_loss = _first(rec.get("final_loss"))
        rows.append({
            "run": i + 1,
            "t_start": run[0].get("t"),
            "records": len(run),
            "events": events,
            "last_step": steps,
            "final_loss": final_loss,
            "config_digest": run[0].get("config_digest")
            if run[0].get("event") == "run" else None,
        })
    return rows


def summarize(records: list, run=None) -> dict:
    """Fold a record stream into per-section summaries (dict, so tests
    and dashboards can consume it without parsing rendered text).

    A JSONL file reused across invocations holds several runs
    (``JsonlSink`` appends); each ``run`` header starts a new one.
    Mixing them would stitch one run's first loss to another's final
    loss and compute steps/s across the idle gap — so a single run is
    summarized, with ``runs_in_file`` recording how many the file
    holds.  ``run`` selects which: 1-based from the front, negative
    from the back, default the LAST (the historical behavior); out of
    range raises ``IndexError``.
    """
    runs = split_runs(records)
    n_runs = len(runs)
    if n_runs:
        if run is None:
            run = -1
        elif run == 0:
            raise IndexError("run selection is 1-based (or negative "
                             "from the end); got 0")
        index = run - 1 if run > 0 else n_runs + run
        if not 0 <= index < n_runs:
            raise IndexError(
                f"run {run} out of range: file holds {n_runs} run(s)")
        records = runs[index]
    out: dict = {}
    if n_runs:
        out["runs_in_file"] = n_runs
        out["run_index"] = index + 1
    by_event: dict = {}
    for rec in records:
        by_event.setdefault(rec.get("event", "?"), []).append(rec)

    runs = by_event.get("run", [])
    if runs:
        out["run"] = runs[0]

    # -- fit curve (in-graph adam taps and host-loop equivalents) ------
    fit = by_event.get("adam", [])
    if fit:
        first, last = fit[0], fit[-1]
        sec = {
            "records": len(fit),
            "first_step": first.get("step"),
            "last_step": last.get("step"),
            "first_loss": _first(first.get("loss")),
            "final_loss": _first(last.get("loss")),
            "final_grad_norm": _first(last.get("grad_norm")),
        }
        dt = last.get("t", 0) - first.get("t", 0)
        dstep = (last.get("step") or 0) - (first.get("step") or 0)
        if dt > 0 and dstep > 0:
            sec["steps_per_sec"] = dstep / dt
        out["fit"] = sec
    for rec in by_event.get("fit_summary", []):
        out.setdefault("fit", {}).update(
            {k: v for k, v in rec.items() if k not in ("event", "t")})

    # -- multi-tenant QoS rollup (fit_summary tenant/class stamps) -----
    tagged = [r for r in by_event.get("fit_summary", [])
              if r.get("tenant") is not None
              or r.get("priority_class") is not None]
    if tagged:
        qos: dict = {}
        for rec in tagged:
            key = (str(rec.get("tenant", "default")),
                   str(rec.get("priority_class", "standard")))
            cur = qos.setdefault(key, {"fits": 0, "wait_s_total": 0.0,
                                       "wait_s_max": 0.0})
            cur["fits"] += 1
            wait = rec.get("wait_s")
            if isinstance(wait, (int, float)):
                cur["wait_s_total"] += float(wait)
                cur["wait_s_max"] = max(cur["wait_s_max"],
                                        float(wait))
        out["qos"] = {
            f"{tenant}/{cls}": {
                "fits": v["fits"],
                "mean_wait_s": (v["wait_s_total"] / v["fits"]
                                if v["fits"] else None),
                "max_wait_s": v["wait_s_max"],
            }
            for (tenant, cls), v in sorted(qos.items())}

    # -- per-tenant usage accounting (tenant_usage records) -------------
    usage_recs = by_event.get("tenant_usage", [])
    if usage_recs:
        usage: dict = {}
        for rec in usage_recs:
            # Records are cumulative ledger snapshots: the LAST one
            # per (tenant, class) is the truth, earlier ones are
            # progress updates.
            key = (str(rec.get("tenant", "default")),
                   str(rec.get("priority_class", "standard")))
            usage[key] = {
                "fits": rec.get("fits"),
                "busy_s": rec.get("busy_s"),
                "sheds": rec.get("sheds"),
                "violations": rec.get("violations"),
            }
        out["usage"] = {f"{tenant}/{cls}": v
                        for (tenant, cls), v in sorted(usage.items())}

    # -- error-budget trail (slo_budget records) ------------------------
    budget_recs = by_event.get("slo_budget", [])
    if budget_recs:
        budget: dict = {}
        for rec in budget_recs:
            cls = str(rec.get("priority_class", "standard"))
            budget[cls] = {
                "remaining_frac": rec.get("remaining_frac"),
                "burn_rate": rec.get("burn_rate"),
                "fast_burning": rec.get("fast_burning"),
                "violations": rec.get("violations"),
            }
        out["slo_budget"] = dict(sorted(budget.items()))

    # -- sampler (hmc taps) --------------------------------------------
    hmc = by_event.get("hmc", [])
    if hmc:
        last = hmc[-1]
        out["hmc"] = {
            "records": len(hmc),
            "last_step": last.get("step"),
            "accept": _first(last.get("accept")),
            "step_size": _first(last.get("step_size")),
            "divergences": (sum(last["divergences"])
                            if isinstance(last.get("divergences"), list)
                            else last.get("divergences")),
        }

    # -- collective traffic --------------------------------------------
    comm = by_event.get("comm", [])
    if comm:
        last = comm[-1]
        out["comm"] = {k: v for k, v in last.items()
                       if k not in ("event", "t")}

    # -- streaming pipeline --------------------------------------------
    stream = by_event.get("stream", [])
    if stream:
        last = stream[-1]
        out["stream"] = {k: v for k, v in last.items()
                         if k not in ("event", "t")}

    # -- profiler capture / roofline attribution -----------------------
    for event in ("profile", "roofline", "costmodel"):
        recs = by_event.get(event, [])
        if recs:
            out[event] = {k: v for k, v in recs[-1].items()
                          if k not in ("event", "t")}

    # -- distributed traces (trace_span records) -------------------------
    tspans = by_event.get("trace_span", [])
    if tspans:
        trace_ids = set()
        hops: dict = {}
        for rec in tspans:
            if rec.get("trace_id"):
                trace_ids.add(rec["trace_id"])
            if rec.get("parent_span_id") is None:
                continue        # roots are requests, not hops
            name = rec.get("name", "?")
            cur = hops.setdefault(
                name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
            cur["count"] += 1
            elapsed = rec.get("elapsed_s") or 0.0
            cur["total_s"] += elapsed
            cur["max_s"] = max(cur["max_s"], elapsed)
        roots = [r for r in tspans
                 if r.get("parent_span_id") is None]
        slowest = max(roots,
                      key=lambda r: r.get("elapsed_s") or 0.0,
                      default=None)
        out["trace"] = {
            "spans": len(tspans),
            "traces": len(trace_ids),
            "hops": hops,
            "requeues": sum(1 for r in tspans
                            if r.get("name") == "requeue"),
            "slowest": ({"trace_id": slowest.get("trace_id"),
                         "elapsed_s": slowest.get("elapsed_s"),
                         "outcome": slowest.get("outcome")}
                        if slowest is not None else None),
        }

    # -- job pipelines (job_summary + predictive_check records) ----------
    jobs = by_event.get("job_summary", [])
    checks = by_event.get("predictive_check", [])
    if jobs or checks:
        verdicts_by_job: dict = {}
        for rec in checks:
            verdicts_by_job.setdefault(rec.get("job_id"), []).append({
                k: rec.get(k) for k in
                ("stage", "ok", "verdicts", "n_draws", "finite_frac",
                 "median_excess") if rec.get(k) is not None
                or k == "ok"})
        out["job"] = {
            "records": len(jobs),
            "jobs": [{
                "job_id": rec.get("job_id"),
                "ok": rec.get("ok"),
                "elapsed_s": rec.get("elapsed_s"),
                "trace_id": rec.get("trace_id"),
                "n_stages": rec.get("n_stages"),
                "stages": rec.get("stages") or [],
                "checks": verdicts_by_job.get(rec.get("job_id"), []),
            } for rec in jobs],
            # Checks whose job never settled a summary (crashed
            # runner) still surface.
            "orphan_checks": [v for job_id, vs in
                              verdicts_by_job.items()
                              if not any(r.get("job_id") == job_id
                                         for r in jobs)
                              for v in vs],
        }

    # -- spans (total time per name) -------------------------------------
    spans = by_event.get("span", [])
    if spans:
        totals: dict = {}
        for rec in spans:
            name = rec.get("path", rec.get("name", "?"))
            cur = totals.setdefault(name, {"count": 0, "total_s": 0.0})
            cur["count"] += 1
            cur["total_s"] += rec.get("elapsed_s") or 0.0
        out["spans"] = totals

    # -- liveness --------------------------------------------------------
    stalls = by_event.get("stall", [])
    beats = by_event.get("heartbeat", [])
    if stalls or beats:
        out["liveness"] = {
            "heartbeats": len(beats),
            "stalls": len(stalls),
            "max_stalled_s": max(
                (rec.get("stalled_s") or 0.0 for rec in stalls),
                default=0.0),
        }

    # -- bench dossier records -------------------------------------------
    bench = by_event.get("bench", [])
    if bench:
        out["bench"] = {rec.get("config", "?"): rec.get("value")
                        for rec in bench}

    # -- autotuner decisions (why a config was chosen) -------------------
    tune = by_event.get("tune", [])
    if tune:
        chosen = []
        for rec in tune:
            if not rec.get("chosen"):
                continue
            chosen.append({k: rec.get(k) for k in
                           ("key", "scope", "knobs", "predicted_s",
                            "measured_s", "fits_per_hour", "warm")
                           if rec.get(k) is not None})
        out["tune"] = {"records": len(tune), "chosen": chosen}

    out["n_records"] = len(records)
    return out


def render(summary: dict) -> str:
    """The human-readable view of :func:`summarize`'s output."""
    lines = []
    if summary.get("runs_in_file", 0) > 1:
        which = summary.get("run_index")
        lines.append(
            f"(file holds {summary['runs_in_file']} runs; "
            + ("summarizing the last"
               if which in (None, summary["runs_in_file"])
               else f"summarizing run {which}") + ")")
    run = summary.get("run")
    if run:
        lines.append(
            f"run: torch {run.get('torch_version')} / "
            f"cuda {run.get('cuda_version')}  "
            f"backend={run.get('backend')}  "
            f"devices={run.get('device_count')}x"
            f"{run.get('device_kind')}  "
            f"processes={run.get('process_count')}  "
            f"config={run.get('config_digest')}")
    fit = summary.get("fit")
    if fit:
        if fit.get("records"):
            lines.append(
                f"fit: loss {_fmt(fit.get('first_loss'))} -> "
                f"{_fmt(fit.get('final_loss'))} over steps "
                f"{_fmt(fit.get('first_step'))}.."
                f"{_fmt(fit.get('last_step'))}"
                f"  ({fit['records']} tap records)")
        extras = [f"{k}={_fmt(float(v) if isinstance(v, (int, float)) else v)}"
                  for k, v in fit.items()
                  if k in ("steps_per_sec", "final_grad_norm",
                           "best_loss", "max_rhat", "min_ess",
                           "divergences", "overlap_frac",
                           "postmortem_bundle") and v is not None]
        if not fit.get("records") and fit.get("final_loss") is not None:
            extras.insert(0, f"final_loss={_fmt(fit['final_loss'])}")
        if extras:
            prefix = "     " if fit.get("records") else "fit: "
            lines.append(prefix + "  ".join(extras))
        pass_overlap = fit.get("pass_overlap")
        if isinstance(pass_overlap, dict) and pass_overlap:
            lines.append("     pass overlap: " + "  ".join(
                f"{name}={_fmt(frac)}"
                for name, frac in sorted(pass_overlap.items())))
        hops = fit.get("hops")
        if isinstance(hops, dict) and hops:
            # The served fit's per-hop latency vector (FitResult
            # .hops via fit_summary), slowest hop first.
            lines.append("     trace hops: " + "  ".join(
                f"{name}={_fmt(v)}s" for name, v in sorted(
                    hops.items(), key=lambda kv: -(kv[1] or 0)))
                + (f"  [trace {str(fit['trace_id'])[:12]}]"
                   if fit.get("trace_id") else ""))
    qos = summary.get("qos")
    if qos:
        lines.append("qos (tenant/class): " + "  ".join(
            f"{key}: {v['fits']} fits, "
            f"wait mean={_fmt(v.get('mean_wait_s'))}s "
            f"max={_fmt(v.get('max_wait_s'))}s"
            for key, v in qos.items()))
    usage = summary.get("usage")
    if usage:
        lines.append("usage (tenant/class): " + "  ".join(
            f"{key}: {v.get('fits')} fits, "
            f"busy={_fmt(v.get('busy_s'))}s, "
            f"shed={v.get('sheds')}, viol={v.get('violations')}"
            for key, v in usage.items()))
    budget = summary.get("slo_budget")
    if budget:
        lines.append("slo budget: " + "  ".join(
            f"{cls}: {_fmt((v.get('remaining_frac') or 0) * 100)}% "
            f"left, burn={_fmt(v.get('burn_rate'))}"
            + ("!" if v.get("fast_burning") else "")
            for cls, v in budget.items()))
    hmc = summary.get("hmc")
    if hmc:
        lines.append(
            f"hmc: accept={_fmt(hmc.get('accept'))}  "
            f"step_size={_fmt(hmc.get('step_size'))}  "
            f"divergences={_fmt(hmc.get('divergences'))}  "
            f"({hmc.get('records', 0)} tap records)")
    comm = summary.get("comm")
    if comm:
        by_op = comm.get("bytes_by_op") or {}
        ops = "  ".join(f"{k}={v}B" for k, v in sorted(by_op.items()))
        lines.append(
            f"comm: {_fmt(comm.get('bytes_per_step'))} bytes/step "
            f"({_fmt(comm.get('calls_per_step'))} collective calls)"
            + (f"  [{ops}]" if ops else ""))
    stream = summary.get("stream")
    if stream:
        lines.append(
            f"stream: stall_fraction={_fmt(stream.get('stall_fraction'))}"
            f"  overlap_frac={_fmt(stream.get('overlap_frac'))}"
            f"  chunks/s={_fmt(stream.get('chunks_per_sec'))}"
            f"  bytes={_fmt(stream.get('bytes_streamed'))}"
            f"  max_live_buffers={_fmt(stream.get('max_live_buffers'))}")
        passes = stream.get("passes")
        if isinstance(passes, dict) and passes:
            for name, per in sorted(passes.items()):
                lines.append(
                    f"  pass {name}: "
                    f"stall_fraction={_fmt(per.get('stall_fraction'))}"
                    f"  overlap_frac={_fmt(per.get('overlap_frac'))}"
                    f"  chunks={_fmt(per.get('chunks'))}"
                    f"  bytes={_fmt(per.get('bytes_streamed'))}")
    profile = summary.get("profile")
    if profile:
        lines.append(
            f"profile: device={_fmt(profile.get('total_device_us'))}us"
            + (f"  per_step={_fmt(profile.get('per_step_us'))}us"
               if profile.get("per_step_us") is not None else "")
            + (f"  roofline_frac={_fmt(profile.get('roofline_frac'))}"
               f" ({profile.get('bound')}-bound)"
               if profile.get("roofline_frac") is not None else "")
            + (f"  rtt={_fmt(profile.get('tunnel_rtt_ms'))}ms"
               if profile.get("tunnel_rtt_ms") is not None else ""))
        for op in (profile.get("top_ops") or [])[:5]:
            lines.append(f"  {op.get('frac', 0):7.1%}  "
                         f"{_fmt(op.get('us'))}us  x{op.get('count')}"
                         f"  {str(op.get('op'))[:70]}")
    roofline = summary.get("roofline")
    if roofline:
        lines.append(
            f"roofline: predicted={_fmt(roofline.get('predicted_s'))}s"
            f"  measured={_fmt(roofline.get('measured_s'))}s"
            f"  frac={_fmt(roofline.get('roofline_frac'))}"
            f"  ({roofline.get('bound')}-bound, "
            f"{roofline.get('device_kind')})")
    trace = summary.get("trace")
    if trace:
        lines.append(
            f"trace: {trace['traces']} traces / {trace['spans']} "
            f"spans"
            + (f", {trace['requeues']} requeue hops"
               if trace.get("requeues") else ""))
        slowest = trace.get("slowest")
        if slowest:
            lines.append(
                f"  slowest: {str(slowest.get('trace_id'))[:12]}  "
                f"{_fmt(slowest.get('elapsed_s'))}s  "
                f"outcome={slowest.get('outcome')}  "
                "(waterfall: python -m multigrad_tpu.telemetry"
                ".trace --trace <id>)")
        for name, cur in sorted(trace["hops"].items(),
                                key=lambda kv: -kv[1]["total_s"]):
            lines.append(
                f"  hop {name}: x{cur['count']}  "
                f"total {_fmt(cur['total_s'])}s  "
                f"max {_fmt(cur['max_s'])}s")
    job = summary.get("job")
    if job:
        for j in job.get("jobs", []):
            lines.append(
                f"job: {j.get('job_id')}  "
                + ("ok" if j.get("ok") else "FAILED")
                + f"  {_fmt(j.get('elapsed_s'))}s  "
                f"{j.get('n_stages')} stages"
                + (f"  [trace {str(j['trace_id'])[:12]}]"
                   if j.get("trace_id") else ""))
            for st in j.get("stages", []):
                extra = ""
                if st.get("n_fits"):
                    extra += f"  fits={st['n_fits']}"
                if (st.get("attempts") or 1) > 1:
                    extra += f"  attempts={st['attempts']}"
                if st.get("error"):
                    extra += f"  error={str(st['error'])[:50]}"
                lines.append(
                    f"  stage {st.get('stage')}: "
                    f"{st.get('outcome')}  "
                    f"{_fmt(st.get('elapsed_s'))}s" + extra)
            for chk in j.get("checks", []):
                verdicts = chk.get("verdicts") or {}
                lines.append(
                    f"  check {chk.get('stage')}: "
                    + ("ok" if chk.get("ok") else "FAILED")
                    + ("  " + "  ".join(
                        f"{k}={'ok' if v else 'FAIL'}"
                        for k, v in sorted(verdicts.items()))
                       if verdicts else "")
                    + (f"  draws={chk['n_draws']}"
                       if chk.get("n_draws") is not None else ""))
        for chk in job.get("orphan_checks", []):
            lines.append(
                f"job: (unsettled)  check {chk.get('stage')}: "
                + ("ok" if chk.get("ok") else "FAILED"))
    spans = summary.get("spans")
    if spans:
        parts = [f"{name}={cur['total_s']:.3f}s(x{cur['count']})"
                 for name, cur in sorted(spans.items())]
        lines.append("spans: " + "  ".join(parts))
    liveness = summary.get("liveness")
    if liveness:
        lines.append(
            f"liveness: {liveness['heartbeats']} heartbeats, "
            f"{liveness['stalls']} stalls "
            f"(max {_fmt(liveness['max_stalled_s'])}s)")
    tune = summary.get("tune")
    if tune:
        lines.append(f"tune: {tune.get('records', 0)} candidate "
                     f"records, {len(tune.get('chosen', []))} chosen")
        for ch in tune.get("chosen", []):
            knobs = ch.get("knobs")
            lines.append(
                f"  {ch.get('key')} -> "
                + (json.dumps(knobs) if isinstance(knobs,
                                                   (dict, list))
                   else str(knobs))
                + f"  predicted={_fmt(ch.get('predicted_s'))}s"
                  f"  measured={_fmt(ch.get('measured_s'))}s"
                + ("  (warm: zero trials)" if ch.get("warm")
                   else ""))
    bench = summary.get("bench")
    if bench:
        lines.append("bench configs:")
        for name, value in bench.items():
            lines.append(f"  {name} = "
                         + (json.dumps(value)
                            if isinstance(value, (dict, list))
                            else _fmt(value)))
    if not lines:
        lines.append("(no recognized telemetry records)")
    lines.append(f"records: {summary.get('n_records', 0)}")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m multigrad_tpu_torch.telemetry.report",
        description="Summarize a multigrad_tpu_torch telemetry JSONL stream.")
    parser.add_argument("paths", nargs="+",
                        help="telemetry .jsonl file(s)")
    parser.add_argument("--json", action="store_true",
                        help="emit the summary as JSON instead of text")
    parser.add_argument("--run", type=int, default=None, metavar="N",
                        help="which run of an appended multi-run file "
                             "to summarize (1-based; negative counts "
                             "from the end; default: the last)")
    parser.add_argument("--list-runs", action="store_true",
                        help="list the runs an appended file holds "
                             "instead of summarizing one")
    args = parser.parse_args(argv)
    rc = 0
    for path in args.paths:
        try:
            records = load_records(path)
        except OSError as e:
            print(f"{path}: {e}", file=sys.stderr)
            rc = 1
            continue
        if len(args.paths) > 1 and not args.json:
            print(f"== {path} ==")
        if args.list_runs:
            rows = list_runs(records)
            if args.json:
                print(json.dumps({"path": path, "runs": rows},
                                 indent=1))
                continue
            for row in rows:
                events = "  ".join(
                    f"{k}={v}" for k, v in sorted(row["events"].items()))
                print(f"run {row['run']}: {row['records']} records"
                      + (f", last step {row['last_step']}"
                         if row["last_step"] is not None else "")
                      + (f", final loss {_fmt(row['final_loss'])}"
                         if row["final_loss"] is not None else "")
                      + f"  [{events}]")
            continue
        try:
            summary = summarize(records, run=args.run)
        except IndexError as e:
            print(f"{path}: {e}", file=sys.stderr)
            rc = 1
            continue
        if args.json:
            print(json.dumps({"path": path, **summary}, indent=1))
        else:
            print(render(summary))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
