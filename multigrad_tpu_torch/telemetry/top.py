"""``top`` for the fit fleet: live per-worker resource columns (a copy of
:mod:`multigrad_tpu.telemetry.top`).

Usage::

    python -m multigrad_tpu_torch.telemetry.top --once \\
        http://127.0.0.1:9100/status http://127.0.0.1:9101/status
    python -m multigrad_tpu_torch.telemetry.top --follow w0.jsonl w1.jsonl

Each source is either a ``/status`` URL (a worker's or scheduler's
:class:`~multigrad_tpu_torch.telemetry.LiveServer` — the ``resources``
section is the row) or a telemetry ``.jsonl`` path (the
``resource_sample`` records a :class:`~multigrad_tpu_torch.telemetry
.ResourceMonitor` emits are folded, newest wins).  A URL or
single-line JSON file whose body carries a ``workers`` mapping (a
:attr:`FleetRouter.stats <multigrad_tpu_torch.serve.fleet.FleetRouter
.stats>` snapshot) expands into one row per worker, so pointing top
at the router shows the whole fleet from one source.

Columns: window duty cycle (``BUSY%``), host RSS, device memory
in-use / limit and peak, compile count + cumulative seconds, queue
depth, trailing fits/hour, the worst-class SLO error budget
(remaining %% and burn rate, ``!`` while fast-burning — from the
``qos`` section of a ``/status`` body or folded ``slo_budget``
records), and sample age.  ``-`` means "source doesn't know"
(e.g. device columns on CPU backends, the SLO column on sources
with no declared SLOs) — never zero.

``--once`` prints a single deterministic table (CI receipts, tests);
``--follow`` redraws every ``--interval`` seconds; ``--json`` emits
the rows as a JSON list instead of the table (scripting);
``--tenants`` switches to per-(tenant, priority class) usage rows
folded from ``tenant_usage`` records (or a ``usage`` mapping in a
status body) — who burned the fleet, not which host is busy.

Pure stdlib — usable on a machine with nothing installed, same as
:mod:`.dashboard`.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request

from .dashboard import TailReader, _fmt_bytes

__all__ = ["fetch_source", "fold_records", "collect_rows",
           "render_rows", "collect_tenant_rows",
           "render_tenant_rows", "main"]

COLUMNS = ("WORKER", "BUSY%", "RSS", "DEV MEM", "PEAK",
           "COMPILE", "QUEUE", "FITS/H", "SLO", "AGE")

TENANT_COLUMNS = ("TENANT/CLASS", "FITS", "BUSY S", "SHED", "VIOL")


def _fmt_pct(frac) -> str:
    return "-" if frac is None else f"{100.0 * frac:5.1f}"


def _fmt_age(s) -> str:
    if s is None:
        return "-"
    return f"{s:.0f}s" if s < 120 else f"{s / 60.0:.0f}m"


def _fmt_slo(budgets) -> str:
    """Worst-class error-budget cell from a ``{class: budget-dict}``
    mapping: remaining percent and burn rate, ``!`` while
    fast-burning, ``-`` when no class is monitored."""
    worst = None
    for b in (budgets or {}).values():
        if not isinstance(b, dict) or b.get("remaining_frac") is None:
            continue
        if worst is None or b["remaining_frac"] < worst["remaining_frac"]:
            worst = b
    if worst is None:
        return "-"
    cell = f"{100.0 * worst['remaining_frac']:.0f}%"
    if worst.get("burn_rate") is not None:
        cell += f" b={worst['burn_rate']:.1f}"
    if worst.get("fast_burning"):
        cell += "!"
    return cell


def _status_budgets(st: dict) -> dict:
    """``{class: budget-dict}`` out of a status body's ``qos``
    section (:func:`~multigrad_tpu_torch.telemetry.live.LiveMetrics
    .qos_summary` shape)."""
    qos = st.get("qos")
    out = {}
    if isinstance(qos, dict):
        for cls, entry in (qos.get("classes") or {}).items():
            if (isinstance(entry, dict)
                    and isinstance(entry.get("budget"), dict)):
                out[cls] = entry["budget"]
    return out


def _row(name, *, busy_frac=None, rss_bytes=None, dev_in_use=None,
         dev_limit=None, dev_peak=None, compile_count=None,
         compile_s=None, queue_depth=None, fits_per_hour=None,
         slo="-", age_s=None, state=None) -> dict:
    return {"name": str(name), "busy_frac": busy_frac,
            "rss_bytes": rss_bytes, "dev_in_use": dev_in_use,
            "dev_limit": dev_limit, "dev_peak": dev_peak,
            "compile_count": compile_count, "compile_s": compile_s,
            "queue_depth": queue_depth,
            "fits_per_hour": fits_per_hour, "slo": slo,
            "age_s": age_s, "state": state}


def _rows_from_status(name: str, st: dict, now: float) -> list:
    """Rows from one ``/status`` JSON body (or any dict shaped like
    it).  A ``workers`` mapping (router stats snapshot) expands to
    one row per worker; otherwise the ``resources`` section is the
    single row.  The SLO budget lives at the source (scheduler /
    router) level, so every expanded worker row carries the same
    worst-class cell."""
    slo = _fmt_slo(_status_budgets(st))
    workers = st.get("workers")
    if isinstance(workers, dict):
        rows = []
        for wid in sorted(workers):
            w = workers[wid] or {}
            res = w.get("resources") or {}
            rows.append(_row(
                wid,
                busy_frac=res.get("busy_frac"),
                rss_bytes=res.get("rss_bytes"),
                dev_in_use=res.get("device_bytes_in_use"),
                dev_limit=res.get("device_bytes_limit"),
                dev_peak=res.get("device_peak_bytes"),
                compile_count=res.get("compile_count"),
                compile_s=res.get("compile_s_total"),
                queue_depth=w.get("queue_depth"),
                slo=slo,
                age_s=w.get("heartbeat_age_s"),
                state=w.get("state")))
        return rows
    res = st.get("resources")
    if not isinstance(res, dict):
        return [_row(name, slo=slo)]
    compile_ = res.get("compile") or {}
    t = res.get("t")
    return [_row(
        name,
        busy_frac=res.get("busy_frac"),
        rss_bytes=res.get("rss_bytes"),
        dev_in_use=res.get("device_bytes_in_use"),
        dev_limit=res.get("device_bytes_limit"),
        dev_peak=res.get("device_peak_bytes"),
        compile_count=(compile_.get("count")
                       if compile_ else res.get("compile_count")),
        compile_s=(compile_.get("seconds_total")
                   if compile_ else res.get("compile_s_total")),
        queue_depth=res.get("queue_depth"),
        fits_per_hour=res.get("fits_per_hour"),
        slo=slo,
        age_s=(round(now - t, 1) if isinstance(t, (int, float))
               else None),
        state=st.get("phase"))]


def fold_records(state: dict, records: list):
    """Fold new telemetry records into a per-source state dict
    (newest ``resource_sample`` wins; a ``workers`` mapping — a
    router stats snapshot written as one JSONL line — replaces the
    whole state)."""
    for rec in records:
        if not isinstance(rec, dict):
            continue
        if isinstance(rec.get("workers"), dict):
            state.clear()
            state["stats"] = rec
        elif rec.get("event") == "resource_sample":
            state["sample"] = rec
        elif rec.get("event") == "serve_dispatch":
            state["dispatches"] = state.get("dispatches", 0) + 1
        elif rec.get("event") == "slo_budget":
            cls = rec.get("priority_class")
            if isinstance(cls, str):
                state.setdefault("budgets", {})[cls] = rec
        elif rec.get("event") == "tenant_usage":
            key = f"{rec.get('tenant')}/{rec.get('priority_class')}"
            state.setdefault("usage", {})[key] = rec


def fetch_source(url: str, timeout: float = 2.0):
    """One ``/status`` fetch → parsed JSON dict, or ``None`` on any
    network/parse failure (a dead worker is a ``-`` row, not a
    crash of the whole top)."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return json.loads(resp.read().decode())
    except Exception:
        return None


def collect_rows(sources: list, readers: dict, states: dict,
                 now=None) -> list:
    """One poll over all sources → the table's row dicts."""
    now = time.time() if now is None else now
    rows = []
    for src in sources:
        if src.startswith(("http://", "https://")):
            st = fetch_source(src)
            name = src.split("//", 1)[-1].split("/", 1)[0]
            if st is None:
                rows.append(_row(name, state="down"))
            else:
                rows.extend(_rows_from_status(name, st, now))
            continue
        reader = readers.setdefault(src, TailReader(src))
        state = states.setdefault(src, {})
        fold_records(state, reader.poll())
        if "stats" in state:
            rows.extend(_rows_from_status(src, state["stats"], now))
            continue
        slo = _fmt_slo(state.get("budgets"))
        sample = state.get("sample")
        if sample is None:
            rows.append(_row(src, slo=slo))
            continue
        t = sample.get("t")
        rows.append(_row(
            src,
            busy_frac=sample.get("busy_frac"),
            rss_bytes=sample.get("rss_bytes"),
            dev_in_use=sample.get("device_bytes_in_use"),
            dev_limit=sample.get("device_bytes_limit"),
            dev_peak=sample.get("device_peak_bytes"),
            compile_count=sample.get("compile_count"),
            compile_s=sample.get("compile_s_total"),
            slo=slo,
            age_s=(round(now - t, 1)
                   if isinstance(t, (int, float)) else None)))
    return rows


def _render_table(table: list) -> str:
    """Column-aligned plain text: first row is the header, first
    column left-justified, the rest right-justified."""
    widths = [max(len(row[i]) for row in table)
              for i in range(len(table[0]))]
    lines = []
    for i, row in enumerate(table):
        lines.append("  ".join(
            cell.ljust(w) if j == 0 else cell.rjust(w)
            for j, (cell, w) in enumerate(zip(row, widths))).rstrip())
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


def render_rows(rows: list) -> str:
    """The table: one header + one line per row, plain text."""
    table = [list(COLUMNS)]
    for r in rows:
        dev = ("-" if r["dev_in_use"] is None
               else _fmt_bytes(r["dev_in_use"])
               + ("/" + _fmt_bytes(r["dev_limit"])
                  if r["dev_limit"] is not None else ""))
        compile_ = ("-" if r["compile_count"] is None
                    else f"{r['compile_count']}"
                    + (f" ({r['compile_s']:.1f}s)"
                       if r["compile_s"] is not None else ""))
        name = r["name"]
        if r.get("state") not in (None, "up", "fitting", "idle",
                                  "done"):
            name += f" [{r['state']}]"
        table.append([
            name, _fmt_pct(r["busy_frac"]),
            _fmt_bytes(r["rss_bytes"]), dev,
            _fmt_bytes(r["dev_peak"]), compile_,
            "-" if r["queue_depth"] is None else str(r["queue_depth"]),
            ("-" if r["fits_per_hour"] is None
             else f"{r['fits_per_hour']:.0f}"),
            r.get("slo") or "-",
            _fmt_age(r["age_s"])])
    return _render_table(table)


def collect_tenant_rows(sources: list, readers: dict,
                        states: dict) -> list:
    """One poll over all sources → per-(tenant, priority class)
    usage rows (``--tenants``).  ``tenant_usage`` records are
    cumulative ledger snapshots, so the newest per key wins; a
    ``usage`` mapping in a ``/status`` body (``telemetry.report``
    shape) merges the same way."""
    usage: dict = {}
    for src in sources:
        if src.startswith(("http://", "https://")):
            st = fetch_source(src)
            if isinstance(st, dict) and isinstance(st.get("usage"),
                                                   dict):
                for key, v in st["usage"].items():
                    if isinstance(v, dict):
                        usage[key] = v
            continue
        reader = readers.setdefault(src, TailReader(src))
        state = states.setdefault(src, {})
        fold_records(state, reader.poll())
        usage.update(state.get("usage") or {})
    return [{"key": key, "fits": v.get("fits"),
             "busy_s": v.get("busy_s"), "sheds": v.get("sheds"),
             "violations": v.get("violations")}
            for key, v in sorted(usage.items())]


def render_tenant_rows(rows: list) -> str:
    """The ``--tenants`` table: one line per (tenant, class)."""
    table = [list(TENANT_COLUMNS)]
    for r in rows:
        table.append([
            r["key"],
            "-" if r["fits"] is None else str(r["fits"]),
            "-" if r["busy_s"] is None else f"{r['busy_s']:.1f}",
            "-" if r["sheds"] is None else str(r["sheds"]),
            "-" if r["violations"] is None else str(r["violations"])])
    return _render_table(table)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m multigrad_tpu_torch.telemetry.top",
        description="per-worker fleet resource columns from /status "
                    "endpoints or telemetry JSONL streams")
    parser.add_argument("sources", nargs="+",
                        help="status URLs (http://host:port/status) "
                             "and/or telemetry .jsonl paths")
    parser.add_argument("--follow", action="store_true",
                        help="redraw every --interval seconds")
    parser.add_argument("--once", action="store_true",
                        help="print one table and exit (default)")
    parser.add_argument("--interval", type=float, default=2.0,
                        help="refresh period in seconds (--follow)")
    parser.add_argument("--json", action="store_true",
                        help="emit rows as a JSON list, not a table")
    parser.add_argument("--tenants", action="store_true",
                        help="per-(tenant, class) usage rows instead "
                             "of per-worker resource rows")
    parser.add_argument("--max-frames", type=int, default=None,
                        help=argparse.SUPPRESS)   # test hook
    args = parser.parse_args(argv)

    readers: dict = {}
    states: dict = {}

    def frame() -> str:
        if args.tenants:
            rows = collect_tenant_rows(args.sources, readers, states)
            render = render_tenant_rows
        else:
            rows = collect_rows(args.sources, readers, states)
            render = render_rows
        if args.json:
            return json.dumps(rows, indent=1)
        return render(rows)

    if args.once or not args.follow:
        print(frame())
        return 0
    frames = 0
    try:
        while args.max_frames is None or frames < args.max_frames:
            out = frame()
            if sys.stdout.isatty():
                sys.stdout.write("\x1b[H\x1b[2J" + out + "\n")
            else:
                sys.stdout.write(out + "\n\n")
            sys.stdout.flush()
            frames += 1
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":                           # pragma: no cover
    sys.exit(main())
