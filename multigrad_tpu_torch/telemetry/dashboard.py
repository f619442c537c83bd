"""Streaming ANSI terminal dashboard over a telemetry JSONL stream (a copy
of :mod:`multigrad_tpu.telemetry.dashboard` that reads the port's run
record).

::

    python -m multigrad_tpu_torch.telemetry.dashboard run.jsonl --follow
    python -m multigrad_tpu_torch.telemetry.dashboard run.jsonl --once

The terminal twin of the live HTTP endpoint (:mod:`.live`): tail a
fit's JSONL file as it is written and render loss/|grad| sparklines,
steps/s, ETA against the fit plan, HMC acceptance/divergence rates,
per-class SLO error budgets (remaining %%, burn rate, ``!`` while
fast-burning — from ``slo_budget`` records), a stall indicator and
any fired alerts — no HTTP, no dependencies, just
the file the fit is already writing (``JsonlSink`` flushes one
complete line per record precisely so this tail is safe).

``--follow`` refreshes in place every ``--interval`` seconds until
interrupted; ``--once`` renders a single deterministic snapshot (no
cursor control codes) — the mode tests and CI use.  Multi-run files
(appended streams) render the LAST run, same convention as
:mod:`.report`.

Pure stdlib, same triage-box caveat as the report CLI: ``-m`` imports
the package (and so torch); on a torch-less box run the file directly
(``python path/to/multigrad_tpu_torch/telemetry/dashboard.py run.jsonl``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

__all__ = ["TailReader", "Collector", "sparkline", "collect",
           "render", "main"]

SPARK_CHARS = "▁▂▃▄▅▆▇█"


class TailReader:
    """Incremental JSONL reader safe against live writers.

    Reads only *complete* lines: bytes after the last newline stay in
    a carry buffer until the writer finishes the line, so a reader
    polling mid-write can never parse a half-written record — the
    follow-mode twin of ``report.load_records``'s truncated-tail
    repair (which this reader also inherits: an unparseable line —
    e.g. a crashed run's torn tail closed off by the next
    ``JsonlSink`` — is skipped, not fatal).  A shrinking file
    (rotation/truncation) resets the reader to the top.
    """

    def __init__(self, path: str):
        self.path = path
        self._pos = 0
        self._buf = b""

    def poll(self) -> list:
        """New complete records since the last poll."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []
        if size < self._pos:            # truncated/rotated: start over
            self._pos = 0
            self._buf = b""
        try:
            with open(self.path, "rb") as f:
                f.seek(self._pos)
                data = f.read()
                self._pos = f.tell()
        except OSError:
            return []
        self._buf += data
        records = []
        while b"\n" in self._buf:
            line, self._buf = self._buf.split(b"\n", 1)
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except ValueError:
                continue                # torn line: skip, don't die
        return records


def sparkline(values, width: int = 40) -> str:
    """Unicode block sparkline of the last ``width`` values (non-
    finite values render as spaces; a flat series renders mid-height)."""
    vals = [float(v) for v in values][-width:]
    finite = [v for v in vals if v == v and abs(v) != float("inf")]
    if not finite:
        return " " * len(vals)
    lo, hi = min(finite), max(finite)
    span = hi - lo
    out = []
    for v in vals:
        if v != v or abs(v) == float("inf"):
            out.append(" ")
        elif span == 0:
            out.append(SPARK_CHARS[len(SPARK_CHARS) // 2])
        else:
            idx = int((v - lo) / span * (len(SPARK_CHARS) - 1))
            out.append(SPARK_CHARS[idx])
    return "".join(out)


def _scalar(v):
    if isinstance(v, list):
        return float(v[0]) if v else None
    return float(v) if isinstance(v, (int, float)) else None


def _fmt(v, nd=4):
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}g}"
    return str(v)


def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return (f"{n:.0f}{unit}" if unit == "B"
                    else f"{n:.1f}{unit}")
        n /= 1024.0


def _fmt_eta(seconds) -> str:
    if seconds is None:
        return "-"
    seconds = max(0, int(seconds))
    h, rem = divmod(seconds, 3600)
    m, s = divmod(rem, 60)
    return f"{h}:{m:02d}:{s:02d}" if h else f"{m}:{s:02d}"


# Trailing points kept per sparkline series: render shows at most
# `width` of them, so the cap only needs to exceed any sane terminal.
_SERIES_CAP = 512


class Collector:
    """Incremental fold of a record stream into the dashboard view.

    ``--follow`` feeds each poll's NEW records into one persistent
    collector, so a frame costs O(new records) and memory stays
    bounded (series keep the trailing :data:`_SERIES_CAP` points) —
    a multi-hour fit never degrades the refresh.  Boundaries reset
    state: a ``run`` record starts a fresh run (only the LAST run of
    an appended file renders, same rationale as ``report.summarize``
    — stitching runs would fabricate a fit curve), and a ``fit_plan``
    record starts a fresh *fit* within the run (so a sequence of fits
    through one logger never shows the previous fit's summary/series
    against the new plan).  Recent alerts survive fit boundaries —
    they are exactly what an operator coming back to the terminal
    needs to see.
    """

    def __init__(self):
        self.runs_in_file = 0
        self.n_records = 0
        self.run = None
        self.alerts: list = []
        self._reset_run()

    def _reset_run(self):
        self.stalled = False
        self.comm = None
        self.resources = None
        self.budgets: dict = {}
        self._reset_fit()

    def _reset_fit(self):
        self.plan = None
        self.summary = None
        self.hmc = None
        self.loss: list = []
        self.grad: list = []
        self.ema: list = []
        self.steps: list = []
        self.ts: list = []

    def feed(self, records):
        for rec in records:
            self._one(rec)
        return self

    def _one(self, rec: dict):
        event = rec.get("event")
        self.n_records += 1
        if event == "run":
            self.runs_in_file += 1
            if self.runs_in_file > 1:      # keep only the last run
                self.n_records = 1
                self.alerts = []
            self.run = rec
            self._reset_run()
        elif event == "fit_plan":
            self._reset_fit()
            self.plan = rec
        elif event == "adam":
            s, v = rec.get("step"), _scalar(rec.get("loss"))
            if s is not None and v is not None:
                self.steps.append(s)
                self.ts.append(rec.get("t"))
                self.loss.append(v)
                g = _scalar(rec.get("grad_norm"))
                if g is not None:
                    self.grad.append(g)
                e = _scalar(rec.get("loss_ema"))
                if e is not None:
                    self.ema.append(e)
                for series in (self.steps, self.ts, self.loss,
                               self.grad, self.ema):
                    del series[:-_SERIES_CAP]
        elif event == "hmc":
            self.hmc = rec
        elif event == "comm":
            self.comm = rec
        elif event == "resource_sample":
            self.resources = rec       # newest wins, like comm
        elif event == "stall":
            self.stalled = True
        elif event == "stall_recovered":
            self.stalled = False
        elif event == "alert":
            self.alerts.append(rec)
            del self.alerts[:-8]
        elif event == "slo_budget":
            # cumulative ledger snapshot: newest per class wins, and
            # like alerts it survives fit boundaries — the budget
            # spans the serving run, not one fit
            cls = rec.get("priority_class")
            if isinstance(cls, str):
                self.budgets[cls] = rec
        elif event == "fit_summary":
            self.summary = rec

    def view(self) -> dict:
        """The dict :func:`render` consumes."""
        # trailing steps/s from record spacing (last ~8 records);
        # timestamps and steps are filtered as PAIRS, so a stream
        # with some t-less records can't mismatch the endpoints
        rate = None
        pairs = [(t, s) for t, s in zip(self.ts[-8:], self.steps[-8:])
                 if t is not None]
        if len(pairs) >= 2 and pairs[-1][0] > pairs[0][0] \
                and pairs[-1][1] > pairs[0][1]:
            rate = (pairs[-1][1] - pairs[0][1]) \
                / (pairs[-1][0] - pairs[0][0])
        nsteps = (self.plan or {}).get("nsteps")
        if self.summary is not None:
            eta = 0.0
        elif rate and nsteps and self.steps:
            eta = max(0, nsteps - 1 - self.steps[-1]) / rate
        else:
            eta = None
        return {
            "runs_in_file": self.runs_in_file,
            "n_records": self.n_records,
            "run": self.run,
            "plan": self.plan,
            "loss": self.loss,
            "grad_norm": self.grad,
            "loss_ema": self.ema,
            "steps": self.steps,
            "steps_per_sec": rate,
            "nsteps": nsteps,
            "eta_s": eta,
            "hmc": self.hmc,
            "comm": self.comm,
            "resources": self.resources,
            "stalled": self.stalled,
            "alerts": self.alerts,
            "budgets": self.budgets,
            "summary": self.summary,
        }


def collect(records: list) -> dict:
    """One-shot fold (the ``--once`` path): feed everything through a
    fresh :class:`Collector` and return its view."""
    return Collector().feed(records).view()


def render(view: dict, width: int = 64) -> str:
    """One dashboard frame (plain text; the follow loop adds cursor
    control around it)."""
    bar_w = max(16, width - 24)
    lines = []
    run = view.get("run")
    if run:
        lines.append(
            f"run  {run.get('backend')}  "
            f"{run.get('device_count')}x{run.get('device_kind')}  "
            f"procs={run.get('process_count')}  "
            f"torch {run.get('torch_version')}")
    if view.get("runs_in_file", 0) > 1:
        lines.append(f"(file holds {view['runs_in_file']} runs; "
                     f"showing the last)")
    plan = view.get("plan") or {}
    steps = view.get("steps") or []
    nsteps = view.get("nsteps")
    if steps:
        head = f"step {steps[-1]}"
        if nsteps:
            frac = min(1.0, (steps[-1] + 1) / nsteps)
            filled = int(frac * bar_w)
            head += (f"/{nsteps}  [" + "#" * filled
                     + "-" * (bar_w - filled) + f"] {frac:4.0%}")
        lines.append(head)
    elif plan:
        lines.append(f"step -/{plan.get('nsteps')}  (no tap records "
                     f"yet)")
    loss = view.get("loss") or []
    if loss:
        lines.append(f"loss   {sparkline(loss, bar_w)}  "
                     f"{_fmt(loss[-1])}")
    ema = view.get("loss_ema") or []
    if ema:
        lines.append(f"ema    {sparkline(ema, bar_w)}  "
                     f"{_fmt(ema[-1])}")
    grad = view.get("grad_norm") or []
    if grad:
        lines.append(f"|grad| {sparkline(grad, bar_w)}  "
                     f"{_fmt(grad[-1])}")
    rate_bits = [f"steps/s {_fmt(view.get('steps_per_sec'))}",
                 f"ETA {_fmt_eta(view.get('eta_s'))}"]
    comm = view.get("comm")
    if comm:
        rate_bits.append(
            f"comm {_fmt(comm.get('bytes_per_step'))} B/step")
    lines.append("  ".join(rate_bits))
    hmc = view.get("hmc")
    if hmc:
        div = hmc.get("divergences")
        if isinstance(div, list):
            div = sum(div)
        draws = hmc.get("step") or 0
        div_rate = (div / draws) if div is not None and draws else None
        lines.append(
            f"hmc  draw {draws}  accept={_fmt(_scalar(hmc.get('accept')))}"
            f"  divergences={_fmt(div)}"
            + (f" ({div_rate:.1%}/draw)" if div_rate is not None
               else ""))
    res = view.get("resources")
    if res:
        bits = [f"rss {_fmt_bytes(res.get('rss_bytes'))}"]
        busy = res.get("busy_frac")
        if busy is not None:
            bits.append(f"busy {busy:.0%}")
        if res.get("device_bytes_in_use") is not None:
            bits.append(
                f"dev {_fmt_bytes(res['device_bytes_in_use'])}")
        cc = res.get("compile_count")
        if cc is not None:
            bits.append(
                f"compiles {cc}"
                + (f" ({res['compile_s_total']:.1f}s)"
                   if res.get("compile_s_total") is not None
                   else ""))
        lines.append("res  " + "  ".join(bits))
    budgets = view.get("budgets")
    if budgets:
        bits = []
        for cls in sorted(budgets):
            b = budgets[cls]
            rem = b.get("remaining_frac")
            bit = (f"{cls} -" if rem is None
                   else f"{cls} {100.0 * rem:.0f}%")
            burn = b.get("burn_rate")
            if burn is not None:
                bit += f" b={burn:.1f}"
            if b.get("fast_burning"):
                bit += "!"
            bits.append(bit)
        lines.append("slo  " + "  ".join(bits))
    if view.get("stalled"):
        lines.append("STALL  no progress (heartbeat stall active)")
    summary = view.get("summary")
    if summary:
        final = _scalar(summary.get("final_loss"))
        if final is None and loss:
            final = loss[-1]     # scan fits: last tapped loss
        lines.append(
            f"done  final_loss={_fmt(final)}"
            + (f"  steps/s={_fmt(summary.get('steps_per_sec'))}"
               if summary.get("steps_per_sec") is not None else "")
            + (f"  postmortem={summary['postmortem_bundle']}"
               if summary.get("postmortem_bundle") else ""))
    for alert in (view.get("alerts") or [])[-4:]:
        lines.append(
            f"ALERT [{alert.get('rule')}] {alert.get('message', '')}"
            + (f" (step {alert.get('step')})"
               if alert.get("step") is not None else ""))
    if not (steps or loss or hmc or plan):
        lines.append("(no recognized telemetry records yet)")
    lines.append(f"records: {view.get('n_records', 0)}")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m multigrad_tpu_torch.telemetry.dashboard",
        description="Streaming terminal dashboard over a telemetry "
                    "JSONL file.")
    parser.add_argument("path", help="telemetry .jsonl file (may "
                                     "still be growing)")
    parser.add_argument("--follow", action="store_true",
                        help="keep tailing and re-rendering until "
                             "interrupted")
    parser.add_argument("--once", action="store_true",
                        help="render one snapshot and exit "
                             "(deterministic; for tests/CI)")
    parser.add_argument("--interval", type=float, default=1.0,
                        help="refresh period in seconds (--follow)")
    parser.add_argument("--width", type=int, default=64,
                        help="render width in columns")
    parser.add_argument("--max-frames", type=int, default=None,
                        help=argparse.SUPPRESS)   # test hook
    args = parser.parse_args(argv)

    reader = TailReader(args.path)
    records: list = []
    if args.once or not args.follow:
        if not os.path.exists(args.path):
            print(f"{args.path}: no such file", file=sys.stderr)
            return 1
        records += reader.poll()
        print(render(collect(records), width=args.width))
        return 0

    frames = 0
    collector = Collector()
    try:
        while True:
            # incremental: only this poll's NEW records are folded,
            # so a frame costs O(new records), not O(whole file)
            collector.feed(reader.poll())
            frame = render(collector.view(), width=args.width)
            # home + clear-to-end keeps the frame flicker-free on any
            # ANSI terminal; plain output when not a tty (piped logs).
            if sys.stdout.isatty():
                sys.stdout.write("\x1b[H\x1b[2J" + frame + "\n")
            else:
                sys.stdout.write(frame + "\n---\n")
            sys.stdout.flush()
            frames += 1
            if args.max_frames is not None \
                    and frames >= args.max_frames:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
