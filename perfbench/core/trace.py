"""The traced window of a ``--trace 1`` run, and what is read from it.

A frozen copy of ``multigrad_tpu_torch/telemetry/profile.py``'s lead-in:
:data:`LEAD_IN` spin kernels open every profiler window on the card,
because after many launches a window loses its first few device events
and the lead-in takes that loss.  The window itself is bracketed by a
``record_function`` range (:data:`WINDOW`), so that its bounds and the
device events share one clock.

From the profiler's events the window gives:

- ``window_s``: the bracket's length;
- ``busy_s``: the union of the device's intervals (kernels, copies,
  memsets; the lead-in left out) inside the bracket;
- ``kernels``: device seconds and launches by kernel name;
- ``device_ops``: the ten names that took most device time;
- ``idle_gaps``: idle device time inside the bracket, summed by what the
  host was doing (the innermost host operation covering the middle of
  each gap of at least :data:`GAP_US` microseconds; shorter gaps are
  summed under one name);
- ``spans``: the program's span table (:func:`perfbench.core.spans
  .table_of`) of the events that start inside the bracket.

The profiler's events are read once, into :class:`perfbench.core.spans
.Event` tuples, whose first four fields are what :func:`summarize`
reads.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict

from perfbench.core import spans

#: Spin kernels at the start of every window on the card.
LEAD_IN = 256
SPIN_KERNEL = "spin_kernel"
#: The host range that brackets the traced work.
WINDOW = "perfbench.window"
#: Idle gaps shorter than this (microseconds) are summed under one name.
GAP_US = 10.0
SHORT_GAPS = "gaps under 10 us"
TOP = 10


class Window:
    """A profiler window over the traced part of a run.

    :meth:`start` starts the profiler and runs the lead-in; :meth:`open`
    (which starts it first if need be) and :meth:`close` bracket the
    traced work.  Starting the profiler takes seconds the first time in
    a process, so a driver whose work runs on while the window opens
    (the scheduler's dispatcher thread) starts it ahead."""

    def __init__(self, device):
        import torch
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.started = self.opened = self.closed = False
        self.summary: dict | None = None
        self.wall_s = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.on_card:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        if self.on_card:
            for _ in range(LEAD_IN):
                torch.cuda._sleep(1)
            torch.cuda.synchronize(self.device)
        self.started = True

    def open(self):
        import torch
        if not self.started:
            self.start()
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()
        self._t0 = time.perf_counter()
        self.opened = True

    def close(self):
        import torch
        if self.on_card:
            torch.cuda.synchronize(self.device)
        self.wall_s = time.perf_counter() - self._t0
        self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.closed = True
        evs = spans.events(self._prof)
        self.summary = summarize(evs)
        self.summary["wall_s"] = self.wall_s
        w0, w1 = bracket(evs)
        self.summary["spans"] = spans.table_of(
            [e for e in evs if w0 <= e.start < w1])
        del self._prof, self._range


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def short_name(name: str) -> str:
    """A kernel's name without its argument list, at most 160 letters."""
    name = name.replace("(anonymous namespace)::", "")
    return (name.split("(")[0] if "<" in name else name)[:160]


def bracket(events):
    """The start and end (ns) of the last :data:`WINDOW` range."""
    ranges = [e for e in events if not e[1] and e[0] == WINDOW]
    if not ranges:
        raise RuntimeError(f"the profiler kept no {WINDOW!r} range")
    return ranges[-1][2], ranges[-1][3]


def summarize(events) -> dict:
    """Read the window out of ``events``, each ``(name, on_device,
    start_ns, end_ns, ...)`` (see the module docstring)."""
    w0, w1 = bracket(events)
    # A host range shows on the device too, as an annotation spanning the
    # kernels it launched: not device work of its own.
    annotations = {e[0] for e in events if not e[1]}
    kernels = defaultdict(lambda: [0.0, 0])
    ops, lead = [], 0
    for name, on_device, start, end, *_ in events:
        if not on_device:
            continue
        if SPIN_KERNEL in name:
            lead += 1
            continue
        if name in annotations or start < w0 or start >= w1:
            continue
        end = min(end, w1)
        ops.append((start, end))
        kernels[name][0] += (end - start) * 1e-9
        kernels[name][1] += 1
    busy = _union(ops)
    busy_s = sum(e - s for s, e in busy) * 1e-9
    host = sorted((s, e, n) for n, d, s, e, *_ in events
                  if not d and n != WINDOW and s < w1 and e > w0)
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    edge = w0
    for s, e in busy + [[w1, w1]]:
        if s > edge:
            gaps[_host_label(host, starts, edge, s)] += (s - edge) * 1e-9
        edge = max(edge, e)
    device_ops = sorted(([short_name(n), v[0]] for n, v in kernels.items()),
                        key=lambda r: -r[1])[:TOP]
    idle = sorted(([n, v] for n, v in gaps.items()), key=lambda r: -r[1])
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": busy_s,
        "lead_in_kept": lead,
        "kernels": {n: (v[0], v[1]) for n, v in kernels.items()},
        "device_ops": device_ops,
        "idle_gaps": idle[:TOP],
    }


def _host_label(host, starts, start, end, walk=4096):
    """What the host was doing over the idle gap ``[start, end)``: the
    innermost host operation covering its middle."""
    if (end - start) * 1e-3 < GAP_US:
        return SHORT_GAPS
    mid = (start + end) // 2
    i = bisect.bisect_right(starts, mid) - 1
    for j in range(i, max(-1, i - walk), -1):
        if host[j][1] >= mid:
            return "host: " + host[j][2]
    return "host: between operations"
