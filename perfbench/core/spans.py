"""The program's spans in the traced window, read from the profiler.

While a profiler runs, each span of ``multigrad_tpu_torch`` opens a
``record_function`` range named ``mgt.<name>``
(``multigrad_tpu_torch/telemetry/spans.py``).  :func:`table_of` reads
those ranges out of the window's profiler events (:func:`events`), on the
trace's own clock, into
``{path: {"count", "host_s", "host_work_s", "device_s"}}``.  A range's
``path`` is its name after those of the ranges that hold it
(``"mgt.adam.step/mgt.hist.cumsum"``); over the instances of a path:

- ``host_s``: the ranges' length;
- ``host_work_s``: that less the time in which the host was blocked on
  the card inside them (:data:`BLOCKING`: a full launch queue, and the
  runtime calls that wait for the card, on any thread).  When the launch
  queue is full the host waits inside whatever range is open, and a host
  metric of a device-bound run would read the card's pace;
- ``device_s``: the device time of the kernels, copies and memsets
  attributed to the ranges, those of the ranges they hold included.

A device event is attributed through the host operation that launched it
(its ``linked_correlation_id``):

1. to the innermost range open on that operation's thread at its start;
2. else, when the operation runs under an autograd backward node, to the
   innermost range that held the node's forward operation (the one with
   the node's ``sequence_nr`` on its ``fwd_thread_id``);
3. else, to the innermost range on any thread open at the operation's
   start.

One that matches none is left out.  A range's parent is the innermost
range that holds its start on its own thread, else on any other thread
(the autograd engine's thread runs a step's backward while the step's
range is open on the thread that called it).  A window without ranges
(a program that opens none) gives an empty table.

The window of a traced run (:class:`perfbench.core.trace.Window`) keeps
this table as ``summary["spans"]``, read from the same list of events as
the rest of its summary; :func:`host_work_ms` and :func:`device_ms_per`
read it from there.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import NamedTuple

#: The prefix of the program's ranges.
PREFIX = "mgt."
#: Host events in which the host waits for the card.
BLOCKING = ("Command Buffer Full", "cudaStreamSynchronize",
            "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
#: The host event of an autograd backward node's evaluation.
NODE = "autograd::engine::evaluate_function: "


class Event(NamedTuple):
    name: str
    on_device: bool
    start: int          # ns
    end: int            # ns
    thread: int
    corr: int           # correlation id (host operations)
    linked: int         # the launching operation's id (device events)
    seq: int            # autograd sequence number, -1 when none
    fwd_thread: int     # a backward node's forward thread, 0 when none


def events(prof) -> list:
    """Every event of the profiler ``prof`` as an :class:`Event`, read from
    its raw results (building its event objects would take longer than
    many a window)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.append(Event(e.name(), e.device_type() == cuda, start,
                         start + e.duration_ns(), e.start_thread_id(),
                         e.correlation_id(), e.linked_correlation_id(),
                         e.sequence_nr(), e.fwd_thread_id()))
    return out


class _Cover:
    """The intervals ``[start, end)`` open at each time: ``at(t)`` gives
    the indices of those holding ``t``, in ascending order."""

    def __init__(self, intervals):
        marks = defaultdict(lambda: ([], []))
        for i, (start, end) in enumerate(intervals):
            marks[start][0].append(i)
            marks[end][1].append(i)
        self.bounds = sorted(marks)
        self.open = []
        active = set()
        for b in self.bounds:
            opened, closed = marks[b]
            active.difference_update(closed)
            active.update(i for i in opened if intervals[i][1] > b)
            self.open.append(tuple(sorted(active)))

    def at(self, t):
        i = bisect.bisect_right(self.bounds, t) - 1
        return self.open[i] if i >= 0 else ()


def _innermost(candidates, items, thread=None, before=None):
    """The last of ``candidates`` (ascending indices into ``items``) on
    ``thread`` (any when None) and below ``before``."""
    for i in reversed(candidates):
        if (thread is None or items[i].thread == thread) \
                and (before is None or i < before):
            return i
    return None


def _blocked(evs):
    """The union of the host's blocked intervals, merged and sorted."""
    spans = sorted((e.start, e.end) for e in evs
                   if not e.on_device and e.name.startswith(BLOCKING))
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _overlap(merged, starts, s, e):
    total = 0
    i = max(0, bisect.bisect_right(starts, s) - 1)
    while i < len(merged) and merged[i][0] < e:
        total += max(0, min(e, merged[i][1]) - max(s, merged[i][0]))
        i += 1
    return total


class Attribution(NamedTuple):
    ranges: list        # the ranges, ordered by (start, -end)
    parent: list        # each one's parent's index, None at the top
    path: list          # each one's path
    device: list        # (device event, its range's index or None)


def attribute(evs) -> Attribution:
    """The ranges of the events ``evs`` (:class:`Event` tuples), their
    nesting, and the range each device event is attributed to (see the
    module)."""
    host = [e for e in evs if not e.on_device]
    ranges = sorted((e for e in host if e.name.startswith(PREFIX)),
                    key=lambda e: (e.start, -e.end))
    if not ranges:
        return Attribution([], [], [], [])
    cover = _Cover([(r.start, r.end) for r in ranges])

    parent, path = [], []
    for i, r in enumerate(ranges):
        held = cover.at(r.start)
        p = _innermost(held, ranges, r.thread, before=i)
        if p is None:
            p = _innermost(held, ranges, before=i)
        parent.append(p)
        path.append(r.name if p is None else f"{path[p]}/{r.name}")

    # The host operations that launched device work, the backward nodes,
    # and the forward operations the nodes point at.
    names = {e.name for e in host}
    launched = {e.linked for e in evs if e.on_device and e.linked > 0}
    # Operations link to nothing; the runtime's calls link to them.
    ops = {e.corr: e for e in host if e.linked == 0 and e.corr in launched}
    nodes = [e for e in host if e.name.startswith(NODE) and e.seq >= 0]
    node_cover = _Cover([(n.start, n.end) for n in nodes])
    forward = {}
    for e in host:
        if e.seq >= 0 and e.fwd_thread == 0 and not e.name.startswith(NODE):
            key = (e.seq, e.thread)
            if key not in forward or forward[key].start <= e.start:
                forward[key] = e

    def owner(op):
        r = _innermost(cover.at(op.start), ranges, op.thread)
        if r is not None:
            return r
        n = _innermost(node_cover.at(op.start), nodes, op.thread)
        if n is not None:
            fwd = forward.get((nodes[n].seq, nodes[n].fwd_thread))
            if fwd is not None:
                r = _innermost(cover.at(fwd.start), ranges, fwd.thread)
                if r is not None:
                    return r
        return _innermost(cover.at(op.start), ranges)

    device, owners = [], {}
    for e in evs:
        # A host range shows on the device too, as an annotation over its
        # kernels: not device work of its own.
        if not e.on_device or e.name in names:
            continue
        op = ops.get(e.linked)
        if op is not None and e.linked not in owners:
            owners[e.linked] = owner(op)
        device.append((e, owners.get(e.linked)))
    return Attribution(ranges, parent, path, device)


def table_of(evs) -> dict:
    """The span table of the events ``evs`` (:class:`Event` tuples)."""
    ranges, parent, path, attributed = attribute(evs)
    device = [0] * len(ranges)
    for e, r in attributed:
        if r is not None:
            device[r] += e.end - e.start
    for i in range(len(ranges) - 1, -1, -1):
        if parent[i] is not None:
            device[parent[i]] += device[i]

    blocked = _blocked(evs)
    starts = [b[0] for b in blocked]
    out = {}
    for i, r in enumerate(ranges):
        row = out.setdefault(path[i], {"count": 0, "host_s": 0.0,
                                       "host_work_s": 0.0, "device_s": 0.0})
        host_ns = r.end - r.start
        row["count"] += 1
        row["host_s"] += host_ns * 1e-9
        row["host_work_s"] += (host_ns - _overlap(blocked, starts, r.start,
                                                  r.end)) * 1e-9
        row["device_s"] += device[i] * 1e-9
    return out


def select(spans: dict, name: str, within: str | None = None) -> list:
    """The rows of the span ``name`` (the last name of their path), those
    held by a span ``within`` alone when given."""
    return [row for p, row in spans.items()
            if p.rsplit("/", 1)[-1] == name
            and (within is None or within in p.split("/")[:-1])]


def host_work_ms(ctx, name: str):
    """The host work of the span ``name`` a range, in ms; None off the
    card or without the span."""
    rows = select(ctx.trace.get("spans") or {}, name) if ctx.on_card else []
    count = sum(r["count"] for r in rows)
    if not count:
        return None
    return 1e3 * sum(r["host_work_s"] for r in rows) / count


def device_ms_per(ctx, name: str, per: str):
    """The device time attributed to the span ``name`` inside the ranges
    of the span ``per``, over their number, in ms; None off the card or
    without either span."""
    spans = (ctx.trace.get("spans") or {}) if ctx.on_card else {}
    count = sum(r["count"] for r in select(spans, per))
    rows = select(spans, name, within=per)
    if not count or not rows:
        return None
    return 1e3 * sum(r["device_s"] for r in rows) / count
