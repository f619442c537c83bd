"""Flight recorder: bounded record ring + anomaly postmortems (port of
:mod:`multigrad_tpu.telemetry.flight`).

A long fit that dies — NaN loss, diverging sampler, wedged prefetch
thread — is only debuggable if *what happened just before* survives
the crash.  The :class:`FlightRecorder` is a telemetry **sink** (give
it to :class:`~multigrad_tpu_torch.telemetry.MetricsLogger` next to the
JSONL file): every record the fit emits — ``adam`` taps, ``comm``
accounting, ``span``\\ s, ``heartbeat``\\ s — lands in a bounded
in-memory ring, and on an anomaly the recorder dumps a
**self-contained postmortem bundle** (one JSON file: the ring
contents, the run record, the identity of the watched programs, the
last checkpoint path, the trip reason) and the fit entry points
raise :class:`FlightRecorderTripped` with the bundle path (also
stamped into the ``fit_summary`` record).

Three trigger classes:

* **non-finite sentinel** — a latch on the device
  (:class:`NonFiniteSentinel`) that each step of an Adam fit or an
  HMC draw folds ``~isfinite(loss) | ~isfinite(|grad|)`` (or the
  sampler's proposal potential) into, keeping the first step at which
  it fired and the values there.  It never makes the host wait: its
  state travels in the copy of each tap record
  (:class:`~multigrad_tpu_torch.telemetry.taps.ScalarTap`) and is read
  once more at the fit's end.  When the host sees it fired, the
  recorder dumps the bundle; the fit runs to its end (a checkpointed
  fit stops at the next checkpoint, before writing it) and raises.
* **heartbeat stall** — the recorder sees the ``stall`` records the
  :class:`~multigrad_tpu_torch.telemetry.Heartbeat` thread writes and
  dumps a bundle (non-fatal by default: a transient stall should
  not kill a fit that recovers; set ``fatal_on_stall=True`` for
  fail-fast fleets).
* **divergence spike** — a jump of ``divergence_spike`` or more in
  the cumulative divergence count between consecutive ``hmc`` tap
  records dumps a bundle (non-fatal: the run's statistics decide).

Where the JAX package's bundle holds a jaxpr digest of each watched
program, the port's holds what identifies the program in PyTorch: the
callable's qualified name, its arguments' shapes and dtypes, and the
hash of the CUDA kernel sources the package builds
(:func:`multigrad_tpu_torch.ops.cuda_build.sources_digest`).

Wiring::

    recorder = FlightRecorder(dump_dir="postmortems")
    log = MetricsLogger(JsonlSink("run.jsonl"), recorder)
    model.run_adam(guess, nsteps, telemetry=log, log_every=10,
                   flight=recorder)     # raises on NaN, bundle saved

This module imports only stdlib/numpy at module level (torch lazily
inside the device paths), per the telemetry package contract.
"""
from __future__ import annotations

import collections
import json
import os
import tempfile
import time
from typing import Optional

from .metrics import _jsonable

__all__ = ["FlightRecorder", "FlightRecorderTripped", "NonFiniteSentinel"]


def _strict_json(value):
    """Replace non-finite floats with their string names.

    Postmortem bundles embed NaN/Inf by construction (the trip's
    whole point); ``json.dump``'s default would write bare ``NaN``
    tokens — valid for Python's lenient reader, rejected by every
    strict RFC-8259 parser (jq, JSON.parse, fleet dashboards).  A
    fleet-readable artifact gets ``"NaN"``/``"Infinity"`` strings
    instead.
    """
    if isinstance(value, float):
        if value != value:
            return "NaN"
        if value == float("inf"):
            return "Infinity"
        if value == float("-inf"):
            return "-Infinity"
        return value
    if isinstance(value, dict):
        return {k: _strict_json(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_strict_json(v) for v in value]
    return value


class FlightRecorderTripped(RuntimeError):
    """A fatal flight-recorder trip (non-finite loss/grad/potential).

    ``bundle_path`` points at the postmortem JSON; ``reason`` and
    ``step`` carry the trigger.
    """

    def __init__(self, reason: str, bundle_path: Optional[str],
                 step=None):
        self.reason = reason
        self.bundle_path = bundle_path
        self.step = step
        at = f" at step {step}" if step is not None else ""
        super().__init__(
            f"flight recorder tripped ({reason}{at}); postmortem "
            f"bundle: {bundle_path}")


def _program_identity(program, args) -> dict:
    """What identifies ``program`` in PyTorch: its qualified name, its
    arguments' shapes and dtypes, and the hash of the package's kernel
    sources.  Best effort: a postmortem must never crash on its own
    context gathering."""
    out = {"qualname": f"{getattr(program, '__module__', '?')}."
                       f"{getattr(program, '__qualname__', repr(program))}",
           "args": args}
    try:
        from ..ops.cuda_build import sources_digest
        out["kernel_sources"] = sources_digest()
    except OSError:
        out["kernel_sources"] = None
    return out


def _describe(arg):
    """``(shape, dtype)`` of a tensor or array, ``repr`` of anything
    else: what ``watch_program`` keeps of an argument."""
    shape, dtype = getattr(arg, "shape", None), getattr(arg, "dtype", None)
    if shape is not None and dtype is not None:
        return [list(shape), str(dtype)]
    if isinstance(arg, (list, tuple)):
        return [_describe(a) for a in arg]
    return repr(arg)[:80]


class NonFiniteSentinel:
    """Non-finite watch on the device, bound to a :class:`FlightRecorder`.

    Its :attr:`state` is a latch on the fit's device: ``[first step at
    which it fired (-1 while it has not), which names were watched then,
    the watched values at that step...]``.  :meth:`watch` folds a step into it with a few
    elementwise kernels and no read; the host learns of a trip from the
    copy of the latch that rides along each tap record (:meth:`seen`) or
    from the one read at the fit's end (:meth:`finish`).  Obtain
    instances via :meth:`FlightRecorder.sentinel` (one per name); a fit
    calls :meth:`arm` before its first step.
    """

    def __init__(self, recorder: "FlightRecorder", name: str):
        self.recorder = recorder
        self.name = name
        self.state = None
        self._layouts: list = []
        self._tripped = False

    def _key(self):
        return (id(self.recorder), self.name)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return (isinstance(other, NonFiniteSentinel)
                and self._key() == other._key())

    def arm(self):
        """Clear the latch for a new fit."""
        self.state = None
        self._layouts = []
        self._tripped = False

    def watch(self, step, values: dict, gate=None):
        """Fold step ``step`` into the latch: it fires iff any entry of
        ``values`` (tensors on one device) is non-finite and it has not
        fired before (and ``gate``, a Python bool, when given).  Returns
        the raw non-finite flag, a 0-d bool tensor on the device (gate
        not applied); nothing is read.  Every call of a fit watches
        values of one total size (their names may change, as from the
        sampler's warmup to its sampling)."""
        import torch

        vals = torch.cat([v.detach().reshape(-1).float()
                          for v in values.values()])
        layout = [(n, v.dim(), v.numel()) for n, v in values.items()]
        if layout not in self._layouts:
            self._layouts.append(layout)
        if self.state is None:
            self.state = torch.cat([vals.new_full((1,), -1.0),
                                    torch.zeros(vals.numel() + 1,
                                                device=vals.device)])
        bad = ~torch.isfinite(vals).all()
        if gate is None or gate:
            fire = bad & (self.state[0] < 0)
            # Filled on the device: an assignment from the host would
            # copy a CPU scalar and wait for the stream.
            head = vals.new_full((2,), float(step))
            head.narrow(0, 1, 1).fill_(float(self._layouts.index(layout)))
            self.state = torch.where(fire, torch.cat([head, vals]),
                                     self.state)
        return bad

    def seen(self, step: int, values):
        """The host's copy of the latch, taken with the tap record of
        ``step`` and seen before that record is logged: a latch that
        fired (at ``step`` or before) trips now, so the bundle's ring
        holds the records before the trip step's, as the JAX package's
        does (its sentinel's callback runs before its tap's)."""
        if not self._tripped and values[0] >= 0:
            self._trip(int(values[0]), values[1:])

    def finish(self):
        """The fit's end: read the latch (a copy that waits only for the
        latch itself) and trip if it fired and no record showed it."""
        if self.state is None or self._tripped:
            return
        import torch

        state = self.state
        if state.device.type == "cuda":
            host = torch.empty(state.shape, dtype=state.dtype,
                               pin_memory=True)
            host.copy_(state, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(state.device))
            event.synchronize()
            values = host.tolist()
        else:
            values = state.tolist()
        if values[0] >= 0:
            self._trip(int(values[0]), values[1:])

    def _trip(self, step, flat):
        self._tripped = True
        host, at = {}, 0
        for name, ndim, numel in self._layouts[int(flat[0])]:
            vals = flat[1 + at:1 + at + numel]
            host[name] = float(vals[0]) if ndim == 0 \
                else [float(v) for v in vals]
            at += numel
        self.recorder._on_nonfinite(self.name, step, host)


class FlightRecorder:
    """Bounded record ring + postmortem dumper (a telemetry sink).

    Parameters
    ----------
    dump_dir : str, optional
        Where bundles land (created on first dump).  Default: a
        fresh ``mkdtemp`` child — bundles are never silently
        clobbered between runs.
    capacity : int
        Ring size — the "last K records" a bundle preserves.
    trip_on_stall : bool
        Dump a bundle when a ``stall`` record flows through
        (non-fatal unless ``fatal_on_stall``).
    fatal_on_stall : bool
        Treat heartbeat stalls as fatal (the fit raises once it
        regains the host loop).
    divergence_spike : int, optional
        Dump when the cumulative divergence count in consecutive
        ``hmc`` records jumps by at least this much (None disables).
    context : dict, optional
        Extra provenance baked into every bundle (job id, config
        path, ...); extend later with :meth:`attach`.

    One recorder serves one fit at a time; call :meth:`reset`
    between fits to re-arm (the drivers do not reset automatically —
    a tripped recorder keeps refusing until the operator looks).
    """

    def __init__(self, dump_dir: Optional[str] = None,
                 capacity: int = 512, trip_on_stall: bool = True,
                 fatal_on_stall: bool = False,
                 divergence_spike: Optional[int] = 50,
                 context: Optional[dict] = None):
        self.dump_dir = dump_dir
        self.capacity = int(capacity)
        self.trip_on_stall = bool(trip_on_stall)
        self.fatal_on_stall = bool(fatal_on_stall)
        self.divergence_spike = divergence_spike
        self._ring = collections.deque(maxlen=self.capacity)
        # Re-entrant: write() -> trip() -> dump() all touch recorder
        # state; dump snapshots under the lock and does its file IO
        # outside it.
        from .._lockdep import make_rlock
        self._lock = make_rlock(
            "telemetry.flight.FlightRecorder._lock")
        self._context = dict(context or {})
        self._watched: dict = {}
        self._run_record: Optional[dict] = None
        self._sentinels: dict = {}
        self._last_divergences: Optional[float] = None
        self._seq = 0
        self.reason: Optional[str] = None
        self.fatal_step = None
        self.bundle_path: Optional[str] = None
        self._fatal = False

    # -- sink protocol ------------------------------------------------------
    def write(self, record: dict):
        with self._lock:
            self._ring.append(dict(record))
            event = record.get("event")
            if event == "run":
                self._run_record = dict(record)
            elif event == "stall" and self.trip_on_stall:
                self.trip("heartbeat_stall",
                          fatal=self.fatal_on_stall,
                          stalled_s=record.get("stalled_s"),
                          step=record.get("step"))
            elif event == "hmc" and self.divergence_spike:
                div = record.get("divergences")
                if isinstance(div, (list, tuple)):
                    div = sum(div)
                if isinstance(div, (int, float)):
                    prev = self._last_divergences
                    if (prev is not None
                            and div - prev >= self.divergence_spike):
                        self.trip("divergence_spike", fatal=False,
                                  divergences=div, previous=prev,
                                  step=record.get("step"))
                    self._last_divergences = div

    def close(self):
        pass

    # -- fit-driver context -------------------------------------------------
    def attach(self, **context):
        """Merge provenance into future bundles (checkpoint path,
        config digest, ...).  The fit drivers call this; users can
        too."""
        with self._lock:
            self._context.update(context)

    def watch_program(self, label: str, program, args):
        """Register a program whose identity a bundle records (the
        port's counterpart of the JAX package's jaxpr digest): its
        qualified name, the shapes and dtypes of ``args`` (kept as
        descriptions, so the recorder pins no buffer) and, at dump time,
        the hash of the kernel sources."""
        with self._lock:
            self._watched[label] = (program, _describe(args))

    def sentinel(self, name: str = "fit") -> NonFiniteSentinel:
        """The per-name cached non-finite watch (one object per name, as
        in the JAX package)."""
        with self._lock:
            if name not in self._sentinels:
                self._sentinels[name] = NonFiniteSentinel(self, name)
            return self._sentinels[name]

    # -- trip + dump --------------------------------------------------------
    @property
    def tripped(self) -> bool:
        return self.reason is not None

    @property
    def fatal(self) -> bool:
        return self._fatal

    def _on_nonfinite(self, name: str, step: int, values: dict):
        self.trip(f"non_finite_{name}", fatal=True, step=step,
                  values=values)

    def trip(self, reason: str, fatal: bool = True, step=None,
             **detail) -> Optional[str]:
        """Record an anomaly and dump a bundle.  Returns the bundle
        path.

        The first trip dumps; repeated trips at the same severity are
        no-ops (a NaN scan fires its sentinel once per remaining
        step — one bundle tells the story).  A FATAL trip after only
        non-fatal ones ESCALATES: it dumps a fresh bundle (the ring
        now holds the records around the actual failure, not the
        earlier stall) and takes over ``reason``/``bundle_path``, so
        :class:`FlightRecorderTripped` always names the trip that
        killed the fit.
        """
        with self._lock:
            first = self.reason is None
            escalating = fatal and not self._fatal
            if fatal:
                self._fatal = True
                if self.fatal_step is None:
                    self.fatal_step = step
            if first or escalating:
                self.reason = reason
                path = self.dump(reason, step=step, **detail)
                if path is not None:
                    self.bundle_path = path
            return self.bundle_path

    def dump(self, reason: str = "manual", step=None,
             **detail) -> Optional[str]:
        """Write a self-contained postmortem bundle; returns its path.

        The bundle is one JSON file: trip metadata, the run record,
        attached context (last checkpoint path, cache keys, ...),
        the identity of the watched programs, and the ring contents.
        Any failure is swallowed into a ``None`` return — the dump
        path must never add a second failure to the one being
        reported.
        """
        try:
            with self._lock:
                if self.dump_dir is None:
                    self.dump_dir = tempfile.mkdtemp(
                        prefix="mgt_postmortem_")
                os.makedirs(self.dump_dir, exist_ok=True)
                self._seq += 1
                seq = self._seq
                ring = list(self._ring)
                context = dict(self._context)
                run_record = self._run_record
                watched = dict(self._watched)
            from ..parallel.distributed import process_index
            process = process_index()
            programs = {label: _program_identity(program, args)
                        for label, (program, args) in watched.items()}
            bundle = {
                "event": "postmortem",
                "t": time.time(),
                "reason": reason,
                "step": step,
                "detail": _jsonable(detail),
                "process_index": process,
                "run": _jsonable(run_record),
                "context": _jsonable(context),
                "programs": programs,
                "ring_records": len(ring),
                "ring": _jsonable(ring),
            }
            path = os.path.join(
                self.dump_dir,
                f"postmortem_p{process}_{seq:03d}_{reason}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(_strict_json(bundle), f, indent=1,
                          allow_nan=False)
            os.replace(tmp, path)
            return path
        except Exception:
            return None

    def reset(self):
        """Re-arm for the next fit (ring and context survive; trip
        state clears)."""
        with self._lock:
            self.reason = None
            self.fatal_step = None
            self.bundle_path = None
            self._fatal = False
            self._last_divergences = None

    def raise_if_fatal(self):
        """Raise :class:`FlightRecorderTripped` if a fatal trip
        occurred (the fit drivers' post-run check)."""
        if self._fatal:
            raise FlightRecorderTripped(self.reason or "fatal",
                                        self.bundle_path,
                                        step=self.fatal_step)
