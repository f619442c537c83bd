"""Metrics logging: pluggable sinks and run-record provenance (port of
:mod:`multigrad_tpu.telemetry.metrics`).

The record stream is a flat sequence of JSON-able dicts, one per
event.  Every record carries ``event`` (its type) and ``t`` (wall
clock, ``time.time()``); everything else is event-specific.  The
stream's first record is always the **run record** — the provenance
header (torch and CUDA versions, backend, device kind, process
topology, config digest) that makes a metrics file interpretable months later on a
different machine.  Event names in the shipped wiring:

========== =========================================================
``run``     provenance header (one per logger)
``adam``    optimizer tap (:mod:`.taps` via ``optim/adam``)
``hmc``     sampler tap (``inference/hmc``)
``comm``    collective-traffic accounting (:mod:`.comm`)
``stream``  :class:`~multigrad_tpu_torch.utils.profiling.StreamStats` summary
``span``    nested wall-clock span (:mod:`.spans`)
``heartbeat``/``stall``  liveness records (:mod:`.spans`)
``fit_summary``  end-of-fit scalars (steps/s, final loss)
``trace_span``  one hop of a distributed request trace (:mod:`.tracing`)
``trace_rtt``  heartbeat-RPC round-trip sample (``serve/fleet``)
========== =========================================================

Sinks are deliberately tiny — ``write(record)`` + ``close()`` — so a
training service can add its own (a socket, a metrics agent) without
touching the callers.  This module imports only the standard library
and ``numpy`` at module level (``torch`` and the process index inside
:func:`run_record`), so every layer (collectives, optimizers, models)
can depend on it without cycles.
"""
from __future__ import annotations

import collections
import csv
import hashlib
import json
import os
import time
from typing import Optional

import numpy as np

from .._lockdep import make_rlock

__all__ = ["run_record", "config_digest", "JsonlSink", "CsvSink",
           "MemorySink", "MetricsLogger"]


def _jsonable(value):
    """Best-effort conversion of a record value to a JSON-able type."""
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    if isinstance(value, (np.integer,)):
        return int(value)
    if isinstance(value, (np.floating,)):
        return float(value)
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if hasattr(value, "tolist"):           # numpy arrays, tensors
        return _jsonable(value.tolist())
    return str(value)


def config_digest(config) -> Optional[str]:
    """Short stable digest of a run configuration (sorted-key JSON →
    sha256 → 12 hex chars).  ``None`` config digests to ``None``."""
    if config is None:
        return None
    blob = json.dumps(_jsonable(config), sort_keys=True,
                      separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def run_record(config=None, **extra) -> dict:
    """The provenance header: what software/hardware produced a stream.

    Captures the torch and CUDA versions, the backend (``"cuda"`` where
    a card is present, else ``"cpu"``), the device kind
    (``torch.cuda.get_device_name()``) and count, the process topology
    of :mod:`multigrad_tpu_torch.parallel.distributed`, and a digest of
    ``config`` (the caller's run configuration — CLI args, bench
    config, fit hyperparameters).  Safe to call before any device
    computation: it launches nothing.
    """
    import torch

    from ..parallel.distributed import process_count, process_index

    if torch.cuda.is_available():
        backend, device_kind = "cuda", torch.cuda.get_device_name()
        n_devices = torch.cuda.device_count()
    else:
        backend, device_kind, n_devices = "cpu", "cpu", 1
    rec = {
        "event": "run",
        "t": time.time(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": backend,
        "device_kind": device_kind,
        "device_count": n_devices,
        "process_index": process_index(),
        "process_count": process_count(),
        "config_digest": config_digest(config),
    }
    if config is not None:
        rec["config"] = _jsonable(config)
    rec.update({k: _jsonable(v) for k, v in extra.items()})
    return rec


class JsonlSink:
    """Append records to a JSON-lines file, one record per line.

    The format every other telemetry consumer reads
    (:mod:`multigrad_tpu_torch.telemetry.report`, the CI artifact): newline-
    delimited, self-describing, cat-able, resilient to truncation (a
    crash loses at most the last partial line).

    Writes are **line-atomic for live tails**: the file is opened
    unbuffered (binary) and each record lands as one ``write`` of a
    complete ``...\\n`` line, so a concurrent reader — the dashboard's
    ``--follow`` tail, a ``tail -f`` — can never observe a buffer
    flush splitting a record in half.  With ``fsync=True`` every
    record is additionally fsynced to disk — the durability knob for
    fits whose telemetry must survive a host power-cut (e.g. evidence
    streams feeding postmortems); leave it off for throughput.
    """

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = bool(fsync)
        # A writer that crashed mid-record leaves no trailing newline;
        # appending straight on would glue the next run's header onto
        # the truncated line, losing BOTH records.  Close the old line
        # first (the reader already skips unparseable lines).
        needs_newline = False
        try:
            with open(path, "rb") as f:
                f.seek(0, 2)
                if f.tell() > 0:
                    f.seek(-1, 2)
                    needs_newline = f.read(1) != b"\n"
        except OSError:
            pass
        self._f = open(path, "ab", buffering=0)
        if needs_newline:
            self._f.write(b"\n")

    def write(self, record: dict):
        line = json.dumps(_jsonable(record),
                          separators=(",", ":")) + "\n"
        self._f.write(line.encode())
        if self.fsync:
            os.fsync(self._f.fileno())

    def close(self):
        self._f.close()


class CsvSink:
    """Append records to a CSV file with a fixed column set.

    CSV cannot grow columns mid-stream, so the header is pinned at
    construction (``fields=``) or to the keys of the first record
    written; later records are projected onto it (missing fields write
    empty, extra fields are dropped).  Meant for single-event streams
    — e.g. a logger dedicated to ``adam`` tap records feeding a
    spreadsheet; use :class:`JsonlSink` for mixed streams.
    """

    def __init__(self, path: str, fields=None):
        self.path = path
        self._fields = list(fields) if fields is not None else None
        self._f = open(path, "a", newline="")
        self._writer = None

    def write(self, record: dict):
        if self._writer is None:
            if self._fields is None:
                self._fields = list(record)
            self._writer = csv.DictWriter(
                self._f, fieldnames=self._fields, extrasaction="ignore")
            if self._f.tell() == 0:
                self._writer.writeheader()
        self._writer.writerow(
            {k: _jsonable(record.get(k, "")) for k in self._fields})
        self._f.flush()

    def close(self):
        self._f.close()


class MemorySink:
    """In-memory ring buffer of the last ``capacity`` records.

    The zero-IO sink for tests and live dashboards: reading
    ``.records`` never blocks the writer for long (one lock-free-ish
    deque append per record, bounded memory by construction).
    """

    def __init__(self, capacity: int = 4096):
        self._buf = collections.deque(maxlen=capacity)

    @property
    def records(self) -> list:
        return list(self._buf)

    def write(self, record: dict):
        self._buf.append(dict(record))

    def close(self):
        pass


class MetricsLogger:
    """Fan a record stream out to one or more sinks.

    Parameters
    ----------
    *sinks
        Any objects with ``write(record)``/``close()``
        (:class:`JsonlSink`, :class:`CsvSink`, :class:`MemorySink`,
        or user-provided).  A convenience: a plain string argument is
        wrapped in a :class:`JsonlSink`.
    run_config : optional
        Configuration captured into the run record (see
        :func:`run_record`), written as the stream's first record.
    run_extra : dict, optional
        Extra provenance fields merged into the run record (e.g. the
        comm's mesh shape).

    Thread-safe: the prefetcher's loader thread and the heartbeat
    thread may log concurrently with the fit loop.
    """

    def __init__(self, *sinks, run_config=None, run_extra=None):
        self._sinks = [JsonlSink(s) if isinstance(s, str) else s
                       for s in sinks]
        # Re-entrant: a sink may emit back into its own stream from
        # inside write() — the AlertEngine logs `alert` records this
        # way — and a plain Lock would deadlock that same-thread
        # recursion.  Sinks are pluggable, so the lock-order edges
        # this opens cannot be derived statically: declared as a
        # fan-out source for the lockdep cross-check.
        self._lock = make_rlock(
            "telemetry.metrics.MetricsLogger._lock",
            may_precede="*")
        self._closed = False
        self.run = run_record(run_config, **(run_extra or {}))
        # Stamped on every record (not just the run header): multi-
        # host jobs write one JSONL per process, and merged streams
        # (telemetry.aggregate) are only attributable if each record
        # names its rank.
        self._process_index = self.run.get("process_index") or 0
        self._write(self.run)

    def add_sink(self, sink):
        """Attach another sink mid-stream (idempotent by identity).

        The hook behind the fit entry points' ``live=``/``alerts=``
        parameters: a monitor can join a logger the caller already
        constructed.  The new sink immediately receives the run
        record, so every sink sees a self-describing stream; a string
        is wrapped in a :class:`JsonlSink` like in the constructor.
        Returns the (possibly wrapped) sink.
        """
        if isinstance(sink, str):
            sink = JsonlSink(sink)
        with self._lock:
            if self._closed or any(s is sink for s in self._sinks):
                return sink
            self._sinks.append(sink)
            # lock-ok: callback-under-lock deliberate: the lock is an RLock exactly so a sink may re-enter log() from inside write(); the replayed run record must be ordered before any record a racing log() would fan out
            sink.write(self.run)
        return sink

    def _write(self, record: dict):
        with self._lock:
            if self._closed:
                return
            for sink in self._sinks:
                # lock-ok: callback-under-lock deliberate: sinks may re-enter (RLock) and the lock is what gives every sink the same total record order; the lock is declared may_precede="*" so lockdep still watches the edges sinks open
                sink.write(record)

    def log(self, event: str, **fields) -> dict:
        """Write one record; returns it (with ``event``/``t``/
        ``process_index`` stamped — explicit fields win)."""
        record = {"event": event, "t": time.time(),
                  "process_index": self._process_index, **fields}
        self._write(record)
        return record

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for sink in self._sinks:
                sink.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
