"""Profiling and timing helpers (port of
:mod:`multigrad_tpu.utils.profiling`).

The reference's only instrumentation is wall-clock timing with a
warm-up run (SURVEY §5.1).  This module keeps that warm-up-then-time
shape (:class:`Timer`, each call ended by a synchronize of the card),
adds ``torch.profiler`` capture (:func:`trace`: a Chrome trace that
Perfetto and TensorBoard read), the steps/s meter of the host loops
(:class:`StepsPerSecond`) and the streaming pipeline's counters
(:class:`StreamStats`).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from .._lockdep import make_lock

__all__ = ["Timer", "trace", "StreamStats", "StepsPerSecond"]


def _fence(result):
    """Wait for the card when ``result`` holds a CUDA tensor: PyTorch
    returns before the device finishes, so a host clock without this
    measures the enqueue."""
    import torch

    from .util import tree_leaves

    for leaf in tree_leaves(result):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            return


class Timer:
    """Warm-up-then-time harness (the reference benchmark's shape).

    Each timed call is individually fenced (a synchronize of the card
    when the result holds CUDA tensors) so per-call latencies are real
    measurements, not enqueue times — which makes the tail visible: the
    returned dict carries ``p50`` and ``p95`` per-call seconds alongside
    the aggregate ``calls_per_sec``.  A p95 far above p50 is the
    signature of host interference that a bare mean averages away.
    """

    def __init__(self, fn: Callable, warmup: int = 1):
        self.fn = fn
        self.warmup = warmup

    def __call__(self, n_calls: int, *args, **kwargs):
        import numpy as np

        for _ in range(self.warmup):
            _fence(self.fn(*args, **kwargs))
        latencies = []
        t0 = time.perf_counter()
        for _ in range(n_calls):
            t1 = time.perf_counter()
            _fence(self.fn(*args, **kwargs))
            latencies.append(time.perf_counter() - t1)
        elapsed = time.perf_counter() - t0
        return dict(calls_per_sec=n_calls / elapsed, elapsed=elapsed,
                    n_calls=n_calls,
                    p50=float(np.percentile(latencies, 50)),
                    p95=float(np.percentile(latencies, 95)),
                    latencies=latencies)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, perfetto: bool = False):
    """Capture a ``torch.profiler`` trace around a block (the CPU's ops,
    and the card's kernels and copies where there is a card); yields the
    trace directory.

    At exit the trace is written into it as a Chrome trace,
    ``<host>.<pid>.pt.trace.json`` (gzipped, ``.pt.trace.json.gz``, with
    ``perfetto=True``), which Perfetto, ``chrome://tracing`` and
    TensorBoard's profiler plugin read, and which
    :func:`multigrad_tpu_torch.telemetry.profile.summarize_device_trace`
    aggregates.

    ``log_dir=None`` (the default) captures into a fresh private
    ``mkdtemp`` child, so two captures never clobber each other — read
    the actual directory off the yielded value.
    """
    import gzip
    import shutil
    import socket
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = tempfile.mkdtemp(prefix="multigrad_tpu_torch_trace_")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    path = os.path.join(
        log_dir, f"{socket.gethostname()}.{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    if perfetto:
        with open(path, "rb") as src, gzip.open(path + ".gz", "wb") as dst:
            shutil.copyfileobj(src, dst)
        os.remove(path)


@dataclass
class StreamStats:
    """Counters for the streaming-data pipeline (:mod:`..data`).

    Updated concurrently by the prefetcher's loader thread and the
    consuming fit loop, so every increment goes through one lock.
    ``stall_s`` is host time the *consumer* spent blocked waiting for a
    chunk after the pipeline was primed: near 0 when the load and the
    host→device copy of chunk k+1 overlap the compute on chunk k.  The
    first chunk's wait is ``fill_s``.  ``max_live_buffers`` is the
    high-water mark of device chunk buffers the prefetcher held (at most
    its ``max_buffers``, 2 for double buffering).
    """

    bytes_streamed: int = 0
    chunks: int = 0
    stall_s: float = 0.0
    fill_s: float = 0.0
    wall_s: float = 0.0
    max_live_buffers: int = 0
    #: Per-pass counter splits, keyed by the pass label the streamed
    #: model supplies ("sumstats" / "vjp" / "jac"): the streamed
    #: loss-and-grad re-streams the catalog for its backward pass, and
    #: these say which pass starved.
    passes: dict = field(default_factory=dict, compare=False)

    _PASS_KEYS = ("bytes_streamed", "chunks", "stall_s", "fill_s",
                  "wall_s")
    _lock: threading.Lock = field(
        default_factory=lambda: make_lock(
            "utils.profiling.StreamStats._lock"),
        repr=False, compare=False)

    def add(self, pass_name: Optional[str] = None, **deltas):
        with self._lock:
            for name, delta in deltas.items():
                setattr(self, name, getattr(self, name) + delta)
            if pass_name is not None:
                per = self.passes.setdefault(
                    pass_name, {k: 0.0 for k in self._PASS_KEYS})
                for name, delta in deltas.items():
                    if name in per:
                        per[name] += delta

    def saw_live_buffers(self, n: int):
        with self._lock:
            self.max_live_buffers = max(self.max_live_buffers, n)

    @property
    def chunks_per_sec(self) -> float:
        return self.chunks / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def stall_fraction(self) -> float:
        """Fraction of streamed wall time the consumer spent starved."""
        return self.stall_s / self.wall_s if self.wall_s > 0 else 0.0

    @staticmethod
    def _overlap(stall_s: float, fill_s: float, wall_s: float) -> float:
        """Overlap in the post-fill window: 1 when the consumer never
        waited for a chunk after the pipeline primed, 0 when every chunk
        was waited for in line (serial)."""
        busy = wall_s - fill_s
        if busy <= 0.0:
            return 1.0
        return max(0.0, min(1.0, 1.0 - stall_s / busy))

    @property
    def overlap_fraction(self) -> float:
        return self._overlap(self.stall_s, self.fill_s, self.wall_s)

    def pass_summary(self) -> dict:
        """Per-pass counters with derived stall/overlap fractions."""
        with self._lock:
            snap = {name: dict(per) for name, per in self.passes.items()}
        out = {}
        for name, per in snap.items():
            wall = per["wall_s"]
            out[name] = dict(
                bytes_streamed=int(per["bytes_streamed"]),
                chunks=int(per["chunks"]),
                stall_s=round(per["stall_s"], 4),
                fill_s=round(per["fill_s"], 4),
                wall_s=round(wall, 4),
                stall_fraction=round(
                    per["stall_s"] / wall if wall > 0 else 0.0, 4),
                overlap_frac=round(self._overlap(
                    per["stall_s"], per["fill_s"], wall), 4))
        return out

    def summary(self) -> dict:
        return dict(bytes_streamed=int(self.bytes_streamed),
                    chunks=int(self.chunks),
                    chunks_per_sec=round(self.chunks_per_sec, 3),
                    stall_fraction=round(self.stall_fraction, 4),
                    overlap_frac=round(self.overlap_fraction, 4),
                    fill_s=round(self.fill_s, 4),
                    max_live_buffers=int(self.max_live_buffers),
                    passes=self.pass_summary())


class StepsPerSecond:
    """Streaming steps/sec meter for host-side optimizer loops.

    The clock starts at the first :meth:`tick`, so call :meth:`reset`
    right after the first step completes — otherwise ``rate`` averages
    the one-time warm-up cost into steady state and under-reports
    throughput for short fits (``optim/adam.run_adam_streamed`` does
    exactly this).  The port's host loops run ahead of the card, so read
    ``rate`` after a wait for the card (the streamed fit reads it after
    its final loss reaches the host).
    """

    def __init__(self):
        self.t0: Optional[float] = None
        self.steps = 0

    def tick(self, n: int = 1):
        if self.t0 is None:
            self.t0 = time.perf_counter()
        self.steps += n

    def reset(self):
        """Zero the step count and restart the clock NOW.

        Call at the end of a warm-up step: every subsequently ticked
        step is then measured over its full duration (a tick marks a
        step's END, so a clock started *at* the first tick would miss
        that step's duration and overstate the rate by
        ``steps/(steps-1)`` — degenerately so for short fits).
        """
        self.t0 = time.perf_counter()
        self.steps = 0

    @property
    def rate(self) -> float:
        if self.t0 is None or self.steps == 0:
            return 0.0
        return self.steps / (time.perf_counter() - self.t0)
