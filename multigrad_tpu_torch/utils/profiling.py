"""Counters of the streaming-data pipeline (port of
:mod:`multigrad_tpu.utils.profiling`: ``StreamStats`` only).

``Timer``, ``trace`` and ``StepsPerSecond`` belong to the telemetry
layer, which is not ported yet.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional

__all__ = ["StreamStats"]


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
    _lock: threading.Lock = field(default_factory=threading.Lock,
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
