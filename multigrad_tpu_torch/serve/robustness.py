"""Per-request fault isolation for bucketed fit dispatches (a copy of
:mod:`multigrad_tpu.serve.robustness`).

A bucket dispatch runs K tenants' fits as one batched Adam scan.
Adam's update is elementwise along the batch axis, so a NaN/Inf in
one tenant's fit is *structurally contained* to its own row — the
batch-mates' trajectories are bitwise identical to what they would
have been in a clean batch (``tests/test_serve.py`` asserts exactly
that).  What remains for the serving layer is the per-request
bookkeeping this module provides:

* :func:`nonfinite_rows` — classify the finished batch: which rows
  came back poisoned (non-finite final parameters or loss)?
* :func:`request_postmortem` — dump a flight-recorder bundle for the
  failing request alone (the recorder's ring carries the serve
  telemetry records around the dispatch, the bundle detail carries
  the tenant's request id, guess, bucket and row), without tripping
  the recorder's fatal latch — batch-mates and later dispatches must
  keep flowing.
* :func:`split_expired` — deadline enforcement at dispatch time: a
  request whose deadline passed while it sat in the queue is resolved
  with :class:`~multigrad_tpu_torch.serve.queue.FitDeadlineExceeded`
  instead of wasting a bucket row.

The retry policy (a poisoned request is re-enqueued ONCE at the head
of the queue, so its second attempt runs in a fresh bucket) and the
graceful drain live in :class:`~multigrad_tpu_torch.serve.scheduler
.FitScheduler`, which composes these helpers.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np

from .queue import FitDeadlineExceeded, FitRequest

__all__ = ["nonfinite_rows", "request_postmortem", "split_expired"]


def nonfinite_rows(finals, losses) -> np.ndarray:
    """Boolean mask over batch rows: True = poisoned.

    A row is poisoned when its final parameters or its final loss are
    non-finite.  (An *infinite* loss with finite parameters is
    poisoned too: the tenant's objective is broken at the returned
    point, and handing it back as a "result" would just defer the
    failure to the caller.)
    """
    finals = np.asarray(finals)
    losses = np.asarray(losses)
    bad_params = ~np.all(np.isfinite(finals), axis=-1)
    return bad_params | ~np.isfinite(losses)


def request_postmortem(recorder, request: FitRequest, row: int,
                       bucket: int, final_params, final_loss,
                       resources=None) -> Optional[str]:
    """Dump a per-request postmortem bundle; returns its path.

    Uses :meth:`~multigrad_tpu_torch.telemetry.flight.FlightRecorder.dump`
    directly — NOT :meth:`trip` — because a poisoned tenant must not
    latch the shared recorder into a fatal state that would poison
    every later dispatch.  ``None`` when the recorder is absent or
    the dump itself failed (the recorder swallows its own errors by
    contract: a postmortem must never add a second failure).
    """
    if recorder is None:
        return None
    params = np.asarray(final_params, dtype=float)
    trace = getattr(request, "trace", None)
    return recorder.dump(
        "non_finite_request",
        request_id=request.id,
        # Postmortems are navigable from either end: the bundle
        # names the trace, the trace's root span names the bundle.
        trace_id=(trace.trace_id if trace is not None else None),
        row=int(row),
        bucket=int(bucket),
        retried=bool(request.retried),
        guess=[float(g) for g in np.asarray(request.guess).ravel()],
        final_params=[float(p) for p in params.ravel()],
        final_loss=float(final_loss),
        nsteps=request.config.nsteps,
        learning_rate=request.config.learning_rate,
        # The consumed-resources context (the monitor's sample ring)
        # — was the device near its memory limit, was the process
        # busy-saturated — rides along when the caller monitors.
        resources=resources,
    )


def split_expired(requests, now: Optional[float] = None
                  ) -> Tuple[list, list]:
    """Partition a dispatch group into (live, expired) by deadline."""
    now = time.time() if now is None else now
    live, expired = [], []
    for r in requests:
        (expired if r.expired(now) else live).append(r)
    for r in expired:
        r.future._set_exception(FitDeadlineExceeded(
            f"request {r.id} deadline passed "
            f"{now - r.deadline:.3f} s before dispatch"))
    return live, expired
