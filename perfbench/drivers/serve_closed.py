"""Served fits from a closed loop of tenants: ``FitScheduler.submit``.

Each of ``tenants`` tenants submits a fit of ``nsteps`` steps at
``learning_rate`` from a seeded guess and submits its next one when the
result is on the host.  The scheduler runs with ``buckets`` and
``batch_window_s`` and warms up ``warmup_buckets`` only.  Traffic
parameters also: ``guess`` (see :class:`perfbench.programs.common
.Guesses`), ``check_fits`` (fits the reference checks) and
``check_last`` (of them, the window's last fits: a cell sets it to its
bucket, so that the last dispatch is checked whole).

The tenants first submit together, and the scheduler starts.  The window
opens at the start of the first dispatch (its requests' submission plus
their ``queue_wait`` hop) and closes at the end of the first dispatch
that ends ``seconds`` after it: then every request not yet claimed by a
dispatch is cancelled, and the dispatch in flight is the last.
``fits_per_hour`` is the fits completed over the window's length;
``fit_p90_s`` the 90th percentile (nearest rank) of submit to result on
the host over them, a failed fit counting as beyond every limit.  A
traced run profiles from the end of the first dispatch to the end of the
second, and counts the work of the fits served in it: ``nsteps + 1``
loss-and-gradient evaluations a row (the steps and the finalize).
"""
from __future__ import annotations

import collections
import math
import statistics
import sys
import time

import numpy as np

from perfbench.core.record import Fit, Record
from perfbench.programs.common import Guesses

#: What ``fit_p90_s`` reads when more than a tenth of the fits failed.
FAILED_LATENCY_S = 1e9


def p90(values):
    ordered = sorted(values)
    return ordered[math.ceil(0.9 * len(ordered)) - 1]


class Driver:
    def __init__(self, program, traffic: dict, seed: int, device):
        from multigrad_tpu_torch.serve import FitConfig, FitScheduler
        self.traffic = traffic
        self.tenants = int(traffic["tenants"])
        self.bucket = max(traffic["buckets"])
        self.config = FitConfig(nsteps=int(traffic["nsteps"]),
                                learning_rate=float(
                                    traffic["learning_rate"]))
        self.ndim = len(program.truth)
        self.guesses = Guesses(traffic["guess"], program.truth, seed)
        self.sched = FitScheduler(
            program.model, buckets=tuple(traffic["buckets"]),
            batch_window_s=float(traffic["batch_window_s"]), start=False)

    def warmup(self):
        self.sched.warmup(self.config, ndim=self.ndim,
                          buckets=tuple(self.traffic["warmup_buckets"]))

    def _submit(self, pending):
        guess = self.guesses.next()
        t = time.perf_counter()
        pending.append((self.sched.submit(guess, config=self.config),
                        guess, t))

    def run(self, seconds: float, window=None) -> Record:
        from multigrad_tpu_torch.serve.queue import FitCancelled
        rec = Record()
        before = self.sched.stats
        pending = collections.deque()
        for _ in range(self.tenants):
            self._submit(pending)
        if window is not None:
            window.start()
        self.sched.start()
        t_open = deadline = None
        closing = False
        served = 0
        while pending:
            fut, guess, submitted = pending[0]
            now = time.perf_counter()
            if not closing and deadline is not None and now >= deadline \
                    and (window is None or window.closed):
                closing = True
                pending = collections.deque(
                    p for p in pending if not p[0].cancel())
                continue
            try:
                res = fut.result(timeout=600.0 if closing or deadline is None
                                 else max(deadline - now, 0.01))
            except TimeoutError:
                continue
            except FitCancelled:
                pending.popleft()
                continue
            except Exception as e:     # a failed fit: counted, not raised
                pending.popleft()
                rec.fits.append(Fit(guess=guess, traj=None, loss=None,
                                    submitted=submitted,
                                    done=time.perf_counter(),
                                    error=f"{type(e).__name__}: {e}"))
                if t_open is None:    # no hop to read: from its submission
                    t_open = submitted
                    deadline = t_open + seconds
            else:
                pending.popleft()
                rec.fits.append(Fit(
                    guess=guess, traj=np.asarray(res.traj, np.float64),
                    loss=float(res.loss), submitted=submitted,
                    done=time.perf_counter(), hops=dict(res.hops)))
                if t_open is None:
                    t_open = submitted + res.hops["queue_wait"]
                    deadline = t_open + seconds
            served += 1
            if window is not None and not window.opened \
                    and served == self.bucket:
                window.open()
            elif window is not None and window.opened \
                    and not window.closed and served == 2 * self.bucket:
                window.close()
                rec.counters["traced_evaluations"] = \
                    self.bucket * (self.config.nsteps + 1)
            if not closing:
                self._submit(pending)
        after = self.sched.stats
        if t_open is None:
            raise RuntimeError("no fit of the window was served")
        elapsed = rec.fits[-1].done - t_open
        lat = [math.inf if f.failed else f.done - f.submitted
               for f in rec.fits]
        tail = p90(lat)
        rec.end_to_end["fits_per_hour"] = \
            sum(not f.failed for f in rec.fits) / elapsed * 3600.0
        rec.end_to_end["fit_p90_s"] = \
            tail if math.isfinite(tail) else FAILED_LATENCY_S
        print(f"fit_p90_s over {len(lat)} fits", file=sys.stderr)
        rec.counters.update(
            learning_rate=self.config.learning_rate,
            **{k: after.get(k, 0) - before.get(k, 0)
               for k in ("dispatches", "rows_total", "rows_padded")})
        self._report_dispatches(rec, elapsed)
        return rec

    def _report_dispatches(self, rec, elapsed):
        """Where the window's time went, on standard error: the dispatches'
        scan and finalize (medians of their fits' hops) and the time
        outside every dispatch."""
        hops = [f.hops for f in rec.fits if f.hops]
        if not hops:
            return
        inside = sum(h["dispatch"] for h in hops) / self.bucket
        print(f"dispatches: {rec.counters['dispatches']}; adam_segments "
              f"median {statistics.median(h['adam_segments'] for h in hops)!r}"
              f" s, finalize median "
              f"{statistics.median(h['finalize'] for h in hops)!r} s; "
              f"{elapsed - inside!r} s of the window outside them",
              file=sys.stderr)

    def close(self):
        self.sched.close(drain=False, timeout=600.0)
        self.sched = None
