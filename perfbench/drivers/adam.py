"""Fits back to back: ``OnePointModel.run_adam`` from one seeded guess
after another, each ended by the loss at its final parameters and one
read of both to the host.

Traffic parameters: ``nsteps``, ``learning_rate``, ``guess`` (see
:class:`perfbench.programs.common.Guesses`), ``warmup_steps`` (the
warm-up fit's length) and ``check_fits`` (fits the reference checks).

The window opens at the first fit's start and closes at the end of the
first fit that ends after ``seconds``; ``steps_per_s`` is all the steps
of those fits over that time.  A traced run profiles the second fit.
"""
from __future__ import annotations

import time

import numpy as np

from perfbench.core.record import Fit, Record
from perfbench.programs.common import Guesses


class Driver:
    def __init__(self, program, traffic: dict, seed: int, device):
        self.model = program.model
        self.nsteps = int(traffic["nsteps"])
        self.lr = float(traffic["learning_rate"])
        self.warmup_steps = int(traffic["warmup_steps"])
        self.guesses = Guesses(traffic["guess"], program.truth, seed)

    def _fit(self, guess, nsteps):
        import torch
        t0 = time.perf_counter()
        traj = self.model.run_adam(guess=guess, nsteps=nsteps,
                                   learning_rate=self.lr, progress=False)
        loss = self.model.calc_loss_from_params(traj[-1])
        flat = torch.cat([traj.reshape(-1), loss.reshape(1).to(traj.dtype)]
                         ).cpu().numpy().astype(np.float64)
        done = time.perf_counter()
        return Fit(guess=np.asarray(guess, np.float64),
                   traj=flat[:-1].reshape(traj.shape), loss=float(flat[-1]),
                   submitted=t0, done=done)

    def warmup(self):
        self._fit(self.guesses.next(), self.warmup_steps)

    def run(self, seconds: float, window=None) -> Record:
        rec = Record()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            traced = window is not None and len(rec.fits) == 1
            if traced:
                window.open()
            fit = self._fit(self.guesses.next(), self.nsteps)
            if traced:
                window.close()
                rec.counters["traced_evaluations"] = self.nsteps
                rec.counters["traced_forwards"] = 1
            rec.fits.append(fit)
            if fit.done >= deadline and (window is None or window.closed):
                break
        rec.end_to_end["steps_per_s"] = \
            self.nsteps * len(rec.fits) / (rec.fits[-1].done - t0)
        rec.counters["learning_rate"] = self.lr
        return rec

    def close(self):
        self.model = None
