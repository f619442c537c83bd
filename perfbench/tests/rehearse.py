"""Rehearsals of the benchmark on the CPU, at small sizes on the port's
plain paths, for the tests of this folder.

``python perfbench/tests/rehearse.py <root> <cell> <seed> <trace> [fault]
[--card SECONDS]`` runs one cell through
:func:`perfbench.core.harness.run` (the whole run but the look for a
card), then prints the result line, and last a line with the top-level
names of the modules loaded that may not be.  A ``fault`` (or ``none``)
breaks the program's timed path underneath first (see :data:`FAULTS`).
With ``--card`` the run is on the CUDA card at the cell's own sizes, with
a window of ``SECONDS``: a fault's reading at the cell's size.
"""
from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: Sizes small enough for the CPU, by model.
CONFIG = {
    "smf": {"num_halos": 20_000},
    "hist": {"num_halos": 20_000, "chunk_size": 5_000},
}
#: Traffic cut to a few seconds on the CPU, by driver.
TRAFFIC = {
    "adam": {"nsteps": 12, "warmup_steps": 1},
    "serve_closed": {"tenants": 8, "buckets": [1, 4], "warmup_buckets": [4],
                     "nsteps": 10, "batch_window_s": 0.0},
}
SECONDS = 1.0


def _unchanged():
    """Every Adam step returns its state unchanged."""
    from multigrad_tpu_torch.optim import adam

    def update(u, grad, mu, nu, corrections, learning_rate):
        return u, mu, nu, u * 0
    adam.adam_update = update


def _altered():
    """Every Adam step's new parameters are altered where they are made
    (each moved by 1e-3)."""
    from multigrad_tpu_torch.optim import adam
    real = adam.adam_update

    def update(*args):
        u, mu, nu, upd = real(*args)
        return u + 1e-3, mu, nu, upd
    adam.adam_update = update


def _half():
    """The sumstats over the first half of the halos, the mean taken over
    them (over half the volume)."""
    from multigrad_tpu_torch.models import galhalo_hist, smf

    def half_aux(aux, key):
        n = aux[key].shape[0] // 2
        return dict(aux, **{key: aux[key][:n], "volume": aux["volume"] / 2})

    real_smf = smf.SMFModel.calc_partial_sumstats_from_params

    def smf_half(self, params, randkey=None):
        full = self.aux_data
        self.aux_data = half_aux(full, "log_halo_masses")
        try:
            return real_smf(self, params, randkey)
        finally:
            self.aux_data = full

    def hist_half(self, params, randkey=None):
        aux = half_aux(self.aux_data, "log_halo_masses")
        return galhalo_hist._multi_epoch_smf(aux["log_halo_masses"], params,
                                             aux)
    smf.SMFModel.calc_partial_sumstats_from_params = smf_half
    galhalo_hist.GalhaloHistModel.calc_partial_sumstats_from_params = \
        hist_half


def _wrap_loop(wrap):
    """Every fit's host loop (``run_adam``'s and the scheduler's batched
    fit alike) through ``wrap(real, loss_and_grad, guess, *args,
    **kwargs)``."""
    from multigrad_tpu_torch.optim import adam
    real = adam._run_adam_loop

    def loop(loss_and_grad, guess, *args, **kwargs):
        return wrap(real, loss_and_grad, guess, *args, **kwargs)
    adam._run_adam_loop = loop


def _swapped():
    """A batched fit answers its first two rows with each other's
    trajectories (a pack or a slice of the batch gone wrong)."""
    def wrap(real, loss_and_grad, guess, *args, **kwargs):
        traj = real(loss_and_grad, guess, *args, **kwargs)
        if traj.dim() == 3 and traj.shape[1] >= 2:
            order = list(range(traj.shape[1]))
            order[:2] = [1, 0]
            traj = traj[:, order]
        return traj
    _wrap_loop(wrap)


def _moved():
    """Every fit starts 1e-5 away from its guess in each parameter: a
    trajectory sound from its own start, too near the fit's to show in
    its first steps."""
    import torch

    def wrap(real, loss_and_grad, guess, *args, **kwargs):
        return real(loss_and_grad, torch.as_tensor(guess) + 1e-5, *args,
                    **kwargs)
    _wrap_loop(wrap)


FAULTS = {"unchanged": _unchanged, "altered": _altered, "half": _half,
          "swapped": _swapped, "moved": _moved}


def rehearse(root: str, cell: str, seed: int, trace: bool,
             fault: str | None = None, card_seconds: float | None = None
             ) -> dict:
    from perfbench.core import harness
    from perfbench.core.registry import Benchmark
    harness.cache_dirs(root)
    if fault:
        FAULTS[fault]()
    if card_seconds is not None:
        return harness.run(root, cell, seed, card_seconds, trace,
                           device="cuda")
    bench = Benchmark(root)
    c = bench.cell(cell)
    model = bench.config(c.config)["model"]
    driver = bench.traffic(c.traffic)["driver"]
    return harness.run(root, cell, seed, SECONDS, trace, device="cpu",
                       overrides=CONFIG[model],
                       traffic_overrides=TRAFFIC[driver])


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    args = sys.argv[1:]
    card_seconds = None
    if "--card" in args:
        i = args.index("--card")
        card_seconds = float(args[i + 1])
        del args[i: i + 2]
    root, cell, seed, trace = args[:4]
    fault = args[4] if len(args) > 4 and args[4] != "none" else None
    from perfbench.core.harness import _finite, forbidden_modules
    result = rehearse(root, cell, int(seed), trace == "1", fault,
                      card_seconds)
    print(json.dumps(_finite(result)))
    print(json.dumps({"forbidden_modules": forbidden_modules()}))
