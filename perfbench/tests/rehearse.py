"""Rehearsals of the benchmark on the CPU, at small sizes on the port's
plain paths, for the tests of this folder.

``python perfbench/tests/rehearse.py <root> <cell> <seed> <trace> [fault]
[--card SECONDS]`` runs one cell through
:func:`perfbench.core.harness.run` (the whole run but the look for a
card), then prints the result line, and last a line with the top-level
names of the modules loaded that may not be.  A ``fault`` (or ``none``)
breaks the program's timed path underneath first (see :data:`FAULTS`, and
``half`` in the model's rehearsal file).  The CPU sizes and the traffic's
cut are the model's and the driver's files under ``perfbench/rehearsal/``.
With ``--card`` the run is on the CUDA card at the cell's own sizes, with
a window of ``SECONDS``: a fault's reading at the cell's size.
"""
from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

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


#: The faults that break any model; ``half`` is each model's own
#: (``perfbench/rehearsal/<model>.py``).
FAULTS = {"unchanged": _unchanged, "altered": _altered, "swapped": _swapped,
          "moved": _moved}


def rehearsal(bench, cell: str):
    """The rehearsal file of ``cell``'s model, and its driver's cut
    (``perfbench/rehearsal/``)."""
    c = bench.cell(cell)
    model = bench.config(c.config)["model"]
    driver = bench.traffic(c.traffic)["driver"]
    return (bench.module("rehearsal", model),
            bench.module("rehearsal", driver).CUT)


def rehearse(root: str, cell: str, seed: int, trace: bool,
             fault: str | None = None, card_seconds: float | None = None
             ) -> dict:
    from perfbench.core import harness
    from perfbench.core.registry import Benchmark
    harness.cache_dirs(root)
    model, cut = rehearsal(Benchmark(root), cell)
    if fault:
        (model.half if fault == "half" else FAULTS[fault])()
    if card_seconds is not None:
        return harness.run(root, cell, seed, card_seconds, trace,
                           device="cuda")
    return harness.run(root, cell, seed, SECONDS, trace, device="cpu",
                       overrides=model.SIZES, traffic_overrides=cut)


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
