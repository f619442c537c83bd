"""The comparison that decides ``correct``.

The window's fits are the program's answers: each a trajectory from its
guess and the loss at its end, as ``run_adam`` (with the loss read after
it) or the scheduler returned them.  Every fit is held to its own guess:

- ``start_gap``: the largest gap between a trajectory's first point and
  the guess submitted for it, rounded to the parameters' dtype.  Exact:
  a fit that answers another fit's guess (rows of a batch swapped, a pad
  row's trajectory) or ignores its guess reads above 0.

A sample of the fits, drawn from the seed with the window's last
``last`` fits in it (a cell sets ``last`` to its bucket, so that a whole
dispatch, every row of it, is in), is held against the plain reference
of the configuration, computed in float64 on the same catalog (the
reference works its own target out again):

- ``step_gap``: from the fit's guess the reference takes the
  first three Adam steps itself; the largest gap between the program's
  and the reference's parameters after steps 1 to 3, in units of the
  learning rate.  It sees the sumstats, the loss and the gradient
  through the updates they give (Adam's first update is the gradient's
  sign, the next two its ratios to the first), and the update itself.
- ``loss_gap``: the gap between the square roots of the program's loss
  at the fit's last point and the reference's loss there (for these
  losses, the root mean square of the log10 sumstats' gaps to the
  target, in dex).  It sees the forward sumstats and the loss whole.

Steps after the third are held to nothing but the loss at the fit's end.
A fit that failed (an error, or a trajectory or loss that is not finite)
makes the run not correct.  ``failed_fits`` and ``start_gap`` have the
limit 0; every other number has the limit of its cell's
``limits/<cell>.json``.
"""
from __future__ import annotations

import math

import numpy as np

from perfbench.reference.adam import adam_steps

STEPS = 3


def sample(fits, count: int, seed: int, last: int = 1):
    """``count`` of the window's fits: the last ``last`` of them, and the
    rest drawn from the seed among the others."""
    last = min(max(last, 1), len(fits))
    head = len(fits) - last
    rng = np.random.default_rng([int(seed), 3])
    rest = rng.permutation(head)[: max(0, count - last)]
    return [fits[i] for i in sorted(rest)] + list(fits[head:])


def rounded_guess(fit, param_dtype) -> np.ndarray:
    """The fit's guess rounded to ``param_dtype``, in float64."""
    return np.asarray(fit.guess).astype(param_dtype).astype(np.float64)


def start_gap(fit, param_dtype) -> float:
    """The largest gap between the fit's first point and its guess."""
    return float(np.max(np.abs(fit.traj[0] - rounded_guess(fit,
                                                           param_dtype))))


def readings(fit, reference, learning_rate: float, detail=False,
             param_dtype=np.float32) -> dict:
    """The numbers of one fit against ``reference``: ``step_gap`` (the
    largest over the parameters), ``step_gap_median`` (the median over the
    parameters of each one's largest gap) and ``loss_gap``.  With
    ``detail``, also each parameter's gap and the reference's first
    gradient."""
    import torch
    dtype, device = reference.dtype, reference.device
    start = torch.tensor(rounded_guess(fit, param_dtype), dtype=dtype,
                         device=device)
    ref, _, grads = adam_steps(reference.loss_and_grad, start, STEPS,
                               learning_rate)
    ref = ref.to(torch.float64).cpu().numpy()
    per_param = np.max(np.abs(fit.traj[1: STEPS + 1] - ref[1:]), axis=0) \
        / learning_rate
    last = torch.tensor(fit.traj[-1], dtype=dtype, device=device)
    ref_loss = reference.loss(last)
    out = {
        "step_gap": float(np.max(per_param)),
        "step_gap_median": float(np.median(per_param)),
        "loss_gap": abs(math.sqrt(max(fit.loss, 0.0))
                        - math.sqrt(max(ref_loss, 0.0))),
    }
    # A number that is not finite (a NaN in a stand-in's sumstats) is
    # beyond every limit.
    out = {k: v if math.isfinite(v) else math.inf for k, v in out.items()}
    if detail:
        out["per_param"] = per_param.tolist()
        out["first_grad"] = grads[0].to(torch.float64).cpu().tolist()
    return out


def judge(fits, reference, learning_rate: float, limits: dict, count: int,
          seed: int, last: int = 1, param_dtype=np.float32):
    """``(correct, checks)``: ``checks`` maps each number compared to its
    value and its limit, the largest over the fits it reads."""
    good = [f for f in fits if not f.failed]
    checks = {
        "failed_fits": {"value": len(fits) - len(good), "limit": 0},
        "start_gap": {"value": max((start_gap(f, param_dtype)
                                    for f in good), default=0.0),
                      "limit": 0.0},
    }
    worst = {name: 0.0 for name in limits}
    for fit in sample(good, count, seed, last):
        values = readings(fit, reference, learning_rate,
                          param_dtype=param_dtype)
        for name in limits:
            worst[name] = max(worst[name], values[name])
    for name, limit in limits.items():
        checks[name] = {"value": worst[name], "limit": limit}
    correct = bool(good) and all(c["value"] <= c["limit"]
                                 for c in checks.values())
    return correct, checks
