"""L-BFGS with a zoom line search, on float32 tensors with the loop on the
host: the port's counterpart of ``optax.lbfgs(memory_size=10)``, which
the JAX package's ``run_lbfgs_scan`` runs inside one ``lax.scan``.

Written out from optax 0.2.6, whose numbers it follows branch for branch:

* :func:`scale_by_lbfgs` is ``optax.scale_by_lbfgs``
  (``optax/_src/transform.py``): a ring of ``memory_size`` pairs
  ``(Δp, Δg)`` indexed ``count % memory_size``, each weighted ``1/⟨Δg,
  Δp⟩`` (0 where the product is 0, with no skip when it is negative),
  the pairs held at 0 while ``count == 0``, and the initial inverse
  Hessian ``⟨Δg, Δp⟩/‖Δg‖²`` (1 when ``‖Δg‖² = 0``), or ``min(1, 1/‖g‖)``
  at the first step;
* :func:`zoom_linesearch` is ``optax.scale_by_zoom_linesearch``
  (``optax/_src/linesearch.py``) with the defaults ``optax.lbfgs`` gives
  it: at most 20 trials from a step size of 1, the interval search
  (doubling), then the zoom (cubic, quadratic or bisection), the
  sufficient-decrease test with Hager and Zhang's approximate form, and
  the safe step taken when the search fails;
* :func:`lbfgs` chains them as ``optax.lbfgs`` does: the preconditioned
  gradient, its sign flipped, then the line search along it.

The vectors (parameters, gradients, the ring) stay on their device; the
line search decides on the host in float32 (numpy scalars, rounding as
XLA's float32 scalars do), from the value and the slope of each trial,
read in one transfer.  Dot products are an elementwise product and a sum
(no BLAS ``sdot``, which may contract into FMAs on one device and not
another).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

F32 = np.float32

# The zoom search's settings in optax.lbfgs: at most 20 trials, the
# sufficient-decrease (slope) and curvature tolerances, the approximate
# decrease's tolerance on the value, the interval search's growth, the
# interval below which a step with sufficient decrease is taken, and no
# absolute tolerance.
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL, CURV_RTOL, APPROX_DEC_RTOL = F32(1e-4), F32(0.9), F32(1e-6)
APPROX_SLOPE = F32(2 * 1e-4 - 1.0)
INCREASE_FACTOR, STEPSIZE_PRECISION, TOL = F32(2.0), F32(1e-5), F32(0.0)


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``⟨a, b⟩`` as a 0-d float32 tensor on their device."""
    return (a * b).sum()


def _read(*scalars: torch.Tensor):
    """0-d tensors as float32 numpy scalars, in one device-to-host copy."""
    host = torch.stack([s.reshape(()).to(torch.float32)
                        for s in scalars]).cpu().numpy()
    return tuple(F32(x) for x in host)


# --------------------------------------------------------------------- #
# The preconditioner
# --------------------------------------------------------------------- #
class LBFGSState(NamedTuple):
    """``optax.ScaleByLBFGSState``: the step count (a host int), the last
    parameters and gradient, the ring of differences and their weights."""
    count: int
    params: torch.Tensor
    updates: torch.Tensor
    diff_params_memory: torch.Tensor
    diff_updates_memory: torch.Tensor
    weights_memory: torch.Tensor


def _precondition(updates, diff_params, diff_updates, rhos, identity_scale,
                  memory_idx):
    """The two-loop recursion (Nocedal and Wright, Algorithm 7.4), the ring
    read from the oldest pair (``memory_idx``) to the newest."""
    m = rhos.shape[0]
    indices = [(memory_idx + i) % m for i in range(m)]
    vec, alphas = updates, {}
    for idx in reversed(indices):
        alpha = rhos[idx] * _vdot(diff_params[idx], vec)
        vec = vec + (-alpha) * diff_updates[idx]
        alphas[idx] = alpha
    vec = identity_scale * vec
    for idx in indices:
        beta = rhos[idx] * _vdot(diff_updates[idx], vec)
        vec = vec + (alphas[idx] - beta) * diff_params[idx]
    return vec


def scale_by_lbfgs(memory_size: int = 10):
    """``(init_fn, update_fn)`` of ``optax.scale_by_lbfgs`` (with its
    default scaled initial preconditioner):
    ``init_fn(params) -> state`` and ``update_fn(grad, state, params) ->
    (direction, state)``, the direction ``P_k g_k`` (before the sign
    flip); the ring is updated first from the fresh ``params`` and
    ``grad``."""
    if memory_size < 1:
        raise ValueError("memory_size must be >= 1")

    def init_fn(params: torch.Tensor) -> LBFGSState:
        ring = torch.zeros((memory_size,) + tuple(params.shape),
                           dtype=params.dtype, device=params.device)
        return LBFGSState(
            count=0, params=torch.zeros_like(params),
            updates=torch.zeros_like(params), diff_params_memory=ring,
            diff_updates_memory=ring.clone(),
            weights_memory=torch.zeros(memory_size, dtype=torch.float32,
                                       device=params.device))

    def update_fn(updates: torch.Tensor, state: LBFGSState,
                  params: torch.Tensor):
        memory_idx = state.count % memory_size
        prev_memory_idx = (state.count - 1) % memory_size
        if state.count > 0:
            diff_params = params - state.params
            diff_updates = updates - state.updates
            vdot = _vdot(diff_updates, diff_params)
            weight = torch.where(vdot == 0.0, torch.zeros_like(vdot),
                                 1.0 / vdot)
        else:
            diff_params = torch.zeros_like(params)
            diff_updates = torch.zeros_like(updates)
            weight = torch.zeros((), dtype=torch.float32,
                                 device=params.device)
        dp_mem = state.diff_params_memory.clone()
        du_mem = state.diff_updates_memory.clone()
        w_mem = state.weights_memory.clone()
        dp_mem[prev_memory_idx] = diff_params
        du_mem[prev_memory_idx] = diff_updates
        w_mem[prev_memory_idx] = weight
        if state.count > 0:
            numerator = _vdot(diff_updates, diff_params)
            denominator = _vdot(diff_updates, diff_updates)
            identity_scale = torch.where(
                denominator > 0.0, numerator / denominator,
                torch.ones_like(numerator))
        else:
            # A capped reciprocal of the gradient norm (1 when g = 0).
            norm = torch.sqrt(_vdot(updates, updates))
            identity_scale = torch.minimum(torch.ones_like(norm), 1.0 / norm)
        direction = _precondition(updates, dp_mem, du_mem, w_mem,
                                  identity_scale, memory_idx)
        return direction, LBFGSState(
            count=state.count + 1, params=params, updates=updates,
            diff_params_memory=dp_mem, diff_updates_memory=du_mem,
            weights_memory=w_mem)

    return init_fn, update_fn


# --------------------------------------------------------------------- #
# The zoom line search
# --------------------------------------------------------------------- #
class ZoomResult(NamedTuple):
    """The step size the search chose (a float32 numpy scalar) and its
    number of trials, each one evaluation."""
    stepsize: np.float32
    num_linesearch_steps: int


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through ``(a, fa)``, ``(b, fb)``,
    ``(c, fc)`` with slope ``fpa`` at ``a`` (NaN where none)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc * dc * v0 + (-(db * db)) * v1) / denom
    B = ((-(dc * (dc * dc))) * v0 + db * (db * db) * v1) / denom
    radical = B * B - F32(3.0) * A * C
    return a + (-B + np.sqrt(radical)) / (F32(3.0) * A)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through ``(a, fa)`` and ``(b,
    fb)`` with slope ``fpa`` at ``a``."""
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db * db)
    return a - C / (F32(2.0) * B)


def zoom_linesearch(value_and_grad_fn: Callable, params: torch.Tensor,
                    updates: torch.Tensor, value,
                    grad: torch.Tensor) -> ZoomResult:
    """A step size along ``updates`` from ``params`` that meets the
    sufficient-decrease and small-curvature criteria (Nocedal and Wright,
    Algorithms 3.5 and 3.6), as ``optax.scale_by_zoom_linesearch``
    chooses it with ``initial_guess_strategy='one'`` and no largest step.

    ``value_and_grad_fn(p) -> (value, grad)`` is called once a trial, at
    ``params + stepsize * updates``; ``value`` and ``grad`` are those at
    ``params``.
    """
    zero = F32(0.0)
    value_init, slope_init = _read(
        torch.as_tensor(value, device=updates.device), _vdot(updates, grad))

    def trial(stepsize):
        step = params + torch.tensor(stepsize, device=params.device) \
            * updates
        v, g = value_and_grad_fn(step)
        return _read(v, _vdot(g, updates))

    def decrease_error(stepsize, value_step, slope_step):
        err = value_step - value_init - SLOPE_RTOL * stepsize * slope_init
        approx = slope_step - APPROX_SLOPE * slope_init
        delta = value_step - value_init - APPROX_DEC_RTOL * abs(value_init)
        err = np.minimum(np.maximum(approx, delta), err)
        err = np.maximum(err, zero)
        return F32(np.inf) if np.isnan(err) else err

    def curvature_error(slope_step):
        err = np.maximum(abs(slope_step) - CURV_RTOL * abs(slope_init), zero)
        return F32(np.inf) if np.isnan(err) else err

    s = dict(count=0, stepsize=zero, value=value_init, slope=slope_init,
             decrease_error=F32(np.inf), interval_found=False, done=False,
             failed=False, low=zero, value_low=value_init,
             slope_low=slope_init, high=zero, value_high=value_init,
             slope_high=slope_init, cubic_ref=zero,
             value_cubic_ref=value_init, safe_stepsize=zero,
             safe_value=value_init)

    def search_interval():
        count = s["count"]
        new = F32(1.0) if count == 0 else INCREASE_FACTOR * s["stepsize"]
        v, slope = trial(new)
        dec, curv = decrease_error(new, v, slope), curvature_error(slope)
        error = np.maximum(dec, curv)
        if dec <= TOL:
            s.update(safe_stepsize=new, safe_value=v)
        set_high = bool(dec > zero) or bool(v >= s["value"] and count > 0)
        set_low = bool(slope >= zero) and not set_high
        prev = (s["stepsize"], s["value"], s["slope"])
        low, high = ((new, v, slope), prev) if set_low \
            else (prev, (new, v, slope))
        done = bool(error <= TOL)
        s.update(count=count + 1, stepsize=new, value=v, slope=slope,
                 decrease_error=dec, interval_found=set_high or set_low or done, done=done,
                 failed=count + 1 >= MAX_LINESEARCH_STEPS and not done,
                 low=low[0], value_low=low[1], slope_low=low[2],
                 high=high[0], value_high=high[1], slope_high=high[2],
                 cubic_ref=low[0], value_cubic_ref=low[1])

    def zoom_into_interval():
        count = s["count"]
        low, value_low, slope_low = s["low"], s["value_low"], s["slope_low"]
        high, value_high = s["high"], s["value_high"]
        slope_high = s["slope_high"]
        delta = abs(high - low)
        left, right = min(high, low), max(high, low)
        cubic_chk, quad_chk = F32(0.2) * delta, F32(0.1) * delta
        too_small_int = bool(delta <= STEPSIZE_PRECISION)
        cubic = _cubicmin(low, value_low, slope_low, high, value_high,
                          s["cubic_ref"], s["value_cubic_ref"])
        quad = _quadmin(low, value_low, slope_low, high, value_high)
        if left + cubic_chk < cubic < right - cubic_chk:
            middle = cubic
        elif left + quad_chk < quad < right - quad_chk:
            middle = quad
        else:
            middle = (low + high) / F32(2.0)
        v, slope = trial(middle)
        dec, curv = decrease_error(middle, v, slope), curvature_error(slope)
        error = np.maximum(dec, curv)
        if dec <= TOL and v < s["safe_value"]:
            s.update(safe_stepsize=middle, safe_value=v)
        done = bool(error <= TOL)
        set_high_to_middle = bool(dec > zero) or bool(v >= value_low)
        set_high_to_low = bool(slope * (high - low) >= zero) \
            and not set_high_to_middle
        new_high = (middle, v, slope) if set_high_to_middle \
            else (high, value_high, slope_high)
        if set_high_to_low:
            new_high = (low, value_low, slope_low)
        new_low = (low, value_low, slope_low) if set_high_to_middle \
            else (middle, v, slope)
        ref = (high, value_high) if set_high_to_middle or set_high_to_low \
            else (low, value_low)
        failed = (count + 1 >= MAX_LINESEARCH_STEPS
                  or (too_small_int and s["safe_stepsize"] > zero))
        s.update(count=count + 1, stepsize=middle, value=v, slope=slope,
                 decrease_error=dec, done=done, failed=failed and not done,
                 low=new_low[0], value_low=new_low[1],
                 slope_low=new_low[2], high=new_high[0],
                 value_high=new_high[1], slope_high=new_high[2],
                 cubic_ref=ref[0], value_cubic_ref=ref[1])

    # Non-finite trials (outside the domain) are part of the search.
    with np.errstate(all="ignore"):
        while not (s["done"] or s["failed"]):
            if s["interval_found"]:
                zoom_into_interval()
            else:
                search_interval()
            if s["failed"] and (s["safe_stepsize"] > zero
                                or np.isinf(s["decrease_error"])):
                # The safe step: the best sufficient decrease seen, or no
                # step at all where every trial left the domain.
                s.update(stepsize=s["safe_stepsize"])
    return ZoomResult(s["stepsize"], s["count"])


# --------------------------------------------------------------------- #
# The chain
# --------------------------------------------------------------------- #
class LBFGSStep(NamedTuple):
    """One L-BFGS step: the loss at the iterate, the direction the
    preconditioner gave (before the sign flip), and the line search's
    result."""
    loss: np.float32
    direction: torch.Tensor
    search: ZoomResult


def lbfgs(loss_and_grad: Callable, params: torch.Tensor, maxsteps: int,
          memory_size: int = 10, on_step: Callable = None):
    """``maxsteps`` steps of ``optax.lbfgs(memory_size=memory_size)`` from
    ``params`` on ``loss_and_grad(p) -> (loss, grad)``, as the JAX
    package's scan runs them: at each step one evaluation at the iterate,
    then the line search's own, and no early stop.  Returns the final
    parameters and the ``(maxsteps,)`` losses at the iterates, on the
    device of ``params``; ``on_step(LBFGSStep)``, when given, sees every
    step."""
    init_fn, update_fn = scale_by_lbfgs(memory_size)
    state = init_fn(params)
    u, losses = params, []
    for _ in range(maxsteps):
        loss, grad = loss_and_grad(u)
        direction, state = update_fn(grad, state, u)
        descent = -1.0 * direction
        search = zoom_linesearch(loss_and_grad, u, descent, loss, grad)
        u = u + torch.tensor(search.stepsize, device=u.device) * descent
        losses.append(loss.detach().reshape(()).to(torch.float32))
        if on_step is not None:
            on_step(LBFGSStep(_read(loss)[0], direction, search))
    losses = torch.stack(losses) if losses else \
        torch.zeros(0, dtype=torch.float32, device=params.device)
    return u, losses
