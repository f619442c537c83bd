"""The port's L-BFGS (``optim/_lbfgs.py``, ``optim/bfgs.py::run_lbfgs_scan``)
against optax's and the JAX package's on the CPU.

The machinery.  ``scale_by_lbfgs`` and the zoom line search run step by
step beside ``optax.scale_by_lbfgs`` and ``optax.scale_by_zoom_linesearch(
20, initial_guess_strategy='one')`` on the same objective: one numpy
function, called by both sides (through ``jax.pure_callback`` on the JAX
side), so every value and gradient is the same float32 on both.  Each
step's trial count is equal, and its step size and preconditioned
direction agree within the rtol stated by the case, until both reach the
float32 floor, where the line search decides on rounding (the branches
may part only once the loss is within ``FLOOR_RTOL`` of its range from
the end).  Why not bit for bit: XLA contracts ``x + a·y`` into FMAs on the
CPU (on 2,000 random 2-vectors, 839 of ``x + a*y`` and 506 of the
2-element ``vdot`` differ from torch's separate multiply and add), and
the Rosenbrock valley amplifies those ulps over 15 steps.

The whole fit.  ``run_lbfgs_scan`` against the JAX package's on the cases
of ``tests/test_optim.py:302-385`` (the port's SMF model on the JAX
model's numpy halos: its loss differs from the JAX package's by up to 7e-4
relative, ``tests/test_torch_smf.py``, so its trajectory is held at the
finals, at the JAX tests' own tolerances, and the line search is held on
the port's SMF objective above) and on the linear-Gaussian model, whose
loss agrees to rtol 1e-6, so its trajectory is held step for step.
"""
import numpy as np
import pytest
import torch

from multigrad_tpu_torch import run_bfgs, run_lbfgs_scan
from multigrad_tpu_torch.models import SMFModel, aux_from_numpy
from multigrad_tpu_torch.optim import _lbfgs
from multigrad_tpu_torch.optim.bfgs import _lbfgs_fit
from test_torch_fisher import GaussianLinearModel, _jax_gaussian_linear

CPU = "cpu"
TRUTH = np.array([-2.0, 0.2])
SMF_HALOS = 10_000
#: A step may take other line-search branches than optax's only once the
#: loss is within this fraction of its range (start to end) from its end.
FLOOR_RTOL = 1e-6


def _quadratic():
    rng = np.random.default_rng(0)
    m = rng.normal(size=(4, 4)).astype(np.float32)
    a = (m @ m.T + np.eye(4, dtype=np.float32)).astype(np.float32)
    b = rng.normal(size=4).astype(np.float32)

    def fn(p):
        ap = (a @ p).astype(np.float32)
        return (np.float32(0.5) * np.float32(p @ ap) - np.float32(b @ p),
                (ap - b).astype(np.float32))
    return fn, np.zeros(4, np.float32)


def _rosenbrock():
    def fn(p):
        x, y = p[:-1], p[1:]
        t = (y - x * x).astype(np.float32)
        loss = np.sum(np.float32(100) * t * t + (1 - x) * (1 - x),
                      dtype=np.float32)
        g = np.zeros_like(p)
        g[:-1] += -400 * x * t - 2 * (1 - x)
        g[1:] += 200 * t
        return np.float32(loss), g.astype(np.float32)
    return fn, np.array([-1.2, 1.0, -0.5], np.float32)


def _smf():
    from multigrad_tpu_torch.models import make_smf_data
    model = SMFModel(aux_data=make_smf_data(SMF_HALOS, device=CPU))

    def fn(p):
        loss, grad = model.calc_loss_and_grad_from_params(torch.tensor(p))
        return np.float32(loss), grad.numpy().astype(np.float32)
    return fn, np.array([-1.5, 0.4], np.float32)


def _optax_steps(fn, p0, nsteps):
    """``(loss, step size, trials, direction)`` of each step of optax's
    L-BFGS chain on ``fn``, values and gradients from ``fn`` itself."""
    import jax
    import jax.numpy as jnp
    import optax

    @jax.custom_vjp
    def value(p):
        return jax.pure_callback(lambda q: fn(np.asarray(q))[0],
                                 jax.ShapeDtypeStruct((), jnp.float32), p)

    def fwd(p):
        return jax.pure_callback(
            lambda q: fn(np.asarray(q)),
            (jax.ShapeDtypeStruct((), jnp.float32),
             jax.ShapeDtypeStruct(p.shape, jnp.float32)), p)

    value.defvjp(fwd, lambda g, ct: (ct * g,))
    pre = optax.scale_by_lbfgs(memory_size=10)
    search = optax.scale_by_zoom_linesearch(
        max_linesearch_steps=20, initial_guess_strategy="one")
    p = jnp.asarray(p0)
    s_pre, s_search = pre.init(p), search.init(p)
    steps = []
    for _ in range(nsteps):
        loss, grad = (jnp.asarray(x) for x in fn(np.asarray(p)))
        direction, s_pre = pre.update(grad, s_pre, p)
        updates, s_search = search.update(
            optax.tree.scale(-1.0, direction), s_search, p, value=loss,
            grad=grad, value_fn=value)
        p = optax.apply_updates(p, updates)
        steps.append((float(loss), float(s_search.learning_rate),
                      int(s_search.info.num_linesearch_steps),
                      np.asarray(direction)))
    return steps


def _port_steps(fn, p0, nsteps):
    steps = []

    def loss_and_grad(p):
        loss, grad = fn(p.numpy())
        return torch.tensor(loss), torch.tensor(grad)

    _lbfgs.lbfgs(loss_and_grad, torch.tensor(p0), nsteps,
                 on_step=lambda s: steps.append((
                     float(s.loss), float(s.search.stepsize),
                     s.search.num_linesearch_steps, s.direction.numpy())))
    return steps


# case: (objective, steps, rtol of the step size, tolerance of the
# direction relative to the largest direction component of the run,
# fewest steps on the same branches).  Measured: the quadratic 1.5e-6 /
# 7.8e-8 over its 8 steps before the floor, the SMF objective 0 / 6.1e-6
# over 11, the Rosenbrock 2.1e-3 / 1.5e-4 over all 15 (its valley
# amplifies one-ulp differences step after step).
CASES = {"quadratic": (_quadratic, 15, 1e-5, 1e-6, 8),
         "rosenbrock": (_rosenbrock, 15, 1e-2, 1e-3, 15),
         "smf": (_smf, 15, 1e-5, 5e-5, 11)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lbfgs_and_zoom_search_match_optax(case):
    make, nsteps, step_rtol, dir_tol, fewest = CASES[case]
    fn, p0 = make()
    want, got = _optax_steps(fn, p0, nsteps), _port_steps(fn, p0, nsteps)
    losses = np.array([s[0] for s in want])
    span = abs(losses[0] - losses[-1])
    scale = max(np.max(np.abs(s[3])) for s in want)
    same = 0
    for k, (w, g) in enumerate(zip(want, got)):
        if w[2] != g[2]:
            # Other branches: only at the float32 floor.
            assert abs(w[0] - losses[-1]) <= FLOOR_RTOL * span, (k, w, g)
            break
        assert abs(g[1] - w[1]) <= step_rtol * abs(w[1]), (k, w[1], g[1])
        assert np.max(np.abs(g[3] - w[3])) <= dir_tol * scale, (k, w, g)
        same += 1
    assert same >= fewest, same


def test_scale_by_lbfgs_first_step_and_zero_gradient():
    init_fn, update_fn = _lbfgs.scale_by_lbfgs(memory_size=3)
    p = torch.tensor([1.0, 2.0])
    state = init_fn(p)
    # count 0: the gradient scaled by min(1, 1/|g|).
    d, state = update_fn(torch.tensor([3.0, 4.0]), state, p)
    assert torch.equal(d, torch.tensor([3.0, 4.0]) * 0.2)
    # A zero gradient: 1/|g| = inf, so the scale is 1 and d = 0.
    d0, _ = update_fn(torch.zeros(2), init_fn(p), p)
    assert torch.equal(d0, torch.zeros(2))
    # Δp = 0: <Δg, Δp> = 0 gives weight 0, not inf.
    _, state = update_fn(torch.tensor([1.0, 1.0]), state, p)
    assert state.weights_memory.tolist() == [0.0, 0.0, 0.0]
    assert state.count == 2


# --------------------------------------------------------------------- #
# run_lbfgs_scan against the JAX package's
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def smf_models():
    from multigrad_tpu.models import SMFModel as JaxSMFModel
    from multigrad_tpu.models import make_smf_data as jax_make_smf_data
    jax_model = JaxSMFModel(aux_data=jax_make_smf_data(SMF_HALOS))
    arrays = {k: np.asarray(v) if hasattr(v, "shape") else v
              for k, v in jax_model.aux_data.items()}
    return SMFModel(aux_data=aux_from_numpy(arrays, device=CPU)), jax_model


def _jax_scan(fn, params, **kw):
    import jax.numpy as jnp
    import multigrad_tpu as mgt
    p, losses = mgt.run_lbfgs_scan(fn, jnp.asarray(params, jnp.float32),
                                   **kw)
    return np.asarray(p), np.asarray(losses)


def test_lbfgs_scan_smf(smf_models):
    port, jax_model = smf_models
    p, losses = run_lbfgs_scan(port.calc_loss_and_grad_from_params,
                               torch.tensor([-1.5, 0.4]), maxsteps=40)
    want, want_losses = _jax_scan(jax_model.calc_loss_and_grad_from_params,
                                  [-1.5, 0.4], maxsteps=40)
    assert tuple(losses.shape) == (40,) and p.device.type == CPU
    # The JAX test's limit against the truth (atol 5e-3); against the JAX
    # fit's finals 1e-4 (measured 1.1e-5).
    np.testing.assert_allclose(p.numpy(), TRUTH, atol=5e-3)
    np.testing.assert_allclose(p.numpy(), want, atol=1e-4)
    # The first loss is the same start's (rtol 1e-6, the models' own).
    assert abs(float(losses[0]) - want_losses[0]) <= 1e-6 * want_losses[0]


def _scalar_fn(shapes=None):
    def fn(p):
        if shapes is not None:
            shapes.append(tuple(p.shape))
        return (p - 1.0) ** 2, 2.0 * (p - 1.0)
    return fn


def test_lbfgs_scan_scalar_params():
    p, losses = run_lbfgs_scan(_scalar_fn(), 0.3, maxsteps=20, device=CPU)
    want, want_losses = _jax_scan(_scalar_fn(), 0.3, maxsteps=20)
    assert p.shape == () and abs(float(p) - 1.0) < 1e-5
    # Step for step while above the floor (measured: equal bit for bit).
    above = want_losses > 1e-12
    np.testing.assert_allclose(losses.numpy()[above], want_losses[above],
                               rtol=1e-6)
    assert abs(float(p) - float(want)) <= 1e-6


@pytest.mark.parametrize("box,maxsteps", [((0.0, 2.0), 100),
                                          ((0.0, 0.5), 25)],
                         ids=["inside", "pinned"])
def test_lbfgs_scan_scalar_params_with_bounds(box, maxsteps):
    shapes = []
    p, losses = run_lbfgs_scan(_scalar_fn(shapes), 0.3, maxsteps=maxsteps,
                               param_bounds=[box], device=CPU)
    want, _ = _jax_scan(_scalar_fn(), 0.3, maxsteps=maxsteps,
                        param_bounds=[box])
    assert p.shape == () and all(s == () for s in shapes)
    assert torch.isfinite(losses).all()
    if box[1] > 1.0:
        assert abs(float(p) - 1.0) < 1e-4          # the JAX test's limit
    else:
        assert 0.4 < float(p) <= 0.5               # pinned at the edge
    # Finals, not step counts (the JAX test: convergence through the
    # float32 bijection varies by XLA version): within 1e-4.
    assert abs(float(p) - float(want)) <= 1e-4


def test_lbfgs_scan_bounded_matches_run_bfgs(smf_models):
    port, jax_model = smf_models
    bounds = [(-3.0, -1.0), (0.05, 1.0)]
    scipy_result = run_bfgs(port.calc_loss_and_grad_from_params,
                            torch.tensor([-1.5, 0.4]), maxsteps=100,
                            param_bounds=bounds, progress=False)
    p, losses = run_lbfgs_scan(port.calc_loss_and_grad_from_params,
                               torch.tensor([-1.5, 0.4]), maxsteps=60,
                               param_bounds=bounds)
    want, _ = _jax_scan(jax_model.calc_loss_and_grad_from_params,
                        [-1.5, 0.4], maxsteps=60, param_bounds=bounds)
    np.testing.assert_allclose(p.numpy(), scipy_result.x, atol=2e-3)
    np.testing.assert_allclose(p.numpy(), want, atol=1e-4)
    assert torch.isfinite(losses).all() and float(losses[-1]) < 1e-7


def test_lbfgs_scan_bounded_pins_active_bound(smf_models):
    port, jax_model = smf_models
    bounds = [(-3.0, -1.0), (0.3, 1.0)]   # truth sigma=0.2 is outside
    p, losses = run_lbfgs_scan(port.calc_loss_and_grad_from_params,
                               torch.tensor([-1.5, 0.5]), maxsteps=60,
                               param_bounds=bounds)
    _, want_losses = _jax_scan(jax_model.calc_loss_and_grad_from_params,
                               [-1.5, 0.5], maxsteps=60, param_bounds=bounds)
    p = p.numpy()
    # The JAX test's checks.
    assert np.all(np.isfinite(p)) and np.isfinite(float(losses[-1]))
    assert -3.0 < p[0] < -1.0
    assert 0.3 <= p[1] < 0.32
    # Riding the bound, the losses follow the JAX fit's for the first 25
    # steps within 1e-3 relative (the models' loss gap; measured 3e-4);
    # past that both walk the float32 floor of an ill-conditioned corner.
    np.testing.assert_allclose(losses.numpy()[:25], want_losses[:25],
                               rtol=1e-3)
    with pytest.raises(ValueError, match="strictly inside"):
        run_lbfgs_scan(port.calc_loss_and_grad_from_params,
                       torch.tensor([-1.0, 0.3]), maxsteps=5,
                       param_bounds=bounds)


# --------------------------------------------------------------------- #
# The linear-Gaussian model
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def gaussian():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    u = rng.normal(size=(64, 3)).astype(np.float32)
    jac = x.T @ u
    prec = np.diag(rng.uniform(0.5, 2.0, 4)).astype(np.float32)
    target = (jac @ np.array([0.5, -0.3, 0.8], np.float32)).astype(
        np.float32)
    mle = np.linalg.solve(jac.T @ prec @ jac, jac.T @ prec @ target)
    aux = dict(x=x, u=u, target=target, prec=prec)
    return (GaussianLinearModel(aux_data=aux_from_numpy(aux, device=CPU)),
            _jax_gaussian_linear(aux), mle.astype(np.float32))


@pytest.mark.parametrize("bounds", [None, [(-2.0, 2.0)] * 3],
                         ids=["unbounded", "bounded"])
def test_lbfgs_scan_gaussian_linear(gaussian, bounds):
    port, jax_model, mle = gaussian
    start = [0.1, 0.2, -0.4]
    p, losses = run_lbfgs_scan(port.calc_loss_and_grad_from_params,
                               torch.tensor(start), maxsteps=30,
                               param_bounds=bounds)
    want, want_losses = _jax_scan(jax_model.calc_loss_and_grad_from_params,
                                  start, maxsteps=30, param_bounds=bounds)
    np.testing.assert_allclose(p.numpy(), mle, atol=1e-3)
    np.testing.assert_allclose(p.numpy(), want, atol=1e-4)
    # Step for step while the loss is above 1e-4 of its start (11 steps):
    # rtol 2e-3 (measured 1.1e-4 unbounded, 6.7e-4 bounded: the models'
    # 1e-6 and the bijection's tan and atan, amplified as the loss falls).
    above = want_losses > 1e-4 * want_losses[0]
    assert above.sum() >= 11
    np.testing.assert_allclose(losses.numpy()[above], want_losses[above],
                               rtol=2e-3)


def test_lbfgs_scan_randkey_held_constant():
    keys = []

    def fn(p, randkey=None):
        keys.append(randkey)
        return ((p - 1.0) ** 2).sum(), 2.0 * (p - 1.0)

    run_lbfgs_scan(fn, torch.tensor([0.3, 0.1]), maxsteps=3, randkey=7)
    assert keys and set(keys) == {7}


def test_lbfgs_on_step_counts_evaluations():
    calls, trials = [], []

    def fn(p):
        calls.append(1)
        return ((p - 1.0) ** 2).sum(), 2.0 * (p - 1.0)

    _lbfgs_fit(fn, torch.tensor([0.3, 0.1]), maxsteps=6,
               on_step=lambda s: trials.append(
                   s.search.num_linesearch_steps))
    # One evaluation at each iterate, then the line search's own.
    assert len(calls) == 6 + sum(trials)
