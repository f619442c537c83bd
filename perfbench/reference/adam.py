"""Plain Adam, as optax's ``adam`` and the port's fits define it: ``b1 =
0.9``, ``b2 = 0.999``, ``eps = 1e-8`` outside the square root,
bias-corrected moments.  Imports nothing of the program."""
from __future__ import annotations

B1, B2, EPS = 0.9, 0.999, 1e-8


def adam_steps(loss_and_grad, guess, nsteps: int, learning_rate: float):
    """The first ``nsteps`` Adam steps from ``guess`` (a 1-D tensor, in the
    dtype the reference computes in): the ``(nsteps + 1, ndim)``
    trajectory, the guess first, and the loss and the gradient at each
    point before a step."""
    import torch
    u = guess.clone()
    mu = torch.zeros_like(u)
    nu = torch.zeros_like(u)
    traj, losses, grads = [u.clone()], [], []
    for t in range(1, nsteps + 1):
        loss, grad = loss_and_grad(u)
        losses.append(float(loss))
        grads.append(grad)
        mu = (1 - B1) * grad + B1 * mu
        nu = (1 - B2) * grad * grad + B2 * nu
        mu_hat = mu / (1 - B1 ** t)
        nu_hat = nu / (1 - B2 ** t)
        u = u - learning_rate * (mu_hat / (torch.sqrt(nu_hat) + EPS))
        traj.append(u.clone())
    return torch.stack(traj), losses, grads
