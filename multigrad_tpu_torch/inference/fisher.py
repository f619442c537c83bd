"""Distributed Fisher information and Laplace uncertainty (port of
:mod:`multigrad_tpu.inference.fisher`).

The sumstats Jacobian sums over shards exactly like the sumstats
(``J = Σ_r ∂y_r/∂p``, one all-reduce of |y|·|p| floats), and every
second-order object a one-point analysis needs factors through it.  For
a loss ``L(y(p))`` the Gauss–Newton Hessian is

    F  =  Jᵀ H_y J,        H_y = ∂²L/∂y²   (|y|×|y|, on every process,
                                            with no pass over the data)

which for the Gaussian likelihood ``L = ½ (y-t)ᵀ Σ⁻¹ (y-t)`` is the exact
Fisher information ``Jᵀ Σ⁻¹ J``.  The Laplace approximation reads the
parameter uncertainty off ``F⁻¹``.

The resident Jacobian (:meth:`~multigrad_tpu_torch.core.model
.OnePointModel.calc_sumstats_and_jac_from_params`) and the streamed one
(:meth:`~multigrad_tpu_torch.data.streaming.StreamingOnePointModel
.calc_sumstats_and_jac_from_params`) both feed this module, so
out-of-core catalogs get Fisher matrices through the same algebra.
Every tensor stays float32, on the model's device.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch

from ..core.group import OnePointGroup

__all__ = ["FisherResult", "sumstats_jacobian", "fisher_information",
           "laplace_covariance", "fisher_diagnostics"]


def _streamed(model) -> bool:
    return hasattr(model, "streams")  # StreamingOnePointModel


def sumstats_jacobian(model, params, randkey=None, mode: str = "fwd"):
    """Total sumstats and their Jacobian for a resident or a streamed
    model: ``(sumstats, jac)``, ``jac`` of shape ``(*sumstats.shape,
    ndim)``.  A streamed model adds its chunks' Jacobians up over its
    plan (``mode`` does not apply there)."""
    if _streamed(model):
        return model.calc_sumstats_and_jac_from_params(
            params, randkey=randkey)
    return model.calc_sumstats_and_jac_from_params(
        params, randkey=randkey, mode=mode)


@dataclass(frozen=True)
class FisherResult:
    """Fisher information at a parameter point, with its factors.

    Attributes
    ----------
    params : tensor, shape (ndim,)
        Evaluation point (typically the MLE).
    fisher : tensor, shape (ndim, ndim)
        Gauss–Newton Fisher information ``Jᵀ H_y J``, symmetrized.
    jac : tensor, shape (n_sumstats, ndim)
        Total sumstats Jacobian.
    sumstats : tensor, shape (n_sumstats,)
        Total sumstats at ``params``.
    sumstats_hessian : tensor, shape (n_sumstats, n_sumstats)
        ``H_y = ∂²loss/∂y²`` at the total sumstats.
    """

    params: torch.Tensor
    fisher: torch.Tensor
    jac: torch.Tensor
    sumstats: torch.Tensor
    sumstats_hessian: torch.Tensor

    def covariance(self, jitter: float = 0.0):
        """Laplace covariance ``F⁻¹`` (see :func:`laplace_covariance`)."""
        return laplace_covariance(self.fisher, jitter=jitter)

    def stderr(self, jitter: float = 0.0):
        """Per-parameter 1σ Laplace uncertainties, ``sqrt(diag(F⁻¹))``."""
        return torch.sqrt(torch.diagonal(self.covariance(jitter=jitter)))

    def diagnostics(self) -> dict:
        """Conditioning report (see :func:`fisher_diagnostics`)."""
        return fisher_diagnostics(self.fisher)


def fisher_information(model, params, randkey=None, mode: str = "fwd"
                       ) -> FisherResult:
    """Distributed Gauss–Newton Fisher information ``Jᵀ H_y J``.

    One pass over the data for ``(y, J)`` (resident, or streamed chunk by
    chunk), then the ``|y|×|y|`` Hessian of the loss-from-sumstats at the
    total ``y`` (``torch.autograd.functional.hessian``).  Exact for
    Gaussian likelihoods.  Takes an :class:`OnePointModel`, a
    :class:`~multigrad_tpu_torch.data.streaming.StreamingOnePointModel`
    or an :class:`OnePointGroup` (the sum of its members' Fisher
    matrices).  For calibrated *absolute* uncertainties the loss must be
    a negative log-density (e.g. ``½ χ²``), not a rescaled proxy.
    """
    if isinstance(model, OnePointGroup):
        return _group_fisher_information(model, params, randkey=randkey,
                                         mode=mode)
    loss_model = model.model if _streamed(model) else model
    params = loss_model._params(params)
    y, jac = sumstats_jacobian(model, params, randkey=randkey, mode=mode)
    jac = jac.reshape(-1, params.shape[-1])

    kwargs = loss_model._key_kwargs(randkey)
    ss_aux = None
    if loss_model.sumstats_func_has_aux:
        # The Jacobian pass drops the aux; one sumstats pass fetches it
        # (a streamed model's is the additive total, a resident model's
        # this process's, as its loss reads it).
        ss_aux = model.calc_sumstats_from_params(params,
                                                 randkey=randkey)[1]

    def loss_of_y(y_flat):
        loss, _ = loss_model._loss(y_flat.reshape(y.shape), ss_aux, kwargs)
        return loss

    hess_y = torch.autograd.functional.hessian(loss_of_y,
                                               y.detach().reshape(-1))
    fisher = jac.T @ hess_y @ jac
    fisher = 0.5 * (fisher + fisher.T)     # exact symmetry
    return FisherResult(params=params, fisher=fisher, jac=jac, sumstats=y,
                        sumstats_hessian=hess_y)


def _group_fisher_information(group, params, randkey=None,
                              mode: str = "fwd") -> FisherResult:
    """Joint Fisher of an :class:`OnePointGroup`: the group loss is the
    sum of the member losses and each reads only its own sumstats, so the
    joint Gauss–Newton Fisher is the sum of the members' (each member's
    Jacobian already differentiates with respect to the joint parameters:
    a ``param_view`` member's selection puts its columns in its slots).
    The factors are returned stacked: ``jac`` the members' Jacobians one
    above the other, ``sumstats_hessian`` their block-diagonal, so that
    ``fisher == jac.T @ H_y @ jac``."""
    members = [fisher_information(m, params, randkey=randkey, mode=mode)
               for m in group.models]
    fisher = members[0].fisher
    for m in members[1:]:
        fisher = fisher + m.fisher
    return FisherResult(
        params=members[0].params, fisher=fisher,
        jac=torch.cat([m.jac for m in members]),
        sumstats=torch.cat([m.sumstats.reshape(-1) for m in members]),
        sumstats_hessian=torch.block_diag(
            *[m.sumstats_hessian for m in members]))


def laplace_covariance(fisher, jitter: float = 0.0):
    """Laplace posterior covariance ``F⁻¹`` via Cholesky.

    ``jitter`` (added to the diagonal, scaled by the mean diagonal)
    regularizes a singular or near-singular Fisher; a matrix that is not
    positive definite falls back to the Moore–Penrose pseudoinverse with a
    warning: unidentifiable directions then get zero (not infinite)
    variance, so check :func:`fisher_diagnostics` before trusting
    per-parameter errors.
    """
    fisher = torch.as_tensor(fisher)
    ndim = fisher.shape[0]
    eye = torch.eye(ndim, dtype=fisher.dtype, device=fisher.device)
    mat = fisher
    if jitter:
        scale = torch.mean(torch.abs(torch.diagonal(fisher))) + 1e-30
        mat = fisher + jitter * scale * eye
    chol, info = torch.linalg.cholesky_ex(mat)
    if int(info) != 0 or not bool(torch.isfinite(chol).all()):
        warnings.warn(
            "Fisher matrix is not positive definite; falling back to "
            "pseudoinverse — some directions are unidentifiable (see "
            "fisher_diagnostics)", RuntimeWarning, stacklevel=2)
        return torch.linalg.pinv(mat)
    inv_chol = torch.linalg.solve_triangular(chol, eye, upper=False)
    return inv_chol.T @ inv_chol


def fisher_diagnostics(fisher) -> dict:
    """Conditioning report for a Fisher matrix, a plain dict of host
    numpy values:

    * ``eigvals``: the ascending eigenvalue spectrum;
    * ``condition_number``: λ_max/λ_min (inf when singular);
    * ``n_unidentifiable``: eigenvalues below ``ndim · eps · λ_max``
      (parameter combinations the data does not constrain);
    * ``identifiable``: True when there are none.
    """
    if isinstance(fisher, torch.Tensor):
        fisher = fisher.detach().cpu().numpy()
    fisher = np.asarray(fisher)
    eigvals = np.linalg.eigvalsh(fisher)
    lam_max = float(eigvals[-1]) if eigvals.size else 0.0
    tol = fisher.shape[0] * np.finfo(fisher.dtype).eps * abs(lam_max)
    n_null = int(np.sum(eigvals <= tol))
    lam_min = float(eigvals[0]) if eigvals.size else 0.0
    cond = float("inf") if lam_min <= tol else float(lam_max / lam_min)
    return {
        "eigvals": eigvals,
        "condition_number": cond,
        "n_unidentifiable": n_null,
        "identifiable": n_null == 0,
    }
