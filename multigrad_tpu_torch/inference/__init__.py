"""Inference: uncertainty for fitted models (port of
:mod:`multigrad_tpu.inference`).

* :mod:`.fisher`: distributed sumstats Jacobians (per shard and per
  chunk, ``∂y_r/∂p`` sums like ``y_r``), the Gauss–Newton Fisher
  information, Laplace covariances and conditioning diagnostics.
* :mod:`.hmc`: multi-chain HMC, the chains one batch through the model's
  batched loss and gradient, dual-averaging warmup, every draw on the
  device; split R-hat and ESS on the host.
* :mod:`.ensemble`: multi-start Adam (K fits as one batched fit), the
  L-BFGS polish of the best basins, and chain starts around the winner.

The JAX package's pipeline (``examples/smf_posterior.py``)::

    ens = run_multistart_adam(model, param_bounds=bounds)
    top = ens.params[torch.argsort(ens.losses)[:2]]
    ens = run_multistart_lbfgs(model, inits=top, maxsteps=60,
                               param_bounds=bounds)
    fr = fisher_information(model, ens.best_params)
    res = run_hmc(model, hmc_init_from_ensemble(ens, stderr=fr.stderr()),
                  inv_mass=fr.stderr() ** 2)
"""
from .fisher import (FisherResult, fisher_diagnostics,  # noqa: F401
                     fisher_information, laplace_covariance,
                     sumstats_jacobian)
from .hmc import (HMCResult, effective_sample_size, run_hmc,  # noqa: F401
                  split_rhat)
from .ensemble import (DEFAULT_K_BUDGET_BYTES,  # noqa: F401
                       EnsembleResult, batched_fit_wrapper,
                       ensemble_memory_model, hmc_init_from_ensemble,
                       max_k_for_budget, resolve_k_sharded,
                       row_graph_bytes, run_multistart_adam,
                       run_multistart_lbfgs)

__all__ = [
    "FisherResult", "fisher_information", "laplace_covariance",
    "fisher_diagnostics", "sumstats_jacobian",
    "HMCResult", "run_hmc", "split_rhat", "effective_sample_size",
    "EnsembleResult", "run_multistart_adam", "run_multistart_lbfgs",
    "hmc_init_from_ensemble",
    "batched_fit_wrapper", "ensemble_memory_model", "max_k_for_budget",
    "resolve_k_sharded", "row_graph_bytes", "DEFAULT_K_BUDGET_BYTES",
]
