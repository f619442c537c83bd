"""Multi-chain Hamiltonian Monte Carlo over sharded sumstats (port of
:mod:`multigrad_tpu.inference.hmc`).

The potential ``U(θ) = loss(θ)`` (the negative log-posterior up to a
constant) and its gradient cost O(|y| + |params|) communication an
evaluation, so a trajectory is more of the same chain rule: the C chains
are one ``(C, ndim)`` batch through the model's
:meth:`~multigrad_tpu_torch.core.model.OnePointModel
.batched_loss_and_grad_fn` (2 all-reduces an evaluation, whatever C).

The sampler keeps the JAX package's structure: kick–drift–kick leapfrog
carrying the end-of-step gradient (``num_leapfrog`` evaluations a draw),
a uniform step-size jitter a draw, the Metropolis test on ``ΔH``,
divergences where ``ΔH`` is not finite or below ``-1000``, per-chain
Nesterov dual averaging of the step size during warmup (Stan's
constants) and sampling at the averaged step size.  Where the JAX package
compiles the whole run into one ``lax.scan`` program, the port runs a
host loop of draws whose every tensor stays on the model's device: an
accept is a ``torch.where``, the draws go into a preallocated ``(C, S,
D)`` tensor, and nothing reaches the host before the end.  Randomness
comes from a ``torch.Generator`` on that device, seeded with
``randkey``, so runs match the JAX package in distribution only.

Sharded chains (``k_sharded=True``, a model on an
:func:`~multigrad_tpu_torch.parallel.ensemble_comm`): the C chains are
partitioned C/R a process over the replica axis.  Every process draws the
full ``(C, ndim)`` momenta and ``(C,)`` uniforms from the one generator
and takes its rows, so each chain follows the replicated sampler's stream
bit for bit.  The replica comm carries the tap's records (mean acceptance
averaged, divergences summed, step sizes gathered, on record draws only)
and the gather of the result at the end, nothing else.

Split R-hat and the bulk effective sample size run on the host, in
numpy, on the returned draws (:func:`split_rhat`,
:func:`effective_sample_size`).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..optim.adam import init_randkey
from .ensemble import float32_on

__all__ = ["HMCResult", "run_hmc", "split_rhat", "effective_sample_size"]

# Dual-averaging constants (Hoffman & Gelman 2014, §3.2.1; Stan's
# defaults): adaptation gain, iteration offset, averaging decay.
_DA_GAMMA = 0.05
_DA_T0 = 10.0
_DA_KAPPA = 0.75
# ΔH below minus this is a divergence (Stan's threshold).
_DIVERGENCE_DH = 1000.0


@dataclass(frozen=True)
class HMCResult:
    """Posterior draws and sampler accounting.

    Attributes
    ----------
    samples : np.ndarray, shape (num_chains, num_samples, ndim)
        Post-warmup draws.
    potential : np.ndarray, shape (num_chains, num_samples)
        ``U = loss`` at each draw.
    accept_prob : np.ndarray, shape (num_chains,)
        Mean Metropolis acceptance probability over the sampling run.
    step_size : np.ndarray, shape (num_chains,)
        Dual-averaged step size each chain sampled with.
    warmup_accept_prob : np.ndarray, shape (num_chains,)
        Mean acceptance over the warmup (NaN when ``num_warmup=0``).
    divergences : np.ndarray, shape (num_chains,)
        Divergent transitions a chain during sampling.
    rhat : np.ndarray, shape (ndim,)
        Split-chain potential scale reduction.
    ess : np.ndarray, shape (ndim,)
        Bulk effective sample size, combined over chains.
    """

    samples: np.ndarray
    potential: np.ndarray
    accept_prob: np.ndarray
    step_size: np.ndarray
    warmup_accept_prob: np.ndarray
    divergences: np.ndarray
    rhat: np.ndarray
    ess: np.ndarray

    @property
    def num_chains(self) -> int:
        return self.samples.shape[0]

    def mean(self) -> np.ndarray:
        """Posterior mean over all chains and draws."""
        return self.samples.reshape(-1, self.samples.shape[-1]).mean(0)

    def cov(self) -> np.ndarray:
        """Posterior covariance over all chains and draws."""
        flat = self.samples.reshape(-1, self.samples.shape[-1])
        return np.cov(flat, rowvar=False)

    def summary(self) -> dict:
        """Compact per-run scalars (JSON-friendly)."""
        return {
            "num_chains": int(self.num_chains),
            "num_samples": int(self.samples.shape[1]),
            "accept_prob": [round(float(a), 3) for a in self.accept_prob],
            "step_size": [round(float(s), 5) for s in self.step_size],
            "divergences": [int(d) for d in self.divergences],
            "max_rhat": round(float(np.max(self.rhat)), 4),
            "min_ess": round(float(np.min(self.ess)), 1),
        }


def _f32(x) -> float:
    """A float32 scalar as a Python float (exact), so that the dual
    averaging's schedule rounds as the JAX package's float32 does."""
    return float(np.float32(x))


def _sample(potential, q0, noise, num_warmup, num_samples, num_leapfrog,
            step_size0, inv_mass, target_accept, jitter, tap=None,
            sentinel=None, ks=None):
    """The sampler (parity: ``_build_hmc_local`` of the JAX package's
    ``hmc.py``) on ``(C, D)`` starts ``q0``, every tensor on ``q0``'s
    device.

    ``potential(q (C, D)) -> (U (C,), grad (C, D))``; ``noise(t) ->
    (std-normal momenta (C, D), jitter uniforms (C,), accept uniforms
    (C,))`` for draw ``t`` (warmup draws first, numbered from 0).
    Returns a dict of tensors: ``samples`` (C, S, D), ``potential``
    (C, S), ``accept_prob``, ``warmup_accept_prob``, ``step_size`` and
    ``divergences`` (C,).

    ``tap`` (a :class:`~multigrad_tpu_torch.telemetry.ScalarTap`) emits
    an ``hmc`` record at sampling draw ``t + 1`` when it is a multiple of
    ``tap.log_every``: the window's mean acceptance, the cumulative
    divergences and each chain's step size, added up on the device draw
    by draw.  ``sentinel`` (a :class:`~multigrad_tpu_torch.telemetry
    .NonFiniteSentinel`) watches each draw's proposal potential (NaN
    only: an infinite one is a divergence the Metropolis test rejects),
    at warmup draw ``t`` and sampling draw ``t + 1`` as in the JAX
    package.  Neither reads a value inside a draw.

    ``ks`` (a :class:`~multigrad_tpu_torch.parallel.KSharding`): ``q0``
    holds this process's chains; a record draw's acceptance is averaged,
    its divergences summed and its step sizes gathered over the replica
    comm, so the records cover the whole ensemble.
    """
    n_chains, ndim = q0.shape
    inv_mass = inv_mass.reshape(1, ndim)
    inv_sqrt_mass = torch.sqrt(inv_mass)

    def kinetic(p):
        return 0.5 * torch.sum(p * p * inv_mass, dim=-1)

    def draw(q, U, g, eps, t):
        z, u_jit, u_acc = noise(t)
        p = z / inv_sqrt_mass
        eps_col = (eps * (1.0 + jitter * (2.0 * u_jit - 1.0)))[:, None]
        h0 = U + kinetic(p)
        qn, pn, gn, un = q, p, g, U
        for _ in range(num_leapfrog):
            # Kick-drift-kick, the end-of-step gradient carried into the
            # next step: num_leapfrog evaluations a draw.
            p_half = pn - 0.5 * eps_col * gn
            qn = qn + eps_col * inv_mass * p_half
            un, gn = potential(qn)
            pn = p_half - 0.5 * eps_col * gn
        dh = h0 - (un + kinetic(pn))
        finite = torch.isfinite(dh)
        accept_prob = torch.where(finite, torch.exp(torch.clamp(dh, max=0.0)),
                                  0.0)
        divergent = ~finite | (dh < -_DIVERGENCE_DH)
        accept = u_acc < accept_prob
        keep = accept[:, None]
        if sentinel is not None:
            name = "warmup_potential" if t < num_warmup else "potential"
            sentinel.watch(t if t < num_warmup else t - num_warmup + 1, {
                name: torch.where(torch.isinf(un), torch.zeros_like(un),
                                  un)})
        return (torch.where(keep, qn, q), torch.where(accept, un, U),
                torch.where(keep, gn, g), accept_prob, divergent)

    q = q0
    U, g = potential(q)
    mu = torch.log(10.0 * step_size0) * torch.ones(n_chains, device=q.device)
    log_eps = log_eps_bar = torch.log(step_size0) * torch.ones(
        n_chains, device=q.device)
    h_bar = torch.zeros(n_chains, device=q.device)
    warm_accepts = torch.empty((n_chains, num_warmup), device=q.device)
    for t in range(num_warmup):
        q, U, g, accept_prob, _ = draw(q, U, g, torch.exp(log_eps), t)
        warm_accepts[:, t] = accept_prob
        # Nesterov dual averaging toward target_accept, every chain on
        # its own; the schedule's scalars in float32 on the host.
        tt = np.float32(t + 1)
        eta = np.float32(1.0) / (tt + np.float32(_DA_T0))
        h_bar = _f32(np.float32(1.0) - eta) * h_bar \
            + _f32(eta) * (target_accept - accept_prob)
        log_eps = mu - _f32(np.sqrt(tt) / np.float32(_DA_GAMMA)) * h_bar
        w = tt ** np.float32(-_DA_KAPPA)
        log_eps_bar = _f32(w) * log_eps + _f32(np.float32(1.0) - w) \
            * log_eps_bar
    warm_accept = warm_accepts.mean(dim=1) if num_warmup else torch.full(
        (n_chains,), float("nan"), device=q.device)
    eps_sample = torch.exp(log_eps_bar)

    samples = torch.empty((n_chains, num_samples, ndim), device=q.device)
    potentials = torch.empty((n_chains, num_samples), device=q.device)
    accepts = torch.empty((n_chains, num_samples), device=q.device)
    divergent = torch.empty((n_chains, num_samples), dtype=torch.bool,
                            device=q.device)
    win_accept = torch.zeros((), device=q.device)
    div_total = torch.zeros((), dtype=torch.int64, device=q.device)
    for t in range(num_samples):
        q, U, g, accepts[:, t], divergent[:, t] = draw(
            q, U, g, eps_sample, num_warmup + t)
        samples[:, t] = q
        potentials[:, t] = U
        if tap is not None:
            win_accept = win_accept + accepts[:, t].mean()
            div_total = div_total + divergent[:, t].sum()
            if (t + 1) % tap.log_every == 0:
                accept, divergences, eps = \
                    win_accept / tap.log_every, div_total, eps_sample
                if ks is not None:
                    accept = ks.replica.pmean(accept)
                    divergences = ks.replica.psum(divergences)
                    eps = ks.gather(eps)
                tap.maybe_emit(t + 1, dict(
                    accept=accept, divergences=divergences, step_size=eps))
                win_accept = torch.zeros_like(win_accept)
            else:
                tap.drain()
    return {"samples": samples, "potential": potentials,
            "accept_prob": accepts.mean(dim=1),
            "warmup_accept_prob": warm_accept, "step_size": eps_sample,
            "divergences": divergent.sum(dim=1)}


def run_hmc(model, init, num_samples: int = 1000, num_warmup: int = 500,
            num_chains: int = 4, step_size: float = 0.1,
            num_leapfrog: int = 8, inv_mass=None,
            target_accept: float = 0.8, jitter: float = 0.2, randkey=0,
            model_randkey=None, init_spread: float = 0.0, telemetry=None,
            log_every: int = 0, flight=None, live=None, alerts=None,
            k_sharded: bool = False) -> HMCResult:
    """Sample ``p(θ) ∝ exp(-loss(θ))`` with multi-chain HMC (parity:
    ``inference/hmc.py:393-641`` of the JAX package).

    The model's loss must be a negative log-density (e.g. ``½ χ²``).

    Parameters
    ----------
    model : OnePointModel or fused OnePointGroup
        Its batched loss and gradient is the potential; the run is on
        its device.
    init : array, shape (ndim,) or (num_chains, ndim)
        Chain starts (e.g. :func:`~multigrad_tpu_torch.inference
        .hmc_init_from_ensemble`); a 1-D start is scattered by
        ``init_spread`` into ``num_chains`` rows.
    num_samples, num_warmup : int
        Draws a chain after warmup / dual-averaging warmup draws.
    num_chains : int
        Ignored when ``init`` is 2-D.
    step_size : float
        Initial leapfrog step size, adapted a chain during warmup.
    num_leapfrog : int
        Leapfrog steps a draw.
    inv_mass : array (ndim,), optional
        Diagonal inverse mass matrix (≈ posterior variances, e.g. the
        square of ``FisherResult.stderr()``); default ones.
    target_accept, jitter : float
        Dual averaging's target acceptance; the step-size jitter fraction.
    randkey : int
        Seed of the sampler's ``torch.Generator`` (momenta, jitter,
        Metropolis, the scatter of a 1-D ``init``).
    model_randkey : int, optional
        Passed to the model's methods, the same at every draw.
    telemetry, log_every
        With ``log_every > 0``, ``hmc`` records every ``log_every``-th
        sampling draw: the window's mean acceptance, the cumulative
        divergences and each chain's step size, copied off the card
        without a wait (:mod:`multigrad_tpu_torch.telemetry.taps`); a
        ``fit_plan`` up front and a ``fit_summary`` (divergences, mean
        acceptance) at the end.
    flight : FlightRecorder, optional
        Watch the chains' proposal potential for NaN, warmup included;
        a trip dumps the postmortem bundle and the run raises
        :class:`~multigrad_tpu_torch.telemetry.FlightRecorderTripped`
        at its end.
    live, alerts
        The live endpoint and the alert rules, joined to the stream.
    k_sharded : bool
        Partition the chains over the replica axis of the model's
        :func:`~multigrad_tpu_torch.parallel.ensemble_comm` (``ValueError``
        without one, and when R does not divide the chain count): C/R
        chains a process, each bit-equal to the replicated sampler's
        chain, the result gathered at the end (see the module
        docstring).
    """
    from ..parallel.distributed import process_index
    from ..telemetry.live import wire_monitoring
    from ..telemetry.taps import make_tap

    device = model.device
    init = float32_on(init, device)
    gen = torch.Generator(device=device).manual_seed(init_randkey(randkey))
    if init.dim() == 1:
        init = init[None] + init_spread * torch.randn(
            (num_chains, init.shape[0]), generator=gen, device=device)
    elif init.dim() != 2:
        raise ValueError(f"init must be (ndim,) or (num_chains, ndim), got "
                         f"shape {tuple(init.shape)}")
    n_chains, ndim = init.shape
    ks = None
    if k_sharded:
        model._require_k_shard_axis()
        if n_chains % model.k_shard_replicas:
            raise ValueError(
                "k_sharded HMC needs the chain count divisible by the "
                f"replica count: {n_chains} chains on "
                f"{model.k_shard_replicas} replica slices")
        ks = model.k_sharding(2)
    inv_mass = torch.ones(ndim, device=device) if inv_mass is None \
        else float32_on(inv_mass, device)
    if tuple(inv_mass.shape) != (ndim,):
        raise ValueError(f"inv_mass must be diagonal, shape ({ndim},); got "
                         f"{tuple(inv_mass.shape)}")
    if not bool((inv_mass > 0).all()):
        raise ValueError(
            "inv_mass entries must be strictly positive (got "
            f"{inv_mass.cpu().numpy()}); an unidentifiable direction (see "
            "fisher_diagnostics) cannot be used as a preconditioner — fall "
            "back to ones there")
    with_key = model_randkey is not None
    model_key = init_randkey(model_randkey) if with_key else None
    program = model.batched_loss_and_grad_fn(with_key,
                                             k_sharded=ks is not None)
    leaves = model.aux_leaves()
    rows = (lambda x: x) if ks is None else ks.local

    def potential(q):
        return program(q, leaves, model_key)

    def noise(_t):
        # The full (C, ...) draws on every process, this process's rows
        # taken: each chain's stream is the replicated sampler's.
        return (rows(torch.randn((n_chains, ndim), generator=gen,
                                 device=device)),
                rows(torch.rand(n_chains, generator=gen, device=device)),
                rows(torch.rand(n_chains, generator=gen, device=device)))

    telemetry, log_every, owned = wire_monitoring(
        telemetry, log_every, live, alerts)
    try:
        if telemetry is not None:
            telemetry.log("fit_plan", kind="hmc", nsteps=int(num_samples),
                          num_warmup=int(num_warmup),
                          num_chains=int(n_chains),
                          log_every=int(log_every),
                          k_sharded=bool(k_sharded))
        tap = make_tap(telemetry, "hmc", log_every)
        sentinel = flight.sentinel("hmc") if flight is not None else None
        if sentinel is not None:
            sentinel.arm()
            if tap is not None:
                tap.ride(sentinel)
        out = _sample(potential, rows(init), noise, int(num_warmup),
                      int(num_samples), int(num_leapfrog),
                      torch.tensor(float(step_size), device=device),
                      inv_mass, float(target_accept), float(jitter),
                      tap=tap, sentinel=sentinel, ks=ks)
        if ks is not None:
            out = gather_chains(out, ks)
        result = result_from(out)
        if tap is not None:
            tap.drain(block=True)
        if sentinel is not None:
            sentinel.finish()
        if telemetry is not None and process_index() == 0:
            summary = {
                "steps": int(num_samples),
                "divergences": int(np.sum(result.divergences)),
                "accept_prob": round(float(np.mean(result.accept_prob)),
                                     4)}
            if flight is not None and flight.bundle_path:
                summary["postmortem_bundle"] = flight.bundle_path
            telemetry.log("fit_summary", **summary)
    finally:
        if owned is not None:
            owned.close()
    if flight is not None:
        flight.raise_if_fatal()
    return result


def gather_chains(out: dict, ks) -> dict:
    """A sharded sampler run's per-chain tensors, every replica slice's
    chains in order, through ONE all-gather over the replica comm (each
    process's tensors flattened and joined, then split back)."""
    names = list(out)
    local = [out[k] for k in names]
    rows = local[0].shape[0]
    flat = torch.cat([t.reshape(rows, -1).to(torch.float32)
                      for t in local], dim=1)
    full = ks.gather(flat)
    widths = [t[0].numel() for t in local]
    return {name: part.reshape((full.shape[0],) + tuple(t.shape[1:]))
            .to(t.dtype)
            for name, t, part in zip(names, local,
                                     full.split(widths, dim=1))}


def result_from(out) -> HMCResult:
    """The :class:`HMCResult` of a sampler run's tensors, each copied to
    the host once, with R-hat and ESS computed there."""
    host = {k: v.cpu().numpy() for k, v in out.items()}
    return HMCResult(rhat=split_rhat(host["samples"]),
                     ess=effective_sample_size(host["samples"]), **host)


# ------------------------------------------------------------------ #
# Convergence diagnostics (host-side numpy, as in the JAX package)
# ------------------------------------------------------------------ #
def split_rhat(samples) -> np.ndarray:
    """Split-chain potential scale reduction factor (Gelman–Rubin).

    Each chain is split in half (catching within-chain drift that
    whole-chain R-hat misses), then the classic between/within
    variance ratio is computed per dimension.  ``samples`` is
    ``(num_chains, num_draws, ndim)``; returns ``(ndim,)``.
    """
    samples = np.asarray(samples, np.float64)
    n_chains, n_draws, ndim = samples.shape
    half = n_draws // 2
    if half < 2:
        return np.full(ndim, np.nan)
    chains = np.concatenate(
        [samples[:, :half], samples[:, half:2 * half]], axis=0)
    means = chains.mean(axis=1)                       # (2C, D)
    w = chains.var(axis=1, ddof=1).mean(axis=0)       # within
    b = half * means.var(axis=0, ddof=1)              # between
    var_hat = (half - 1) / half * w + b / half
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.sqrt(var_hat / w)


def _autocovariance(x: np.ndarray) -> np.ndarray:
    """Per-chain autocovariance via FFT: ``x`` is (C, S, D), returns
    (C, S, D) with lag along axis 1 (biased 1/S normalization, the
    ESS convention)."""
    c, s, d = x.shape
    x = x - x.mean(axis=1, keepdims=True)
    n = 1 << (2 * s - 1).bit_length()
    f = np.fft.rfft(x, n=n, axis=1)
    acov = np.fft.irfft(f * np.conj(f), n=n, axis=1)[:, :s]
    return acov / s


def effective_sample_size(samples) -> np.ndarray:
    """Bulk ESS, combined over chains (Stan's formulation).

    Per dimension: lag correlations ``ρ_t`` are estimated from the
    chain-averaged autocovariance relative to the pooled variance
    (which deflates ρ for unmixed chains, tying ESS to R-hat), then
    summed under Geyer's initial-monotone-positive-sequence rule.
    ``samples`` is ``(num_chains, num_draws, ndim)``; returns
    ``(ndim,)``, capped at the total draw count.
    """
    samples = np.asarray(samples, np.float64)
    n_chains, n_draws, ndim = samples.shape
    if n_draws < 4:
        return np.full(ndim, np.nan)
    acov = _autocovariance(samples)                    # (C, S, D)
    chain_var = acov[:, 0] * n_draws / (n_draws - 1.0)  # (C, D)
    w = chain_var.mean(axis=0)
    mean_acov = acov.mean(axis=0)                      # (S, D)
    if n_chains > 1:
        means = samples.mean(axis=1)                   # (C, D)
        b = n_draws * means.var(axis=0, ddof=1)
        var_hat = (n_draws - 1.0) / n_draws * w + b / n_draws
    else:
        var_hat = (n_draws - 1.0) / n_draws * w
    ess = np.empty(ndim)
    total = n_chains * n_draws
    for k in range(ndim):
        if var_hat[k] <= 0 or not np.isfinite(var_hat[k]):
            ess[k] = np.nan
            continue
        rho = 1.0 - (w[k] - mean_acov[:, k]) / var_hat[k]
        # Geyer: sum consecutive-lag pairs while positive, enforcing
        # monotone decrease.
        tau = 1.0           # = 1 + 2 Σ ρ_t, built from pair sums
        prev_pair = np.inf
        t = 1
        while t + 1 < n_draws:
            pair = rho[t] + rho[t + 1]
            if pair < 0:
                break
            pair = min(pair, prev_pair)
            tau += 2.0 * pair
            prev_pair = pair
            t += 2
        ess[k] = min(total / tau, float(total))
    return ess
