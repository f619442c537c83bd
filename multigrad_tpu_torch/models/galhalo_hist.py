"""Galaxy–halo model with diffmah-style mass-accretion histories (port of
:mod:`multigrad_tpu.models.galhalo_hist`).

* **MAH** — each halo grows along a smooth power law in cosmic time whose
  index rolls from an early-time to a late-time value through a sigmoid
  at a transition epoch::

      log10 Mh(t) = logm0 + alpha(t) * log10(t / T0)
      alpha(t)    = alpha_late + (alpha_early - alpha_late)
                    * sigmoid(k_t * log10(tc / t))

  so ``Mh(T0) = 10**logm0``; ``d log Mh/dt`` is closed form
  (:func:`_dlogmh_dt`).
* **SFH** — stars form from the accreted baryons at a mass-dependent
  efficiency peaking at ``logm_crit``: ``SFR(t) = eps(Mh(t)) * F_B *
  dMh/dt``, integrated by a fixed-grid trapezoid and read out at the
  observation epochs ``obs_indices`` of the time grid.  The sumstats are
  the concatenated per-epoch stellar mass functions.
* **Scatter** — log-normal, with a mass-dependent width
  ``sigma(logm0) = sigma_0 + sigma_slope * (logm0 - 13)``, entering the
  binned SMF through the per-particle-sigma erf-CDF counts (dense, or
  fused with ``bin_mode="fused"``).

Execution: the history integration, epoch readout, scatter widths and
binned counts all run inside one loop over halo chunks
(:func:`_chunk_epoch_smfs`), each chunk adding its ``(K, B)`` densities
to the total.  Each chunk's body is rematerialized
(``torch.utils.checkpoint``): its backward recomputes the chunk's
forward instead of keeping its ``(chunk, T)`` history tensors, so peak
memory is ``O(N + chunk·T)`` whatever the epoch count.  On the card the
history of a chunk is one CUDA kernel each way
(:mod:`~multigrad_tpu_torch.ops.hist_kernels`) and the counts run the
erf kernels; a ragged last chunk is padded with the neutral sentinel.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.model import OnePointModel
from ..ops import hist_kernels
from ..ops.binned import binned_density, fused_bin_window
from ..parallel.collectives import scatter_nd
from ..parallel.mesh import MeshComm
from ..telemetry.spans import span
from ..utils.util import pad_to_multiple, resolve_device
from .galhalo import sample_log_halo_masses

T0_GYR = 13.8          # age of the universe: the histories' endpoint
F_BARYON = 0.156       # cosmic baryon fraction Omega_b / Omega_m
_LN10 = 2.302585092994046
_LOG10_F_BARYON = math.log10(F_BARYON)
_SOFTPLUS0 = math.log(2.0)
_PAD_LOGM = 1e9        # pad sentinel on the halo-mass axis
_PAD_OUT = 1e18        # emitted log-M* for pad halos (beyond every finite
                       # bin edge: zero count and zero gradient)


class GalhaloHistParams(NamedTuple):
    """Ten-parameter MAH + SFH + scatter family (all differentiable)."""
    alpha_early: float = 2.5    # early-time accretion index
    alpha_late: float = 0.8     # late-time accretion index
    lg_tc: float = 0.3          # log10 of the MAH transition time [Gyr]
    k_t: float = 3.0            # sharpness of the index rollover
    lgeps_max: float = -0.7     # peak star-formation efficiency (log10)
    logm_crit: float = 12.0     # halo mass of peak efficiency
    eps_lo: float = 1.5         # efficiency rise below logm_crit
    eps_hi: float = 1.0         # efficiency fall above logm_crit
    sigma_0: float = 0.2        # log-normal scatter at logm0 = 13
    sigma_slope: float = -0.03  # d sigma / d logm0


TRUTH = GalhaloHistParams()


def default_time_grid(n_times: int = 16, device=None):
    """Log-spaced float32 integration grid over (0.5, T0] Gyr on
    ``device`` (``None`` means CUDA)."""
    return torch.logspace(math.log10(0.5), math.log10(T0_GYR), n_times,
                          dtype=torch.float32,
                          device=resolve_device(device))


def mah_alpha(t, params):
    """The rolling accretion index alpha(t)."""
    p = GalhaloHistParams(*params)
    return p.alpha_late + (p.alpha_early - p.alpha_late) * torch.sigmoid(
        p.k_t * (p.lg_tc - torch.log10(t)))


def log_mh_at_t(log_mh0, t, params):
    """log10 Mh(t) for halos of z=0 mass ``log_mh0`` (broadcasting)."""
    lam = torch.log10(t / T0_GYR)
    return log_mh0 + mah_alpha(t, params) * lam


def _dlogmh_dt(log_mh0, t, params):
    """d(log10 Mh)/dt, closed form.

    With ``lam = log10(t/T0)`` and ``s = sigmoid(k_t (lg_tc - lg t))``:

        d alpha/dt  = -(a_e - a_l) s (1 - s) k_t / (t ln 10)
        d lam /dt   = 1 / (t ln 10)
        d logMh/dt  = lam * d alpha/dt + alpha / (t ln 10)
    """
    p = GalhaloHistParams(*params)
    del log_mh0  # the index is mass-independent in this family
    s = torch.sigmoid(p.k_t * (p.lg_tc - torch.log10(t)))
    alpha = p.alpha_late + (p.alpha_early - p.alpha_late) * s
    dalpha_dt = -(p.alpha_early - p.alpha_late) * s * (1.0 - s) \
        * p.k_t / (t * _LN10)
    lam = torch.log10(t / T0_GYR)
    return lam * dalpha_dt + alpha / (t * _LN10)


def lg_sfr_efficiency(log_mh, params):
    """log10 of the star-formation efficiency eps(Mh): two softplus ramps
    joined at ``logm_crit`` (rising ``eps_lo``, falling ``eps_hi``),
    shifted so the peak is exactly ``lgeps_max`` at the critical mass."""
    p = GalhaloHistParams(*params)
    k = 2.0  # fixed join sharpness; the slopes carry the physics
    x = log_mh - p.logm_crit
    ramp = (p.eps_lo / k) * F.softplus(-k * x) \
        + (p.eps_hi / k) * F.softplus(k * x)
    ramp0 = (p.eps_lo + p.eps_hi) / k * _SOFTPLUS0
    return p.lgeps_max - (ramp - ramp0)


def _check_obs_indices(obs_indices, t_grid):
    """The observation epochs as a tuple of ints, checked.

    Epochs are configuration, not data: a symbolic value (a
    ``torch.fx.Proxy``) cannot be range-checked and is refused.  Index 0
    has no cumulative integral yet, so it is refused too, as is an index
    past the grid.
    """
    if isinstance(obs_indices, torch.fx.Proxy):
        raise TypeError(
            "obs_indices must be concrete (a static tuple of grid "
            "indices), not a traced value: store a Python tuple in "
            "aux_data/arguments (GalhaloHistModel normalizes this "
            "automatically)")
    oi = _index_tuple(obs_indices)
    if min(oi) < 1 or max(oi) >= t_grid.shape[0]:
        raise ValueError(
            f"obs_indices must lie in [1, {t_grid.shape[0] - 1}] "
            f"(grid indices with at least one trapezoid step "
            f"before them), got {list(oi)}")
    return oi


def _index_tuple(obs_indices):
    if isinstance(obs_indices, torch.Tensor):
        return tuple(int(i) for i in obs_indices.reshape(-1).tolist())
    return tuple(int(i) for i in np.atleast_1d(np.asarray(obs_indices)))


def _mean_log_mstar_block(log_mh0, params, t_grid, obs_indices):
    """Mean log10 M*(t_obs) for a block of halos at each observation
    epoch (``obs_indices``, a tuple of ints), shape ``(n, K)``.

    On a CUDA tensor one kernel each way
    (:mod:`~multigrad_tpu_torch.ops.hist_kernels`, inside a ``hist.history``
    span; ``params`` the float32 tensor on the card that :func:`_on_card`
    makes); on CPU and meta tensors :func:`_mean_log_mstar_torch`.
    """
    if log_mh0.is_cuda:
        with span(None, "hist.history"):
            return hist_kernels.mean_log_mstar_cuda(log_mh0, params, t_grid,
                                                    obs_indices)
    return _mean_log_mstar_torch(log_mh0, params, t_grid, obs_indices)


def _mean_log_mstar_torch(log_mh0, params, t_grid, obs_indices):
    """:func:`_mean_log_mstar_block` in PyTorch ops: the kernels' plain
    version.

    Pad halos (``log_mh0 > 100``) are computed at a sanitized mass and
    overwritten with the neutral sentinel afterwards; the ``where`` zeroes
    their cotangents.
    """
    pad = log_mh0 > 100.0
    lm_safe = torch.where(pad, 13.0, log_mh0)[:, None]    # (n, 1)
    t = t_grid[None, :]                                   # (1, T)

    log_mh_t = log_mh_at_t(lm_safe, t, params)            # (n, T)
    # dM/dt = M ln10 dlogM/dt, assembled in log space so the ~10 dex
    # range of Mh over the grid stays in the exponent.
    lg_dmh_dt = log_mh_t + torch.log10(
        torch.clamp(_dlogmh_dt(lm_safe, t, params), min=1e-30) * _LN10)
    lg_sfr = lg_sfr_efficiency(log_mh_t, params) + _LOG10_F_BARYON \
        + lg_dmh_dt                                       # [Msun/Gyr]
    # Cumulative trapezoid in linear SFR, rescaled by the row maximum so
    # the exponentials stay in float32 range at any halo mass.
    lg_ref = torch.amax(lg_sfr, dim=1, keepdim=True)
    sfr = torch.pow(10.0, lg_sfr - lg_ref)
    dt = torch.diff(t_grid)[None, :]
    increments = 0.5 * (sfr[:, 1:] + sfr[:, :-1]) * dt    # (n, T-1)
    # The scan: a profiler range (no logger) in the forward and in the
    # checkpoint's recompute; its backward is traced back to it.
    with span(None, "hist.cumsum"):
        mstar_cum = torch.cumsum(increments, dim=1)       # up to t_k
    # Columns by views: an index tensor would cost a host-to-device copy.
    cols = torch.stack([mstar_cum[:, i - 1] for i in obs_indices], dim=1)
    logsm = lg_ref + torch.log10(torch.clamp(cols, min=1e-30))
    return torch.where(pad[:, None], _PAD_OUT, logsm)


def _halo_chunks(log_mh, chunk_size):
    """Chunks of ``chunk_size`` halos; a ragged last chunk is padded with
    the neutral sentinel ``_PAD_LOGM``."""
    chunks = list(torch.split(log_mh, int(chunk_size)))
    chunks[-1], _ = pad_to_multiple(chunks[-1], int(chunk_size),
                                    pad_value=_PAD_LOGM)
    return chunks


def _on_card(params, log_mh):
    """On the card, ``params`` as the one float32 tensor there that the
    history kernels read, made once before the chunks; elsewhere
    unchanged."""
    if log_mh.is_cuda:
        return hist_kernels.param_vector(params, log_mh.device)
    return params


def _remat(fn, *args):
    """``fn(*args)``, rematerialized in the backward pass when autograd
    records: only the inputs are kept, and the backward runs ``fn`` again
    to rebuild what it needs."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def mean_log_mstar(log_mh0, params, t_grid=None,
                   chunk_size: Optional[int] = None, obs_indices=None):
    """Mean log10 M* for halos of z=0 mass ``log_mh0``.

    ``obs_indices``: grid indices (>= 1) of the observation epochs;
    default the final grid point only, returned as shape ``(n,)``; with K
    explicit indices the return is ``(n, K)``.  ``chunk_size`` tiles the
    halo axis (rematerialized), so the ``(n, T)`` history never exceeds
    ``chunk_size * T`` elements.
    """
    log_mh0 = torch.as_tensor(log_mh0)
    if t_grid is None:
        t_grid = default_time_grid(device=log_mh0.device)
    squeeze = obs_indices is None
    if squeeze:
        obs_indices = (t_grid.shape[0] - 1,)
    obs_indices = _check_obs_indices(obs_indices, t_grid)
    params = _on_card(params, log_mh0)
    n = log_mh0.shape[0]
    if chunk_size is None or n <= chunk_size:
        out = _mean_log_mstar_block(log_mh0, params, t_grid, obs_indices)
    else:
        out = torch.cat([
            _remat(_mean_log_mstar_block, chunk, params, t_grid,
                   obs_indices)
            for chunk in _halo_chunks(log_mh0, chunk_size)])[:n]
    return out[:, 0] if squeeze else out


def scatter_sigma(log_mh0, params):
    """Mass-dependent log-normal scatter width, floored at 0.02."""
    p = GalhaloHistParams(*params)
    pad = log_mh0 > 100.0
    sig = p.sigma_0 + p.sigma_slope * (torch.where(pad, 13.0, log_mh0)
                                       - 13.0)
    return torch.clamp(sig, min=0.02)


def _chunk_epoch_smfs(lm_chunk, params, aux, obs_indices):
    """One chunk's ``(K, B)`` partial SMF stack: history, epoch readout,
    scatter widths and the binned counts, all inside the chunk."""
    logsm = _mean_log_mstar_block(lm_chunk, params, aux["time_grid"],
                                  obs_indices)           # (c, K)
    sigma = scatter_sigma(lm_chunk, params)              # (c,)
    return torch.stack([
        binned_density(column, aux["bin_edges"], sigma, aux["volume"],
                       bin_mode=aux.get("bin_mode", "dense"),
                       bin_window=aux.get("bin_window"))
        for column in logsm.unbind(1)])                  # (K, B)


def _multi_epoch_smf(log_mh, params, aux):
    """Concatenated SMFs at every observation epoch (the sumstats), summed
    over rematerialized halo chunks: no ``(N, K)`` readout or ``(N,)``
    sigma is ever materialized."""
    chunk_size = aux.get("chunk_size")
    obs_indices = _check_obs_indices(aux["obs_indices"], aux["time_grid"])
    params = _on_card(params, log_mh)
    if chunk_size is None or log_mh.shape[0] <= chunk_size:
        return _chunk_epoch_smfs(log_mh, params, aux,
                                 obs_indices).reshape(-1)
    acc = None
    for chunk in _halo_chunks(log_mh, chunk_size):
        part = _remat(_chunk_epoch_smfs, chunk, params, aux, obs_indices)
        acc = part if acc is None else acc + part
    return acc.reshape(-1)


#: Default ``sigma_max`` bound for ``bin_mode="auto"``: the TRUTH
#: scatter (sigma_0 = 0.2) plus the mass-slope excursion over the sampled
#: halo range.
DEFAULT_SIGMA_MAX = 0.32


def make_galhalo_hist_data(num_halos=100_000,
                           comm: Optional[MeshComm] = None,
                           chunk_size: Optional[int] = None,
                           bin_edges=None, volume_per_halo=50.0,
                           n_times: int = 16, obs_indices=(7, 12, 15),
                           bin_mode: str = "dense",
                           bin_window: Optional[int] = None,
                           sigma_max: Optional[float] = None,
                           device=None):
    """The history-model fit's aux_data dict, built on ``device`` (``None``
    means CUDA).

    The target — the SMF at each of the ``obs_indices`` epochs of the
    time grid — is computed at TRUTH on the whole catalog before it is
    sharded, through the same counts the fit will use.
    ``bin_mode="fused"`` takes the windowed counts with ``bin_window``
    edges, derived from ``sigma_max`` when only that is given (see
    :func:`~multigrad_tpu_torch.ops.binned.fused_bin_window`).
    ``bin_mode="auto"`` / ``chunk_size="auto"`` defer to the autotuner's
    tuning table (:mod:`multigrad_tpu_torch.tune`; resolved at model
    construction, the hand-set defaults on a cold table); ``sigma_max``
    bounds the fused window auto may pick (default
    :data:`DEFAULT_SIGMA_MAX`).
    """
    device = resolve_device(device)
    if bin_edges is None:
        bin_edges = torch.linspace(7.0, 11.75, 14)
    bin_edges = torch.as_tensor(bin_edges, dtype=torch.float32,
                                device=device)
    t_grid = default_time_grid(n_times, device=device)
    log_mh = sample_log_halo_masses(num_halos, device=device)
    if bin_mode == "auto" and sigma_max is None:
        sigma_max = DEFAULT_SIGMA_MAX
    if bin_mode in ("auto", "fused") and bin_window is None \
            and sigma_max is not None:
        bin_window = fused_bin_window(bin_edges, float(sigma_max))
    aux = dict(
        bin_edges=bin_edges,
        time_grid=t_grid,
        obs_indices=tuple(int(i) for i in obs_indices),
        volume=volume_per_halo * num_halos,
        chunk_size=chunk_size,
        bin_mode=bin_mode,
        bin_window=bin_window,
    )
    if sigma_max is not None:
        aux["sigma_max"] = float(sigma_max)
    # The target is computed on concrete knobs: "auto" resolves only at
    # model construction, and any bin mode gives the same float32 target.
    target_aux = dict(aux)
    if target_aux["bin_mode"] == "auto":
        target_aux["bin_mode"] = "dense"
    if target_aux["chunk_size"] == "auto":
        target_aux["chunk_size"] = None
    with torch.no_grad():
        aux["target_sumstats"] = _multi_epoch_smf(log_mh, TRUTH, target_aux)
    if comm is not None:
        log_mh = scatter_nd(log_mh, axis=0, comm=comm, pad_value=_PAD_LOGM)
    aux["log_halo_masses"] = log_mh
    return aux


@dataclass
class GalhaloHistModel(OnePointModel):
    """Ten-parameter MAH + SFH fit to the multi-epoch stellar mass
    function: partial sumstats per shard, additive totals, loss from
    totals.  The per-particle scatter widths go through the
    per-particle-sigma erf-CDF kernels."""

    aux_data: dict = field(default_factory=dict)

    def __post_init__(self):
        if isinstance(self.aux_data, dict):
            # "auto" knobs resolve through the autotuner's tuning table
            # once, at construction, before any step runs (cold table:
            # the hand-set defaults).
            from ..tune.resolve import resolve_auto_aux
            self.aux_data = resolve_auto_aux(
                type(self).__name__, self.aux_data, self.comm)
            # Epochs are configuration: keep them a tuple of ints (an
            # array or a 0-d value is normalized).
            oi = self.aux_data.get("obs_indices")
            if oi is not None and not isinstance(oi, torch.fx.Proxy):
                self.aux_data = dict(self.aux_data,
                                     obs_indices=_index_tuple(oi))

    def calc_partial_sumstats_from_params(self, params, randkey=None):
        aux = self.aux_data
        return _multi_epoch_smf(aux["log_halo_masses"], params, aux)

    def calc_loss_from_sumstats(self, sumstats, sumstats_aux=None,
                                randkey=None):
        # Floored log: early-epoch high-mass bins can be empty, and bins
        # empty in both prediction and target then contribute exactly 0.
        target = self.aux_data["target_sumstats"]

        def lg(x):
            return torch.log10(torch.clamp(x, min=1e-12))

        return torch.mean((lg(sumstats) - lg(target)) ** 2)
