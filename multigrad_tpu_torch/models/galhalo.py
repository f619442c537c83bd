"""Galaxy–halo model family: smooth SHMR + scatter, fit to the SMF (port
of :mod:`multigrad_tpu.models.galhalo`).

The stellar-to-halo-mass relation is a smoothly broken double power law
whose local slope rolls from ``alpha_lo`` to ``alpha_hi`` through a
sigmoid at ``logmh_crit``; it integrates to a closed form with a
softplus:

    logsm(x) = logsm_crit + α_lo·x + (α_hi − α_lo)/k · (softplus(k·x)
               − softplus(0)),      x = log Mh − log Mh_crit

Log-normal scatter ``sigma_logsm`` enters the binned SMF analytically
through the dense erf-CDF counts (scalar sigma).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..core.model import OnePointModel
from ..ops.binned import binned_density
from ..parallel.collectives import scatter_nd
from ..parallel.mesh import MeshComm
from ..utils.util import resolve_device

_SLOPE_K = 2.0  # fixed sigmoid sharpness of the slope transition
_SOFTPLUS0 = math.log(2.0)
#: Pad sentinel on the halo-mass axis: a large finite mass whose mean
#: log M* lies beyond every bin edge (zero count and zero gradient),
#: where ``inf`` would give ``inf - inf = NaN`` in :func:`mean_logsm`.
PAD_LOGM = 1e9


class GalhaloParams(NamedTuple):
    """Five-parameter smooth SHMR + scatter."""
    logsm_crit: float = 10.5    # log M* at the critical halo mass
    logmh_crit: float = 12.5    # log Mh of the slope transition
    alpha_lo: float = 2.0       # faint-end slope (steep)
    alpha_hi: float = 0.5       # bright-end slope (shallow)
    sigma_logsm: float = 0.2    # log-normal scatter in log M*


TRUTH = GalhaloParams()


def mean_logsm(log_mh, params):
    """Mean log stellar mass of a halo of mass ``log_mh`` (see the module
    docstring for the closed form)."""
    p = GalhaloParams(*params)
    x = torch.as_tensor(log_mh) - p.logmh_crit
    dalpha = p.alpha_hi - p.alpha_lo
    return (p.logsm_crit + p.alpha_lo * x
            + dalpha / _SLOPE_K * (F.softplus(_SLOPE_K * x) - _SOFTPLUS0))


def sample_log_halo_masses(num_halos=100_000, logmh_min=11.0,
                           logmh_max=15.0, slope=-1.5, device=None):
    """Deterministic power-law halo mass function sample, float32 on
    ``device`` (``None`` means CUDA).

    Inverse-CDF of ``dn/dM ∝ M^slope`` over ``[10^logmh_min,
    10^logmh_max)`` on a uniform grid, ``q_i = i / num_halos``.
    """
    q = torch.arange(num_halos, dtype=torch.float32,
                     device=resolve_device(device)) * (1.0 / num_halos)
    a = slope + 1.0
    m_lo, m_hi = 10.0 ** logmh_min, 10.0 ** logmh_max
    masses = (m_lo ** a + q * (m_hi ** a - m_lo ** a)) ** (1.0 / a)
    return torch.log10(masses)


def make_galhalo_data(num_halos=100_000, comm: Optional[MeshComm] = None,
                      chunk_size: Optional[int] = None, bin_edges=None,
                      volume_per_halo=50.0, device=None):
    """The galaxy–halo fit's aux_data dict, built on ``device`` (``None``
    means CUDA).

    The target SMF is computed at TRUTH on the whole catalog before it is
    sharded; with a ``comm`` the masses are padded with :data:`PAD_LOGM`
    to shard evenly and this process keeps its shard.
    """
    device = resolve_device(device)
    if bin_edges is None:
        bin_edges = torch.linspace(9.0, 12.0, 13)
    bin_edges = torch.as_tensor(bin_edges, dtype=torch.float32,
                                device=device)
    log_mh = sample_log_halo_masses(num_halos, device=device)
    volume = volume_per_halo * num_halos
    target = binned_density(mean_logsm(log_mh, TRUTH), bin_edges,
                            TRUTH.sigma_logsm, volume,
                            chunk_size=chunk_size)
    if comm is not None:
        log_mh = scatter_nd(log_mh, axis=0, comm=comm, pad_value=PAD_LOGM)
    return dict(
        log_halo_masses=log_mh,
        bin_edges=bin_edges,
        volume=volume,
        target_sumstats=target,
        chunk_size=chunk_size,
    )


@dataclass
class GalhaloModel(OnePointModel):
    """Five-parameter SHMR fit to the stellar mass function: one pass of
    the dense erf-CDF counts per shard, totals by all-reduce."""

    aux_data: dict = field(default_factory=dict)

    def calc_partial_sumstats_from_params(self, params, randkey=None):
        aux = self.aux_data
        p = GalhaloParams(*params)
        logsm = mean_logsm(aux["log_halo_masses"], p)
        return binned_density(logsm, aux["bin_edges"], p.sigma_logsm,
                              aux["volume"],
                              chunk_size=aux.get("chunk_size"))

    def calc_loss_from_sumstats(self, sumstats, sumstats_aux=None,
                                randkey=None):
        target = self.aux_data["target_sumstats"]
        return torch.mean((torch.log10(sumstats) - torch.log10(target)) ** 2)
