"""Stellar-mass-function model (port of :mod:`multigrad_tpu.models.smf`).

A two-parameter galaxy–halo model (log stellar-to-halo-mass ratio and
scatter) fit to a 10-bin stellar mass function, distributed over the
halo axis.  The sumstats are the erf-CDF counts of
:mod:`multigrad_tpu_torch.ops.binned`, dense or fused (scalar sigma).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.model import OnePointModel
from ..ops.binned import binned_density, fused_bin_window
from ..parallel.collectives import scatter_nd
from ..parallel.mesh import MeshComm
from ..utils.util import resolve_device

#: Default ``sigma_max`` bound for ``bin_mode="auto"`` (the largest scatter
#: the canonical SMF fits reach); override per fit from ``param_bounds``.
DEFAULT_SIGMA_MAX = 0.6

# SMF target at truth params (-2.0, 0.2): the reference's golden
# regression fixture (the JAX package's TARGET_SUMSTATS).
TARGET_SUMSTATS = np.array([
    2.30178721e-02, 1.69728529e-02, 1.16054425e-02, 7.10532581e-03,
    3.77187086e-03, 1.69136131e-03, 6.28149020e-04, 1.90466686e-04,
    4.66692982e-05, 9.17260695e-06])


class ParamTuple(NamedTuple):
    """Parity: ``smf_grad_descent.py:17-19`` of the reference."""
    log_shmrat: float = -2.0
    sigma_logsm: float = 0.2


def load_halo_masses(num_halos=10_000, slope=-2, mmin=10.0 ** 10,
                     qmax=0.95, device=None):
    """Truncated power-law halo mass sample, one global float32 tensor
    built on ``device`` (``None`` means CUDA)."""
    q = torch.linspace(0, qmax, num_halos, dtype=torch.float32,
                       device=resolve_device(device))
    return mmin * (1 - q) ** (1 / (slope + 1))


def make_smf_data(num_halos=10_000, comm: Optional[MeshComm] = None,
                  chunk_size: Optional[int] = None, bin_mode: str = "dense",
                  bin_window: Optional[int] = None,
                  sigma_max: Optional[float] = None, device=None):
    """The SMF fit's aux_data dict, built on ``device`` (``None`` means
    CUDA).  With a ``comm`` the halo masses are padded with ``inf``
    (neutral for the erf counts) to shard evenly, and this process keeps
    its shard.  ``chunk_size`` bounds the dense plain (CPU) path's
    memory.  ``bin_mode="fused"`` takes the windowed counts with
    ``bin_window`` edges, derived from ``sigma_max`` when only that is
    given (see :func:`~multigrad_tpu_torch.ops.binned.fused_bin_window`).
    ``bin_mode="auto"`` defers the choice to the autotuner's tuning table
    (:mod:`multigrad_tpu_torch.tune`; resolved at model construction,
    dense on a cold table); ``sigma_max`` bounds the fused window it may
    pick (default :data:`DEFAULT_SIGMA_MAX`).  ``chunk_size="auto"``
    resolves the same way (``None`` cold)."""
    device = resolve_device(device)
    log_mh = torch.log10(load_halo_masses(num_halos, device=device))
    if comm is not None:
        log_mh = scatter_nd(log_mh, axis=0, comm=comm, pad_value=np.inf)
    edges = torch.linspace(9, 10, 11, dtype=torch.float32, device=device)
    if bin_mode == "auto" and sigma_max is None:
        sigma_max = DEFAULT_SIGMA_MAX
    if bin_mode in ("auto", "fused") and bin_window is None \
            and sigma_max is not None:
        bin_window = fused_bin_window(edges, float(sigma_max))
    out = dict(
        log_halo_masses=log_mh,
        smf_bin_edges=edges,
        volume=10.0 * num_halos,  # Mpc^3/h^3
        target_sumstats=torch.as_tensor(TARGET_SUMSTATS, dtype=torch.float32,
                                        device=device),
        chunk_size=chunk_size,
        bin_mode=bin_mode,
        bin_window=bin_window,
    )
    if sigma_max is not None:
        out["sigma_max"] = float(sigma_max)
    return out


def aux_from_numpy(aux: dict, device=None) -> dict:
    """A JAX package data dict (``make_smf_data``, ``make_galhalo_data``,
    ``make_galhalo_hist_data``, ``make_wprp_data``, ``make_xi_data``), its
    array leaves turned into numpy arrays, as the port's dict of tensors
    on ``device`` (``None`` means CUDA), so both packages compute on
    identical inputs.

    Arrays keep their dtype; ``obs_indices`` stays a tuple of ints (epochs
    are configuration); other Python values are kept as they are.  The
    JAX-only ``backend`` knob is dropped (in the port the device decides),
    and so is ``ring_axis`` (in the port the model's comm decides).
    """
    device = resolve_device(device)
    out = {}
    for name, value in aux.items():
        if name in ("backend", "ring_axis"):
            continue
        if name == "obs_indices":
            value = tuple(int(i) for i in np.atleast_1d(value))
        elif isinstance(value, np.ndarray):
            value = torch.tensor(value, device=device)
        out[name] = value
    return out


@dataclass
class SMFModel(OnePointModel):
    """Two-parameter SMF model (parity: ``smf_grad_descent.py:52-82``)."""

    aux_data: dict = field(default_factory=dict)

    #: ``chunk_size`` bounds the plain versions' memory on the CPU only;
    #: the CUDA kernels stream any N, so the tuner enumerates no chunk
    #: candidates for this model on the card.
    chunks_on_card = False

    def __post_init__(self):
        # "auto" knobs (bin_mode / chunk_size) resolve through the
        # autotuner's tuning table ONCE, here, before any step runs; a
        # cold table resolves to the hand-set defaults.
        if isinstance(self.aux_data, dict):
            from ..tune.resolve import resolve_auto_aux
            self.aux_data = resolve_auto_aux(
                type(self).__name__, self.aux_data, self.comm)

    def calc_partial_sumstats_from_params(self, params, randkey=None):
        """SMF of this shard's halos — totals sum over shards."""
        params = ParamTuple(*params)
        mean_logsm = self.aux_data["log_halo_masses"] + params.log_shmrat
        return binned_density(mean_logsm, self.aux_data["smf_bin_edges"],
                              params.sigma_logsm, self.aux_data["volume"],
                              chunk_size=self.aux_data.get("chunk_size"),
                              bin_mode=self.aux_data.get("bin_mode",
                                                         "dense"),
                              bin_window=self.aux_data.get("bin_window"))

    def calc_loss_from_sumstats(self, sumstats, sumstats_aux=None,
                                randkey=None):
        """MSE in log10 space (parity: ``smf_grad_descent.py:78-82``)."""
        target = torch.log10(self.aux_data["target_sumstats"])
        return torch.mean((torch.log10(sumstats) - target) ** 2)


@dataclass
class SMFChi2Model(SMFModel):
    """SMF model with a Gaussian (½ χ²) likelihood:
    ``loss = ½ Σ_b ((y_b - t_b) / σ_b)²`` with ``σ_b = sigma_frac · t_b``
    (``aux_data["sigma_frac"]``, default 5%)."""

    def calc_loss_from_sumstats(self, sumstats, sumstats_aux=None,
                                randkey=None):
        target = self.aux_data["target_sumstats"]
        sigma = self.aux_data.get("sigma_frac", 0.05) * target
        return 0.5 * torch.sum(((sumstats - target) / sigma) ** 2)
