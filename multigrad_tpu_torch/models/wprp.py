"""Two-point clustering models (port of :mod:`multigrad_tpu.models.wprp`).

A galaxy-selection model over a fixed halo catalog: the parameters set
each halo's selection weight (a smooth sigmoid cut in stellar mass); the
sumstats are the weighted DD pair counts in separation bins plus the total
selected weight, all additive over processes; the loss compares the
derived wp(rp) (:class:`WprpModel`) or ξ(r) (:class:`XiModel`) to a target.
Gradients flow through the weights, the pair-count kernels
(:mod:`multigrad_tpu_torch.ops.pair_kernels`) and, across processes, the
reverse ring (:mod:`multigrad_tpu_torch.ops.pairwise`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.model import OnePointModel
from ..ops.pairwise import (ring_weighted_pair_counts, wp_from_counts,
                            xi_from_counts)
from ..parallel.collectives import scatter_nd
from ..parallel.mesh import MeshComm
from ..utils.util import resolve_device


class WprpParams(NamedTuple):
    """log stellar-to-halo-mass ratio + log selection softness (the cut's
    transition width; a cut location would be degenerate with
    ``log_shmrat``)."""
    log_shmrat: float = -2.0
    log_softness: float = -1.0


TRUTH = WprpParams()
LOGSM_CUT = 8.6


def make_galaxy_mock(num_halos=2048, box_size=100.0, seed=0,
                     satellites_per_parent=4, sat_sigma=1.5, device=None):
    """Clustered mock, ``(positions (N, 3), log_mass (N,))`` float32 on
    ``device`` (``None`` means CUDA): uniform parents and Gaussian
    satellite clouds around them (wrapped into the box), satellites with
    lower halo masses, so raising the stellar-mass cut removes satellites
    first and suppresses the small-scale signal.

    Drawn from a ``torch.Generator`` seeded with ``seed`` on the device.
    The construction is the JAX package's, but the draws are not
    ``jax.random``'s: the two mocks match in distribution only.
    """
    device = resolve_device(device)
    n_parents = max(1, num_halos // (1 + satellites_per_parent))
    n_sats = num_halos - n_parents
    gen = torch.Generator(device=device).manual_seed(int(seed))
    f32 = dict(dtype=torch.float32, device=device)

    parent_pos = torch.rand((n_parents, 3), generator=gen, **f32) * box_size
    host = torch.arange(n_sats, device=device) % n_parents
    offsets = torch.randn((n_sats, 3), generator=gen, **f32) * sat_sigma
    sat_pos = (parent_pos[host] + offsets) % box_size

    # Parents: truncated power law in [1e10.5, 1e12); satellites: [1e10, 1e11)
    q = torch.linspace(0.0, 0.95, n_parents, **f32)
    parent_logm = 10.5 + 1.5 * (1 - (1 - q) ** 2)
    sat_logm = 10.0 + torch.rand(n_sats, generator=gen, **f32)
    return (torch.cat([parent_pos, sat_pos]),
            torch.cat([parent_logm, sat_logm]))


def selection_weights(log_mass, params):
    """``sigmoid((log M_h + log_shmrat − LOGSM_CUT) / 10**log_softness)``,
    differentiable in both parameters."""
    p = WprpParams(*params)
    logsm = log_mass + p.log_shmrat
    return torch.sigmoid((logsm - LOGSM_CUT) / 10.0 ** p.log_softness)


def shard_catalog(positions, log_mass, comm: Optional[MeshComm]):
    """This process's shard of a ``(positions, log_mass)`` catalog,
    ``(positions, log_mass)``; the whole catalog for ``comm`` None.

    Ragged catalogs are padded with positions 0 and log mass −1e9, whose
    weight is exactly 0 with gradient 0 (a −inf mass would give a
    sigmoid argument of −inf and a NaN gradient, 0·inf).
    """
    if comm is None:
        return positions, log_mass
    return (scatter_nd(positions, axis=0, comm=comm, pad_value=0.0),
            scatter_nd(log_mass, axis=0, comm=comm, pad_value=-1e9))


def _truth_weights(log_mass):
    # The same float32 parameter tensor the model evaluates at TRUTH.
    return selection_weights(log_mass, torch.tensor(
        np.asarray(TRUTH, np.float32), device=log_mass.device))


def make_wprp_data(num_halos=2048, box_size=100.0, pimax=20.0,
                   comm: Optional[MeshComm] = None, rp_bin_edges=None,
                   row_chunk: Optional[int] = None, seed=0, device=None):
    """The wp(rp) fit's aux_data dict, built on ``device`` (``None`` means
    CUDA).

    The target wp is computed at TRUTH over the whole catalog (one block)
    before sharding, by the same kernel on the same device as the model
    uses, so that the loss at TRUTH is 0.  Default bins: 8 in r_p on
    ``logspace(-0.5, 1.2, 9)``.
    """
    device = resolve_device(device)
    if rp_bin_edges is None:
        rp_bin_edges = np.logspace(-0.5, 1.2, 9)
    rp_bin_edges = torch.as_tensor(np.asarray(rp_bin_edges, np.float32),
                                   device=device)
    positions, log_mass = make_galaxy_mock(num_halos, box_size, seed=seed,
                                           device=device)
    with torch.no_grad():
        w_truth = _truth_weights(log_mass)
        dd = ring_weighted_pair_counts(positions, w_truth, rp_bin_edges,
                                       box_size=box_size, pimax=pimax,
                                       row_chunk=row_chunk)
        target_wp = wp_from_counts(dd, torch.sum(w_truth), rp_bin_edges,
                                   pimax, box_size ** 3)
    positions, log_mass = shard_catalog(positions, log_mass, comm)
    return dict(positions=positions, log_mass=log_mass,
                rp_bin_edges=rp_bin_edges, pimax=pimax, box_size=box_size,
                target_wp=target_wp, row_chunk=row_chunk)


@dataclass
class WprpModel(OnePointModel):
    """wp(rp) clustering fit over a ring-sharded halo catalog.

    Sumstats layout: ``[DD_0 … DD_{B-1}, W]``, the per-bin weighted DD
    partial counts plus this process's selected weight.  The ring runs
    over the model's ``comm``.
    """

    aux_data: dict = field(default_factory=dict)

    def calc_partial_sumstats_from_params(self, params, randkey=None):
        aux = self.aux_data
        # Padded halos (log mass -1e9) weigh exactly 0, forward and back.
        w = selection_weights(aux["log_mass"], params)
        dd = ring_weighted_pair_counts(
            aux["positions"], w, aux["rp_bin_edges"], comm=self.comm,
            box_size=aux["box_size"], pimax=aux["pimax"],
            row_chunk=aux.get("row_chunk"))
        return torch.cat([dd, torch.sum(w)[None]])

    def calc_loss_from_sumstats(self, sumstats, sumstats_aux=None,
                                randkey=None):
        aux = self.aux_data
        dd, w_tot = sumstats[:-1], sumstats[-1]
        wp = wp_from_counts(dd, w_tot, aux["rp_bin_edges"], aux["pimax"],
                            aux["box_size"] ** 3)
        target = aux["target_wp"]
        return torch.mean((wp - target) ** 2) / torch.mean(target ** 2)


@dataclass
class XiModel(OnePointModel):
    """3D two-point correlation fit: the selection model of
    :class:`WprpModel` with 3D separation bins (no line-of-sight cut); the
    loss compares ξ(r) from the analytic-RR natural estimator to a
    target."""

    aux_data: dict = field(default_factory=dict)

    def calc_partial_sumstats_from_params(self, params, randkey=None):
        aux = self.aux_data
        w = selection_weights(aux["log_mass"], params)
        dd = ring_weighted_pair_counts(
            aux["positions"], w, aux["bin_edges"], comm=self.comm,
            box_size=aux["box_size"], row_chunk=aux.get("row_chunk"))
        return torch.cat([dd, torch.sum(w)[None]])

    def calc_loss_from_sumstats(self, sumstats, sumstats_aux=None,
                                randkey=None):
        aux = self.aux_data
        dd, w_tot = sumstats[:-1], sumstats[-1]
        xi = xi_from_counts(dd, w_tot, aux["bin_edges"],
                            aux["box_size"] ** 3)
        target = aux["target_xi"]
        return torch.mean((xi - target) ** 2 / (1.0 + target ** 2))


def make_xi_data(num_halos=2048, box_size=75.0,
                 comm: Optional[MeshComm] = None, bin_edges=None, seed=0,
                 device=None):
    """The ξ(r) fit's aux_data dict on ``device`` (``None`` means CUDA),
    the target at TRUTH computed over the whole catalog before sharding,
    as :func:`make_wprp_data` does.  Default bins: 7 in r on
    ``logspace(-0.3, 1.1, 8)``."""
    device = resolve_device(device)
    if bin_edges is None:
        bin_edges = np.logspace(-0.3, 1.1, 8)
    bin_edges = torch.as_tensor(np.asarray(bin_edges, np.float32),
                                device=device)
    positions, log_mass = make_galaxy_mock(num_halos, box_size, seed=seed,
                                           device=device)
    with torch.no_grad():
        w_truth = _truth_weights(log_mass)
        dd = ring_weighted_pair_counts(positions, w_truth, bin_edges,
                                       box_size=box_size)
        target_xi = xi_from_counts(dd, torch.sum(w_truth), bin_edges,
                                   box_size ** 3)
    positions, log_mass = shard_catalog(positions, log_mass, comm)
    return dict(positions=positions, log_mass=log_mass, bin_edges=bin_edges,
                box_size=box_size, target_xi=target_xi)
