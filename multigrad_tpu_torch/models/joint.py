"""Joint SMF + wp(rp) likelihood (port of :mod:`multigrad_tpu.models.joint`).

An abundance probe (the SMF's erf-CDF binned counts) and a clustering
probe (wp(rp)'s pair counts) each reduce to a per-shard partial sum, so
their joint likelihood is one fused :class:`~multigrad_tpu_torch.core
.group.OnePointGroup` over one shared comm:

* :class:`~multigrad_tpu_torch.models.smf.SMFChi2Model` reads joint slots
  ``(log_shmrat, sigma_logsm)``;
* :class:`~multigrad_tpu_torch.models.wprp.WprpModel` reads joint slots
  ``(log_shmrat, log_softness)``.

Both probes share the halo catalog's ``log_shmrat`` truth (-2.0), so the
joint posterior is a multi-probe constraint, not two fits side by side.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch.distributed as dist

from ..core.group import OnePointGroup, param_view
from ..parallel.mesh import global_comm
from .smf import SMFChi2Model, make_smf_data
from .wprp import WprpModel, make_wprp_data

__all__ = ["JOINT_PARAM_NAMES", "JOINT_TRUTH", "make_joint_smf_wprp"]

#: Joint parameter vector layout.
JOINT_PARAM_NAMES = ("log_shmrat", "sigma_logsm", "log_softness")

#: Truth values of the joint vector (SMF truth + wp(rp) truth; the shared
#: slot agrees by construction).
JOINT_TRUTH = np.array([-2.0, 0.2, -1.0])


def _joint_group(smf_aux, wprp_aux, comm=None) -> OnePointGroup:
    """The joint group over given data dicts."""
    return OnePointGroup(models=(
        param_view(SMFChi2Model(aux_data=smf_aux, comm=comm),
                   (0, 1)),                  # (log_shmrat, sigma_logsm)
        param_view(WprpModel(aux_data=wprp_aux, comm=comm),
                   (0, 2)),                  # (log_shmrat, log_softness)
    ))


def make_joint_smf_wprp(num_halos: int = 2048,
                        smf_num_halos: Optional[int] = None,
                        comm="auto", seed: int = 0,
                        smf_kwargs: Optional[dict] = None,
                        wprp_kwargs: Optional[dict] = None,
                        device=None) -> OnePointGroup:
    """Build the fused joint SMF + wp(rp) group on one shared comm.

    Parameters
    ----------
    num_halos : int
        wp(rp) mock size (pair counting is O(N²)).
    smf_num_halos : int, optional
        SMF halo sample size (default ``4 * num_halos``: the SMF kernel
        is O(N)).
    comm : MeshComm | None | "auto"
        The shared comm.  ``"auto"``: the world comm when
        ``torch.distributed`` is initialised with more than one rank, else
        ``None``.
    seed : int
        wp(rp) mock seed.
    smf_kwargs, wprp_kwargs : dict, optional
        Extra keyword arguments of :func:`~multigrad_tpu_torch.models.smf
        .make_smf_data` / :func:`~multigrad_tpu_torch.models.wprp
        .make_wprp_data`.
    device : optional
        Where the data lives (``None`` means CUDA).
    """
    if comm == "auto":
        comm = global_comm() if (dist.is_available() and dist.is_initialized()
                                 and dist.get_world_size() > 1) else None
    smf_n = int(smf_num_halos) if smf_num_halos is not None \
        else 4 * int(num_halos)
    smf_aux = make_smf_data(smf_n, comm=comm, device=device,
                            **(smf_kwargs or {}))
    wprp_aux = make_wprp_data(int(num_halos), comm=comm, seed=seed,
                              device=device, **(wprp_kwargs or {}))
    return _joint_group(smf_aux, wprp_aux, comm)
