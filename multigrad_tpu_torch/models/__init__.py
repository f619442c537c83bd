"""Shipped models (port of :mod:`multigrad_tpu.models`): the SMF, the
static galaxy–halo SHMR and the galaxy–halo history model."""
from .smf import (ParamTuple, SMFChi2Model, SMFModel,  # noqa: F401
                  TARGET_SUMSTATS, aux_from_numpy, load_halo_masses,
                  make_smf_data)
from .galhalo import (GalhaloModel, GalhaloParams,  # noqa: F401
                      make_galhalo_data, mean_logsm,
                      sample_log_halo_masses)
from .galhalo_hist import (GalhaloHistModel,  # noqa: F401
                           GalhaloHistParams, make_galhalo_hist_data,
                           mean_log_mstar, scatter_sigma)
