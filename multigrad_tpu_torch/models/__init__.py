"""Shipped models (port of :mod:`multigrad_tpu.models`): the SMF, the
static galaxy–halo SHMR, the galaxy–halo history model, the wp(rp) and
ξ(r) clustering models and the joint SMF + wp(rp) fit."""
from .smf import (ParamTuple, SMFChi2Model, SMFModel,  # noqa: F401
                  TARGET_SUMSTATS, aux_from_numpy, load_halo_masses,
                  make_smf_data)
from .galhalo import (GalhaloModel, GalhaloParams,  # noqa: F401
                      make_galhalo_data, mean_logsm,
                      sample_log_halo_masses)
from .galhalo_hist import (GalhaloHistModel,  # noqa: F401
                           GalhaloHistParams, make_galhalo_hist_data,
                           mean_log_mstar, scatter_sigma)
from .wprp import (WprpModel, WprpParams, XiModel,  # noqa: F401
                   make_galaxy_mock, make_wprp_data, make_xi_data,
                   selection_weights, shard_catalog)
from .joint import (JOINT_PARAM_NAMES, JOINT_TRUTH,  # noqa: F401
                    make_joint_smf_wprp)
