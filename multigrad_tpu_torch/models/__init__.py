"""Shipped models (port of :mod:`multigrad_tpu.models`, SMF so far)."""
from .smf import (ParamTuple, SMFChi2Model, SMFModel,  # noqa: F401
                  TARGET_SUMSTATS, aux_from_numpy, load_halo_masses,
                  make_smf_data)
