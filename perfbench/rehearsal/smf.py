"""The SMF model's rehearsal on the CPU: its sizes, and its ``half``
fault."""
from __future__ import annotations

from perfbench.rehearsal.common import half_aux

#: Configuration keys set anew, small enough for the CPU.
SIZES = {"num_halos": 20_000}


def half():
    """The sumstats over the first half of the halos, the mean taken over
    them (over half the volume)."""
    from multigrad_tpu_torch.models import smf
    real = smf.SMFModel.calc_partial_sumstats_from_params

    def smf_half(self, params, randkey=None):
        full = self.aux_data
        self.aux_data = half_aux(full, "log_halo_masses")
        try:
            return real(self, params, randkey)
        finally:
            self.aux_data = full
    smf.SMFModel.calc_partial_sumstats_from_params = smf_half
