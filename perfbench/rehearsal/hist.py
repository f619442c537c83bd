"""The history model's rehearsal on the CPU: its sizes, and its ``half``
fault."""
from __future__ import annotations

from perfbench.rehearsal.common import half_aux

#: Configuration keys set anew, small enough for the CPU.
SIZES = {"num_halos": 20_000, "chunk_size": 5_000}


def half():
    """The sumstats over the first half of the halos, the mean taken over
    them (over half the volume)."""
    from multigrad_tpu_torch.models import galhalo_hist

    def hist_half(self, params, randkey=None):
        aux = half_aux(self.aux_data, "log_halo_masses")
        return galhalo_hist._multi_epoch_smf(aux["log_halo_masses"], params,
                                             aux)
    galhalo_hist.GalhaloHistModel.calc_partial_sumstats_from_params = \
        hist_half
