"""The port's SMF model (``multigrad_tpu_torch.models.SMFModel``) built
from a configuration and a seed.

The catalog is the benchmark's: ``num_halos`` halo masses drawn on the
device from the truncated power law ``dn/dM ∝ M^slope`` above ``mmin``,
``M = mmin (1 - q)^(1/(slope + 1))`` with ``q ~ U(0, qmax)`` from the
seed, in float32, in ascending order as the source's grid of ``q`` is
(so that a run that leaves out a contiguous part of the catalog leaves
out a range of masses, and shows).  The target is the program's own sumstats at the
truth (the reference works its own out again)."""
from __future__ import annotations

import math
from types import SimpleNamespace

from perfbench.programs.common import generator, inputs_made


def catalog(config: dict, seed: int, device):
    import torch
    hm = config["halo_mass"]
    q = torch.rand(config["num_halos"], generator=generator(seed, device),
                   device=device, dtype=torch.float32).sort().values \
        * hm["qmax"]
    return math.log10(hm["mmin"]) + torch.log10(1 - q) / (hm["slope"] + 1)


def build(config: dict, seed: int, device):
    import torch
    from multigrad_tpu_torch.models import SMFModel
    log_mh = catalog(config, seed, device)
    inputs_made(device)
    e = config["bin_edges"]
    aux = dict(
        log_halo_masses=log_mh,
        smf_bin_edges=torch.linspace(e["low"], e["high"], e["count"],
                                     dtype=torch.float32, device=device),
        volume=config["volume_per_halo"] * config["num_halos"],
        target_sumstats=torch.ones(e["count"] - 1, dtype=torch.float32,
                                   device=device),
        chunk_size=config.get("chunk_size"), bin_mode=config["bin_mode"],
        bin_window=None)
    truth = torch.tensor(config["truth"], dtype=torch.float32,
                         device=device)
    target = SMFModel(aux_data=dict(aux)).calc_sumstats_from_params(truth)
    model = SMFModel(aux_data=dict(aux, target_sumstats=target))
    return SimpleNamespace(model=model, truth=list(config["truth"]),
                           inputs={"log_halo_masses": log_mh})
