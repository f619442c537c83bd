"""The port's history model (``multigrad_tpu_torch.models
.GalhaloHistModel``) built from a configuration and a seed.

The catalog is the benchmark's: ``num_halos`` halo masses drawn on the
device from ``dn/dM ∝ M^slope`` over ``[10^logmh_min, 10^logmh_max)`` by
the inverse CDF of ``q ~ U(0, 1)`` from the seed, in float32, in
ascending order as the source's grid of ``q`` is.  The
target is the program's own sumstats at the truth (the reference works
its own out again)."""
from __future__ import annotations

from types import SimpleNamespace

from perfbench.programs.common import generator, inputs_made


def catalog(config: dict, seed: int, device):
    import torch
    hm = config["halo_mass"]
    q = torch.rand(config["num_halos"], generator=generator(seed, device),
                   device=device, dtype=torch.float32).sort().values
    a = hm["slope"] + 1.0
    lo, hi = 10.0 ** (hm["logmh_min"] * a), 10.0 ** (hm["logmh_max"] * a)
    return torch.log10(lo + q * (hi - lo)) / a


def build(config: dict, seed: int, device):
    import torch
    from multigrad_tpu_torch.models import GalhaloHistModel
    from multigrad_tpu_torch.models.galhalo_hist import default_time_grid
    log_mh = catalog(config, seed, device)
    inputs_made(device)
    e = config["bin_edges"]
    k = len(config["obs_indices"])
    aux = dict(
        log_halo_masses=log_mh,
        bin_edges=torch.linspace(e["low"], e["high"], e["count"],
                                 dtype=torch.float32, device=device),
        time_grid=default_time_grid(config["n_times"], device=device),
        obs_indices=tuple(config["obs_indices"]),
        volume=config["volume_per_halo"] * config["num_halos"],
        target_sumstats=torch.ones(k * (e["count"] - 1),
                                   dtype=torch.float32, device=device),
        chunk_size=config["chunk_size"], bin_mode=config["bin_mode"],
        bin_window=None)
    truth = torch.tensor(config["truth"], dtype=torch.float32,
                         device=device)
    target = GalhaloHistModel(aux_data=dict(aux)) \
        .calc_sumstats_from_params(truth)
    model = GalhaloHistModel(aux_data=dict(aux, target_sumstats=target))
    return SimpleNamespace(model=model, truth=list(config["truth"]),
                           inputs={"log_halo_masses": log_mh})
