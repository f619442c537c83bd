#!/usr/bin/env python3
"""The SMF posterior pipeline alone on one card: ``chip_smoke.py``'s
phases 18, 19 and 20.

    python3 tools/posterior_smf.py

Builds the kernels, then runs on ``SMFChi2Model`` at 1e8 halos
``chip_smoke.batched_phase`` (K = 8 rows of the batched loss and gradient
against 8 solo calls, the Latin-hypercube scan), ``chip_smoke
.ensemble_phase`` (8 Adam starts, 200 batched steps) and ``chip_smoke
.hmc_phase`` (card against CPU at 32,768 halos; 4 chains of 50 + 150
draws at 1e8; a profiler window of 3 leapfrog steps); every check of
theirs holds here too.  Prints the card's name and power limit and one
JSON line of the results; exits non-zero when a check fails or there is
no card.  About 2 minutes on an H100, the build included.  Imports no
JAX.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch
    if not torch.cuda.is_available():
        print("posterior_smf: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from multigrad_tpu_torch.models import SMFChi2Model, make_smf_data
    from multigrad_tpu_torch.ops import cuda_build
    from multigrad_tpu_torch.ops import erf_kernels as ek
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    cs.log(f"card: {smi}")
    t0 = time.perf_counter()
    cuda_build.build()
    cs.log(f"built in {time.perf_counter() - t0:.1f} s")
    wrappers = {"erf_counts_fwd": ek.erf_counts_fwd_cuda,
                "erf_counts_bwd": ek.erf_counts_bwd_cuda}

    def reset_launches():
        for fn in wrappers.values():
            fn.launches = 0

    def read_launches():
        return {name: fn.launches for name, fn in wrappers.items()}

    model = SMFChi2Model(aux_data=make_smf_data(cs.BIG_HALOS))
    batched = cs.batched_phase(reset_launches, read_launches, wrappers,
                               model)
    ensemble = cs.ensemble_phase(reset_launches, read_launches, wrappers,
                                 model)
    hmc = cs.hmc_phase(reset_launches, read_launches, wrappers, model,
                       ensemble.pop("ens"))
    print(smi)
    print(json.dumps({"card": smi, "batched": batched, "ensemble": ensemble,
                      "hmc": hmc, "profiler_windows": cs.WINDOWS}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
