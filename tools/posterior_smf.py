#!/usr/bin/env python3
"""The SMF posterior pipeline alone on one card: ``chip_smoke.py``'s
phases 18, 19 and 20, and its phase 21 (the one-process NCCL run).

    python3 tools/posterior_smf.py

Builds the kernels, then runs on ``SMFChi2Model`` at 1e8 halos
``chip_smoke.batched_phase`` (K = 8 rows of the batched loss and gradient
against 8 solo calls, the Latin-hypercube scan), ``chip_smoke
.ensemble_phase`` (8 Adam starts, 200 batched steps), ``chip_smoke
.polish_phase`` (the L-BFGS polish of the two best starts, 60 steps,
evaluations and launches counted), ``chip_smoke.lbfgs_card_phase`` (the
L-BFGS fit card against CPU at 32,768 halos) and ``chip_smoke.hmc_phase``
(card against CPU at 32,768 halos; 4 chains of 50 + 150 draws at 1e8; a
profiler window of 3 leapfrog steps); then phase 5's SMF Adam fit at 1e8
(20 steps, no comm) as the reference of ``chip_smoke.nccl_phase``.  Every
check of theirs holds here too.  Prints the card's name and power limit
and one JSON line of the results; exits non-zero when a check fails or
there is no card.  About 3 minutes on an H100, the build included.
Imports no JAX.
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
    from multigrad_tpu_torch.models import (SMFChi2Model, SMFModel,
                                            make_smf_data)
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
    polish = cs.polish_phase(reset_launches, read_launches, wrappers,
                             model, ensemble["ens"])
    lbfgs_card = cs.lbfgs_card_phase()
    hmc = cs.hmc_phase(reset_launches, read_launches, wrappers, model,
                       ensemble.pop("ens"))
    for key in ("start", "result", "inv_mass"):
        del hmc[key]
    for key in ("rows", "losses", "grads"):
        del batched[key]
    del model
    torch.cuda.empty_cache()
    # Phase 5's fit without a comm, the reference of the NCCL run.
    smf = SMFModel(aux_data=make_smf_data(cs.BIG_HALOS))
    smf.run_adam(guess=cs.GUESS, nsteps=2, learning_rate=0.02,
                 progress=False)  # warm-up
    traj, seconds, _ = cs.counted(
        reset_launches, read_launches, lambda: smf.run_adam(
            guess=cs.GUESS, nsteps=20, learning_rate=0.02, progress=False))
    cs.log(f"SMF, 20 Adam steps at {cs.BIG_HALOS:,} halos without a comm: "
           f"{20 / seconds:.2f} steps/s")
    del smf
    torch.cuda.empty_cache()
    nccl = cs.nccl_phase(reset_launches, read_launches, wrappers,
                         dict(traj=traj, sps=20 / seconds))
    print(smi)
    print(json.dumps({"card": smi, "batched": batched, "ensemble": ensemble,
                      "polish": polish, "lbfgs_card": lbfgs_card,
                      "hmc": hmc, "nccl": nccl,
                      "profiler_windows": {
                          "windows": cs.windows().windows,
                          "retries": cs.windows().retries}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
