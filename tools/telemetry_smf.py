#!/usr/bin/env python3
"""The fits' telemetry alone on one card: ``chip_smoke.py``'s phase 22.

    python3 tools/telemetry_smf.py

Builds the kernels, runs phase 5's SMF fit at 1e8 halos (20 Adam steps
after a warm-up, and its 5-step profiler window: the reference of the
device time a step), brings up the one-process NCCL group of phase 21
and runs the same fit under it (bit-equal), then
``chip_smoke.monitored_smf_phase`` under that group (the monitored fit,
the steps alone monitored against plain in turns, the profiler windows
with and without monitoring, the NaN trips card against CPU); then, on
``SMFChi2Model`` at 1e8, HMC from the truth scattered by the Laplace
errors (4 chains, 8 leapfrog steps, 50 + 100 draws) plain and through
``chip_smoke.tapped_hmc_phase``, and ``chip_smoke.tapped_streamed_phase``.
Every check of theirs holds here too.  Prints the card's name and power
limit and one JSON line of the results; exits non-zero when a check
fails or there is no card.  About two minutes on an H100, the build
included.  Imports no JAX.
"""
import json
import os
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch
    if not torch.cuda.is_available():
        print("telemetry_smf: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import torch.distributed as dist

    import chip_smoke as cs
    from multigrad_tpu_torch import global_comm
    from multigrad_tpu_torch.inference import fisher_information, run_hmc
    from multigrad_tpu_torch.models import (SMFChi2Model, SMFModel,
                                            make_smf_data)
    from multigrad_tpu_torch.ops import cuda_build
    from multigrad_tpu_torch.ops import erf_kernels as ek
    from multigrad_tpu_torch.parallel import distributed
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

    def fit(model):
        model.run_adam(guess=cs.GUESS, nsteps=2, learning_rate=0.02,
                       progress=False)  # warm-up
        traj, seconds, _ = cs.counted(
            reset_launches, read_launches, lambda: model.run_adam(
                guess=cs.GUESS, nsteps=20, learning_rate=0.02,
                progress=False))
        return traj, 20 / seconds

    model = SMFModel(aux_data=make_smf_data(cs.BIG_HALOS))
    ref, sps = fit(model)
    busy_us = sum(us for us, _ in cs.profile_steps(model, 5).values()) / 5
    del model
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    distributed.initialize()
    try:
        comm = global_comm()
        model = SMFModel(aux_data=make_smf_data(cs.BIG_HALOS, comm=comm),
                         comm=comm)
        traj, nccl_sps = fit(model)
        cs.check(torch.equal(traj, ref), "the NCCL fit differs")
        monitored = cs.monitored_smf_phase(
            reset_launches, read_launches, wrappers, model, traj,
            dict(sps=sps, nccl_sps=nccl_sps), busy_us)
        del model
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    posterior = SMFChi2Model(aux_data=make_smf_data(cs.BIG_HALOS))
    laplace = fisher_information(posterior, cs.TRUTH).stderr()
    gen = torch.Generator(device="cuda").manual_seed(1)
    init = torch.tensor(cs.TRUTH, device="cuda") + laplace * torch.randn(
        (cs.HMC_CHAINS, 2), generator=gen, device="cuda")
    kw = dict(step_size=cs.HMC_STEP, num_leapfrog=cs.HMC_LEAPFROG,
              inv_mass=laplace ** 2, randkey=2)
    run_hmc(posterior, init, num_samples=1, num_warmup=1, **kw)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_hmc(posterior, init, num_samples=cs.TAPPED_SAMPLES,
            num_warmup=cs.HMC_WARMUP, **kw)
    plain_dps = (cs.HMC_WARMUP + cs.TAPPED_SAMPLES) / (
        time.perf_counter() - t0)
    hmc = cs.tapped_hmc_phase(posterior, (init, kw), plain_dps)
    del posterior
    torch.cuda.empty_cache()
    stream = cs.tapped_streamed_phase()
    print(smi)
    print(json.dumps({"card": smi, "smf_sps": sps, "nccl_sps": nccl_sps,
                      "busy_us": busy_us, "monitored": monitored,
                      "hmc_plain_dps": plain_dps, "hmc": hmc,
                      "stream": stream,
                      "profiler_windows": {
                          "windows": cs.windows().windows,
                          "retries": cs.windows().retries}}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
