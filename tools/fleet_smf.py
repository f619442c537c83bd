#!/usr/bin/env python3
"""The fleet alone on one card: ``chip_smoke.py``'s phase 24 (and, with
``--job``, phase 25 after it).

    python3 tools/fleet_smf.py               # phase 24 on the card
    python3 tools/fleet_smf.py --job         # phases 24 and 25
    python3 tools/fleet_smf.py --cpu --job   # a rehearsal on the CPU

Builds the kernels and runs ``chip_smoke.fleet_phase``: two port workers
sharing the card serve phase 23's burst at 1e8 halos while one is
SIGKILL'd inside its dispatch (every future settles, the requeued fits
equal solo fits, the merged trace complete), then ``bench_fleet`` at 500
halos with 1, 2 and 4 workers; with ``--job``, ``chip_smoke.job_phase``:
the joint posterior pipeline at 1e8 + 1e5 halos as one job over a
2-worker fleet, a worker SIGKILL'd mid-ensemble.  Every check of those
phases holds here too.  Prints the card's name and power limit and one
JSON line of the results; exits non-zero when a check fails or there is
no card.  About two minutes on an H100 for phase 24, two more for 25,
the build included.  With ``--cpu`` the workers run on the CPU (one
OpenMP thread each) at 3,000 halos (phase 24; 500 for ``bench_fleet``,
16 requests) and 512 + 4,096 halos (phase 25, HMC 10 + 10 draws); the
kernels' plain versions launch nothing, so the launch counts are not
checked.  Imports no JAX.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    import torch
    args = sys.argv[1:] if argv is None else argv
    cpu, with_job = "--cpu" in args, "--job" in args
    if not cpu and not torch.cuda.is_available():
        print("fleet_smf: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from multigrad_tpu_torch.ops import cuda_build
    from multigrad_tpu_torch.serve.worker import kernel_launches
    from multigrad_tpu_torch.ops import erf_kernels as ek
    from multigrad_tpu_torch.ops import fused_kernels as fk
    from multigrad_tpu_torch.ops import pair_kernels as pk
    wrappers = [ek.erf_counts_fwd_cuda, ek.erf_counts_bwd_cuda,
                ek.erf_counts_fwd_vec_cuda, ek.erf_counts_bwd_vec_cuda,
                fk.fused_counts_fwd_cuda, fk.fused_counts_bwd_cuda,
                pk.pair_counts_fwd_cuda, pk.pair_rowgrad_cuda,
                pk.pair_counts_bwd_cuda]

    def reset_launches():
        for fn in wrappers:
            fn.launches = 0

    if cpu:
        smi = "cpu"
        # The workers inherit this: tiny rows, one thread each.
        os.environ["OMP_NUM_THREADS"] = "1"
        torch.set_num_threads(1)
        out = {"fleet": cs.fleet_phase(device="cpu", big=3_000, small=500,
                                       n_bench=16, kill_launches=0)}
        if with_job:
            out["job"] = cs.job_phase(reset_launches, kernel_launches,
                                      device="cpu", wp=512, smf=4_096,
                                      hmc=(10, 10), kill_steps=0,
                                      wprp_kwargs={})
    else:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True).stdout.strip().splitlines()[0]
        cs.log(f"card: {smi}")
        t0 = time.perf_counter()
        cuda_build.build()
        cs.log(f"built in {time.perf_counter() - t0:.1f} s")
        out = {"fleet": cs.fleet_phase()}
        if with_job:
            out["job"] = cs.job_phase(reset_launches, kernel_launches)
        cs.log(f"done in {time.perf_counter() - t0:.0f} s")
    print(json.dumps(out, default=str))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
