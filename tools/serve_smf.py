#!/usr/bin/env python3
"""Serving alone on one card: ``chip_smoke.py``'s phase 23.

    python3 tools/serve_smf.py          # on the card
    python3 tools/serve_smf.py --cpu    # a rehearsal on the CPU

Builds the kernels and runs ``chip_smoke.serving_phase``: the
``FitScheduler`` warmup and a burst of 20 requests over the SMF model at
1e8 halos, ``/metrics``, NaN poison in bucket 4, profiler windows of a
bucket dispatch against ``run_adam_scan`` alone (no synchronizing call
added), ``bench_serve`` at 1e5 halos (buckets (1, 4, 16) against (1,))
and the worker process behind its wire.  Every check of phase 23 holds
here too.  Prints the card's name and power limit and one JSON line of
the results; exits non-zero when a check fails or there is no card.
About two minutes on an H100, the build included.  With ``--cpu`` the
same checks run on the CPU at 3,000 and 1,000 halos, 8 requests for
``bench_serve``, without the profiler windows (the plain versions of the
kernels; nothing is built).  Imports no JAX.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    import torch
    cpu = "--cpu" in (sys.argv[1:] if argv is None else argv)
    if not cpu and not torch.cuda.is_available():
        print("serve_smf: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from multigrad_tpu_torch.ops import cuda_build
    from multigrad_tpu_torch.ops import erf_kernels as ek
    from multigrad_tpu_torch.ops import fused_kernels as fk
    from multigrad_tpu_torch.ops import pair_kernels as pk
    wrappers = {"erf_counts_fwd": ek.erf_counts_fwd_cuda,
                "erf_counts_bwd": ek.erf_counts_bwd_cuda,
                "fused_counts_fwd": fk.fused_counts_fwd_cuda,
                "fused_counts_bwd": fk.fused_counts_bwd_cuda,
                "pair_counts_fwd": pk.pair_counts_fwd_cuda,
                "pair_rowgrad": pk.pair_rowgrad_cuda,
                "pair_counts_bwd": pk.pair_counts_bwd_cuda}

    def reset_launches():
        for fn in wrappers.values():
            fn.launches = 0

    def read_launches():
        return {name: fn.launches for name, fn in wrappers.items()}

    if cpu:
        # The plain versions launch nothing: count the calls of the erf
        # counts' plain versions in their place.
        smi = "cpu"
        for name, attr in (("erf_counts_fwd", "erf_counts_fwd_plain"),
                           ("erf_counts_bwd", "erf_counts_bwd_plain")):
            fn = getattr(ek, attr)

            def counting(*args, _fn=fn, _name=name, **kwargs):
                wrappers[_name].launches += 1
                return _fn(*args, **kwargs)
            setattr(ek, attr, counting)
        out = cs.serving_phase(reset_launches, read_launches, wrappers,
                               device="cpu", big=3_000, small=1_000,
                               n_bench=8, profile=False)
    else:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True).stdout.strip().splitlines()[0]
        cs.log(f"card: {smi}")
        t0 = time.perf_counter()
        cuda_build.build()
        cs.log(f"built in {time.perf_counter() - t0:.1f} s")
        out = cs.serving_phase(reset_launches, read_launches, wrappers)
    print(json.dumps(out, default=str))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
