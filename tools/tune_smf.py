#!/usr/bin/env python3
"""The autotuner alone on one card: ``chip_smoke.py``'s phase 26.

    python3 tools/tune_smf.py          # on the card
    python3 tools/tune_smf.py --cpu    # a rehearsal on the CPU

Builds the kernels and runs ``chip_smoke.tune_phase``: the cold table's
defaults, the static cost model of the SMF and history models at 1e8
halos against a measured loss and gradient, ``tune_model`` on the history
model in two sigma regimes (every candidate's prediction, measurement
and roofline fraction; ``"auto"`` bit-equal to the winner set by hand),
the warm start, ``tune_buckets`` with the scheduler and a worker booting
on the ladder, ``tune_streaming``, the CLI twice and
``profiled_fit(cost=...)``.  Every check of phase 26 holds here too.
Prints the card's name and power limit and one JSON line of the results;
exits non-zero when a check fails or there is no card.  With ``--cpu``
the same checks run on the CPU at 60,000 halos (the plain versions of
the kernels, their calls counted in place of launches; nothing is
built).  Imports no JAX.
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
        print("tune_smf: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from multigrad_tpu_torch.ops import cuda_build
    from multigrad_tpu_torch.ops import erf_kernels as ek
    from multigrad_tpu_torch.ops import fused_kernels as fk
    wrappers = {"erf_counts_fwd": ek.erf_counts_fwd_cuda,
                "erf_counts_bwd": ek.erf_counts_bwd_cuda,
                "erf_counts_fwd_vec": ek.erf_counts_fwd_vec_cuda,
                "erf_counts_bwd_vec": ek.erf_counts_bwd_vec_cuda,
                "fused_counts_fwd": fk.fused_counts_fwd_cuda,
                "fused_counts_bwd": fk.fused_counts_bwd_cuda}

    def reset_launches():
        for fn in wrappers.values():
            fn.launches = 0

    def read_launches():
        return {name: fn.launches for name, fn in wrappers.items()}

    t_start = time.perf_counter()
    if cpu:
        # The plain versions launch nothing: count their calls in place
        # of the kernels' launches.
        smi = "cpu"
        for module, attr, name in (
                (ek, "erf_counts_fwd_plain", "erf_counts_fwd"),
                (ek, "erf_counts_bwd_plain", "erf_counts_bwd"),
                (fk, "fused_counts_fwd_plain", "fused_counts_fwd"),
                (fk, "fused_counts_bwd_plain", "fused_counts_bwd")):
            fn = getattr(module, attr)

            def counting(values, edges, sigma, *args, _fn=fn, _name=name,
                         _dense=module is ek, **kwargs):
                vec = "_vec" if _dense and sigma.dim() else ""
                wrappers[_name + vec].launches += 1
                return _fn(values, edges, sigma, *args, **kwargs)
            setattr(module, attr, counting)
        out = cs.tune_phase(reset_launches, read_launches, wrappers,
                            t_start, device="cpu", big=60_000,
                            hist_chunk=20_000, stream_chunk=8_192)
    else:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True).stdout.strip().splitlines()[0]
        cs.log(f"card: {smi}")
        t0 = time.perf_counter()
        cuda_build.build()
        cs.log(f"built in {time.perf_counter() - t0:.1f} s")
        out = cs.tune_phase(reset_launches, read_launches, wrappers, t_start)
    cs.log(f"done in {time.perf_counter() - t_start:.0f} s")
    print(json.dumps(out, default=str))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
