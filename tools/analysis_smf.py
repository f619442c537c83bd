#!/usr/bin/env python3
"""The static analysis alone on one card: ``chip_smoke.py``'s phase 27,
with phase 21's ``MeshComm`` collectives before it.

    python3 tools/analysis_smf.py          # on the card
    python3 tools/analysis_smf.py --cpu    # a rehearsal on the CPU

Builds the kernels, takes phase 5's reference (one loss and gradient of
the SMF model at 1e8 halos without a comm), runs ``MeshComm``'s
``pmean``, ``pmax``, ``pmin``, ``all_gather`` and ``axis_index`` under a
one-process NCCL group (``chip_smoke.mesh_comm_collectives``), then
``chip_smoke.analysis_phase``: ``check_shard_safety`` of the SMF, history
(dense and fused), joint, batched and streamed models at 1e8 halos with
no launch and no card memory, the gather mutation caught, the analyzed
model's loss and gradient equal to the reference bit for bit, and the
lint CLI in a subprocess.  Every check of those phases holds here too.
Prints the card's name and power limit and one JSON line of the results;
exits non-zero when a check fails or there is no card.  With ``--cpu``
phase 27's checks run on the CPU at 20,000 halos under a gloo group (the
plain versions of the kernels, so nothing launches or is built).
Imports no JAX.
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
        print("analysis_smf: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import numpy as np
    import torch.distributed as dist
    import chip_smoke as cs
    from multigrad_tpu_torch.models import SMFModel, make_smf_data
    from multigrad_tpu_torch.ops import binned as tb
    from multigrad_tpu_torch.ops import cuda_build
    from multigrad_tpu_torch.ops import erf_kernels as ek
    from multigrad_tpu_torch.ops import fused_kernels as fk
    from multigrad_tpu_torch.ops import pair_kernels as pk
    from multigrad_tpu_torch.parallel.mesh import global_comm
    wrappers = {"erf_counts_fwd": ek.erf_counts_fwd_cuda,
                "erf_counts_bwd": ek.erf_counts_bwd_cuda,
                "erf_counts_fwd_vec": ek.erf_counts_fwd_vec_cuda,
                "erf_counts_bwd_vec": ek.erf_counts_bwd_vec_cuda,
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

    t_start = time.perf_counter()
    edges = np.linspace(*cs.FUSED_EDGES)
    fused_kwargs = dict(bin_edges=edges, obs_indices=cs.FUSED_OBS,
                        bin_mode="fused",
                        bin_window=tb.fused_bin_window(edges,
                                                       cs.FUSED_SIGMA_MAX))
    if cpu:
        smi, device = "cpu", "cpu"
        sizes = dict(big=20_000, hist_chunk=5_000, pair_halos=512,
                     stream_chunk=4_096)
    else:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True).stdout.strip().splitlines()[0]
        cs.log(f"card: {smi}")
        device, sizes = "cuda", {}
        t0 = time.perf_counter()
        cuda_build.build()
        cs.log(f"built in {time.perf_counter() - t0:.1f} s")
    # Phase 5's reference: one loss and gradient without a comm.
    model = SMFModel(aux_data=make_smf_data(sizes.get("big", cs.BIG_HALOS),
                                            device=device))
    loss, grad = model.calc_loss_and_grad_from_params(cs.GUESS)
    reference = dict(loss=loss.clone(), grad=grad.clone())
    del model
    if not cpu:
        # Phase 21's collectives under a one-process NCCL group.
        torch.cuda.set_device(0)
        dist.init_process_group(
            "nccl", init_method=f"tcp://127.0.0.1:{cs.free_port()}",
            rank=0, world_size=1)
        try:
            cs.mesh_comm_collectives(global_comm())
        finally:
            dist.destroy_process_group()
    out = cs.analysis_phase(reset_launches, read_launches, wrappers,
                            reference, fused_kwargs, t_start, device=device,
                            **sizes)
    cs.log(f"done in {time.perf_counter() - t_start:.0f} s")
    print(json.dumps(out, default=str))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
