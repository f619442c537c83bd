#!/usr/bin/env python3
"""The streamed SMF path and the Fisher matrix alone on one card:
``chip_smoke.py``'s phases 16 and 17, and the streamed loader's pieces
timed without a consumer.

    python3 tools/streamed_smf.py

Builds the kernels, runs the resident SMF fit's first 5 Adam steps at 1e8
halos (phase 16's reference trajectory), then ``chip_smoke.streamed_phase``
and ``chip_smoke.fisher_phase`` (every check of theirs holds here too).
Then the loader alone, as the prefetcher runs it, over the 1e8 halos in
chunks of 2^22: per chunk the copy into the pinned staging buffer
(``np.copyto``) and the host-to-device copy on the copy stream, waited
for; medians over the 24 chunks of 3 passes.  Prints one JSON line of
the results; exits non-zero when a check fails or there is no card.
About 1.5 minutes on an H100, the build included.  Imports no JAX.
"""
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def loader_alone(log_mh, chunk_rows, passes=3):
    """Median ms a chunk of the staging copy and of the copy to the card
    (waited for), through the prefetcher's own staging."""
    import torch
    from multigrad_tpu_torch.data import plan_chunks
    from multigrad_tpu_torch.data.prefetch import _stage, _Staging
    from multigrad_tpu_torch.data.source import ArraySource
    src = ArraySource(log_mh)
    plan = plan_chunks(src.n_rows, chunk_rows)
    staging = _Staging(torch.device("cuda", torch.cuda.current_device()))
    stage_ms, card_ms = [], []
    for _ in range(passes):
        for spec in plan.chunks:
            leaves = [src._chunk_rows(spec)]
            slot = spec.index % 2
            _, views, _ = staging.buffers(slot, leaves)
            t0 = time.perf_counter()
            _stage(leaves, views)
            t1 = time.perf_counter()
            staging.to_card(slot, leaves)  # stages again, then copies
            t2 = time.perf_counter()
            stage_ms.append((t1 - t0) * 1e3)
            card_ms.append((t2 - t1) * 1e3 - stage_ms[-1])
            staging.release(slot)
    return dict(stage_ms=statistics.median(stage_ms),
                copy_ms=statistics.median(card_ms), chunks=plan.n_chunks)


def main():
    import torch
    if not torch.cuda.is_available():
        print("streamed_smf: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from multigrad_tpu_torch.models import SMFModel, make_smf_data
    from multigrad_tpu_torch.ops import cuda_build
    from multigrad_tpu_torch.ops import erf_kernels as ek
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

    model = SMFModel(aux_data=make_smf_data(cs.BIG_HALOS))
    traj = model.run_adam(guess=cs.GUESS, nsteps=cs.STREAM_STEPS,
                          learning_rate=0.02, progress=False)
    log_mh = model.aux_data["log_halo_masses"].cpu().numpy()
    del model
    torch.cuda.empty_cache()
    stream = cs.streamed_phase(reset_launches, read_launches, wrappers, traj)
    fisher = cs.fisher_phase(reset_launches, read_launches, wrappers)
    alone = loader_alone(log_mh, cs.STREAM_CHUNK)
    cs.log(f"loader alone at {cs.STREAM_CHUNK:,}: {alone}")
    print(json.dumps({
        "card": torch.cuda.get_device_name(0),
        "steps_per_s": {str(k): v["sps"]
                        for k, v in stream["sweep"].items()},
        "ab": stream["ab"], "scan_steps_per_s": stream["scan"]["sps"],
        "bound": stream["bound"], "window": stream["window"],
        "peak_bytes": {str(k): v["peak"] for k, v in stream["sweep"].items()},
        "fisher_s": [fisher["resident_s"], fisher["streamed_s"]],
        "loader_alone": alone}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
