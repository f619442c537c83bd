#!/usr/bin/env python3
"""Sharded K alone on one card: ``chip_smoke.py``'s phase 28, and a probe
of NCCL with two ranks on the one device.

    python3 tools/sharded_smf.py          # on the card
    python3 tools/sharded_smf.py --cpu    # a rehearsal on the CPU

Builds the kernels, runs the replicated references of phases 18-20 on
``SMFChi2Model`` at 1e8 halos (the 8 Latin-hypercube rows of the batched
loss and gradient, ``run_multistart_adam`` of 8 starts x 200 steps, the
Fisher matrix at the best and ``run_hmc`` from ``hmc_init_from_ensemble``,
4 chains x (50 + 150) draws: the calls those phases make, so the results
are theirs), then ``chip_smoke.sharded_phase``: two worker processes of a
gloo world on the card, ``ensemble_comm(2)``, each holding the catalog and
half of every batch, their rows, chains and a served bucket bit-equal to
the references, with each process's launches, replica-comm calls and
memory.  Then two processes try an NCCL world on the one card and the
error they meet is printed.  Prints the card's name and power limit and
one JSON line of the results; exits non-zero when a check fails or there
is no card.  With ``--cpu`` the same runs at 20,000 halos on the CPU (the
kernels' plain versions; no memory check, no NCCL).  Imports no JAX.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NCCL_TIMEOUT_S = 90


def references(device, halos):
    """Phases 18-20's replicated runs: what phase 28 holds its workers'
    results against (numpy), and phase 18's peak on the card."""
    import torch

    import chip_smoke as cs
    from multigrad_tpu_torch.inference import (fisher_information,
                                               hmc_init_from_ensemble,
                                               run_hmc, run_multistart_adam)
    from multigrad_tpu_torch.models import SMFChi2Model, make_smf_data
    from multigrad_tpu_torch.utils.util import latin_hypercube_sampler
    model = SMFChi2Model(aux_data=make_smf_data(halos, device=device))
    rows = torch.tensor(latin_hypercube_sampler(
        *cs.LHS_BOX, 2, cs.BATCH_K, seed=0), dtype=torch.float32,
        device=device)
    program = model.batched_loss_and_grad_fn()
    leaves = model.aux_leaves()
    program(rows, leaves)  # warm-up
    if device == "cuda":
        (losses, grads), peak = cs.peak_above(lambda: program(rows, leaves))
    else:
        (losses, grads), peak = program(rows, leaves), 0
    ens = run_multistart_adam(
        model, param_bounds=cs.POSTERIOR_BOUNDS, n_starts=cs.BATCH_K,
        learning_rate=cs.ENSEMBLE_LR, seed=0, nsteps=cs.ENSEMBLE_STEPS)
    laplace = fisher_information(model, ens.best_params).stderr()
    init = hmc_init_from_ensemble(ens, num_chains=cs.HMC_CHAINS, spread=1.0,
                                  stderr=laplace, randkey=1)
    res = run_hmc(model, init, num_samples=cs.HMC_SAMPLES,
                  num_warmup=cs.HMC_WARMUP, step_size=cs.HMC_STEP,
                  num_leapfrog=cs.HMC_LEAPFROG, inv_mass=laplace ** 2,
                  randkey=2)
    return dict(
        rows=rows.cpu().numpy(), losses=losses.cpu().numpy(),
        grads=grads.cpu().numpy(), peak=peak,
        ens_params=ens.params.cpu().numpy(),
        ens_losses=ens.losses.cpu().numpy(),
        ens_best=ens.best_params.cpu().numpy(),
        hmc_init=init.cpu().numpy(), inv_mass=(laplace ** 2).cpu().numpy(),
        randkey=2, hmc={f: getattr(res, f) for f in (
            "samples", "potential", "step_size", "divergences",
            "accept_prob")})


def nccl_rank(rank, world, port):
    """One rank of an NCCL world on card 0 (what the probe runs)."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=int(rank), world_size=int(world))
    try:
        x = torch.ones(1, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        print(f"NCCL-PROBE rank {rank}: all_reduce gave {x.item()}")
    finally:
        dist.destroy_process_group()


def nccl_probe():
    """Two processes of an NCCL world on the one card: their exit codes
    and the last lines of their output."""
    import chip_smoke as cs
    port = cs.free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--nccl-rank", str(r),
         "2", str(port)], cwd=HERE, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    out = []
    for r, p in enumerate(procs):
        try:
            text = p.communicate(timeout=NCCL_TIMEOUT_S)[0]
        except subprocess.TimeoutExpired:
            p.kill()
            text = p.communicate()[0] + f"\n(killed after {NCCL_TIMEOUT_S} s)"
        lines = [ln for ln in text.splitlines() if ln.strip()]
        hits = [ln for ln in lines if "uplicate" in ln or "NCCL" in ln]
        out.append(dict(rank=r, returncode=p.returncode,
                        lines=(hits or lines)[-4:]))
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    return out


def main(argv=None):
    import torch
    cpu = "--cpu" in (sys.argv[1:] if argv is None else argv)
    if not cpu and not torch.cuda.is_available():
        print("sharded_smf: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from multigrad_tpu_torch.ops import cuda_build
    t_start = time.perf_counter()
    if cpu:
        smi, device, halos = "cpu", "cpu", 20_000
    else:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True).stdout.strip().splitlines()[0]
        cs.log(f"card: {smi}")
        device, halos = "cuda", cs.BIG_HALOS
        t0 = time.perf_counter()
        cuda_build.build()
        cs.log(f"built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    refs = references(device, halos)
    cs.log(f"references (phases 18-20's runs) in "
           f"{time.perf_counter() - t0:.1f} s")
    out = cs.sharded_phase(refs, time.perf_counter(), device=device,
                           halos=halos)
    if not cpu:
        out["nccl_two_ranks_one_card"] = nccl_probe()
        cs.log(f"NCCL, two ranks on one card: {out['nccl_two_ranks_one_card']}")
    cs.log(f"done in {time.perf_counter() - t_start:.0f} s")
    print(json.dumps(out, default=str))
    print(smi)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--nccl-rank"]:
        nccl_rank(*sys.argv[2:])
        sys.exit(0)
    sys.exit(main())
