#!/usr/bin/env python3
"""Smoke run of multigrad_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``multigrad_tpu_torch/csrc/`` and runs, in
order:

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: ``nvcc`` of ``csrc/erf_counts.cu`` for ``sm_90a``;
3. each kernel against its plain PyTorch version on the card, at
   N = 1,000,003 (a ragged tail, 1,000 of them ``+inf``) and at the main
   path's N = 1e8, with their median times;
4. golden: an SMF model at 10,000 halos reproduces ``TARGET_SUMSTATS``;
5. the main path: ``SMFModel(make_smf_data(1e8)).run_adam`` for 20 steps,
   with each kernel's launch count over exactly that run;
6. recovery: at 1e6 halos, 300 Adam steps recover the truth (-2.0, 0.2).

Any failure raises, so the run exits non-zero.  The last lines are one
JSON object per kernel run (``kernels``), the ``nvidia-smi`` line, and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the package beside it, the script exits non-zero and prints no result.
It imports torch, numpy and the port only.
"""
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BIG_HALOS = 100_000_000
RAGGED_HALOS = 1_000_003
N_INF = 1_000
PLAIN_CHUNK = 1 << 22
GUESS = (-1.0, 0.5)
TRUTH = (-2.0, 0.2)
COT = [float(i) for i in range(10)]  # a fixed cotangent for the backward

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): device memory and
# FP32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# f32 operations per (particle, edge), counted from csrc/erf_counts.cu.
# Forward, one cdf: z (2), clamp (2), x² (1), P and Q by Horner (6 and 4
# FMAs: 20), x·P (1), /Q (1), 0.5·(1+erf) (2) = 29, plus 2 per bin for
# the difference and the sum.  Backward: z (2), z² (1), expf (1),
# dv += h·P (2), ΣP (1), P·z (1), hpz += h·Pz (2) = 10.
FWD_OPS_PER_CDF, FWD_OPS_PER_BIN, BWD_OPS_PER_EDGE = 29, 2, 10


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def profile_steps(model, nsteps):
    """Device time by kernel over ``nsteps`` Adam steps (torch.profiler),
    and the device's busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.run_adam(guess=GUESS, nsteps=nsteps, learning_rate=0.02,
                       progress=False)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us, count = by_name.get(evt.name, (0.0, 0))
            by_name[evt.name] = (us + evt.time_range.elapsed_us(), count + 1)
    if not by_name:
        log("profile: the profiler saw no device time (not measured)")
        return
    busy_us = sum(us for us, _ in by_name.values())
    log(f"profile of {nsteps} steps: wall {wall_us / nsteps / 1e3:.4f} "
        f"ms/step, device busy {busy_us / nsteps / 1e3:.4f} ms/step "
        f"({100 * busy_us / wall_us:.1f}%)")
    for name, (us, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:12]:
        log(f"  {us / nsteps / 1e3:.4f} ms/step, {count / nsteps:g} "
            f"launches/step: {name[:100]}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import numpy as np
    import multigrad_tpu_torch
    pkg = os.path.dirname(os.path.abspath(multigrad_tpu_torch.__file__))
    if os.path.dirname(pkg) != HERE:
        raise ImportError(f"multigrad_tpu_torch found at {pkg}, not beside "
                          f"this script in {HERE}")
    from multigrad_tpu_torch.models import (SMFModel, TARGET_SUMSTATS,
                                            make_smf_data)
    from multigrad_tpu_torch.ops import erf_kernels as ek

    dev = torch.device("cuda")

    # 1. environment ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    # 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib = ek.build()
    log(f"built {os.path.relpath(lib, HERE)} in "
        f"{time.perf_counter() - t0:.1f} s")

    # 3. kernels against their plain versions --------------------------
    def time_ms(fn, reps, warmup=2):
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        return statistics.median(times)

    def compare_kernels(values, sigma, label, timed):
        edges = torch.linspace(9, 10, 11, dtype=torch.float32, device=dev)
        s = torch.tensor(sigma, dtype=torch.float32, device=dev)
        s1 = s.reshape(1)
        g = torch.tensor(COT, dtype=torch.float32, device=dev)
        fwd = ek.erf_counts_fwd_cuda(values, edges, s1)
        fwd_plain = ek.erf_counts_fwd_plain(values, edges, s, PLAIN_CHUNK)
        torch.cuda.synchronize()
        fwd_err = float((fwd - fwd_plain).abs().max())
        fwd_tol = 2e-5 * float(fwd_plain.abs().max())
        check(fwd_err <= fwd_tol, f"{label}: forward error {fwd_err} > "
              f"{fwd_tol}")
        check(torch.equal(fwd, ek.erf_counts_fwd_cuda(values, edges, s1)),
              f"{label}: forward not deterministic")
        bwd = ek.erf_counts_bwd_cuda(values, edges, s1, g)
        bwd_plain = ek.erf_counts_bwd_plain(values, edges, s, g,
                                            PLAIN_CHUNK)
        torch.cuda.synchronize()
        bwd_err = 0.0
        for name, a, b in zip(("dvalues", "dedges", "dsigma"), bwd,
                              bwd_plain):
            check(bool(torch.isfinite(a).all()), f"{label}: {name} not "
                  "finite")
            scale = float(b.abs().max())
            excess = float(((a - b).abs() - 1e-3 * b.abs()).max())
            check(excess <= 1e-5 * scale, f"{label}: {name} off by "
                  f"{excess} beyond rtol 1e-3, atol {1e-5 * scale}")
            bwd_err = max(bwd_err, float((a - b).abs().max()))
        log(f"{label}: forward max|err| {fwd_err:.3e} (tol {fwd_tol:.3e}), "
            f"backward max|err| {bwd_err:.3e}")
        out = dict(fwd_err=fwd_err, bwd_err=bwd_err)
        if timed:
            out["fwd_ms"] = time_ms(
                lambda: ek.erf_counts_fwd_cuda(values, edges, s1), 20)
            out["fwd_plain_ms"] = time_ms(
                lambda: ek.erf_counts_fwd_plain(values, edges, s,
                                                PLAIN_CHUNK), 5, 1)
            out["bwd_ms"] = time_ms(
                lambda: ek.erf_counts_bwd_cuda(values, edges, s1, g), 20)
            out["bwd_plain_ms"] = time_ms(
                lambda: ek.erf_counts_bwd_plain(values, edges, s, g,
                                                PLAIN_CHUNK), 5, 1)
            log(f"{label}: forward {out['fwd_ms']:.4f} ms (plain "
                f"{out['fwd_plain_ms']:.3f} ms), backward "
                f"{out['bwd_ms']:.4f} ms (plain {out['bwd_plain_ms']:.3f} ms)")
        return out

    gen = torch.Generator(device=dev).manual_seed(0)
    ragged = 9.5 + 0.4 * torch.randn(RAGGED_HALOS, generator=gen,
                                     device=dev)
    ragged[-N_INF:] = float("inf")
    compare_kernels(ragged, 0.2, f"N={RAGGED_HALOS:,}", timed=False)
    del ragged

    # The main path's inputs: the 1e8-halo SMF data at the guess.
    model = SMFModel(aux_data=make_smf_data(BIG_HALOS))
    values = (model.aux_data["log_halo_masses"] + GUESS[0]).contiguous()
    big = compare_kernels(values, GUESS[1], f"N={BIG_HALOS:,}", timed=True)
    n, n_edges = values.shape[0], 11
    del values

    # 4. golden ---------------------------------------------------------
    golden = SMFModel(aux_data=make_smf_data(10_000))
    y = golden.calc_sumstats_from_params(TRUTH).cpu().numpy()
    check(np.allclose(y, TARGET_SUMSTATS, rtol=1e-5, atol=1e-8),
          f"golden sumstats {y} != {TARGET_SUMSTATS}")
    log("golden TARGET_SUMSTATS reproduced at 10,000 halos")

    # 5. the main path at 1e8 halos ------------------------------------
    # First step against the plain path, by hand: the same two-stage
    # chain rule through the plain versions of both kernels.
    aux = model.aux_data
    loss_k, grad_k = model.calc_loss_and_grad_from_params(GUESS)
    vals = (aux["log_halo_masses"] + GUESS[0]).contiguous()
    edges, sig = aux["smf_bin_edges"], torch.tensor(GUESS[1], device=dev)
    widths = torch.diff(edges)
    counts = ek.erf_counts_fwd_plain(vals, edges, sig, PLAIN_CHUNK)
    y = (counts / aux["volume"] / widths).requires_grad_(True)
    loss_p = model.calc_loss_from_sumstats(y)
    (dl_dy,) = torch.autograd.grad(loss_p, y)
    dv, _, dsig = ek.erf_counts_bwd_plain(
        vals, edges, sig, dl_dy / aux["volume"] / widths, PLAIN_CHUNK)
    grad_p = torch.stack([dv.sum(), dsig])
    del vals, dv
    loss_k, loss_p = float(loss_k), float(loss_p.detach())
    log(f"first step: loss {loss_k:.7g} (plain {loss_p:.7g}), grad "
        f"{grad_k.tolist()} (plain {grad_p.tolist()})")
    check(abs(loss_k - loss_p) <= 1e-4 * abs(loss_p),
          "first-step loss differs from the plain path")
    check(bool(torch.allclose(grad_k, grad_p, rtol=1e-3,
                              atol=1e-5 * float(grad_p.abs().max()))),
          "first-step gradient differs from the plain path")

    model.run_adam(guess=GUESS, nsteps=2, learning_rate=0.02,
                   progress=False)  # warm-up
    torch.cuda.synchronize()
    ek.erf_counts_fwd_cuda.launches = 0
    ek.erf_counts_bwd_cuda.launches = 0
    t0 = time.perf_counter()
    traj = model.run_adam(guess=GUESS, nsteps=20, learning_rate=0.02,
                          progress=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"erf_counts_fwd": ek.erf_counts_fwd_cuda.launches,
                "erf_counts_bwd": ek.erf_counts_bwd_cuda.launches}
    log(f"main path: 20 Adam steps at {BIG_HALOS:,} halos in "
        f"{seconds:.4f} s = {20 / seconds:.2f} steps/s; launches "
        f"{launches}")
    check(launches == {"erf_counts_fwd": 20, "erf_counts_bwd": 20},
          f"kernel launches on the main path: {launches}")
    check(tuple(traj.shape) == (21, 2) and bool(torch.isfinite(traj).all()),
          "trajectory not finite or of the wrong shape")
    loss_0 = float(model.calc_loss_from_params(traj[0]))
    loss_20 = float(model.calc_loss_from_params(traj[-1]))
    log(f"main path: loss {loss_0:.6g} -> {loss_20:.6g}, params "
        f"{traj[-1].tolist()}")
    check(loss_20 < loss_0, "the loss did not decrease")
    profile_steps(model, 5)
    del model, aux, traj

    # 6. recovery at 1e6 halos -----------------------------------------
    small = SMFModel(aux_data=make_smf_data(1_000_000))
    t0 = time.perf_counter()
    traj = small.run_adam(guess=GUESS, nsteps=300, learning_rate=0.02,
                          progress=False)
    final = traj[-1].cpu().numpy()
    log(f"recovery: 300 steps at 1,000,000 halos -> {final.tolist()} in "
        f"{time.perf_counter() - t0:.2f} s")
    check(np.allclose(final, TRUTH, atol=0.02), f"fit ended at {final}")

    # 7. summary --------------------------------------------------------
    def bound(nbytes, ops):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")

    # Bytes: each input read once, each output written once.
    fwd_bound, fwd_by = bound(
        4 * (n + n_edges + 1 + (n_edges - 1)),
        n * (FWD_OPS_PER_CDF * n_edges + FWD_OPS_PER_BIN * (n_edges - 1)))
    bwd_bound, bwd_by = bound(
        4 * (n + n_edges + 1 + (n_edges - 1) + n + n_edges + 1),
        n * BWD_OPS_PER_EDGE * n_edges)
    kernels = [
        dict(name="erf_counts_fwd", route="cuda",
             source="multigrad_tpu_torch/csrc/erf_counts.cu",
             replaces="multigrad_tpu/ops/pallas_kernels.py:201",
             launches=launches["erf_counts_fwd"],
             max_abs_err=big["fwd_err"], ms=big["fwd_ms"],
             plain_ms=big["fwd_plain_ms"], bound_ms=fwd_bound,
             bound_by=fwd_by, library_ms=None),
        dict(name="erf_counts_bwd", route="cuda",
             source="multigrad_tpu_torch/csrc/erf_counts.cu",
             replaces="multigrad_tpu/ops/pallas_kernels.py:237",
             launches=launches["erf_counts_bwd"],
             max_abs_err=big["bwd_err"], ms=big["bwd_ms"],
             plain_ms=big["bwd_plain_ms"], bound_ms=bwd_bound,
             bound_by=bwd_by, library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
