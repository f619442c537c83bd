#!/usr/bin/env python3
"""Smoke run of multigrad_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``multigrad_tpu_torch/csrc/`` and runs, in
order:

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: ``nvcc`` of every ``csrc/*.cu`` for ``sm_90a``, all at once;
3. the dense scalar-sigma kernels against their plain PyTorch versions on
   the card, at N = 1,000,003 (a ragged tail, 1,000 of them ``+inf``) and
   at the SMF path's N = 1e8, with their median times;
4. golden: an SMF model at 10,000 halos reproduces ``TARGET_SUMSTATS``;
5. the SMF path: ``SMFModel(make_smf_data(1e8)).run_adam`` for 20 steps,
   with each kernel's launch count over exactly that run;
6. recovery: at 1e6 halos, 300 Adam steps recover the truth (-2.0, 0.2);
7. the dense per-particle-sigma kernels against their plain versions at
   N = 1,000,003, timed at the history path's launch shape (1e6
   particles, 14 edges) and at 1e8;
8. the fused kernels (scalar and per-particle sigma) against their plain
   versions at N = 1,000,003 with 41 edges and a 33-edge window, fused
   counts against dense counts, timed at 1e6 and at 1e8;
9. the history model on the card against the same model on the CPU
   (the plain versions), fed the card's mean log M* and whole, at 1e6
   halos, dense and fused;
10. the history path, dense: ``GalhaloHistModel(make_galhalo_hist_data(
    1e8, chunk_size=1e6)).run_adam`` for 20 steps, launches counted;
11. the history path, fused: the same with 41 edges, six epochs and
    ``bin_mode="fused"``, launches counted.

Any failure raises, so the run exits non-zero.  The last lines are one
JSON object per kernel run (``kernels``), the ``nvidia-smi`` line, and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the package beside it, the script exits non-zero and prints no result.
It imports torch, numpy, the port and ``tools/hist_card_vs_cpu.py``
(phase 9's references) only.
"""
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BIG_HALOS = 100_000_000
HIST_CHUNK = 1_000_000      # the history path's launch shape
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
# With a per-particle sigma, each particle also forms inv_i (2); the
# dense backward weights each row term by inv_i (+1 per edge) and scales
# dv and dsigma (5).  The fused backward per slot: h (1), z (2), z² (1),
# expf (1), h·P (1), dv += (1), hz += h·P·z (2) = 9; per particle inv
# and the scaling of dv and dsigma (7).
INV_OPS, VEC_BWD_OPS_PER_EDGE, VEC_BWD_OPS = 2, 11, 5
FUSED_BWD_OPS_PER_SLOT, FUSED_BWD_OPS = 9, 7
# The history path (bench.py:339-372 and :2059-2063): 1e8 halos in chunks
# of 1e6, from TRUTH + 0.05 at learning rate 1e-3.
HIST_STEPS = 20
HIST_LR = 1e-3
FUSED_EDGES = (7.0, 11.75, 41)
FUSED_OBS = (5, 7, 9, 11, 13, 15)
FUSED_SIGMA_MAX = 0.32


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def profile_steps(model, nsteps, guess=GUESS, learning_rate=0.02):
    """Device time by kernel over ``nsteps`` Adam steps (torch.profiler),
    and the device's busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.run_adam(guess=guess, nsteps=nsteps,
                       learning_rate=learning_rate, progress=False)
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
    from multigrad_tpu_torch.models import (GalhaloHistModel, SMFModel,
                                            TARGET_SUMSTATS,
                                            make_galhalo_hist_data,
                                            make_smf_data)
    from multigrad_tpu_torch.models.galhalo_hist import TRUTH as HIST_TRUTH
    from multigrad_tpu_torch.ops import binned as tb
    from multigrad_tpu_torch.ops import cuda_build
    from multigrad_tpu_torch.ops import erf_kernels as ek
    from multigrad_tpu_torch.ops import fused_kernels as fk
    from tools.hist_card_vs_cpu import evaluate, evaluate_fed, gaps
    wrappers = {"erf_counts_fwd": ek.erf_counts_fwd_cuda,
                "erf_counts_bwd": ek.erf_counts_bwd_cuda,
                "erf_counts_fwd_vec": ek.erf_counts_fwd_vec_cuda,
                "erf_counts_bwd_vec": ek.erf_counts_bwd_vec_cuda,
                "fused_masses_fwd": fk.fused_masses_fwd_cuda,
                "fused_masses_bwd": fk.fused_masses_bwd_cuda}

    def reset_launches():
        for fn in wrappers.values():
            fn.launches = 0

    def read_launches():
        return {name: fn.launches for name, fn in wrappers.items()}

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
    t_start = t0 = time.perf_counter()
    libs = cuda_build.build()
    log(f"built {', '.join(os.path.relpath(p, HERE) for p in libs)} in "
        f"{time.perf_counter() - t0:.1f} s (one nvcc per source, in "
        "parallel)")

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
    reset_launches()
    t0 = time.perf_counter()
    traj = model.run_adam(guess=GUESS, nsteps=20, learning_rate=0.02,
                          progress=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    smf_launches = read_launches()
    log(f"main path: 20 Adam steps at {BIG_HALOS:,} halos in "
        f"{seconds:.4f} s = {20 / seconds:.2f} steps/s; launches "
        f"{smf_launches}")
    # One forward and one backward per step, scalar sigma, dense.
    check(smf_launches == dict.fromkeys(wrappers, 0) | {
        "erf_counts_fwd": 20, "erf_counts_bwd": 20},
        f"kernel launches on the main path: {smf_launches}")
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

    def bound(nbytes, ops):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")

    def grads_close(label, got, want):
        """Gradients: rtol 1e-3 plus atol 1e-5·max|grad|; max |err|."""
        err = 0.0
        for name, a, b in zip(("dvalues", "dedges", "dsigma"), got, want):
            if a is None:
                continue
            check(bool(torch.isfinite(a).all()), f"{label}: {name} not "
                  "finite")
            scale = float(b.abs().max())
            excess = float(((a - b).abs() - 1e-3 * b.abs()).max())
            check(excess <= 1e-5 * scale, f"{label}: {name} off by "
                  f"{excess} beyond rtol 1e-3, atol {1e-5 * scale}")
            err = max(err, float((a - b).abs().max()))
        return err

    # 7. dense kernels, per-particle sigma ------------------------------
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 7")
    gen = torch.Generator(device=dev).manual_seed(7)
    hist_edges = torch.linspace(7.0, 11.75, 14, device=dev)
    n_hist_edges = 14
    hcot = torch.randn(n_hist_edges - 1, generator=gen, device=dev)

    def hist_inputs(n):
        v = 9.4 + 0.9 * torch.randn(n, generator=gen, device=dev)
        return v, 0.1 + 0.3 * torch.rand(n, generator=gen, device=dev)

    def vec_dense(v, sig, label, timed):
        fwd = ek.erf_counts_fwd_vec_cuda(v, hist_edges, sig)
        fwd_plain = ek.erf_counts_fwd_plain(v, hist_edges, sig, PLAIN_CHUNK)
        torch.cuda.synchronize()
        fwd_err = float((fwd - fwd_plain).abs().max())
        fwd_tol = 2e-5 * float(fwd_plain.abs().max())
        check(fwd_err <= fwd_tol, f"{label}: vec forward error {fwd_err} "
              f"> {fwd_tol}")
        check(torch.equal(fwd, ek.erf_counts_fwd_vec_cuda(v, hist_edges,
                                                          sig)),
              f"{label}: vec forward not deterministic")
        bwd_err = grads_close(
            f"{label} vec", ek.erf_counts_bwd_vec_cuda(v, hist_edges, sig,
                                                      hcot),
            ek.erf_counts_bwd_plain(v, hist_edges, sig, hcot, PLAIN_CHUNK))
        log(f"{label}: vec forward max|err| {fwd_err:.3e} (tol "
            f"{fwd_tol:.3e}), backward max|err| {bwd_err:.3e}")
        out = dict(fwd_err=fwd_err, bwd_err=bwd_err)
        if timed:
            out["fwd_ms"] = time_ms(
                lambda: ek.erf_counts_fwd_vec_cuda(v, hist_edges, sig), 20)
            out["bwd_ms"] = time_ms(
                lambda: ek.erf_counts_bwd_vec_cuda(v, hist_edges, sig,
                                                   hcot), 20)
            out["fwd_plain_ms"] = time_ms(
                lambda: ek.erf_counts_fwd_plain(v, hist_edges, sig,
                                                PLAIN_CHUNK), 5, 1)
            out["bwd_plain_ms"] = time_ms(
                lambda: ek.erf_counts_bwd_plain(v, hist_edges, sig, hcot,
                                                PLAIN_CHUNK), 5, 1)
            log(f"{label}: vec forward {out['fwd_ms']:.4f} ms (plain "
                f"{out['fwd_plain_ms']:.3f} ms), backward "
                f"{out['bwd_ms']:.4f} ms (plain {out['bwd_plain_ms']:.3f} "
                "ms)")
        return out

    v, sig = hist_inputs(RAGGED_HALOS)
    v[-N_INF:] = float("inf")
    vec_dense(v, sig, f"N={RAGGED_HALOS:,}", timed=False)
    vec_1e6 = vec_dense(v[:HIST_CHUNK].clone(), sig[:HIST_CHUNK].clone(),
                        f"N={HIST_CHUNK:,}", timed=True)
    del v, sig
    v, sig = hist_inputs(BIG_HALOS)
    vec_1e8 = vec_dense(v, sig, f"N={BIG_HALOS:,}", timed=True)
    del v, sig

    # 8. fused kernels, scalar and per-particle sigma -------------------
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 8")
    fused_edges = torch.linspace(*FUSED_EDGES, device=dev)
    n_fused_edges = FUSED_EDGES[2]
    window = tb.fused_bin_window(fused_edges, FUSED_SIGMA_MAX)
    check(window == 33, f"fused window {window} != 33")
    fcot = torch.randn(n_fused_edges - 1, generator=gen, device=dev)

    def fused_case(v, sig, label, timed, compare=True):
        """The fused kernels against their plain versions (``compare``)
        and their median times (``timed``; the plain versions' too at the
        launch shape)."""
        start = tb.window_starts(torch.clamp(v, -ek.PAD_VALUE, ek.PAD_VALUE),
                                 fused_edges, sig, window)
        g = torch.randn(window - 1, v.shape[0], generator=gen, device=dev)
        out = {}
        if compare:
            masses = fk.fused_masses_fwd_cuda(v, fused_edges, sig, start,
                                              window)
            plain = fk.fused_masses_fwd_plain(v, fused_edges, sig, start,
                                              window)
            torch.cuda.synchronize()
            # Same float32 operations in the same order: equal to 1e-6.
            out["fwd_err"] = float((masses - plain).abs().max())
            check(out["fwd_err"] <= 1e-6,
                  f"{label}: fused forward error {out['fwd_err']}")
            check(torch.equal(masses, fk.fused_masses_fwd_cuda(
                v, fused_edges, sig, start, window)),
                f"{label}: fused forward not deterministic")
            del masses, plain
            out["bwd_err"] = grads_close(
                f"{label} fused", fk.fused_masses_bwd_cuda(
                    v, fused_edges, sig, start, window, g, True),
                fk.fused_masses_bwd_plain(v, fused_edges, sig, start, window,
                                          g, True))
            log(f"{label}: fused forward max|err| {out['fwd_err']:.3e}, "
                f"backward max|err| {out['bwd_err']:.3e}")
        if timed:
            out["fwd_ms"] = time_ms(lambda: fk.fused_masses_fwd_cuda(
                v, fused_edges, sig, start, window), 20)
            out["bwd_ms"] = time_ms(lambda: fk.fused_masses_bwd_cuda(
                v, fused_edges, sig, start, window, g), 20)
            if compare:
                out["fwd_plain_ms"] = time_ms(
                    lambda: fk.fused_masses_fwd_plain(
                        v, fused_edges, sig, start, window), 5, 1)
                out["bwd_plain_ms"] = time_ms(
                    lambda: fk.fused_masses_bwd_plain(
                        v, fused_edges, sig, start, window, g), 5, 1)
            log(f"{label}: fused forward {out['fwd_ms']:.4f} ms (plain "
                f"{out.get('fwd_plain_ms', float('nan')):.3f} ms), backward "
                f"{out['bwd_ms']:.4f} ms (plain "
                f"{out.get('bwd_plain_ms', float('nan')):.3f} ms)")
        return out

    v, sig = hist_inputs(RAGGED_HALOS)
    v[-N_INF:] = float("inf")
    sig = sig * (FUSED_SIGMA_MAX / 0.4)
    for s_label, s in (("scalar", torch.tensor(0.25, device=dev)),
                       ("vec", sig)):
        fused_case(v, s, f"N={RAGGED_HALOS:,} {s_label}", timed=False)
        counts_f = tb.binned_erf_counts(v, fused_edges, s, bin_mode="fused",
                                        bin_window=window)
        counts_d = tb.binned_erf_counts(v, fused_edges, s)
        f_err = float((counts_f - counts_d).abs().max())
        check(bool(torch.allclose(counts_f, counts_d, rtol=1e-5, atol=1e-4)),
              f"{s_label}: fused counts off dense by {f_err}")
        log(f"N={RAGGED_HALOS:,} {s_label}: fused counts against dense "
            f"max|err| {f_err:.3e} (counts up to "
            f"{float(counts_d.abs().max()):.6g}; rtol 1e-5, atol 1e-4)")
    fused_1e6 = fused_case(v[:HIST_CHUNK].clone(), sig[:HIST_CHUNK].clone(),
                           f"N={HIST_CHUNK:,} vec", timed=True)
    del v, sig
    v, sig = hist_inputs(BIG_HALOS)
    # At 1e8 the masses are 12.8 GB: time the kernels only.
    fused_1e8 = fused_case(v, sig * (FUSED_SIGMA_MAX / 0.4),
                           f"N={BIG_HALOS:,} vec", timed=True, compare=False)
    del v, sig
    torch.cuda.empty_cache()

    # 9. the history model, card against CPU ----------------------------
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 9")
    hist_guess = np.array(HIST_TRUTH, np.float32) + 0.05
    fused_kwargs = dict(bin_edges=np.linspace(*FUSED_EDGES),
                        obs_indices=FUSED_OBS, bin_mode="fused",
                        bin_window=window)
    # Two references on the CPU (the plain versions): the same model fed
    # the card's mean log M*, so that only the counts, the scatter and the
    # loss differ, at the tolerances of tests/test_galhalo_hist.py:110-118
    # (sumstats rtol 1e-4 atol 1e-10, loss rtol 1e-3, gradient rtol 1e-3
    # atol 1e-7); and the whole model on the CPU.  The latter also differs
    # in the history, whose log10/pow/cumsum PyTorch rounds differently on
    # the card: with 41 edges and six epochs the lowest late-epoch bins
    # hold only far Gaussian tails, which the log-space loss weighs like
    # any other bin.  There the whole model is held at loss rtol 2e-3 and
    # gradient rtol 8e-3: twice the worst gap of the dense path at the
    # same configuration (1.03e-3, 3.92e-3 over three parameter points at
    # 1e6 halos on an H100, tools/hist_card_vs_cpu.py), which has no fused
    # kernel on it.
    fed_limits = (1e-4, 1e-3, 1e-3)   # sumstats, loss, gradient
    cpu_limits = {"dense": fed_limits, "fused": (1e-4, 2e-3, 8e-3)}
    for mode, kwargs in (("dense", {}), ("fused", fused_kwargs)):
        gpu = GalhaloHistModel(aux_data=make_galhalo_hist_data(
            1_000_000, chunk_size=250_000, **kwargs))
        cpu = GalhaloHistModel(aux_data={
            k: (x.cpu() if isinstance(x, torch.Tensor) else x)
            for k, x in gpu.aux_data.items()})
        card = evaluate(gpu, hist_guess)
        at_truth = float(gpu.calc_loss_from_params(list(HIST_TRUTH)))
        for ref_name, ref, limit in (
                ("CPU fed the card's history",
                 evaluate_fed(cpu, gpu.aux_data, hist_guess), fed_limits),
                ("CPU", evaluate(cpu, hist_guess), cpu_limits[mode])):
            gap = gaps(card, ref)
            log(f"history {mode} at 1e6 halos: loss {card[1]:.7g} ("
                f"{ref_name} {ref[1]:.7g}); against {ref_name}: sumstats "
                f"rtol {gap['y_rtol']:.3e}, loss {gap['loss_rel']:.3e}, "
                f"gradient rtol {gap['grad_rtol']:.3e} (limits {limit})")
            check(all(g <= lim for g, lim in zip(
                (gap["y_rtol"], gap["loss_rel"], gap["grad_rtol"]), limit)),
                f"history {mode}: off {ref_name} by {gap}")
        log(f"history {mode}: gradient {card[2].tolist()}, loss at TRUTH "
            f"{at_truth:.3e}")
        check(at_truth < 1e-10, f"history {mode}: loss at TRUTH {at_truth}")
        del gpu, cpu

    # 10./11. the history path at 1e8 halos, dense then fused -----------
    def hist_path(mode, kwargs, nsteps, expect):
        log(f"[{time.perf_counter() - t_start:.0f} s] history path, {mode}")
        t0 = time.perf_counter()
        model = GalhaloHistModel(aux_data=make_galhalo_hist_data(
            BIG_HALOS, chunk_size=HIST_CHUNK, **kwargs))
        torch.cuda.synchronize()
        log(f"{mode}: data and target at {BIG_HALOS:,} halos in "
            f"{time.perf_counter() - t0:.2f} s")
        guess = np.array(HIST_TRUTH, np.float32) + 0.05
        model.run_adam(guess=guess, nsteps=2, learning_rate=HIST_LR,
                       progress=False)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        traj = model.run_adam(guess=guess, nsteps=nsteps,
                              learning_rate=HIST_LR, progress=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        log(f"{mode}: {nsteps} Adam steps at {BIG_HALOS:,} halos in "
            f"{seconds:.4f} s = {nsteps / seconds:.4f} steps/s; peak "
            f"memory {peak_gb:.3f} GB; launches {launches}")
        check(launches == dict.fromkeys(wrappers, 0) | expect,
              f"{mode}: launches {launches}, expected {expect}")
        check(peak_gb < 20.0, f"{mode}: peak memory {peak_gb} GB")
        check(tuple(traj.shape) == (nsteps + 1, 10)
              and bool(torch.isfinite(traj).all()),
              f"{mode}: trajectory not finite or of the wrong shape")
        loss_0 = float(model.calc_loss_from_params(traj[0]))
        loss_n = float(model.calc_loss_from_params(traj[-1]))
        log(f"{mode}: loss {loss_0:.6g} -> {loss_n:.6g}")
        check(loss_n < loss_0, f"{mode}: the loss did not decrease")
        profile_steps(model, 1, guess, HIST_LR)
        del model, traj
        torch.cuda.empty_cache()
        return launches, nsteps / seconds

    chunks = BIG_HALOS // HIST_CHUNK
    # Per step each chunk runs its forward twice (the pass itself and the
    # checkpoint's recompute in the backward) and its backward once, for
    # each epoch: 20 x 100 x 3 x 2 = 12,000 forward and 6,000 backward
    # launches dense; 20 x 100 x 6 x 2 = 24,000 and 12,000 fused.
    dense_launches, dense_sps = hist_path(
        "dense", {}, HIST_STEPS,
        {"erf_counts_fwd_vec": HIST_STEPS * chunks * 3 * 2,
         "erf_counts_bwd_vec": HIST_STEPS * chunks * 3})
    fused_launches, fused_sps = hist_path(
        "fused", fused_kwargs, HIST_STEPS,
        {"fused_masses_fwd": HIST_STEPS * chunks * len(FUSED_OBS) * 2,
         "fused_masses_bwd": HIST_STEPS * chunks * len(FUSED_OBS)})
    log(f"[{time.perf_counter() - t_start:.0f} s] history path: "
        f"{dense_sps:.4f} steps/s dense, {fused_sps:.4f} steps/s fused")

    # summary -----------------------------------------------------------

    # Bytes: each input read once, each output written once.
    fwd_bound, fwd_by = bound(
        4 * (n + n_edges + 1 + (n_edges - 1)),
        n * (FWD_OPS_PER_CDF * n_edges + FWD_OPS_PER_BIN * (n_edges - 1)))
    bwd_bound, bwd_by = bound(
        4 * (n + n_edges + 1 + (n_edges - 1) + n + n_edges + 1),
        n * BWD_OPS_PER_EDGE * n_edges)
    # The history path's launch shape: 1e6 particles, 14 edges (dense)
    # or 41 edges and a 33-edge window (fused), per-particle sigma.
    nc, e, w = HIST_CHUNK, n_hist_edges, window
    fwd_vec_bound = bound(
        4 * (2 * nc + e + (e - 1)),
        nc * (FWD_OPS_PER_CDF * e + FWD_OPS_PER_BIN * (e - 1) + INV_OPS))
    bwd_vec_bound = bound(
        4 * (2 * nc + e + (e - 1) + 2 * nc + e),
        nc * (VEC_BWD_OPS_PER_EDGE * e + INV_OPS + VEC_BWD_OPS))
    fused_fwd_bound = bound(
        4 * (3 * nc + n_fused_edges + (w - 1) * nc),
        nc * (FWD_OPS_PER_CDF * w + (w - 1) + INV_OPS))
    fused_bwd_bound = bound(
        4 * (3 * nc + n_fused_edges + (w - 1) * nc + 2 * nc),
        nc * (FUSED_BWD_OPS_PER_SLOT * w + FUSED_BWD_OPS))
    for label, (b_ms, b_by), big_ms in (
            ("erf_counts_fwd_vec", fwd_vec_bound, vec_1e8["fwd_ms"]),
            ("erf_counts_bwd_vec", bwd_vec_bound, vec_1e8["bwd_ms"]),
            ("fused_masses_fwd", fused_fwd_bound, fused_1e8["fwd_ms"]),
            ("fused_masses_bwd", fused_bwd_bound, fused_1e8["bwd_ms"])):
        log(f"{label}: bound {b_ms:.4f} ms at 1e6 ({b_by}); "
            f"{big_ms:.4f} ms at 1e8 (bound {100 * b_ms:.4f} ms)")

    def row(name, source, line, launches, out, key, b):
        return dict(name=name, route="cuda",
                    source=f"multigrad_tpu_torch/csrc/{source}",
                    replaces=f"multigrad_tpu/ops/pallas_kernels.py:{line}",
                    launches=launches[name], max_abs_err=out[f"{key}_err"],
                    ms=out[f"{key}_ms"], plain_ms=out[f"{key}_plain_ms"],
                    bound_ms=b[0], bound_by=b[1], library_ms=None)

    kernels = [
        row("erf_counts_fwd", "erf_counts.cu", 201, smf_launches, big,
            "fwd", (fwd_bound, fwd_by)),
        row("erf_counts_bwd", "erf_counts.cu", 237, smf_launches, big,
            "bwd", (bwd_bound, bwd_by)),
        row("erf_counts_fwd_vec", "erf_counts.cu", 201, dense_launches,
            vec_1e6, "fwd", fwd_vec_bound),
        row("erf_counts_bwd_vec", "erf_counts.cu", 237, dense_launches,
            vec_1e6, "bwd", bwd_vec_bound),
        row("fused_masses_fwd", "fused_masses.cu", 526, fused_launches,
            fused_1e6, "fwd", fused_fwd_bound),
        row("fused_masses_bwd", "fused_masses.cu", 553, fused_launches,
            fused_1e6, "bwd", fused_bwd_bound),
    ]
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel was not launched on its path: {kernels}")
    log(f"done in {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
