#!/usr/bin/env python3
"""Smoke run of multigrad_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``multigrad_tpu_torch/csrc/`` and runs, in
order:

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: ``nvcc`` of every ``csrc/*.cu`` for ``sm_90a``, all at once;
3. the dense scalar-sigma kernels against their plain PyTorch versions on
   the card, at N = 1,000,003 (a ragged tail, 1,000 of them ``+inf``) and
   at the SMF path's N = 1e8: the counts and all three gradients (scaled
   inside the kernel), every output bit-identical on repeat, and one
   kernel launch a wrapper call in a profiler window; their median times;
4. golden: an SMF model at 10,000 halos reproduces ``TARGET_SUMSTATS``;
5. the SMF path: ``SMFModel(make_smf_data(1e8)).run_adam`` for 20 steps,
   with each kernel's launch count over exactly that run; a profiler
   window of 5 steps holds one forward and one backward erf kernel a
   step, no ``sum_rows_kernel`` and no N-wide multiply;
6. recovery: at 1e6 halos, 300 Adam steps recover the truth (-2.0, 0.2);
7. the dense per-particle-sigma kernels against their plain versions at
   N = 1,000,003 (as in phase 3: all outputs, bit-identical on repeat,
   one launch a call), timed at the history path's launch shape (1e6
   particles, 14 edges) and at 1e8;
8. the fused kernels (one launch each way: the window start, the masses
   and their scatter into bins, or the cotangent's gather and every
   gradient, inside the kernel) against their plain versions, scalar and
   per-particle sigma, at N = 1,000,003 with 41 edges and a 33-edge
   window and at N = 100,003 with 16,384 edges and a 128-edge window:
   counts, dvalues, dedges and dsigma, every output bit-identical on
   repeat, one kernel a call of ``erf_counts_fused`` forward and
   backward in a profiler window; fused counts against dense counts;
   timed at 1e6 and 1e8 with the history path's per-particle sigma, with
   the wrapper and on the device;
9. the history model on the card against the same model on the CPU
   (the plain versions), fed the card's mean log M* and whole, at 1e6
   halos, dense and fused;
10. the history path, dense: ``GalhaloHistModel(make_galhalo_hist_data(
    1e8, chunk_size=1e6)).run_adam`` for 20 steps, launches counted;
11. the history path, fused: the same with 41 edges, six epochs and
    ``bin_mode="fused"``, launches counted; its profiled step runs no
    index, scatter, gather or search kernel beyond the dense step's;
12. the pair-count kernels against their plain versions at N = 100,003
    (projected with a box, 3D with and without a box, an asymmetric pair
    of blocks, edges from 0): the forward's counts and row sums (equal to
    the plain ones with unit weights), bit-identical on repeat, the row
    gradient from them and the pair sweep; an asymmetric pair through
    autograd, launches counted (the only path that sweeps); the three
    kernels timed at 1e5 and 1e6 halos; ``pair_rowgrad`` against
    ``torch.matmul(g, R)`` like for like (device ms from the profiler,
    ms with the call from CUDA events) and the host time of each piece
    of the wrappers' call path;
13. the wp(rp) model at 8,192 halos: loss at TRUTH, one loss and gradient
    on the card against the same model on the CPU, 150 Adam steps recover
    TRUTH; one loss and gradient of the xi(r) model;
14. the wp(rp) path: ``WprpModel(make_wprp_data(1e5, box_size=250,
    pimax=20)).run_adam`` for 20 steps, launches counted (a forward and a
    row gradient a step, no sweep), and seconds per loss and gradient at
    1e6 halos.

Any failure raises, so the run exits non-zero.  The last lines are one
JSON object per kernel run (``kernels``; ``device_ms`` is the kernel's
device time per launch in its path's profiler window), the ``nvidia-smi``
line, and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the package beside it, the script exits non-zero and prints no result.
It imports torch, numpy, the port and ``tools/hist_card_vs_cpu.py``
(phase 9's references) only.  Float32 matrix products run in full float32
(``torch.backends.cuda.matmul.allow_tf32 = False``): the pair counts'
plain versions are masked matrix-vector products.
"""
import json
import math
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
# The pair counts (bench.py:416-460 and :295-336): a galaxy mock in a
# 250 Mpc/h box, pimax 20, 8 r_p bins on logspace(-0.5, 1.2, 9); the xi
# bins logspace(-0.3, 1.1, 8).  f32 operations per pair, counted from
# csrc/pair_counts.cu: 19 with a box (differences 3, minimum image 9: |d|,
# a compare and a subtract a coordinate, squares and sums 3 projected or
# 5 in 3D, the pi cut 2 when projected, the range test 2); per pair inside
# the bins' range, 3 per bin (two compares and a predicated add); per row,
# 2 per bin for dw = sum_b g_b R_b (the row gradient, the sweep's end).
PAIR_HALOS, PAIR_BIG = 100_000, 1_000_000
PAIR_RAGGED = 100_003
PAIR_BOX, PAIR_PIMAX = 250.0, 20.0
PAIR_OPS, PAIR_OPS_PER_BIN, PAIR_ROW_OPS_PER_BIN = 19, 3, 2
PAIR_PLAIN_ROWS = 512
WPRP_GUESS = (-1.8, -0.8)
MAX_EDGES_FUSED = 16_384


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def device_times(fn):
    """Device time and launches by kernel name over ``fn()``
    (torch.profiler), ``{name: (us, launches)}``, and the wall us."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us, count = by_name.get(evt.name, (0.0, 0))
            by_name[evt.name] = (us + evt.time_range.elapsed_us(), count + 1)
    return by_name, wall_us


def kernel_device_ms(by_name, stem, flag=None):
    """Mean device ms per launch of the kernels called ``stem`` (whose last
    template argument is ``flag``, when given) in a ``device_times``
    window; None where the window holds none."""
    us = count = 0
    for name, (t, c) in by_name.items():
        if stem not in name:
            continue
        args = name.split(stem, 1)[1]
        if flag is not None and (not args.startswith("<") or args[1:].split(
                ">", 1)[0].replace(" ", "").split(",")[-1] != flag):
            continue
        us, count = us + t, count + c
    return us / count / 1e3 if count else None


def profile_steps(model, nsteps, guess=GUESS, learning_rate=0.02):
    """Device time by kernel over ``nsteps`` Adam steps (torch.profiler),
    and the device's busy share of the wall time; returns the
    ``device_times`` of the window."""
    by_name, wall_us = device_times(lambda: model.run_adam(
        guess=guess, nsteps=nsteps, learning_rate=learning_rate,
        progress=False))
    if not by_name:
        log("profile: the profiler saw no device time (not measured)")
        return by_name
    busy_us = sum(us for us, _ in by_name.values())
    log(f"profile of {nsteps} steps: wall {wall_us / nsteps / 1e3:.4f} "
        f"ms/step, device busy {busy_us / nsteps / 1e3:.4f} ms/step "
        f"({100 * busy_us / wall_us:.1f}%)")
    for name, (us, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:12]:
        log(f"  {us / nsteps / 1e3:.4f} ms/step, {count / nsteps:g} "
            f"launches/step: {name[:100]}")
    return by_name


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import numpy as np
    torch.backends.cuda.matmul.allow_tf32 = False
    import multigrad_tpu_torch
    pkg = os.path.dirname(os.path.abspath(multigrad_tpu_torch.__file__))
    if os.path.dirname(pkg) != HERE:
        raise ImportError(f"multigrad_tpu_torch found at {pkg}, not beside "
                          f"this script in {HERE}")
    from multigrad_tpu_torch.models import (GalhaloHistModel, SMFModel,
                                            TARGET_SUMSTATS,
                                            make_galhalo_hist_data,
                                            make_smf_data)
    from multigrad_tpu_torch.models import (WprpModel, XiModel,
                                            make_galaxy_mock, make_wprp_data,
                                            make_xi_data, selection_weights)
    from multigrad_tpu_torch.models.galhalo_hist import TRUTH as HIST_TRUTH
    from multigrad_tpu_torch.models.wprp import TRUTH as WPRP_TRUTH
    from multigrad_tpu_torch.ops import binned as tb
    from multigrad_tpu_torch.ops import cuda_build
    from multigrad_tpu_torch.ops import erf_kernels as ek
    from multigrad_tpu_torch.ops import fused_kernels as fk
    from multigrad_tpu_torch.ops import pair_kernels as pk
    from tools.hist_card_vs_cpu import evaluate, evaluate_fed, gaps
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

    def one_launch(label, fn, stem, calls=3):
        """A profiler window over ``calls`` calls of a dense erf wrapper
        holds ``calls`` launches of its one kernel and no other kernel (no
        ``sum_rows_kernel``, no PyTorch op).  Tried twice, in case the
        profiler drops an event."""
        fn()
        torch.cuda.synchronize()
        for attempt in (1, 2):
            by_name, _ = device_times(lambda: [fn() for _ in range(calls)])
            seen = {name: c for name, (_, c) in by_name.items()}
            if len(seen) == 1 and stem in next(iter(seen)) and \
                    next(iter(seen.values())) == calls:
                return
            log(f"{label}: profiler window {attempt} of {calls} calls saw "
                f"{seen}")
        check(False, f"{label}: not one {stem} launch a call: {seen}")

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
        check(all(torch.equal(a, b) for a, b in zip(
            bwd, ek.erf_counts_bwd_cuda(values, edges, s1, g))),
            f"{label}: backward not deterministic")
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
            f"backward max|err| {bwd_err:.3e} (dvalues, dedges, dsigma "
            "scaled in the kernel); every output bit-identical on repeat")
        out = dict(fwd_err=fwd_err, bwd_err=bwd_err)
        one_launch(f"{label} forward", lambda: ek.erf_counts_fwd_cuda(
            values, edges, s1), "erf_fwd_kernel")
        one_launch(f"{label} backward", lambda: ek.erf_counts_bwd_cuda(
            values, edges, s1, g), "erf_bwd_kernel")
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
    smf_profile = profile_steps(model, 5)
    # One erf kernel a call: neither sum_rows_kernel nor an N-wide
    # multiply (the old dv scaling, ~0.24 ms a step at 1e8) in the window.
    smf_seen = {name: c for name, (_, c) in smf_profile.items()}
    check(not any("sum_rows_kernel" in name for name in smf_seen),
          f"sum_rows_kernel on the SMF path: {smf_seen}")
    for stem in ("erf_fwd_kernel", "erf_bwd_kernel"):
        launched = sum(c for name, c in smf_seen.items() if stem in name)
        check(launched == 5, f"{launched} {stem} launches in 5 SMF steps")
    wide_mul = {name: us / c for name, (us, c) in smf_profile.items()
                if "Mul" in name and us / c > 50.0}
    check(not wide_mul, f"N-wide multiplies on the SMF path: {wide_mul}")
    log("SMF profile: one erf_fwd_kernel and one erf_bwd_kernel a step, "
        "no sum_rows_kernel, no N-wide multiply")
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

    def close(label, name, got, want, rtol=1e-3):
        """rtol plus atol 1e-5·max|want|, all finite; max |err|."""
        check(bool(torch.isfinite(got).all()), f"{label}: {name} not finite")
        scale = float(want.abs().max())
        excess = float(((got - want).abs() - rtol * want.abs()).max())
        check(excess <= 1e-5 * scale, f"{label}: {name} off by {excess} "
              f"beyond rtol {rtol}, atol {1e-5 * scale}")
        return float((got - want).abs().max())

    def grads_close(label, got, want):
        """Gradients: rtol 1e-3 plus atol 1e-5·max|grad|; max |err|."""
        return max(close(label, name, a, b) for name, a, b in zip(
            ("dvalues", "dedges", "dsigma"), got, want) if a is not None)

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
        bwd = ek.erf_counts_bwd_vec_cuda(v, hist_edges, sig, hcot)
        check(all(torch.equal(a, b) for a, b in zip(
            bwd, ek.erf_counts_bwd_vec_cuda(v, hist_edges, sig, hcot))),
            f"{label}: vec backward not deterministic")
        bwd_err = grads_close(
            f"{label} vec", bwd,
            ek.erf_counts_bwd_plain(v, hist_edges, sig, hcot, PLAIN_CHUNK))
        del bwd
        log(f"{label}: vec forward max|err| {fwd_err:.3e} (tol "
            f"{fwd_tol:.3e}), backward max|err| {bwd_err:.3e} (dvalues, "
            "dedges, dsigma scaled in the kernel); every output "
            "bit-identical on repeat")
        out = dict(fwd_err=fwd_err, bwd_err=bwd_err)
        one_launch(f"{label} vec forward", lambda: ek.erf_counts_fwd_vec_cuda(
            v, hist_edges, sig), "erf_fwd_kernel")
        one_launch(f"{label} vec backward",
                   lambda: ek.erf_counts_bwd_vec_cuda(v, hist_edges, sig,
                                                      hcot),
                   "erf_bwd_kernel")
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

    def fused_case(v, sig, label, timed, compare=True, edges=fused_edges,
                   win=window, g=fcot):
        """The fused kernels against their plain versions (``compare``:
        counts within 2e-5·max|count|, dvalues, dedges and dsigma rtol
        1e-3, atol 1e-5·max|grad|, every output bit-identical on repeat,
        one kernel a call of ``erf_counts_fused`` forward and backward in
        a profiler window) and their median times, with the wrapper (CUDA
        events) and on the device (profiler) (``timed``; the plain
        versions' too with ``compare``)."""
        out = {}
        if compare:
            fwd = fk.fused_counts_fwd_cuda(v, edges, sig, win)
            plain = fk.fused_counts_fwd_plain(v, edges, sig, win)
            torch.cuda.synchronize()
            out["fwd_err"] = float((fwd - plain).abs().max())
            fwd_tol = 2e-5 * float(plain.abs().max())
            check(out["fwd_err"] <= fwd_tol, f"{label}: fused forward error "
                  f"{out['fwd_err']} > {fwd_tol}")
            check(torch.equal(fwd, fk.fused_counts_fwd_cuda(v, edges, sig,
                                                            win)),
                  f"{label}: fused forward not deterministic")
            del plain
            bwd = fk.fused_counts_bwd_cuda(v, edges, sig, win, g, True)
            check(all(torch.equal(a, b) for a, b in zip(
                bwd, fk.fused_counts_bwd_cuda(v, edges, sig, win, g, True))),
                f"{label}: fused backward not deterministic")
            out["bwd_err"] = grads_close(
                f"{label} fused", bwd,
                fk.fused_counts_bwd_plain(v, edges, sig, win, g, True))
            del bwd
            log(f"{label}: fused forward max|err| {out['fwd_err']:.3e} (tol "
                f"{fwd_tol:.3e}), backward max|err| {out['bwd_err']:.3e} "
                "(dvalues, dedges, dsigma); every output bit-identical on "
                "repeat")
            # Through the entry point and autograd: one kernel each way.
            vg, sg = v.clone().requires_grad_(), sig.clone().requires_grad_()
            one_launch(f"{label} erf_counts_fused forward",
                       lambda: fk.erf_counts_fused(vg, edges, sg, win),
                       "fused_counts_fwd_kernel")
            counts = fk.erf_counts_fused(vg, edges, sg, win)
            one_launch(f"{label} erf_counts_fused backward",
                       lambda: torch.autograd.grad(counts, (vg, sg), g,
                                                   retain_graph=True),
                       "fused_counts_bwd_kernel")
            del vg, sg, counts
        if timed:
            out["fwd_ms"] = time_ms(lambda: fk.fused_counts_fwd_cuda(
                v, edges, sig, win), 20)
            out["bwd_ms"] = time_ms(lambda: fk.fused_counts_bwd_cuda(
                v, edges, sig, win, g), 20)
            by_name, _ = device_times(lambda: [
                (fk.fused_counts_fwd_cuda(v, edges, sig, win),
                 fk.fused_counts_bwd_cuda(v, edges, sig, win, g))
                for _ in range(10)])
            out["fwd_device_ms"] = kernel_device_ms(
                by_name, "fused_counts_fwd_kernel")
            out["bwd_device_ms"] = kernel_device_ms(
                by_name, "fused_counts_bwd_kernel")
            if compare:
                out["fwd_plain_ms"] = time_ms(
                    lambda: fk.fused_counts_fwd_plain(v, edges, sig, win),
                    5, 1)
                out["bwd_plain_ms"] = time_ms(
                    lambda: fk.fused_counts_bwd_plain(v, edges, sig, win, g),
                    5, 1)
            log(f"{label}: fused forward {out['fwd_ms']:.4f} ms with the "
                f"wrapper, {out['fwd_device_ms']} device ms (plain "
                f"{out.get('fwd_plain_ms', float('nan')):.3f} ms), backward "
                f"{out['bwd_ms']:.4f} ms, {out['bwd_device_ms']} device ms "
                f"(plain {out.get('bwd_plain_ms', float('nan')):.3f} ms)")
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
    # The largest edge count the kernels take (per-warp rows), at widths
    # a 128-edge window covers; 100,003 halos keep the plain dedges'
    # (W, runs x E) scatter rows at 2.6 GB.
    big_edges = torch.linspace(FUSED_EDGES[0], FUSED_EDGES[1], MAX_EDGES_FUSED,
                               device=dev)
    big_cot = torch.randn(MAX_EDGES_FUSED - 1, generator=gen, device=dev)
    v, sig = hist_inputs(PAIR_RAGGED)
    v[-N_INF:] = float("inf")
    sig = 0.0005 + sig * (0.0025 / 0.4)
    for s_label, s in (("scalar", sig[0].clone()), ("vec", sig)):
        fused_case(v, s, f"N={PAIR_RAGGED:,} E={MAX_EDGES_FUSED:,} W=128 "
                   f"{s_label}", timed=False, edges=big_edges, win=128,
                   g=big_cot)
    del v, sig, big_edges, big_cot
    v, sig = hist_inputs(BIG_HALOS)
    # At 1e8 the plain versions' (W-1, N) masses are 12.8 GB: time the
    # kernels only, with the history path's per-particle sigma.
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
        by_name = profile_steps(model, 1, guess, HIST_LR)
        del model, traj
        torch.cuda.empty_cache()
        return launches, nsteps / seconds, by_name

    chunks = BIG_HALOS // HIST_CHUNK
    # Per step each chunk runs its forward twice (the pass itself and the
    # checkpoint's recompute in the backward) and its backward once, for
    # each epoch: 20 x 100 x 3 x 2 = 12,000 forward and 6,000 backward
    # launches dense; 20 x 100 x 6 x 2 = 24,000 and 12,000 fused.
    dense_launches, dense_sps, dense_profile = hist_path(
        "dense", {}, HIST_STEPS,
        {"erf_counts_fwd_vec": HIST_STEPS * chunks * 3 * 2,
         "erf_counts_bwd_vec": HIST_STEPS * chunks * 3})
    fused_launches, fused_sps, fused_profile = hist_path(
        "fused", fused_kwargs, HIST_STEPS,
        {"fused_counts_fwd": HIST_STEPS * chunks * len(FUSED_OBS) * 2,
         "fused_counts_bwd": HIST_STEPS * chunks * len(FUSED_OBS)})
    log(f"[{time.perf_counter() - t_start:.0f} s] history path: "
        f"{dense_sps:.4f} steps/s dense, {fused_sps:.4f} steps/s fused")
    # The fused step's window start, scatter and gather run inside the
    # two kernels: none of PyTorch's search, index or scatter kernels (nor
    # sum_rows_kernel) appear in its profile beyond those the dense step
    # runs too.
    scatter_like = ("index", "scatter", "gather", "searchsorted",
                    "sum_rows_kernel")

    def scatter_kernels(by_name):
        return {name for name in by_name
                if any(word in name for word in scatter_like)}

    extra = scatter_kernels(fused_profile) - scatter_kernels(dense_profile)
    check(not extra, f"the fused step runs scatter or search kernels: {extra}")
    seen = {stem: sum(c for name, (_, c) in fused_profile.items()
                      if stem in name)
            for stem in ("fused_counts_fwd_kernel", "fused_counts_bwd_kernel")}
    log(f"fused history profile of one step: {seen} launches (counted "
        f"above: {chunks * len(FUSED_OBS) * 2} and {chunks * len(FUSED_OBS)} "
        "a step); no index, scatter, gather or search kernel beyond the "
        f"dense step's ({sorted(scatter_kernels(dense_profile)) or 'none'})")

    # 12. pair-count kernels against their plain versions ---------------
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 12")
    wp_edges = torch.logspace(-0.5, 1.2, 9, device=dev)
    xi_edges = torch.logspace(-0.3, 1.1, 8, device=dev)

    def mock(n, box, seed):
        pos, logm = make_galaxy_mock(n, box, seed=seed, device=dev)
        return pos, selection_weights(logm, WPRP_TRUTH).contiguous()

    def pair_case(label, p1, w1, p2, w2, edges, box, pimax):
        """Kernels against plain: counts rtol 1e-4 per bin (the same masks,
        float32 sums of up to N1·N2 products in another order), bit-
        identical on repeat, as are the row sums R (rtol 1e-4); dw rtol
        1e-3, atol 1e-5·max|dw|: dw1 from R (pair_rowgrad) and from the
        sweep, and a cross pair's dw2 from the sweep with the sides
        swapped."""
        esq = (edges * edges).contiguous()
        g = torch.linspace(-1.0, 2.0, esq.shape[0] - 1, device=dev)
        auto = p2 is p1
        got, rows = pk.pair_counts_fwd_cuda(p1, w1, p2, w2, esq, box, pimax,
                                            rows=True)
        want, rows_plain = pk.pair_counts_fwd_plain(
            p1, w1, p2, w2, esq, box, pimax, PAIR_PLAIN_ROWS, rows=True)
        torch.cuda.synchronize()
        fwd_err = float((got - want).abs().max())
        check(bool(torch.all((got - want).abs() <= 1e-4 * want.abs())),
              f"{label}: counts {got.tolist()} != plain {want.tolist()}")
        again, rows_again = pk.pair_counts_fwd_cuda(p1, w1, p2, w2, esq, box,
                                                    pimax, rows=True)
        check(torch.equal(got, again) and torch.equal(rows, rows_again),
              f"{label}: pair forward not deterministic")
        rows_err = close(label, "R", rows, rows_plain, 1e-4)
        del again, rows_again, rows_plain
        dw1, dw2 = pk.pair_counts_bwd_plain(p1, w1, p2, w2, esq, g, box,
                                            pimax, PAIR_PLAIN_ROWS, auto)
        row_err = close(label, "dw1 (pair_rowgrad)",
                        pk.pair_rowgrad_cuda(rows, g), dw1, 1e-3)
        sweep_err = close(label, "dw1 (sweep)", pk.pair_counts_bwd_cuda(
            p1, p2, w2, esq, g, box, pimax), dw1, 1e-3)
        if not auto:
            sweep_err = max(sweep_err, close(
                label, "dw2 (sweep)", pk.pair_counts_bwd_cuda(
                    p2, p1, w1, esq, g, box, pimax), dw2, 1e-3))
        log(f"{label}: counts max|err| {fwd_err:.3e} (counts up to "
            f"{float(want.abs().max()):.6g}), R max|err| {rows_err:.3e}, "
            f"dw max|err| {row_err:.3e} (pair_rowgrad), {sweep_err:.3e} "
            f"(sweep)")
        return dict(fwd_err=fwd_err, rowgrad_err=row_err,
                    bwd_err=sweep_err, counts=got, dw1=dw1, dw2=dw2, g=g)

    pos, w = mock(PAIR_RAGGED, PAIR_BOX, 12)
    wp_case = pair_case(f"pair N={PAIR_RAGGED:,} projected, box",
                        pos, w, pos, w, wp_edges, PAIR_BOX, PAIR_PIMAX)
    # Unit weights: R holds pair counts, integers below 2^24, so kernel and
    # plain agree exactly only if every pair's mask does.
    ones = torch.ones_like(w)
    wp_esq = (wp_edges * wp_edges).contiguous()
    _, unit_rows = pk.pair_counts_fwd_cuda(pos, ones, pos, ones, wp_esq,
                                           PAIR_BOX, PAIR_PIMAX, rows=True)
    _, unit_plain = pk.pair_counts_fwd_plain(pos, ones, pos, ones, wp_esq,
                                             PAIR_BOX, PAIR_PIMAX,
                                             PAIR_PLAIN_ROWS, rows=True)
    check(float(unit_plain.max()) < 2 ** 24 and float(unit_plain.sum()) > 0,
          "unit-weight row sums out of the exact range")
    check(torch.equal(unit_rows, unit_plain),
          f"unit-weight row sums differ from plain in "
          f"{int((unit_rows != unit_plain).sum())} entries")
    log(f"pair N={PAIR_RAGGED:,} unit weights: R equals plain exactly "
        f"({float(unit_plain.sum()):.10g} ordered pairs binned)")
    del ones, unit_rows, unit_plain
    pos2, w2 = mock(60_001, PAIR_BOX, 13)
    cross = pair_case(f"pair {PAIR_RAGGED:,} x 60,001 projected, box", pos,
                      w, pos2, w2, wp_edges, PAIR_BOX, PAIR_PIMAX)
    # The same pair of blocks through autograd: the path that sweeps.
    a, b = w.clone().requires_grad_(), w2.clone().requires_grad_()
    reset_launches()
    counts = pk.pair_counts(pos, a, pos2, b, wp_edges, box_size=PAIR_BOX,
                            pimax=PAIR_PIMAX)
    (counts * cross["g"]).sum().backward()
    torch.cuda.synchronize()
    cross_launches = read_launches()
    log(f"cross-correlation through autograd: launches {cross_launches}")
    check(cross_launches == dict.fromkeys(wrappers, 0) | {
        "pair_counts_fwd": 1, "pair_rowgrad": 1, "pair_counts_bwd": 1},
        f"cross-correlation launches {cross_launches}")
    close("cross autograd", "dw1", a.grad, cross["dw1"], 1e-3)
    close("cross autograd", "dw2", b.grad, cross["dw2"], 1e-3)
    del pos, w, pos2, w2, a, b, counts
    pos, w = mock(PAIR_RAGGED, 75.0, 14)
    pair_case(f"pair N={PAIR_RAGGED:,} 3D, box 75", pos, w, pos, w,
              xi_edges, 75.0, None)
    pair_case(f"pair N={PAIR_RAGGED:,} 3D, no box", pos, w, pos, w,
              xi_edges, None, None)
    zero = pair_case(f"pair N={PAIR_RAGGED:,} 3D, edges from 0", pos, w,
                     pos, w, torch.tensor([0.0, 1.0, 4.0], device=dev),
                     75.0, None)
    check(float(zero["counts"][0]) >= float((w * w).sum()),
          "edges from 0: the self pairs are missing from the first bin")
    del pos, w

    def pair_times(n, reps, plain):
        """Median kernel times on the wp path's shape at n halos (the
        forward as the path runs it, with R), the plain versions' and the
        library product's (``plain``), the sweep's device time, and the
        pairs inside the bins' range."""
        p, wt = mock(n, PAIR_BOX, 15)
        esq = (wp_edges * wp_edges).contiguous()
        g = torch.linspace(-1.0, 2.0, 8, device=dev)
        _, rows = pk.pair_counts_fwd_cuda(p, wt, p, wt, esq, PAIR_BOX,
                                          PAIR_PIMAX, rows=True)

        def sweep():
            return pk.pair_counts_bwd_cuda(p, p, wt, esq, g, PAIR_BOX,
                                           PAIR_PIMAX)

        out = dict(
            fwd_ms=time_ms(lambda: pk.pair_counts_fwd_cuda(
                p, wt, p, wt, esq, PAIR_BOX, PAIR_PIMAX, rows=True), reps, 1),
            rowgrad_ms=time_ms(lambda: pk.pair_rowgrad_cuda(rows, g), 50),
            bwd_ms=time_ms(sweep, reps, 1))
        # Unit weights count the pairs the kernels bin (the pi cut and the
        # range test passed): the data-dependent part of the work.
        ones = torch.ones_like(wt)
        out["in_range"] = float(pk.pair_counts_fwd_cuda(
            p, ones, p, ones, esq, PAIR_BOX, PAIR_PIMAX).double().sum())
        if plain:
            out["fwd_plain_ms"] = time_ms(lambda: pk.pair_counts_fwd_plain(
                p, wt, p, wt, esq, PAIR_BOX, PAIR_PIMAX, PAIR_PLAIN_ROWS,
                rows=True), 3, 1)
            out["rowgrad_plain_ms"] = time_ms(
                lambda: pk.pair_rowgrad_plain(rows, g), 50)
            out["rowgrad_library_ms"] = time_ms(
                lambda: torch.matmul(g, rows), 50)
            out["bwd_plain_ms"] = time_ms(lambda: pk.pair_counts_bwd_plain(
                p, wt, p, wt, esq, g, PAIR_BOX, PAIR_PIMAX, PAIR_PLAIN_ROWS,
                True), 3, 1)
            by_name, _ = device_times(lambda: [sweep() for _ in range(3)])
            out["bwd_device_ms"] = kernel_device_ms(by_name,
                                                    "pair_bwd_kernel")
        log(f"pair kernels at {n:,} halos: forward {out['fwd_ms']:.4f} ms, "
            f"pair_rowgrad {out['rowgrad_ms']:.4f} ms, sweep "
            f"{out['bwd_ms']:.4f} ms (plain "
            f"{out.get('fwd_plain_ms', float('nan')):.3f} / "
            f"{out.get('rowgrad_plain_ms', float('nan')):.4f} / "
            f"{out.get('bwd_plain_ms', float('nan')):.3f} ms; torch.matmul "
            f"{out.get('rowgrad_library_ms', float('nan')):.4f} ms); "
            f"{out['in_range']:.6g} of {float(n) ** 2:.6g} pairs in range")
        return out

    pair_1e5 = pair_times(PAIR_HALOS, 20, plain=True) | {
        "fwd_err": wp_case["fwd_err"], "rowgrad_err": wp_case["rowgrad_err"],
        "bwd_err": cross["bwd_err"]}

    def rowgrad_like_for_like(n):
        """Kernel 6r against ``torch.matmul(g, R)`` on the same inputs:
        device ms a call (every kernel of a 50-call profiler window), and
        the host microseconds a call of each piece of the wrapper's call
        path (2,000 calls, host clock, before a synchronize)."""
        p, wt = mock(n, PAIR_BOX, 15)
        esq = (wp_edges * wp_edges).contiguous()
        g = torch.linspace(-1.0, 2.0, 8, device=dev)
        _, rows = pk.pair_counts_fwd_cuda(p, wt, p, wt, esq, PAIR_BOX,
                                          PAIR_PIMAX, rows=True)
        device = rows.device
        out = {}
        for key, fn in (("rowgrad", lambda: pk.pair_rowgrad_cuda(rows, g)),
                        ("matmul", lambda: torch.matmul(g, rows))):
            fn()
            by_name, _ = device_times(lambda: [fn() for _ in range(50)])
            out[f"{key}_device_ms"] = (sum(us for us, _ in by_name.values())
                                       / 50 / 1e3 if by_name else None)
        lib = cuda_build.load(pk.SOURCE, pk._SIGNATURES)
        dw = torch.empty(n, dtype=torch.float32, device=device)
        args = (rows.data_ptr(), n, g.data_ptr(), 8, dw.data_ptr(),
                cuda_build.row_blocks(n), cuda_build.stream(device))

        def old_device_and_stream():
            with torch.cuda.device(device):
                return torch.cuda.current_stream(device).cuda_stream

        pieces = {
            "pair_rowgrad_cuda, the whole call": lambda: pk.pair_rowgrad_cuda(
                rows, g),
            "torch.matmul(g, R)": lambda: torch.matmul(g, rows),
            "the ctypes call and launch alone": lambda: lib.pair_rowgrad(
                *args),
            "torch.empty": lambda: torch.empty(n, dtype=torch.float32,
                                               device=device),
            "argument checks": lambda: pk._check_float32(
                device, [("rows", rows), ("g", g)]),
            "cuda_build.load": lambda: cuda_build.load(pk.SOURCE,
                                                       pk._SIGNATURES),
            "cuda_build.stream (raw handle)": lambda: cuda_build.stream(
                device),
            "torch.cuda.current_device": torch.cuda.current_device,
            "torch.cuda.device + current_stream (no longer used)":
                old_device_and_stream}
        host = {}
        for name, fn in pieces.items():
            for _ in range(200):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2000):
                fn()
            host[name] = (time.perf_counter() - t0) / 2000 * 1e6
            torch.cuda.synchronize()
        out["host_us"] = host
        log(f"6r at {n:,} halos: device ms a call pair_rowgrad "
            f"{out['rowgrad_device_ms']}, torch.matmul {out['matmul_device_ms']}"
            "; host us a call: " + ", ".join(
                f"{k} {v:.2f}" for k, v in host.items()))
        return out

    pair_1e5 |= rowgrad_like_for_like(PAIR_HALOS)
    pair_1e6 = pair_times(PAIR_BIG, 3, plain=False)

    # 13. the wp(rp) model at 8,192 halos -------------------------------
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 13")
    wprp = WprpModel(aux_data=make_wprp_data(8192, box_size=100.0))
    at_truth = float(wprp.calc_loss_from_params(WPRP_TRUTH))
    check(at_truth < 1e-10, f"wp(rp) loss at TRUTH {at_truth}")
    wprp_cpu = WprpModel(aux_data={
        k: (x.cpu() if isinstance(x, torch.Tensor) else x)
        for k, x in wprp.aux_data.items()})
    params = (-1.9, -0.9)
    loss_g, grad_g = wprp.calc_loss_and_grad_from_params(params)
    loss_c, grad_c = wprp_cpu.calc_loss_and_grad_from_params(params)
    log(f"wp(rp) at 8,192 halos: loss at TRUTH {at_truth:.3e}; at "
        f"{params}: card {float(loss_g):.7g} {grad_g.tolist()}, CPU "
        f"{float(loss_c):.7g} {grad_c.tolist()}")
    # tests/test_torch_wprp.py's tolerances against the JAX package.
    check(abs(float(loss_g) - float(loss_c)) <= 1e-3 * abs(float(loss_c)),
          "wp(rp) loss on the card differs from the CPU")
    check(bool(torch.allclose(grad_g.cpu(), grad_c, rtol=1e-3, atol=1e-6)),
          "wp(rp) gradient on the card differs from the CPU")
    t0 = time.perf_counter()
    traj = wprp.run_adam(guess=WPRP_GUESS, nsteps=150, learning_rate=0.02,
                         progress=False)
    final = traj[-1].cpu().numpy()
    log(f"wp(rp) recovery: 150 steps at 8,192 halos -> {final.tolist()} "
        f"in {time.perf_counter() - t0:.2f} s")
    check(np.allclose(final, WPRP_TRUTH, atol=0.05),
          f"wp(rp) fit ended at {final}")
    xi = XiModel(aux_data=make_xi_data(8192, 75.0))
    xi_loss, xi_grad = xi.calc_loss_and_grad_from_params(params)
    log(f"xi(r) at 8,192 halos: loss {float(xi_loss):.7g}, gradient "
        f"{xi_grad.tolist()}")
    check(bool(torch.isfinite(xi_loss)) and xi_grad.shape == (2,)
          and bool(torch.isfinite(xi_grad).all()), "xi(r) not finite")
    del wprp, wprp_cpu, xi, traj

    # 14. the wp(rp) path at catalog scale ------------------------------
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 14")
    t0 = time.perf_counter()
    wprp = WprpModel(aux_data=make_wprp_data(PAIR_HALOS, box_size=PAIR_BOX,
                                             pimax=PAIR_PIMAX))
    torch.cuda.synchronize()
    log(f"wp(rp): data and target at {PAIR_HALOS:,} halos in "
        f"{time.perf_counter() - t0:.2f} s")
    wprp.run_adam(guess=WPRP_GUESS, nsteps=2, learning_rate=0.02,
                  progress=False)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    traj = wprp.run_adam(guess=WPRP_GUESS, nsteps=20, learning_rate=0.02,
                         progress=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    wprp_launches = read_launches()
    wprp_sps = 20 / seconds
    log(f"wp(rp) path: 20 Adam steps at {PAIR_HALOS:,} halos in "
        f"{seconds:.4f} s = {wprp_sps:.3f} steps/s; launches "
        f"{wprp_launches}")
    # An autocorrelation: one forward (with R) and one row gradient a step,
    # no sweep.
    check(wprp_launches == dict.fromkeys(wrappers, 0) | {
        "pair_counts_fwd": 20, "pair_rowgrad": 20},
        f"kernel launches on the wp(rp) path: {wprp_launches}")
    check(tuple(traj.shape) == (21, 2) and bool(torch.isfinite(traj).all()),
          "wp(rp) trajectory not finite or of the wrong shape")
    loss_0 = float(wprp.calc_loss_from_params(traj[0]))
    loss_20 = float(wprp.calc_loss_from_params(traj[-1]))
    log(f"wp(rp) path: loss {loss_0:.6g} -> {loss_20:.6g}, params "
        f"{traj[-1].tolist()}")
    check(loss_20 < loss_0, "the wp(rp) loss did not decrease")
    wp_profile = profile_steps(wprp, 3, WPRP_GUESS, 0.02)
    del wprp, traj
    t0 = time.perf_counter()
    wprp = WprpModel(aux_data=make_wprp_data(PAIR_BIG, box_size=PAIR_BOX,
                                             pimax=PAIR_PIMAX))
    torch.cuda.synchronize()
    log(f"wp(rp): data and target at {PAIR_BIG:,} halos in "
        f"{time.perf_counter() - t0:.2f} s")
    big_times = []
    for _ in range(4):      # one warm-up, then 3 timed
        t0 = time.perf_counter()
        loss, grad = wprp.calc_loss_and_grad_from_params(WPRP_GUESS)
        torch.cuda.synchronize()
        big_times.append(time.perf_counter() - t0)
    check(bool(torch.isfinite(loss)) and bool(torch.isfinite(grad).all()),
          "wp(rp) at 1e6 halos not finite")
    log(f"wp(rp) at {PAIR_BIG:,} halos: loss and gradient in "
        f"{statistics.median(big_times[1:]):.4f} s (median of "
        f"{[round(t, 4) for t in big_times[1:]]}, warm-up "
        f"{big_times[0]:.4f} s); loss {float(loss):.6g}")
    del wprp
    torch.cuda.empty_cache()

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
    # The fused kernels (one launch each way):
    # values and sigma read once, the edges (and the counts' cotangent)
    # once, the counts (or dv and dsigma) written once; no masses.  Per
    # particle the window start (the clip, x = v - half·sigma: 3; a compare
    # and a select per step of the search over E edges: 2·ceil(log2 E);
    # the clip to [0, E-W]: 2) and, forward, W cdfs, W-1 differences and
    # W-1 adds into the bins.
    search = 5 + 2 * math.ceil(math.log2(n_fused_edges))

    def fused_bounds(n):
        """The fused forward's and backward's bounds for ``n`` particles
        with a per-particle sigma."""
        return (bound(4 * (2 * n + n_fused_edges + (n_fused_edges - 1)),
                      n * (FWD_OPS_PER_CDF * w + 2 * (w - 1) + INV_OPS
                           + search)),
                bound(4 * (2 * n + n_fused_edges + (n_fused_edges - 1)
                           + 2 * n),
                      n * (FUSED_BWD_OPS_PER_SLOT * w + FUSED_BWD_OPS
                           + search)))

    fused_fwd_bound, fused_bwd_bound = fused_bounds(nc)
    # The pair kernels at the wp(rp) path's shape (an autocorrelation of
    # PAIR_HALOS, 9 edges): positions and weights read once, counts and R,
    # or dw, written once; every pair's separation, and the bins of the
    # pairs in range (counted in this run, phase 12).  The row gradient
    # reads R and writes dw.
    def pair_bounds(n, in_range):
        nb = 8
        pairs = n * n * PAIR_OPS + in_range * PAIR_OPS_PER_BIN * nb
        fwd = bound(4 * (4 * n + (nb + 1) + nb + nb * n), pairs)
        rowgrad = bound(4 * (nb * n + nb + n), PAIR_ROW_OPS_PER_BIN * nb * n)
        sweep = bound(4 * (4 * n + (nb + 1) + nb + n),
                      pairs + PAIR_ROW_OPS_PER_BIN * nb * n)
        return fwd, rowgrad, sweep

    pair_fwd_bound, pair_row_bound, pair_bwd_bound = pair_bounds(
        PAIR_HALOS, pair_1e5["in_range"])
    for n, times in ((PAIR_HALOS, pair_1e5), (PAIR_BIG, pair_1e6)):
        fb, rb, bb = pair_bounds(n, times["in_range"])
        log(f"pair kernels at {n:,}: forward {times['fwd_ms']:.4f} ms (bound "
            f"{fb[0]:.4f}, {fb[1]}), pair_rowgrad {times['rowgrad_ms']:.4f} "
            f"ms (bound {rb[0]:.4f}, {rb[1]}), sweep {times['bwd_ms']:.4f} "
            f"ms (bound {bb[0]:.4f}, {bb[1]})")
    # At 1e8 the same per-particle work 100 times over (the edges once).
    big_fused = fused_bounds(BIG_HALOS)
    for label, (b_ms, b_by), big_ms, big_bound in (
            ("erf_counts_fwd_vec", fwd_vec_bound, vec_1e8["fwd_ms"],
             100 * fwd_vec_bound[0]),
            ("erf_counts_bwd_vec", bwd_vec_bound, vec_1e8["bwd_ms"],
             100 * bwd_vec_bound[0]),
            ("fused_counts_fwd", fused_fwd_bound, fused_1e8["fwd_ms"],
             big_fused[0][0]),
            ("fused_counts_bwd", fused_bwd_bound, fused_1e8["bwd_ms"],
             big_fused[1][0])):
        log(f"{label}: bound {b_ms:.4f} ms at 1e6 ({b_by}); "
            f"{big_ms:.4f} ms at 1e8 (bound {big_bound:.4f} ms)")

    def row(name, line, launches, path, out, key, b, device_ms,
            source="pair_counts.cu", library_ms=None):
        if device_ms is None:
            log(f"{name}: the profiler saw no device time; device_ms from "
                "CUDA events around the launch")
            device_ms = out[f"{key}_ms"]
        return dict(name=name, route="cuda",
                    source=f"multigrad_tpu_torch/csrc/{source}",
                    replaces=f"multigrad_tpu/ops/pallas_kernels.py:{line}",
                    launches=launches[name], launches_on=path,
                    max_abs_err=out[f"{key}_err"], ms=out[f"{key}_ms"],
                    device_ms=device_ms, plain_ms=out[f"{key}_plain_ms"],
                    bound_ms=b[0], bound_by=b[1], library_ms=library_ms)

    smf_path = f"SMF, {BIG_HALOS:,} halos, 20 Adam steps"
    hist_run = f"{BIG_HALOS:,} halos, {HIST_STEPS} Adam steps"
    kernels = [
        row("erf_counts_fwd", 201, smf_launches, smf_path, big, "fwd",
            (fwd_bound, fwd_by),
            kernel_device_ms(smf_profile, "erf_fwd_kernel", "false"),
            "erf_counts.cu"),
        row("erf_counts_bwd", 237, smf_launches, smf_path, big, "bwd",
            (bwd_bound, bwd_by),
            kernel_device_ms(smf_profile, "erf_bwd_kernel", "false"),
            "erf_counts.cu"),
        row("erf_counts_fwd_vec", 201, dense_launches,
            f"history dense, {hist_run}", vec_1e6, "fwd", fwd_vec_bound,
            kernel_device_ms(dense_profile, "erf_fwd_kernel", "true"),
            "erf_counts.cu"),
        row("erf_counts_bwd_vec", 237, dense_launches,
            f"history dense, {hist_run}", vec_1e6, "bwd", bwd_vec_bound,
            kernel_device_ms(dense_profile, "erf_bwd_kernel", "true"),
            "erf_counts.cu"),
        row("fused_counts_fwd", 526, fused_launches,
            f"history fused, {hist_run}", fused_1e6, "fwd", fused_fwd_bound,
            kernel_device_ms(fused_profile, "fused_counts_fwd_kernel"),
            "fused_counts.cu"),
        row("fused_counts_bwd", 553, fused_launches,
            f"history fused, {hist_run}", fused_1e6, "bwd", fused_bwd_bound,
            kernel_device_ms(fused_profile, "fused_counts_bwd_kernel"),
            "fused_counts.cu"),
        row("pair_counts_fwd", 837, wprp_launches,
            f"wp(rp), {PAIR_HALOS:,} halos, 20 Adam steps", pair_1e5,
            "fwd", pair_fwd_bound,
            kernel_device_ms(wp_profile, "pair_fwd_kernel")),
        row("pair_rowgrad", 879, wprp_launches,
            f"wp(rp), {PAIR_HALOS:,} halos, 20 Adam steps", pair_1e5,
            "rowgrad", pair_row_bound,
            kernel_device_ms(wp_profile, "pair_rowgrad_kernel"),
            library_ms=pair_1e5["rowgrad_library_ms"])
        | {"device_ms_like_for_like": pair_1e5["rowgrad_device_ms"],
           "library_device_ms": pair_1e5["matmul_device_ms"]},
        # No one-process model path sweeps the pairs in its backward: the
        # sweep's launches are those of phase 12's cross-correlation.
        row("pair_counts_bwd", 879, cross_launches,
            "phase 12's cross-correlation through autograd", pair_1e5,
            "bwd", pair_bwd_bound, pair_1e5["bwd_device_ms"]),
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
