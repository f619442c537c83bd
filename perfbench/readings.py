#!/usr/bin/env python3
"""The readings that each cell's limits are set from, in one process.

    python3 perfbench/readings.py --workload smf_1e9.adam \
        --seeds 101 102 103 --control-seeds 201 202 203 --seconds 2

For every ``--seeds`` seed, a run of the cell as ``run.py`` makes it
(set-up, a short window, the check) and its numbers compared.  For every
``--control-seeds`` seed, the same numbers of two stand-ins put in the
program's place, each fitting its own guesses from the seed's catalog:

- ``control``: the plain reference computed in bfloat16 (the catalog,
  the sumstats, the loss and the gradient; the parameters and Adam's
  moments stay float32): the precision below the configuration's
  float32;
- ``half``: the plain reference in float64 with half of the catalog left
  out and the mean taken over the rest (the sumstats from the first
  half, over half the volume).

Prints one JSON line a reading, and the largest program reading and the
smallest stand-in reading of each number.  The benchmark's own runs do
not run this.
"""
import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def stand_in_fits(bench, cell, seed: int, kind: str, device, overrides=None):
    """The fits of the stand-in ``kind`` (``control`` or ``half``) over the
    seed's catalog, and the float64 reference they are judged by."""
    import torch
    from perfbench.core.record import Fit
    from perfbench.core.compare import STEPS, sample
    from perfbench.programs.common import Guesses
    from perfbench.reference.adam import adam_steps
    config = dict(bench.config(cell.config), **(overrides or {}))
    traffic = bench.traffic(cell.traffic)
    inputs = {"log_halo_masses": bench.module(
        "programs", config["model"]).catalog(config, seed, device)}
    ref_mod = bench.module("reference", config["model"])
    if kind == "control":
        stand_in = ref_mod.Reference(config, inputs, torch.bfloat16)
    else:
        stand_in = ref_mod.Reference(config, inputs, torch.float64,
                                     half=True)
    dtype = stand_in.dtype

    def loss_and_grad(p):
        loss, grad = stand_in.loss_and_grad(p.to(dtype))
        return loss.to(p.dtype), grad.to(p.dtype)

    guesses = Guesses(traffic["guess"], config["truth"], seed)
    fits = []
    for _ in range(int(traffic["check_fits"])):
        g = torch.tensor(guesses.next(), dtype=torch.float32, device=device)
        traj, _, _ = adam_steps(loss_and_grad, g, STEPS,
                             float(traffic["learning_rate"]))
        loss = stand_in.loss(traj[-1].to(dtype))
        fits.append(Fit(guess=g.double().cpu().numpy(),
                        traj=traj.double().cpu().numpy(), loss=loss,
                        submitted=0.0, done=0.0))
    del stand_in
    reference = ref_mod.Reference(config, inputs, torch.float64)
    return sample(fits, len(fits), seed), reference, traffic


def fit_readings(fits, reference, learning_rate):
    """The largest of each number over ``fits``, and each fit's detail
    (each parameter's gap, the reference's first gradient)."""
    from perfbench.core.compare import readings
    out, detail = {}, []
    for fit in fits:
        values = readings(fit, reference, learning_rate, detail=True)
        detail.append({k: values.pop(k) for k in ("per_param", "first_grad")})
        for name, value in values.items():
            out[name] = max(out.get(name, 0.0), value)
    return out, detail


def stand_in_readings(bench, cell, seed, kind, device, overrides=None):
    """The largest of each number over the stand-in's fits, and their
    detail."""
    fits, reference, traffic = stand_in_fits(bench, cell, seed, kind,
                                             device, overrides)
    return fit_readings(fits, reference, float(traffic["learning_rate"]))


def main(argv=None):
    from perfbench.core import harness
    from perfbench.core.compare import sample
    from perfbench.core.registry import Benchmark
    p = argparse.ArgumentParser(prog="perfbench/readings.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    harness.cache_dirs(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    bench = Benchmark(ROOT)
    cell = bench.cell(args.workload)
    worst, least = {}, {}
    traffic = bench.traffic(cell.traffic)
    for seed in args.seeds:
        t = time.perf_counter()
        got = {}

        def on_fits(fits, reference, learning_rate, seed=seed):
            got["values"], got["detail"] = fit_readings(
                sample(fits, int(traffic["check_fits"]), seed,
                       int(traffic.get("check_last", 1))), reference,
                learning_rate)

        r = harness.run(ROOT, cell.name, seed, args.seconds, False,
                        start=time.perf_counter(), on_fits=on_fits)
        values = dict(got["values"], failed_fits=r["failed"],
                      start_gap=r["checks"]["start_gap"]["value"])
        for k, v in values.items():
            worst[k] = max(worst.get(k, 0.0), v)
        print(json.dumps({"cell": cell.name, "seed": seed, "side": "program",
                          "readings": values, "detail": got["detail"],
                          "correct": r["correct"], "metrics": r["metrics"],
                          "s": time.perf_counter() - t}), flush=True)
    for kind in ("control", "half"):
        for seed in args.control_seeds:
            t = time.perf_counter()
            values, detail = stand_in_readings(bench, cell, seed, kind,
                                               "cuda")
            for k, v in values.items():
                least.setdefault(kind, {})
                least[kind][k] = min(least[kind].get(k, float("inf")), v)
            print(json.dumps({"cell": cell.name, "seed": seed, "side": kind,
                              "readings": values, "detail": detail,
                              "s": time.perf_counter() - t}), flush=True)
            torch.cuda.empty_cache()
    print(json.dumps({"cell": cell.name, "program_largest": worst,
                      "stand_in_smallest": least}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
