"""One run of one cell: set-up, the measured window, the check, the line.

``run(...)`` is the run itself; ``main`` is its command line, which
refuses to run without enough CUDA cards.  A run

1. reads the cell's configuration, traffic mix and limits
   (:mod:`.registry`), and builds the port's model from the
   configuration and the seed on the device (``programs/<model>.py``);
2. warms up the shapes of the cell's traffic (``drivers/<driver>.py``):
   set-up ends here, and ``setup_s`` is the time from the process's
   start;
3. measures for ``seconds`` seconds; with ``trace`` a profiler window
   (:mod:`.trace`) covers a part of it;
4. reads the device's peak memory, frees the program's state, holds
   every fit of the window to its guess and a sample of them against the
   plain reference (:mod:`.compare`), in float64;
5. with ``trace``, reads the cell's per-layer metrics
   (``metrics/<metric>.py``), else takes its end-to-end metrics from the
   driver;
6. refuses to print a result if a module of JAX or of the JAX package
   was loaded, prints each number compared beside its limit on standard
   error, and prints the result line last on standard output.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time
from types import SimpleNamespace

import numpy as np

from perfbench.core import compare
from perfbench.core.registry import Benchmark
from perfbench.core.trace import Window

#: Top-level module names that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "multigrad_tpu")


class RunError(RuntimeError):
    """A run that cannot give a result."""


def cache_dirs(root: str):
    """Every build and kernel cache inside the checkout, at fixed paths.
    Set before the program is imported."""
    base = os.path.join(root, "build", "perfbench")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base,
                                                      "torch_extensions")
    os.environ["MGT_TUNING_TABLE"] = os.path.join(
        root, "build", "multigrad_tpu_torch.tuning.json")


def check_program(root: str):
    """The port that runs is the checkout's own, not one installed
    elsewhere: a directory without it gives no result."""
    try:
        import multigrad_tpu_torch as port
    except ImportError as e:
        raise RunError(f"no multigrad_tpu_torch beside the benchmark: {e}")
    want = os.path.realpath(os.path.join(root, "multigrad_tpu_torch"))
    got = os.path.realpath(os.path.dirname(port.__file__))
    if got != want:
        raise RunError(f"multigrad_tpu_torch comes from {got}, not from "
                       f"the checkout ({want})")


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def _finite(x):
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    return x


def run(root: str, workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", start: float | None = None,
        overrides: dict | None = None, traffic_overrides: dict | None = None,
        on_fits=None) -> dict:
    """One run of ``workload``; returns the result line's object.

    ``device="cpu"`` and ``overrides`` (configuration keys set anew, and
    ``traffic_overrides`` the traffic's) are for the rehearsals of the
    tests, at small sizes on the plain paths.  ``on_fits(fits, reference,
    learning_rate)`` is called after the check (the readings of
    ``perfbench/readings.py``)."""
    import torch
    start = time.perf_counter() if start is None else start
    check_program(root)
    bench = Benchmark(root)
    cell = bench.cell(workload)
    config = dict(bench.config(cell.config), **(overrides or {}))
    traffic = dict(bench.traffic(cell.traffic), **(traffic_overrides or {}))
    limits = bench.limits(cell.name)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        # The kernel libraries are built at first use, into the checkout.
        from multigrad_tpu_torch.ops import cuda_build
        cuda_build.set_build_dir(
            os.path.join(root, "build", "multigrad_tpu_torch"))
    # float32 products stay float32 on the card (no TF32), as in the
    # reference.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def mark(what):
        if on_card:
            torch.cuda.synchronize()
        print(f"setup: {what} at {time.perf_counter() - start:.3f} s",
              file=sys.stderr, flush=True)

    mark("imports")
    program = bench.module("programs", config["model"]).build(
        config, seed, device)
    mark("model built")
    driver = bench.module("drivers", traffic["driver"]).Driver(
        program, traffic, seed, device)
    window = Window(device) if trace else None
    driver.warmup()
    mark("warmed up")
    setup_s = time.perf_counter() - start

    rec = driver.run(seconds, window)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    driver.close()
    inputs = program.inputs
    del driver, program
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    reference = bench.module("reference", config["model"]).Reference(
        config, inputs, torch.float64)
    correct, checks = compare.judge(
        rec.fits, reference, rec.counters["learning_rate"], limits,
        int(traffic["check_fits"]), seed, int(traffic.get("check_last", 1)),
        np.dtype(config["dtype"]))
    print(f"check: {len(rec.fits)} fits to their guesses, "
          f"{min(len(rec.fits), int(traffic['check_fits']))} against the "
          f"reference, in {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr, flush=True)
    if on_fits is not None:
        on_fits(rec.fits, reference, rec.counters["learning_rate"])
    del reference, inputs

    metrics = {}
    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name() if on_card else "cpu",
        "count": 1,
        "memory_peak_bytes": int(memory_peak),
    }
    result = {"correct": correct, "attempted": len(rec.fits),
              "failed": sum(f.failed for f in rec.fits)}
    if trace:
        summary = window.summary
        ctx = SimpleNamespace(
            trace=summary, record=rec, config=config, traffic=traffic,
            costs=bench.module("costs", config["model"]).Costs(config),
            on_card=on_card)
        for m in bench.per_layer(cell.name):
            value = bench.module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    else:
        values = dict(rec.end_to_end, setup_s=setup_s)
        for m in bench.end_to_end(cell.name):
            if m["name"] not in values:
                raise RunError(f"the {traffic['driver']!r} driver gives no "
                               f"{m['name']!r}")
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    result.update(metrics=metrics, device=device_info, checks=checks)
    return result


def main(argv, root: str, start: float) -> int:
    parser = argparse.ArgumentParser(prog="perfbench/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cache_dirs(root)
    import torch
    chips = Benchmark(root).cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    try:
        result = run(root, args.workload, args.seed, args.seconds,
                     bool(args.trace), device="cuda", start=start)
    except RunError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 4
    found = forbidden_modules()
    if found:
        print(f"perfbench: modules loaded in the run: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(_finite(result)), flush=True)
    return 0
