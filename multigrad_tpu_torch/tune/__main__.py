"""Autotuner CLI: ``python -m multigrad_tpu_torch.tune`` (port of
``python -m multigrad_tpu.tune``, with ``--device``: the card by
default, ``cpu`` for tests).

Tunes a shipped workload end to end — model knobs (static prune →
measured confirm) and, with ``--tune-buckets``, the serve scheduler's
bucket ladder — persists the winners in the on-disk tuning table, then
**proves resolution**: the same model rebuilt with ``bin_mode="auto"`` /
``chunk_size="auto"`` must resolve to the tuned knobs, and a
:class:`~multigrad_tpu_torch.serve.FitScheduler` booted with
``buckets="auto"`` must come up on the tuned ladder.  Exits nonzero (no
``TUNE OK`` receipt) if any of that fails.

A second invocation against the same table is the warm-start proof:
every knob resolves with **zero measured trials** (``warm=True`` in the
receipt lines).
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m multigrad_tpu_torch.tune",
        description="Two-stage autotuner: static cost-model prune, "
                    "short measured confirm, on-disk tuning table.")
    ap.add_argument("--model", default="smf",
                    choices=("smf", "galhalo_hist"),
                    help="workload to tune (default: smf)")
    ap.add_argument("--num-halos", type=int, default=100_000)
    ap.add_argument("--table", default=None,
                    help="tuning-table path (default: beside the kernel-"
                         "library directory; MGT_TUNING_TABLE overrides)")
    ap.add_argument("--telemetry", default=None,
                    help="JSONL path for tune records")
    ap.add_argument("--sigma-max", type=float, default=None,
                    help="largest smoothing width the fit can reach "
                         "(bounds the fused window; default: the "
                         "workload's convention)")
    ap.add_argument("--trial", default=None,
                    choices=("eval", "fit"),
                    help="trial shape (default: auto)")
    ap.add_argument("--trial-steps", type=int, default=8)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--top-k", type=int, default=3)
    ap.add_argument("--force", action="store_true",
                    help="measure again even on a warm table")
    ap.add_argument("--tune-buckets", action="store_true",
                    help="also tune the serve bucket ladder from "
                         "measured fits/hour")
    ap.add_argument("--bucket-candidates", default="1,2,4,8,16",
                    help="comma list of bucket sizes to measure")
    ap.add_argument("--bucket-nsteps", type=int, default=20)
    ap.add_argument("--json", action="store_true",
                    help="emit the results as one JSON object")
    ap.add_argument("--device", default="cuda",
                    help="the device the model lives on and every trial "
                         "runs on ('cuda', 'cuda:1', or 'cpu' for tests)")
    args = ap.parse_args(argv)

    import numpy as np

    from . import TuningTable, tune_buckets, tune_model
    from .resolve import resolve_auto_aux, resolve_buckets

    table = TuningTable(args.table)
    telemetry = None
    if args.telemetry:
        from ..telemetry import JsonlSink, MetricsLogger
        telemetry = MetricsLogger(
            JsonlSink(args.telemetry),
            run_config={"tool": "tune", "table": table.path})

    if args.model == "smf":
        from ..models.smf import SMFModel, make_smf_data
        sigma_max = args.sigma_max if args.sigma_max is not None \
            else 0.6
        aux = make_smf_data(args.num_halos, sigma_max=sigma_max,
                            device=args.device)
        model = SMFModel(aux_data=aux)
        params = np.array([-1.0, 0.5])
    else:
        from ..models.galhalo_hist import (GalhaloHistModel, TRUTH,
                                           make_galhalo_hist_data)
        sigma_max = args.sigma_max if args.sigma_max is not None \
            else 0.32
        aux = make_galhalo_hist_data(args.num_halos,
                                     sigma_max=sigma_max,
                                     device=args.device)
        model = GalhaloHistModel(aux_data=aux)
        params = np.asarray(TRUTH)

    out = {"table": table.path, "model": type(model).__name__}
    ok = True

    res = tune_model(
        model, params, sigma_max=sigma_max, table=table,
        telemetry=telemetry, top_k=args.top_k, reps=args.reps,
        trial_steps=args.trial_steps, trial=args.trial,
        force=args.force)
    out["model_knobs"] = {
        "key": res.key, "chosen": res.chosen, "warm": res.warm,
        "trials": res.n_trials, "predicted_s": res.predicted_s,
        "measured_s": res.measured_s,
        "baseline_s": res.baseline_s}
    print(f"TUNE model={type(model).__name__} key={res.key} "
          f"chosen={json.dumps(res.chosen)} warm={res.warm} "
          f"trials={res.n_trials}", file=sys.stderr)

    # Resolution proof: an "auto" model must come up on the tuned knobs
    # (the path a production consumer takes), resolved through this run's
    # table: a consumer reads the default table, which --table need not
    # be.
    auto_aux = resolve_auto_aux(
        type(model).__name__, dict(aux, bin_mode="auto", chunk_size="auto"),
        model.comm, table=table)
    auto_model = type(model)(aux_data=auto_aux, comm=model.comm)
    resolved = {k: auto_model.aux_data.get(k)
                for k in ("bin_mode", "bin_window", "chunk_size")}
    out["resolved_aux"] = resolved
    for knob in ("bin_mode", "chunk_size"):
        want = res.chosen.get(knob)
        got = resolved.get(knob)
        if knob == "bin_mode" and want is not None and got != want:
            ok = False
        if knob == "chunk_size" and want is not None \
                and (got or None) != (want or None):
            ok = False
    print(f"TUNE resolve bin_mode=auto -> {resolved}",
          file=sys.stderr)

    if args.tune_buckets:
        candidates = tuple(int(b) for b
                           in args.bucket_candidates.split(","))
        bres = tune_buckets(
            model, params, candidates=candidates,
            nsteps=args.bucket_nsteps, reps=args.reps, table=table,
            telemetry=telemetry, force=args.force)
        ladder = resolve_buckets(model, table=table)
        out["buckets"] = {
            "key": bres.key, "chosen": bres.chosen,
            "warm": bres.warm, "resolved": list(ladder),
            "fits_per_hour": {
                str(c["knobs"]["bucket"]): c.get("fits_per_hour")
                for c in bres.candidates}}
        print(f"TUNE buckets key={bres.key} "
              f"ladder={json.dumps(bres.chosen.get('buckets'))} "
              f"warm={bres.warm}", file=sys.stderr)
        if tuple(ladder) != tuple(sorted(set(
                bres.chosen.get("buckets", [])))):
            ok = False
        # Boot proof: the serve scheduler must come up tuned.
        from ..serve.scheduler import FitScheduler
        sched = FitScheduler(model, buckets="auto",
                             tuning_table=table, start=False)
        out["scheduler_buckets"] = list(sched.buckets)
        print(f"TUNE scheduler boots buckets={list(sched.buckets)}",
              file=sys.stderr)
        if sched.buckets != tuple(ladder):
            ok = False
        sched.close(drain=False)

    if telemetry is not None:
        telemetry.close()
    if args.json:
        print(json.dumps(out, indent=1, default=str))
    if not ok:
        print("TUNE FAILED: resolution disagrees with the tuned "
              "table", file=sys.stderr)
        return 1
    print("TUNE OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
