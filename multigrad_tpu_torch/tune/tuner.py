"""The two-stage autotuner: static prune, measured confirm, persist (port
of :mod:`multigrad_tpu.tune.tuner`).

1. **Enumerate** the knob space for a model or workload (:mod:`.space`):
   ``bin_mode``/``bin_window`` and chunk size, plus the serve bucket
   ladder (:func:`tune_buckets`) and the streaming knobs
   (:func:`tune_streaming`).
2. **Prune statically**: every candidate is counted on meta tensors
   (zero device work) by :func:`~multigrad_tpu_torch.telemetry.costmodel
   .model_cost` — the kernels' own operation counts, read off
   ``csrc/*.cu`` — and folded against the model's device's roofline
   (:func:`~multigrad_tpu_torch.telemetry.costmodel.predicted_time_s`:
   the H100's data-sheet peaks on the card).  Only the top-k predicted
   survivors — **plus the hand-set default, always** — are measured.
3. **Confirm measured**: short trials on the model's device, after the
   kernel libraries are built; the first run of each candidate is its
   warm-up, then the best of ``reps`` runs, each fenced by a read back
   to the host, the floor of one launch and one read back
   (:func:`measure_rtt`) subtracted; ranked with the regress gate's
   noise tolerance — a candidate displaces the default only by beating
   it beyond the relative threshold AND the floor.  The static model
   cannot see what decides the history model's step on the card
   (``torch.cumsum``, host work), so the measurement decides.
4. **Persist** the winner in the on-disk :class:`~.table.TuningTable`
   beside the kernel-library directory, so a fresh process (or a fleet
   worker sharing the directory) starts tuned: a warm table entry
   resolves every knob with **zero measured trials**.

Every decision is emitted as a ``tune`` telemetry record carrying the
static prediction AND the measured confirmation, so
``python -m multigrad_tpu_torch.telemetry.report`` shows why a
configuration was chosen.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .space import (bucket_candidates, model_candidates,
                    streaming_candidates)
from .table import TuningTable, device_tags

__all__ = ["TuneResult", "tune_model", "tune_buckets",
           "tune_streaming", "within_noise", "measure_rtt"]

#: Default relative threshold (%) a candidate must beat the hand-set
#: default by to displace it — the regress gate's --pct philosophy,
#: tighter because trials here are same-process A/Bs.
DEFAULT_PCT = 10.0


def measure_rtt(reps: int = 8, device=None) -> float:
    """The floor of one launch plus one read back on ``device``
    (``None`` means CUDA), min over ``reps``:
    :func:`~multigrad_tpu_torch.telemetry.profile.measure_rtt_floor`, the
    floor every trial pays."""
    from ..telemetry.profile import measure_rtt_floor
    return measure_rtt_floor(reps=reps, device=device)


def _sub_rtt(elapsed: float, rtt: float) -> float:
    """Subtract the floor without eating real signal (never more than
    half the measurement)."""
    return elapsed - rtt if elapsed - rtt >= 0.5 * elapsed else elapsed


def within_noise(cand_s: float, best_s: float,
                 pct: float = DEFAULT_PCT,
                 floor_ms: float = 0.0) -> bool:
    """Is ``cand_s`` indistinguishable from (or better than) ``best_s``?
    The tuner's tie rule, the :mod:`~multigrad_tpu_torch.telemetry
    .regress` tolerance: quiet inside the relative threshold OR inside
    the absolute time floor."""
    if cand_s <= best_s:
        return True
    if best_s > 0 and (cand_s - best_s) / best_s * 100.0 <= pct:
        return True
    return (cand_s - best_s) * 1e3 <= floor_ms


@dataclass
class TuneResult:
    """Outcome of one tuning pass.

    ``chosen`` is the winning knob dict (what the table now resolves
    ``"auto"`` to); ``warm=True`` means the table already held the entry
    and **zero measured trials** ran.  ``candidates`` holds one record
    per enumerated candidate: knobs, ``predicted_s`` (static),
    ``measured_s`` (None when statically pruned), ``chosen``.
    """

    key: str
    chosen: dict
    warm: bool = False
    candidates: list = field(default_factory=list)
    baseline_s: Optional[float] = None
    measured_s: Optional[float] = None
    predicted_s: Optional[float] = None
    rtt_ms: Optional[float] = None
    table_path: Optional[str] = None

    @property
    def n_trials(self) -> int:
        """Measured trials run (0 on a warm start)."""
        return sum(1 for c in self.candidates
                   if c.get("measured_s") is not None)


def _as_table(table) -> TuningTable:
    return table if isinstance(table, TuningTable) else \
        TuningTable(table)


def _log_tune(telemetry, key, table_path, cand):
    if telemetry is not None:
        telemetry.log("tune", key=key, table=table_path, **cand)


def _warm_result(key, entry, table, telemetry, scope) -> TuneResult:
    res = TuneResult(
        key=key, chosen=dict(entry.get("knobs", {})), warm=True,
        baseline_s=entry.get("baseline_s"),
        measured_s=entry.get("measured_s"),
        predicted_s=entry.get("predicted_s"),
        table_path=table.path)
    _log_tune(telemetry, key, table.path, {
        "scope": scope, "knobs": res.chosen, "warm": True,
        "chosen": True, "predicted_s": res.predicted_s,
        "measured_s": res.measured_s})
    return res


def _prepare(device) -> float:
    """Build the kernel libraries on the card (none on the CPU), then
    measure the trials' floor on ``device``."""
    if device.type == "cuda":
        from ..ops import cuda_build
        cuda_build.build()
    return measure_rtt(device=device)


def _spec_kind(device) -> str:
    return device_tags(device)[1]


def model_key(model, sigma_max=None, bin_window=None) -> str:
    """The tuning-table key of a model's knob entry — shared by the tuner
    (write side) and the ``"auto"`` resolution hooks (read side), so
    they never disagree.  The catalog-shape bucket carries per-process
    rows, the edge count and the fused window derived from ``sigma_max``
    (the sigma-regime discriminator; falls back to the aux's stored
    ``bin_window``); the tags are the model's device's."""
    from .resolve import aux_model_key

    aux = model.aux_data if isinstance(model.aux_data, dict) else {}
    if bin_window is None and sigma_max is not None:
        from .space import find_bin_edges
        edges = find_bin_edges(aux)
        if edges is not None:
            from ..ops.binned import fused_bin_window
            bin_window = fused_bin_window(edges, float(sigma_max))
    return aux_model_key(type(model).__name__, aux,
                         comm=getattr(model, "comm", None),
                         bin_window=bin_window)


def _record_op_aliases(table, key: str, knobs: dict) -> None:
    """Mirror a binned-kernel winner under the standalone-op key
    :func:`~.resolve.resolve_op_bin_mode` reads, so a direct
    ``binned_erf_counts(bin_mode="auto")`` call on the tuned workload's
    shape resolves to the same mode.  Only the windowed key is aliased:
    the window IS the sigma-regime discriminator, so a windowless
    (``w0``) alias would hand a tight-sigma fused window to a wide-sigma
    caller — wrong counts, not just a slow path."""
    if "bin_mode" not in knobs:
        return
    parts = key.split("|")
    # model|<name>|rows2^B|e{E}|w{W}|backend|device
    if len(parts) != 7 or not parts[4].startswith("w") \
            or parts[4] == "w0":
        return
    op_knobs = {"bin_mode": knobs.get("bin_mode"),
                "bin_window": knobs.get("bin_window")}
    try:
        alias = "|".join(["model", "binned_erf_counts", parts[2],
                          parts[3], parts[4], parts[5], parts[6]])
        table.record(alias, op_knobs, alias_of=key)
    except Exception:
        pass            # aliases are best-effort; the model key won


def _variant(model, cand: dict):
    """The model re-configured with a candidate's aux knobs (fit knobs
    like ``donate_carry`` ride separately)."""
    if not isinstance(model.aux_data, dict):
        return model
    updates = {k: cand.get(k) for k in
               ("bin_mode", "bin_window", "chunk_size")
               if k in cand}
    return model.replace_aux(**updates) if updates else model


def _host(x):
    """A read back to the host: the trial's fence."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def tune_model(model, params, *, sigma_max=None, table=None,
               telemetry=None, top_k: int = 3, reps: int = 2,
               trial_steps: int = 8, trial: Optional[str] = None,
               pct: float = DEFAULT_PCT, randkey=None,
               learning_rate: float = 0.01, force: bool = False,
               candidates: Optional[list] = None) -> TuneResult:
    """Tune an :class:`~multigrad_tpu_torch.core.model.OnePointModel`'s
    knob set on its device and persist the winner (see the module
    docstring for the four stages).

    Parameters
    ----------
    model, params
        The workload: the model as currently (hand-)configured and a
        representative parameter vector — trials run at these
        parameters, so pass the regime the fit will live in.
    sigma_max : float, optional
        Largest smoothing width the fit can reach (bounds the fused
        window).  Default: ``aux_data["sigma_max"]``; without either, no
        fused candidate is enumerated.
    trial : {"eval", "fit"}, optional
        ``"eval"`` times one ``calc_loss_and_grad_from_params``,
        ``"fit"`` a ``trial_steps``-step Adam fit.  Default: ``"fit"``
        when any candidate varies ``donate_carry``, else ``"eval"``.
    force : bool
        Measure again even when the table already holds the key (the
        warm start returns a zero-trial result otherwise).
    """
    from ..telemetry.costmodel import model_cost, predicted_time_s

    table = _as_table(table)
    key = model_key(model, sigma_max=sigma_max)
    if not force:
        entry = table.lookup(key)
        if entry is not None:
            return _warm_result(key, entry, table, telemetry, "model")

    device = model.device
    params = model._params(params)
    cands = list(candidates if candidates is not None
                 else model_candidates(model, params,
                                       sigma_max=sigma_max))
    if not cands:
        raise ValueError("empty candidate space")
    if trial is None:
        trial = "fit" if any(c.get("donate_carry") is not None
                             for c in cands) else "eval"
    if trial == "eval":
        # The eval trial never exercises carry donation, so donate
        # variants are IDENTICAL programs and would be ranked on timing
        # noise — collapse them instead of persisting a verdict no trial
        # measured.
        seen, collapsed = set(), []
        for c in cands:
            c = dict(c)
            c.pop("donate_carry", None)
            sig = tuple(sorted(c.items()))
            if sig not in seen:
                seen.add(sig)
                collapsed.append(c)
        cands = collapsed

    # ---- stage 2: static prune (roofline fold, zero device work) ----
    kind = _spec_kind(device)
    records = []
    for cand in cands:
        rec = dict(knobs=dict(cand), predicted_s=None,
                   measured_s=None, chosen=False, scope="model")
        try:
            cost = model_cost(_variant(model, cand), params,
                              randkey=randkey)
            rec["predicted_s"] = float(
                predicted_time_s(cost, device_kind=kind)["predicted_s"])
        except Exception as e:      # a candidate that cannot be counted
            rec["error"] = repr(e)  # cannot win either
        records.append(rec)

    ranked = sorted((r for r in records[1:]
                     if r["predicted_s"] is not None),
                    key=lambda r: r["predicted_s"])
    survivors = [records[0]] + ranked[:max(int(top_k) - 1, 0)] \
        if records[0].get("error") is None else ranked[:int(top_k)]
    if not survivors:
        raise RuntimeError(
            "no candidate produced a static cost estimate")

    # ---- stage 3: measured confirm (warmed, floor subtracted) -------
    rtt = _prepare(device)
    for rec in survivors:
        variant = _variant(model, rec["knobs"])
        donate = rec["knobs"].get("donate_carry")
        if trial == "eval":
            def run():
                loss, grad = variant.calc_loss_and_grad_from_params(
                    params, randkey=randkey)
                return float(loss), _host(grad)
            per = 1
        else:
            def run():
                return _host(variant.run_adam(
                    guess=params, nsteps=trial_steps,
                    learning_rate=learning_rate, randkey=randkey,
                    progress=False, donate_carry=donate))
            per = trial_steps
        run()                                         # warm-up
        best = float("inf")
        for _ in range(max(int(reps), 1)):
            t0 = time.perf_counter()
            run()
            best = min(best,
                       _sub_rtt(time.perf_counter() - t0, rtt) / per)
        rec["measured_s"] = best
        if rec["predicted_s"] is not None and best > 0:
            rec["roofline_frac"] = rec["predicted_s"] / best

    # ---- stage 4: rank, prefer the default on a tie, persist --------
    floor_ms = 2.0 * rtt * 1e3
    measured = [r for r in survivors if r["measured_s"] is not None]
    winner = min(measured, key=lambda r: r["measured_s"])
    baseline = records[0]
    baseline_s = baseline.get("measured_s")
    if baseline_s is not None and within_noise(
            baseline_s, winner["measured_s"], pct, floor_ms):
        winner = baseline        # a tie keeps the hand-set default
    winner["chosen"] = True

    for rec in records:
        _log_tune(telemetry, key, table.path, rec)
    table.record(
        key, winner["knobs"], predicted_s=winner["predicted_s"],
        measured_s=winner["measured_s"], baseline_s=baseline_s,
        baseline_knobs=baseline["knobs"], trial=trial,
        trials=len(measured) * max(int(reps), 1),
        rtt_ms=round(rtt * 1e3, 4), pct=pct)
    _record_op_aliases(table, key, winner["knobs"])
    return TuneResult(
        key=key, chosen=dict(winner["knobs"]), warm=False,
        candidates=records, baseline_s=baseline_s,
        measured_s=winner["measured_s"],
        predicted_s=winner["predicted_s"],
        rtt_ms=round(rtt * 1e3, 4), table_path=table.path)


def tune_buckets(model, guess, config=None, candidates=None,
                 nsteps: int = 20, reps: int = 2, table=None,
                 telemetry=None, min_gain: float = 0.08,
                 max_sizes: int = 4, k_sharded="auto",
                 budget_bytes=None,
                 force: bool = False) -> TuneResult:
    """Tune the serve scheduler's bucket-quantization ladder from
    **measured fits/hour** on the model's device.

    For each candidate bucket size K, one warmed ``(K, ndim)`` batched
    Adam fit — :func:`~multigrad_tpu_torch.optim.adam.run_adam_scan`
    over :func:`~multigrad_tpu_torch.inference.batched_fit_wrapper`, the
    program a :class:`~multigrad_tpu_torch.serve.FitScheduler` bucket
    runs — is timed, yielding ``fits/hour(K) = K · 3600 / t``.  The
    ladder keeps K=1 (singleton latency) plus every size whose throughput
    beats the last kept size by ``min_gain``, capped at ``max_sizes``
    rungs.  The static prediction is recorded per K but never prunes:
    the cost model scales linearly in K, so what decides the ladder —
    the per-step host work the rows share — shows only measured.

    ``candidates=None`` takes :func:`~.space.bucket_candidates`, capped
    by ``budget_bytes`` through the memory model (the carry and the
    rows' graphs).  On an :func:`~multigrad_tpu_torch.parallel
    .ensemble_comm` (``k_sharded="auto"``, or ``True``) the sharded
    ladder's rungs are measured through the K-partitioned program and
    carry, exactly what a sharded ``FitScheduler`` dispatch runs (a
    rung the replica count does not divide runs replicated, the
    dispatch rule); every process of the comm makes the call.  The
    winner persists under the ``buckets`` key;
    ``FitScheduler(buckets="auto")`` and fleet workers resolve it at
    boot.
    """
    from ..inference.ensemble import (batched_fit_wrapper,
                                      k_shards_bucket,
                                      resolve_k_shard_topology)
    from ..optim import adam as _adam
    from ..telemetry.costmodel import model_cost, predicted_time_s
    from .resolve import buckets_key

    table = _as_table(table)
    key = buckets_key(model)
    if not force:
        entry = table.lookup(key)
        if entry is not None:
            return _warm_result(key, entry, table, telemetry,
                                "buckets")

    if config is None:
        from ..serve.queue import FitConfig
        config = FitConfig(nsteps=int(nsteps))
    guess = np.asarray(guess, dtype=float)
    if guess.ndim != 1:
        raise ValueError(f"guess must be 1-D, got shape {guess.shape}")
    sharded, n_replicas = resolve_k_shard_topology(model, k_sharded)
    if candidates is None:
        candidates = bucket_candidates(
            model, config.nsteps, ndim=guess.shape[0],
            k_sharded=sharded, budget_bytes=budget_bytes)
    device = model.device
    dynamic = model.aux_leaves()
    try:
        pred1 = predicted_time_s(model_cost(model, guess),
                                 device_kind=_spec_kind(device)
                                 )["predicted_s"]
    except Exception:
        pred1 = None
    rtt = _prepare(device)

    records, rates = [], {}
    for k in sorted(set(int(b) for b in candidates)):
        # The scheduler's dispatch rule: rungs the replica count divides
        # run the K-partitioned program and carry, the rest replicated.
        k_shard = k_shards_bucket(k, sharded, n_replicas)
        wrapper = batched_fit_wrapper(model, config.with_key,
                                      k_sharded=k_shard)
        carry_sharding = model.k_sharding(2) if k_shard else None
        inits = torch.as_tensor(np.tile(guess, (k, 1)),
                                dtype=torch.float32, device=device)

        def run():
            with torch.no_grad():
                return _host(_adam.run_adam_scan(
                    wrapper, inits, nsteps=config.nsteps,
                    param_bounds=config.bounds_list(),
                    learning_rate=config.learning_rate,
                    randkey=config.randkey,
                    const_randkey=config.const_randkey, progress=False,
                    fn_args=(dynamic,), carry_sharding=carry_sharding))

        run()                                 # warm-up
        best = float("inf")
        for _ in range(max(int(reps), 1)):
            t0 = time.perf_counter()
            run()
            best = min(best, _sub_rtt(time.perf_counter() - t0, rtt))
        rates[k] = k * 3600.0 / best
        records.append(dict(
            scope="buckets", knobs={"bucket": k}, chosen=False,
            k_sharded=k_shard,
            predicted_s=(pred1 * config.nsteps * k
                         if pred1 is not None else None),
            measured_s=best,
            fits_per_hour=round(rates[k], 1)))

    ladder, last = [], 0.0
    for k in sorted(rates):               # smallest K always kept —
        if not ladder or rates[k] > last * (1.0 + min_gain):
            ladder.append(k)              # the K=1 solo rung
            last = rates[k]
    if len(ladder) > max_sizes:           # keep 1 + the top rungs
        ladder = ladder[:1] + (ladder[-(max_sizes - 1):]
                               if max_sizes > 1 else [])
    for rec in records:
        rec["chosen"] = rec["knobs"]["bucket"] in ladder
        _log_tune(telemetry, key, table.path, rec)

    chosen = {"buckets": ladder}
    best_k = max(rates, key=rates.get)
    table.record(
        key, chosen,
        fits_per_hour={str(k): round(v, 1) for k, v in rates.items()},
        measured_s=records[-1]["measured_s"],
        nsteps=config.nsteps, rtt_ms=round(rtt * 1e3, 4),
        best_bucket=best_k, k_sharded=sharded,
        n_replicas=n_replicas)
    return TuneResult(
        key=key, chosen=chosen, warm=False, candidates=records,
        measured_s=records[-1]["measured_s"],
        rtt_ms=round(rtt * 1e3, 4), table_path=table.path)


def tune_streaming(smodel, params, *, table=None, telemetry=None,
                   use_scan: bool = False, trial_steps: int = 2,
                   reps: int = 2, pct: float = DEFAULT_PCT,
                   randkey=None, learning_rate: float = 0.01,
                   force: bool = False,
                   candidates: Optional[list] = None) -> TuneResult:
    """Tune a :class:`~multigrad_tpu_torch.data.StreamingOnePointModel`'s
    ``chunk_rows`` (and, with ``use_scan=True``, ``remat_policy``) from
    short streamed fits.  Static predictions ride along per candidate
    (per-chunk cost × chunk count), but chunk-size tradeoffs are
    transfer- and host-bound — the measurement decides.  The winner
    persists under the ``stream`` key; ``chunk_rows="auto"`` /
    ``remat_policy="auto"`` resolve it."""
    import dataclasses

    from .resolve import stream_key

    table = _as_table(table)
    key = stream_key(type(smodel.model).__name__, smodel.n_rows,
                     smodel.comm, smodel.model.device)
    if not force:
        entry = table.lookup(key)
        if entry is not None:
            return _warm_result(key, entry, table, telemetry,
                                "stream")

    device = smodel.model.device
    params = smodel.model._params(params)
    cands = list(candidates if candidates is not None
                 else streaming_candidates(smodel, use_scan=use_scan))
    rtt = _prepare(device)
    records = []
    for cand in cands:
        rec = dict(scope="stream", knobs=dict(cand),
                   predicted_s=None, measured_s=None, chosen=False)
        variant = dataclasses.replace(
            smodel, chunk_rows=int(cand["chunk_rows"]),
            remat_policy=cand["remat_policy"], last_stats=None)
        rec["n_chunks"] = variant.plan().n_chunks
        try:
            rec["predicted_s"] = _streaming_predicted_s(
                variant, params, randkey)
        except Exception:
            pass

        def run():
            return _host(variant.run_adam(
                guess=params, nsteps=trial_steps,
                learning_rate=learning_rate, randkey=randkey,
                progress=False, use_scan=use_scan))
        run()                                  # warm-up
        best = float("inf")
        for _ in range(max(int(reps), 1)):
            t0 = time.perf_counter()
            run()
            best = min(best, _sub_rtt(time.perf_counter() - t0, rtt)
                       / trial_steps)
        rec["measured_s"] = best
        if rec["predicted_s"] is not None and best > 0:
            rec["roofline_frac"] = rec["predicted_s"] / best
        records.append(rec)

    floor_ms = 2.0 * rtt * 1e3
    winner = min(records, key=lambda r: r["measured_s"])
    baseline = records[0]
    if within_noise(baseline["measured_s"], winner["measured_s"],
                    pct, floor_ms):
        winner = baseline
    winner["chosen"] = True
    for rec in records:
        _log_tune(telemetry, key, table.path, rec)
    table.record(
        key, winner["knobs"], predicted_s=winner["predicted_s"],
        measured_s=winner["measured_s"],
        baseline_s=baseline["measured_s"],
        baseline_knobs=baseline["knobs"], use_scan=bool(use_scan),
        trials=len(records) * max(int(reps), 1),
        rtt_ms=round(rtt * 1e3, 4), pct=pct)
    return TuneResult(
        key=key, chosen=dict(winner["knobs"]), warm=False,
        candidates=records, baseline_s=baseline["measured_s"],
        measured_s=winner["measured_s"],
        predicted_s=winner["predicted_s"],
        rtt_ms=round(rtt * 1e3, 4), table_path=table.path)


def _streaming_predicted_s(smodel, params, randkey) -> float:
    """Static roofline prediction of one streamed loss-and-grad step:
    (pass-1 + pass-2 per-chunk cost) × chunk count, each chunk program
    (:meth:`~multigrad_tpu_torch.core.model.OnePointModel
    .chunk_sumstats_fn`, :meth:`~multigrad_tpu_torch.core.model
    .OnePointModel.chunk_vjp_fn`) counted on meta chunks of a process's
    rows."""
    from ..telemetry.costmodel import (estimate_program_cost,
                                       predicted_time_s)

    with_key = randkey is not None
    plan = smodel.plan()
    key = smodel._key_arg(randkey)
    model = smodel.model
    kind = _spec_kind(model.device)

    def chunk_meta(name):
        row = torch.from_numpy(np.asarray(smodel.streams[name].read(0, 1)))
        return torch.empty((plan.shard_rows,) + tuple(row.shape[1:]),
                           dtype=row.dtype, device="meta")

    chunks = [chunk_meta(n) for n in smodel._names]
    p1 = model.chunk_sumstats_fn(smodel._names, with_key)
    shapes = []

    def pass1(p, chunk, k):
        out = p1(p, chunk, k)
        y = out[0] if model.sumstats_func_has_aux else out
        shapes.append((tuple(y.shape), y.dtype))
        return out

    c1 = estimate_program_cost(pass1, params, chunks, key)
    (dims, dtype), = shapes
    ct = torch.empty(dims, dtype=dtype, device="meta")
    p2 = model.chunk_vjp_fn(smodel._names, with_key)
    c2 = estimate_program_cost(p2, params, chunks, ct, key)
    per_chunk = predicted_time_s(c1, device_kind=kind)["predicted_s"] \
        + predicted_time_s(c2, device_kind=kind)["predicted_s"]
    return float(per_chunk * plan.n_chunks)
