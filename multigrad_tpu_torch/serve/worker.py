"""Fit-fleet worker: one scheduler process behind the fleet router (port
of :mod:`multigrad_tpu.serve.worker`).

``python -m multigrad_tpu_torch.serve.worker`` runs one
:class:`~multigrad_tpu_torch.serve.scheduler.FitScheduler` (its own
process, its own card: ``--device``, ``cuda`` by default) behind the
wire protocol of
:mod:`~multigrad_tpu_torch.serve.wire`: it prints a
``FLEET-WORKER-READY {json}`` handshake with its port (and the bucket
ladder its scheduler came up on, ``buckets``), accepts ONE
router connection, and from then on serves ``submit`` ops, streams
heartbeats, and answers with ``result`` / ``error`` / ``reject``
messages.

Lifecycle contract (the preemption story):

* **SIGTERM** (or the ``drain`` op) — graceful preemption: announce
  ``draining`` (so the router routes around this worker), serve
  everything already queued via ``FitScheduler.close(drain=True)``,
  deliver the responses, announce ``drained``, exit 0.
* **SIGKILL** — nothing runs here, by definition; the router detects
  heartbeat/connection loss and re-enqueues this worker's in-flight
  requests elsewhere.
* A full local queue (``QueueFullError``) becomes a ``reject``
  message — the router's work-stealing signal, never a dropped
  request.
* A consumed poison retry is reported upstream (``poison_retry``)
  so a re-enqueued request cannot double-fire it, and incoming
  ``retried=True`` submits are marked accordingly.

The wire is the JAX package's protocol, so a JAX router can drive this
worker.  ``--device`` is the port's own argument (the card the model
lives on; ``cpu`` for tests); ``--compile-cache DIR`` is the directory
the kernel libraries are loaded from (and built into when missing,
:func:`~multigrad_tpu_torch.serve.compile_cache.enable_compile_cache`).

With ``--chaos``, the worker honors fault-injection ops (sent by the
:class:`~multigrad_tpu_torch.serve.chaos.ChaosController` of either
package): forced queue-full rejects, submit-path stalls, and heartbeat
pauses — deterministic handles on the failure modes the fleet must
survive.

With ``--telemetry``, the heartbeat thread also logs a
``kernel_launches`` record whenever this process's kernel launches have
changed since the last one: each CUDA kernel wrapper's ``launches``
count (:func:`kernel_launches`), read and never reset.  The file is
written a line at a time, so a SIGKILL'd worker's launches survive it
up to its last heartbeat.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import threading
import time

__all__ = ["build_model", "main"]


def kernel_launches() -> dict:
    """This process's launches so far of each CUDA kernel wrapper, by
    kernel name (the ``launches`` count a wrapper adds one to where it
    launches its kernel; plain versions on CPU tensors add nothing)."""
    from multigrad_tpu_torch.ops import erf_kernels as ek
    from multigrad_tpu_torch.ops import fused_kernels as fk
    from multigrad_tpu_torch.ops import hist_kernels as hk
    from multigrad_tpu_torch.ops import pair_kernels as pk
    return {"erf_counts_fwd": ek.erf_counts_fwd_cuda.launches,
            "erf_counts_bwd": ek.erf_counts_bwd_cuda.launches,
            "erf_counts_fwd_vec": ek.erf_counts_fwd_vec_cuda.launches,
            "erf_counts_bwd_vec": ek.erf_counts_bwd_vec_cuda.launches,
            "fused_counts_fwd": fk.fused_counts_fwd_cuda.launches,
            "fused_counts_bwd": fk.fused_counts_bwd_cuda.launches,
            "pair_counts_fwd": pk.pair_counts_fwd_cuda.launches,
            "pair_rowgrad": pk.pair_rowgrad_cuda.launches,
            "pair_counts_bwd": pk.pair_counts_bwd_cuda.launches,
            "hist_history_fwd": hk.history_fwd_cuda.launches,
            "hist_history_bwd": hk.history_bwd_cuda.launches}


def build_model(name: str, kwargs: dict, device=None):
    """Resolve a worker model spec.

    ``"smf"`` builds the stock SMF model (``num_halos`` in
    ``kwargs``) on ``device`` (``None`` means the card; one process,
    no comm).  Any ``"module:factory"`` path imports and calls
    ``factory(**kwargs)`` — the hook for serving custom models
    without touching this file (``device`` is not passed: put it in
    ``kwargs`` when the factory takes one).
    """
    if ":" in name:
        import importlib
        module, fn = name.split(":", 1)
        return getattr(importlib.import_module(module), fn)(**kwargs)
    if name == "smf":
        from multigrad_tpu_torch.models.smf import SMFModel, make_smf_data
        n = int(kwargs.get("num_halos", 2000))
        return SMFModel(aux_data=make_smf_data(n, device=device))
    raise ValueError(f"unknown worker model spec {name!r} "
                     "(builtin: 'smf'; or 'module:factory')")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m multigrad_tpu_torch.serve.worker",
        description="One fit-fleet scheduler worker behind the "
                    "JSONL wire (see the module docstring).")
    ap.add_argument("--worker-id", default="w0")
    ap.add_argument("--rank", type=int, default=0,
                    help="fleet rank stamped on telemetry records — "
                         "each worker is its own single process "
                         "(process_index 0), so without this the "
                         "cross-worker /fleet aggregation could not "
                         "tell the streams apart")
    ap.add_argument("--device", default="cuda",
                    help="the device the model lives on and every "
                         "dispatch runs on ('cuda', 'cuda:1', or "
                         "'cpu' for tests)")
    ap.add_argument("--port", type=int, default=0,
                    help="router-facing TCP port (0 = pick free)")
    ap.add_argument("--model", default="smf",
                    help="'smf' or 'module:factory'")
    ap.add_argument("--model-kwargs", default="{}",
                    help="JSON kwargs for the model factory")
    ap.add_argument("--buckets", default="auto",
                    help="comma list of bucket sizes, or 'auto' "
                         "(default): resolve the measured fits/hour "
                         "ladder from the shared tuning table — "
                         "workers sharing the kernel-library directory "
                         "share the table, so the fleet boots tuned "
                         "(DEFAULT_BUCKETS on a cold table)")
    ap.add_argument("--tuning-table", default=None,
                    help="tuning-table path for --buckets auto "
                         "(default: beside the kernel-library "
                         "directory; MGT_TUNING_TABLE overrides)")
    ap.add_argument("--max-pending", type=int, default=1024)
    ap.add_argument("--batch-window-s", type=float, default=0.05)
    ap.add_argument("--heartbeat-s", type=float, default=0.25)
    ap.add_argument("--telemetry", default=None,
                    help="per-worker JSONL record stream (the "
                         "router wires these into /fleet)")
    ap.add_argument("--trace", default=None,
                    help="per-worker trace-span JSONL: this "
                         "worker's hops (queue_wait, dispatch, "
                         "adam_segments, ...) recorded under the "
                         "router-minted trace contexts arriving on "
                         "submit messages; merged by trace_id with "
                         "the router's file "
                         "(the JAX package's telemetry.trace CLI)")
    ap.add_argument("--flight-dir", default=None,
                    help="postmortem bundle directory")
    ap.add_argument("--compile-cache", default=None,
                    help="shared kernel-library dir (the fleet-wide "
                         "warm asset: libraries built there run no "
                         "nvcc here)")
    ap.add_argument("--live-port", type=int, default=None,
                    help="base port for this worker's LiveServer; "
                         "EADDRINUSE probes forward, so every "
                         "worker on a host can share the base")
    ap.add_argument("--no-retry-poisoned", action="store_true")
    ap.add_argument("--qos", action="store_true",
                    help="enable the QoS policy (weighted-fair "
                         "dequeue, class-aware shed, deadline-aware "
                         "packing); submit messages' qos tags are "
                         "honored instead of ignored")
    ap.add_argument("--tenant-quota", type=int, default=None,
                    help="max queued requests per tenant (requires "
                         "--qos); over-quota submits are rejected "
                         "with reason 'tenant_quota' so the router "
                         "can tell 'YOU are over quota' from 'the "
                         "fleet is busy'")
    ap.add_argument("--chaos", action="store_true",
                    help="honor chaos-injection ops (tests/demos)")
    args = ap.parse_args(argv)

    from multigrad_tpu_torch.serve import (FitScheduler, QueueFullError,
                                     enable_compile_cache)
    from multigrad_tpu_torch.serve.qos import (QosPolicy, TenantQuotaError)
    from multigrad_tpu_torch.serve.wire import (JsonlChannel,
                                          config_from_wire,
                                          qos_from_wire,
                                          resources_to_wire,
                                          result_to_wire,
                                          rollup_to_wire,
                                          shed_to_wire)
    from multigrad_tpu_torch.telemetry import JsonlSink, MetricsLogger
    from multigrad_tpu_torch.telemetry.tracing import TraceContext, Tracer

    from multigrad_tpu_torch._lockdep import make_lock, maybe_dump

    state = {"draining": False}
    chaos = {"reject_queue_full": 0, "stall_until": 0.0,
             "heartbeat_pause_until": 0.0}
    inflight: dict = {}              # wire rid -> local FitFuture
    local_to_rid: dict = {}          # scheduler id -> wire rid
    retried_rids: set = set()
    lock = make_lock("serve.worker.main.lock")
    chan_box: dict = {}
    logger = None
    live = None
    sched = None
    tracer = (Tracer(args.trace,
                     service=f"worker:{args.worker_id}")
              if args.trace else None)

    def _send(msg):
        chan = chan_box.get("chan")
        if chan is None:
            return
        try:
            chan.send(msg)
        except OSError:
            pass

    def _shutdown(code: int):
        try:
            if logger is not None:
                logger.close()
            if tracer is not None:
                tracer.close()
            if live is not None:
                live.stop()
            # os._exit skips atexit: flush the lockdep shadow's
            # edges/violations dump (MGT_LOCKDEP_DUMP) explicitly
            # so the chaos suite's cross-check sees this worker.
            maybe_dump()
        finally:
            # Daemon threads (scheduler, waiters, heartbeat) die
            # with the process; flushing happened above.
            os._exit(code)

    def _compact_stats() -> dict:
        if sched is None:
            return {}
        s = sched.stats
        return {k: s.get(k, 0) for k in
                ("submitted", "completed", "failed", "expired",
                 "cancelled", "retried", "dispatches")}

    def log_launches(last: dict) -> dict:
        counts = kernel_launches()
        if logger is not None and counts != last:
            logger.log("kernel_launches", worker=args.worker_id,
                       launches=counts)
        return counts

    def begin_drain(reason: str):
        if state["draining"]:
            return
        state["draining"] = True
        _send({"op": "draining", "worker": args.worker_id,
               "reason": reason})

        def _finish():
            # Serve everything already queued, wait for the waiter
            # threads to deliver every response, then exit 0.
            if sched is not None:
                sched.close(drain=True)
            deadline = time.time() + 120
            while inflight and time.time() < deadline:
                time.sleep(0.02)
            log_launches({})
            _send({"op": "drained", "worker": args.worker_id,
                   "stats": _compact_stats()})
            _shutdown(0)

        threading.Thread(target=_finish, daemon=True,
                         name="mgt-worker-drain").start()

    # Install the preemption handler FIRST — before the model build,
    # the compile-cache wiring or the socket exist.  On a loaded
    # host the gap between this worker's READY handshake and its
    # next timeslice can be long, and a SIGTERM landing in that gap
    # must drain (or cleanly exit), never hit the default
    # terminate-without-goodbye disposition.
    signal.signal(signal.SIGTERM,
                  lambda *a: begin_drain("sigterm"))

    if args.compile_cache:
        enable_compile_cache(args.compile_cache)
    model = build_model(args.model, json.loads(args.model_kwargs),
                        device=args.device)

    if args.telemetry:
        os.makedirs(os.path.dirname(os.path.abspath(args.telemetry)),
                    exist_ok=True)
        logger = MetricsLogger(
            JsonlSink(args.telemetry),
            run_config={"fleet_worker": args.worker_id},
            run_extra={"process_index": args.rank})
    if args.live_port is not None:
        from multigrad_tpu_torch.telemetry import LiveServer
        live = LiveServer(port=args.live_port)

    def on_poison_retry(request):
        with lock:
            rid = local_to_rid.get(request.id)
            if rid is not None:
                retried_rids.add(rid)
        if rid is not None:
            _send({"op": "poison_retry", "rid": rid})

    qos_policy = (QosPolicy(tenant_quota=args.tenant_quota)
                  if args.qos else None)
    sched = FitScheduler(
        model,
        buckets=("auto" if args.buckets.strip() == "auto"
                 else tuple(int(b) for b in args.buckets.split(","))),
        tuning_table=args.tuning_table,
        max_pending=args.max_pending,
        batch_window_s=args.batch_window_s,
        telemetry=logger, live=live, flight_dir=args.flight_dir,
        retry_poisoned=not args.no_retry_poisoned,
        on_poison_retry=on_poison_retry, tracer=tracer,
        qos=qos_policy)

    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", args.port))
    srv.listen(1)
    print("FLEET-WORKER-READY " + json.dumps({
        "id": args.worker_id, "pid": os.getpid(),
        "port": srv.getsockname()[1],
        "live_port": live.port if live is not None else None,
        "buckets": list(sched.buckets),
    }), flush=True)
    conn, _ = srv.accept()
    chan = chan_box["chan"] = JsonlChannel(conn)

    def waiter(rid: str, fut):
        exc = fut.exception(timeout=None)
        with lock:
            retried = rid in retried_rids
        # Send BEFORE dropping the in-flight entry: the drain path
        # exits the process the moment `inflight` empties, and a
        # response popped-but-unsent would be lost with it.
        if exc is None:
            # sent_t anchors the router's result_return span (same
            # host today; across hosts it inherits clock skew, read
            # against the rpc_rtt floor).
            _send({"op": "result", "rid": rid,
                   "result": result_to_wire(fut.result(timeout=0)),
                   "sent_t": time.time()})
        else:
            _send({"op": "error", "rid": rid,
                   "etype": type(exc).__name__,
                   "message": str(exc),
                   "bundle_path": getattr(exc, "bundle_path", None),
                   "retried": retried})
        with lock:
            inflight.pop(rid, None)
            local_to_rid.pop(fut.request_id, None)
            retried_rids.discard(rid)

    def handle_submit(msg):
        rid = msg["rid"]
        if state["draining"]:
            _send({"op": "reject", "rid": rid, "reason": "draining"})
            return
        if chaos["reject_queue_full"] > 0:
            chaos["reject_queue_full"] -= 1
            _send({"op": "reject", "rid": rid,
                   "reason": "queue_full"})
            return
        stall = chaos["stall_until"] - time.time()
        if stall > 0:
            # Slow-worker injection: the submit path wedges (the
            # reader thread sleeps, so EVERY later op queues behind
            # it) while heartbeats keep flowing from their own
            # thread — the "alive but useless" failure mode.
            time.sleep(stall)
        deadline_s = None
        if msg.get("deadline_t") is not None:
            deadline_s = msg["deadline_t"] - time.time()
            if deadline_s <= 0:
                _send({"op": "error", "rid": rid,
                       "etype": "FitDeadlineExceeded",
                       "message": f"request {rid} deadline passed "
                                  "before worker admission"})
                return
        retried = bool(msg.get("retried"))
        # Trace context + origin timestamp are optional wire fields
        # (mixed-version fleet): absent or malformed, the fit is
        # served untraced with a worker-local arrival time.
        trace_ctx = TraceContext.from_wire(msg.get("trace") or {})
        submitted_t = msg.get("submitted_t")
        if not isinstance(submitted_t, (int, float)):
            submitted_t = None
        # QoS tag: optional wire field (mixed-version fleet). A
        # pre-QoS router's submits decode to None and schedule as
        # the default tenant; with --qos off the tag still rides the
        # request (telemetry) but the queue dequeues FIFO.
        qos_tag = qos_from_wire(msg.get("qos"))
        try:
            fut = sched.submit(msg["guess"],
                               config=config_from_wire(msg["config"]),
                               deadline_s=deadline_s,
                               retried=retried, trace=trace_ctx,
                               submitted_t=submitted_t,
                               qos=qos_tag)
        except TenantQuotaError as e:
            # Per-tenant quota: "YOU are over quota", not "the fleet
            # is busy" — the router must NOT mark this worker
            # saturated or steal elsewhere on the tenant's behalf.
            _send({"op": "reject", "rid": rid,
                   "reason": "tenant_quota", "tenant": e.tenant,
                   "shed": shed_to_wire(sched.queue.qos_counts())})
            return
        except QueueFullError:
            shed = (shed_to_wire(sched.queue.qos_counts())
                    if qos_policy is not None else None)
            _send({"op": "reject", "rid": rid,
                   "reason": "queue_full",
                   **({"shed": shed} if shed is not None else {})})
            return
        except RuntimeError:          # queue closed: drain raced us
            _send({"op": "reject", "rid": rid, "reason": "draining"})
            return
        except (ValueError, TypeError) as e:
            _send({"op": "error", "rid": rid,
                   "etype": type(e).__name__, "message": str(e)})
            return
        with lock:
            inflight[rid] = fut
            local_to_rid[fut.request_id] = rid
            if retried:
                retried_rids.add(rid)
        threading.Thread(target=waiter, args=(rid, fut),
                         daemon=True,
                         name=f"mgt-worker-waiter-{rid}").start()

    def heartbeat_loop():
        launches = {}
        while True:
            launches = log_launches(launches)
            if time.time() >= chaos["heartbeat_pause_until"]:
                # The compact resource snapshot rides every
                # heartbeat (known-keys codec; the key stays off the
                # message for an unmonitored scheduler, so a legacy
                # router sees the pre-resources protocol verbatim).
                snap = (resources_to_wire(sched.resources.snapshot())
                        if sched.resources is not None else None)
                # The rollup delta is the since-last-heartbeat slice
                # of the worker's history plane; idle intervals (and
                # history-less schedulers) ship no key at all, so a
                # legacy router sees the pre-rollup protocol
                # verbatim.
                roll = (rollup_to_wire(sched.rollup.take_delta())
                        if sched.rollup is not None else None)
                try:
                    chan.send({
                        "op": "heartbeat", "worker": args.worker_id,
                        "t": time.time(),
                        "queue_depth": len(sched.queue),
                        "inflight": len(inflight),
                        "draining": state["draining"],
                        "stats": _compact_stats(),
                        **({"resources": snap}
                           if snap is not None else {}),
                        **({"rollup": roll}
                           if roll is not None else {})})
                except OSError:
                    return
            time.sleep(args.heartbeat_s)

    threading.Thread(target=heartbeat_loop, daemon=True,
                     name="mgt-worker-heartbeat").start()

    for msg in chan:
        op = msg.get("op")
        if op == "submit":
            handle_submit(msg)
        elif op == "ping":
            # t0 echoed back verbatim: the router's RPC round-trip
            # probe (multigrad_fleet_rpc_rtt) — absent from old
            # routers' pings, so echo None rather than require it.
            _send({"op": "pong", "worker": args.worker_id,
                   "t0": msg.get("t0"),
                   "queue_depth": len(sched.queue),
                   "stats": _compact_stats()})
        elif op == "drain":
            begin_drain("drain op")
        elif op == "stop":
            sched.close(drain=False)
            _shutdown(0)
        elif op == "chaos" and args.chaos:
            what = msg.get("what")
            if what == "queue_full":
                chaos["reject_queue_full"] += int(msg.get("n", 1))
            elif what == "stall":
                chaos["stall_until"] = time.time() \
                    + float(msg.get("duration_s", 1.0))
            elif what == "pause_heartbeat":
                chaos["heartbeat_pause_until"] = time.time() \
                    + float(msg.get("duration_s", 1.0))
    # Router hung up: drain what we hold, then exit (the drain
    # thread calls _shutdown).
    begin_drain("router disconnected")
    while True:
        time.sleep(1.0)


if __name__ == "__main__":
    raise SystemExit(main())
