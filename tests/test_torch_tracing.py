"""The port's request tracing (``telemetry/tracing.py``, a copy of the
JAX package's) against the original, and the scheduler's trace hops.

``TraceContext`` and ``parse_traceparent`` give the same contexts on the
same headers (malformed ones degrade to untraced in both), and each
package reads the other's wire form.  The ``Tracer``'s spans, from its
context manager and from each package's ``FitScheduler`` serving the
same requests (a bucket of two, then a poisoned request retried once),
carry the same names, the same parent links and the same fields, ids and
timestamps aside.  All exact: the copies do the same arithmetic in
Python.
"""
import numpy as np
import pytest

import multigrad_tpu.telemetry.tracing as jax_tracing
import multigrad_tpu_torch.telemetry.tracing as pt_tracing
from multigrad_tpu.models.smf import SMFModel as JaxSMFModel
from multigrad_tpu.models.smf import make_smf_data as jax_make_smf_data
from multigrad_tpu.serve import FitScheduler as JaxFitScheduler
from multigrad_tpu_torch.models import SMFModel, aux_from_numpy
from multigrad_tpu_torch.serve import FitScheduler

#: Span fields that differ run to run: ids and wall-clock times.
VOLATILE = ("trace_id", "span_id", "parent_span_id", "t", "t_start",
            "t_end", "elapsed_s", "bundle")
HEADERS = [
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4BF92F3577B34DA6A3CE929D0E0E4736-00F067AA0BA902B7-00",
    "00-00000000000000000000000000000000-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-0000000000000000-01",
    "ff-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e473-00f067aa0ba902b7-01",
    "garbage", "", None, 17,
]


def _ctx(ctx):
    return None if ctx is None else (ctx.trace_id, ctx.span_id,
                                     ctx.parent_span_id, ctx.traceparent,
                                     ctx.to_wire())


@pytest.mark.parametrize("header", HEADERS, ids=repr)
def test_traceparent_parse_matches_jax(header):
    assert _ctx(pt_tracing.parse_traceparent(header)) == \
        _ctx(jax_tracing.parse_traceparent(header))


def test_contexts_cross_the_wire_both_ways():
    for mine, other in ((pt_tracing, jax_tracing),
                        (jax_tracing, pt_tracing)):
        root = mine.new_trace()
        child = root.child()
        assert child.trace_id == root.trace_id
        assert child.parent_span_id == root.span_id
        # The header carries the span, not its parent (W3C): the
        # receiver's spans parent to it.
        back = other.TraceContext.from_wire(child.to_wire())
        assert _ctx(back) == _ctx(other.TraceContext(child.trace_id,
                                                     child.span_id))
        assert other.TraceContext.from_wire({}) is None
        assert other.TraceContext.from_wire(
            {"traceparent": "nonsense"}) is None


def _canonical(records):
    """Spans with ids replaced by the path of names to the root, and the
    volatile fields dropped, sorted."""
    by_id = {r["span_id"]: r for r in records}

    def path(r):
        names = []
        while r is not None:
            names.append(r["name"])
            r = by_id.get(r.get("parent_span_id"))
        return "/".join(reversed(names))

    out = []
    for r in records:
        fields = {k: v for k, v in r.items() if k not in VOLATILE}
        out.append((path(r), sorted(fields.items(), key=str)))
    return sorted(out, key=str)


def _tracer_spans(tracing):
    tracer = tracing.Tracer(service="unit")
    root = tracer.new_trace()
    with tracer.span(root, "outer", bucket=4) as ctx:
        tracer.record(ctx.child(), "inner", 1.0, 2.0, n_requests=2)
    with pytest.raises(ZeroDivisionError):
        with tracer.span(root, "failing"):
            1 / 0
    tracer.log("trace_note", detail="x")
    return tracer.records


def test_tracer_spans_match_jax():
    port, want = _tracer_spans(pt_tracing), _tracer_spans(jax_tracing)
    assert [r["event"] for r in port] == [r["event"] for r in want]
    spans = [r for r in port if r["event"] == "trace_span"]
    assert _canonical(spans) == _canonical(
        [r for r in want if r["event"] == "trace_span"])
    assert any(r["ok"] is False for r in spans)


def test_scheduler_trace_hops_match_jax(tmp_path):
    aux = jax_make_smf_data(600)
    np_aux = {k: (np.asarray(v) if hasattr(v, "shape") else v)
              for k, v in aux.items()}
    spans = {}
    for name, sched_cls, tracing, model in (
            ("jax", JaxFitScheduler, jax_tracing,
             JaxSMFModel(aux_data=dict(aux))),
            ("port", FitScheduler, pt_tracing,
             SMFModel(aux_data=aux_from_numpy(np_aux, device="cpu")))):
        tracer = tracing.Tracer(service="serve")
        with sched_cls(model, buckets=(1, 4), start=False,
                       batch_window_s=0.0, tracer=tracer,
                       flight_dir=str(tmp_path / name)) as sched:
            futs = [sched.submit(g, nsteps=5, learning_rate=0.05)
                    for g in ([-1.0, 0.5], [-1.4, 0.3])]
            sched.start()
            results = [f.result(timeout=120) for f in futs]
            poison = sched.submit([np.nan, 0.5], nsteps=5,
                                  learning_rate=0.05)
            assert poison.exception(timeout=120) is not None
        assert all(r.trace_id for r in results)
        spans[name] = [r for r in tracer.records
                       if r["event"] == "trace_span"]
    port, want = _canonical(spans["port"]), _canonical(spans["jax"])
    assert port == want
    names = {p.rsplit("/", 1)[-1] for p, _ in port}
    assert names == {"request", "queue_wait", "bucket_coalesce",
                     "dispatch", "adam_segments", "finalize",
                     "result_return"}
