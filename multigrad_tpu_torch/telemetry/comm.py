"""Collective-traffic accounting: count calls and bytes per reduction
(port of :mod:`multigrad_tpu.telemetry.comm`).

The paper's value proposition is a *communication* bound —
O(|sumstats| + |params|) per loss-and-grad evaluation, independent of
data size — and this module turns that claim from an assertion into a
measurement.  Every collective of :mod:`multigrad_tpu_torch.parallel`
(``MeshComm.psum`` for ``psum``, ``collectives.all_gather`` and
``collectives.ring_shift`` for ``ppermute``) reports its payload to any
active :class:`CommCounter` **when it runs**.  The JAX package counts
at trace time, with zero FLOPs; PyTorch has no trace to count, so the
port counts one real execution (:func:`traced_comm` and
:func:`measure_model_comm` run the program once).

Usage::

    with CommCounter() as cc:
        model.calc_loss_and_grad_from_params(params)
    cc.total_bytes        # payload bytes of the evaluation
    cc.calls              # {"psum": 2}

Counting convention: one "call" per collective the port runs, with
``bytes`` the *logical payload* (element count × itemsize of the reduced
tensor, summed over leaves) — the JAX package's convention, so the bytes
are the same.  The calls follow the port's schedule, which joins
payloads the JAX package reduces apart (a batched evaluation makes 2
all-reduces whatever K; a Jacobian pass 1).  Collectives that do not
run — no process group, the identity — count nothing, so a model with
``comm=None`` reports zero.

This module imports only numpy and the standard library at module level
(never :mod:`..parallel` or :mod:`..core`), so the collectives can
depend on it cycle-free.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np

__all__ = ["CommCounter", "record_collective", "traced_comm",
           "measure_model_comm", "leaf_nbytes"]

_ACTIVE = threading.local()

#: The program kinds :func:`measure_model_comm` runs.
KINDS = ("loss_and_grad", "batched_loss_and_grad",
         "batched_loss_and_grad_sharded", "sumstats_jac_rev")


def _active_counters() -> list:
    stack = getattr(_ACTIVE, "stack", None)
    if stack is None:
        stack = _ACTIVE.stack = []
    return stack


def _leaves(value):
    if isinstance(value, dict):
        return [x for v in value.values() for x in _leaves(v)]
    if isinstance(value, (list, tuple)):
        return [x for v in value for x in _leaves(v)]
    return [] if value is None else [value]


def leaf_nbytes(leaf) -> int:
    """Payload bytes of one tensor, array or Python scalar: element count
    × itemsize (a Python scalar weighs its numpy type's itemsize)."""
    numel = getattr(leaf, "numel", None)
    if callable(numel):                       # torch.Tensor
        return int(numel()) * int(leaf.element_size())
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is None or dtype is None:
        return np.dtype(np.result_type(type(leaf))).itemsize
    return int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize


class CommCounter:
    """Context manager accumulating collective calls/bytes per op.

    Attributes
    ----------
    calls : dict[str, int]
        Number of collectives run, per op name.
    bytes : dict[str, int]
        Logical payload bytes, per op name.
    calls_by_axis, bytes_by_axis : dict[str, int]
        The same, per mesh axis, for the collectives of comms that name
        one (an :func:`~multigrad_tpu_torch.parallel.ensemble_comm`'s data
        and replica axes); a flat comm's are in the totals only.
    """

    #: Optional per-call record, ``per_call(op, value, nbytes)``: a
    #: subclass that keeps each collective's site (the analyzer's program
    #: trace) sets it; a plain counter keeps totals only.
    per_call = None

    def __init__(self):
        self.calls: dict = {}
        self.bytes: dict = {}
        self.calls_by_axis: dict = {}
        self.bytes_by_axis: dict = {}

    # -- accounting ---------------------------------------------------------
    def record(self, op: str, nbytes: int, n_calls: int = 1,
               axis: Optional[str] = None):
        self.calls[op] = self.calls.get(op, 0) + n_calls
        self.bytes[op] = self.bytes.get(op, 0) + nbytes
        if axis is not None:
            self.calls_by_axis[axis] = \
                self.calls_by_axis.get(axis, 0) + n_calls
            self.bytes_by_axis[axis] = \
                self.bytes_by_axis.get(axis, 0) + nbytes

    def merge(self, other: "CommCounter") -> "CommCounter":
        for op, n in other.calls.items():
            self.record(op, other.bytes.get(op, 0), n)
        for axis, n in other.calls_by_axis.items():
            self.calls_by_axis[axis] = self.calls_by_axis.get(axis, 0) + n
            self.bytes_by_axis[axis] = self.bytes_by_axis.get(axis, 0) \
                + other.bytes_by_axis.get(axis, 0)
        return self

    def scaled(self, factor: int) -> "CommCounter":
        """A new counter with every count multiplied by ``factor``."""
        out = CommCounter()
        for op, n in self.calls.items():
            out.record(op, self.bytes.get(op, 0) * factor, n * factor)
        return out

    @property
    def total_calls(self) -> int:
        return sum(self.calls.values())

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes.values())

    def summary(self) -> dict:
        return {
            "total_bytes": int(self.total_bytes),
            "total_calls": int(self.total_calls),
            "bytes_by_op": {k: int(v) for k, v in self.bytes.items()},
            "calls_by_op": {k: int(v) for k, v in self.calls.items()},
        }

    def step_record(self, scope: Optional[str] = None, **extra) -> dict:
        """The canonical ``comm``-event payload for one program
        execution (``bytes_per_step``/``calls_per_step``/
        ``bytes_by_op``/``calls_by_op``), the one schema every log site
        and the report CLI share."""
        rec: dict = {}
        if scope is not None:
            rec["scope"] = scope
        rec.update(
            bytes_per_step=int(self.total_bytes),
            calls_per_step=int(self.total_calls),
            bytes_by_op={k: int(v) for k, v in self.bytes.items()},
            calls_by_op={k: int(v) for k, v in self.calls.items()},
        )
        rec.update(extra)
        return rec

    def __repr__(self):
        return (f"CommCounter(total_bytes={self.total_bytes}, "
                f"calls={self.calls})")

    # -- context manager ----------------------------------------------------
    def __enter__(self):
        _active_counters().append(self)
        return self

    def __exit__(self, *exc):
        _active_counters().remove(self)
        return False


def record_collective(op: str, value, n_calls: int = 1):
    """Report one collective's payload to every active counter (a comm
    that names no axis: :func:`record_axis_collective`)."""
    record_axis_collective(None, op, value, n_calls)


def record_axis_collective(axis: Optional[str], op: str, value,
                           n_calls: int = 1):
    """Report one collective's payload to every active counter, under the
    mesh ``axis`` its comm reduces over (``None``: a comm that names
    none).

    Called by the collectives where they run.  No-op (one attribute
    read) when no counter is active, so the instrumentation costs the
    hot path nothing measurable.
    """
    stack = getattr(_ACTIVE, "stack", None)
    if not stack:
        return
    nbytes = sum(leaf_nbytes(leaf) for leaf in _leaves(value))
    for counter in stack:
        counter.record(op, nbytes, n_calls, axis)
        if counter.per_call is not None:
            counter.per_call(op, value, nbytes)


def traced_comm(fn, *args, **kwargs) -> CommCounter:
    """Run ``fn(*args, **kwargs)`` once and return its collective traffic.

    The JAX package traces ``fn`` abstractly; the port runs it (every
    process of the comm must make the same call, as for any collective).
    """
    with CommCounter() as cc:
        fn(*args, **kwargs)
    return cc


def measure_model_comm(model, params, kind: str = "loss_and_grad",
                       randkey=None) -> CommCounter:
    """Collective traffic of ONE execution of a model's program ``kind``.

    Runs the program once on ``params`` (``(ndim,)``, or ``(K, ndim)``
    for ``"batched_loss_and_grad"``; the full ``(K, ndim)`` batch for
    ``"batched_loss_and_grad_sharded"``, of which this process evaluates
    its replica slice's rows) under a :class:`CommCounter`: one
    evaluation, kernels included.  For the paper's
    headline program (``"loss_and_grad"``) the result is the claim
    itself: ``total_bytes == (|sumstats| + |params|) · itemsize`` in 2
    calls, independent of the catalog size.  ``"sumstats_jac_rev"``
    moves ``|y| + |y|·|params|`` floats.  Models
    with ``comm=None`` report zero.
    """
    import torch

    if kind not in KINDS:
        raise ValueError(f"unknown program kind {kind!r}; expected one "
                         f"of {KINDS}")
    params = params if isinstance(params, torch.Tensor) else \
        torch.as_tensor(np.asarray(params, np.float32))
    params = params.detach().to(model.device, torch.float32)
    with CommCounter() as cc:
        if kind == "loss_and_grad":
            model.calc_loss_and_grad_from_params(params, randkey=randkey)
        elif kind == "batched_loss_and_grad":
            model.batched_loss_and_grad_fn(randkey is not None)(
                params, model.aux_leaves(), randkey)
        elif kind == "batched_loss_and_grad_sharded":
            model.batched_loss_and_grad_fn(randkey is not None,
                                           k_sharded=True)(
                model.k_sharding(2).local(params), model.aux_leaves(),
                randkey)
        else:
            model.calc_sumstats_and_jac_from_params(params,
                                                    randkey=randkey)
    return cc
