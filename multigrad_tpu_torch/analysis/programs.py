"""The program trace every shard-safety check reads (the port's
counterpart of the JAX package's ``analysis/jaxprs.py``).

The JAX package traces a jaxpr.  PyTorch has no trace to walk, so the
port runs the program once on ``meta`` tensors — shapes and dtypes, no
data, no device — and records what runs.  That run is the static cost
model's (:func:`~multigrad_tpu_torch.telemetry.costmodel.run_counted`):
one run gives both the count and the trace, and the CUDA kernels'
autograd Functions, which find the counting mode on the dispatch-mode
stack, declare their counts and return meta outputs here as they do
there.  No kernel launches, nothing is allocated on the card, and no
collective communicates.

:func:`trace_program` returns a :class:`ProgramTrace` with

* every aten op that ran (:class:`OpRecord`: its name, its outputs'
  dtypes and shapes, and the source site that ran it);
* every collective (:class:`CollectiveSite`), reported by
  :func:`~multigrad_tpu_torch.telemetry.comm.record_collective` through
  the trace's ``per_call`` hook, with ``where`` the first frame outside
  the port's ``parallel/``, ``telemetry/`` and ``analysis/`` and outside
  torch;
* every captured constant (:class:`CapturedConst`): a tensor that is
  not an argument of the program (so not meta) and reaches an op, with
  its bytes and the site that first read it.

The program is a host loop run in full, so the trace is flat: every op
and every collective call is its own record, ``path`` is empty and
``mult`` is 1.  :func:`walk_eqns`, :func:`collect_collectives` and
:func:`iter_consts` keep the JAX package's names over these records.
"""
from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Iterator, List, Optional

import torch

from ..telemetry.comm import CommCounter, leaf_nbytes
from ..telemetry.costmodel import (ProgramCost, _tensors, _to_meta,
                                   run_counted)

__all__ = ["CollectiveSite", "OpRecord", "CapturedConst", "ProgramTrace",
           "COLLECTIVE_PRIMS", "CALLBACK_PRIMS", "trace_program",
           "abstractify", "walk_eqns", "collect_collectives", "iter_consts",
           "eqn_source", "subjaxprs"]

#: The collectives the port's comm records (``MeshComm`` and
#: ``parallel.collectives``), under the JAX op names.
COLLECTIVE_PRIMS = frozenset({
    "psum", "pmean", "pmax", "pmin", "all_gather", "ppermute",
})

#: In-graph host callbacks: none in the port, whose taps copy records off
#: the card between steps rather than calling the host from inside a
#: program.
CALLBACK_PRIMS = frozenset()

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: Frames a site skips: torch's own and the port's plumbing (the
#: collectives, the counting run, the analyzer).
_SKIP = (os.path.dirname(os.path.abspath(torch.__file__)) + os.sep,) \
    + tuple(os.path.join(_PKG, d) + os.sep
            for d in ("parallel", "telemetry", "analysis"))


def _site() -> str:
    """``file:line (function)`` of the innermost frame outside
    :data:`_SKIP`; empty when there is none."""
    frame = sys._getframe(1)
    while frame is not None:
        code = frame.f_code
        if not code.co_filename.startswith(_SKIP):
            return f"{code.co_filename}:{frame.f_lineno} ({code.co_name})"
        frame = frame.f_back
    return ""


@dataclass(frozen=True)
class OpRecord:
    """One aten op of a traced program."""

    name: str          # e.g. "aten.mul"
    dtypes: tuple      # its tensor outputs' dtypes
    shapes: tuple      # and shapes
    where: str         # the source site that ran it


@dataclass(frozen=True)
class CapturedConst:
    """A tensor the program read that is not one of its arguments."""

    nbytes: int
    shape: tuple
    dtype: torch.dtype
    where: str         # the site that first read it


@dataclass(frozen=True)
class CollectiveSite:
    """One collective call in a traced program (the JAX package's record,
    plus the payload's shape and dtype)."""

    op: str            # the JAX op name, e.g. "psum"
    nbytes: int        # payload bytes of the call
    mult: int          # calls per program execution: 1 (host loops run
    #                    in full, each call its own site)
    where: str         # the first frame outside the port's plumbing
    path: str = ""     # the JAX package's nesting path: empty here
    axes: tuple = ()   # mesh axes: the port's collectives name none
    shape: tuple = ()
    dtype: Optional[torch.dtype] = None

    @property
    def executed_bytes(self) -> int:
        """Payload bytes per program execution (``nbytes * mult``)."""
        return self.nbytes * self.mult


class ProgramTrace(CommCounter):
    """What one meta run of a program did: :attr:`ops`,
    :attr:`collectives` and :attr:`consts` in the order they happened,
    the run's :class:`~multigrad_tpu_torch.telemetry.costmodel
    .ProgramCost` (:attr:`cost`) and the program's meta outputs
    (:attr:`out`).  A :class:`~multigrad_tpu_torch.telemetry.comm
    .CommCounter`, so its totals count the collectives too."""

    def __init__(self):
        super().__init__()
        self.ops: List[OpRecord] = []
        self.collectives: List[CollectiveSite] = []
        self.consts: List[CapturedConst] = []
        self.cost: Optional[ProgramCost] = None
        self.out = None

    def on_op(self, func, out):
        tensors = _tensors(out)
        self.ops.append(OpRecord(
            str(func.overloadpacket), tuple(t.dtype for t in tensors),
            tuple(tuple(t.shape) for t in tensors), _site()))

    def on_const(self, tensor: torch.Tensor):
        self.consts.append(CapturedConst(
            leaf_nbytes(tensor), tuple(tensor.shape), tensor.dtype,
            _site()))

    def per_call(self, op: str, value, nbytes: int):
        first = next(iter(_tensors(value)), None)
        self.collectives.append(CollectiveSite(
            op=op, nbytes=int(nbytes), mult=1, where=_site(),
            shape=() if first is None else tuple(first.shape),
            dtype=None if first is None else first.dtype))

    def __repr__(self):
        return (f"ProgramTrace({len(self.ops)} ops, "
                f"{len(self.collectives)} collectives, "
                f"{len(self.consts)} captured constants)")


def abstractify(x):
    """``x`` with every tensor replaced by an empty meta tensor of its
    shape and dtype (other values pass through)."""
    return _to_meta(x)


def trace_program(fn, *args) -> ProgramTrace:
    """Run ``fn(*args)`` once on meta copies of its tensor arguments
    (nested in lists, tuples and dicts; other values pass through) and
    return its :class:`ProgramTrace`.  Nothing runs on a device."""
    trace = ProgramTrace()
    trace.cost, trace.out = run_counted(fn, args, trace)
    return trace


def walk_eqns(trace: ProgramTrace) -> Iterator[tuple]:
    """Yield ``(op, path, mult)`` for every recorded op: the JAX
    package's triple, with ``path`` ``()`` and ``mult`` 1 (the trace is
    flat)."""
    for op in trace.ops:
        yield op, (), 1


def collect_collectives(trace: ProgramTrace) -> List[CollectiveSite]:
    """Every collective site of a traced program, in the order they ran.
    The order is fixed for a fixed program, which is what lets the
    comm-scaling check pair sites of two traces at different catalog
    sizes."""
    return list(trace.collectives)


def iter_consts(trace: ProgramTrace) -> Iterator[tuple]:
    """Yield ``(const, path)`` for every captured constant (``path``
    empty)."""
    for const in trace.consts:
        yield const, ""


def eqn_source(op) -> str:
    """The source site of a recorded op, constant or collective."""
    return op.where


def subjaxprs(op) -> list:
    """The sub-programs of a recorded op: none (the trace is flat)."""
    del op
    return []
