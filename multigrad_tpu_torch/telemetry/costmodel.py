"""Static cost model: operations, transcendentals and bytes of a program,
counted without running it (port of :mod:`multigrad_tpu.telemetry
.costmodel`).

The perf-attribution counterpart of :mod:`.comm`: where the comm counter
counts what a program *communicates*, this module counts what it
*computes* and *touches* — one execution, with zero device work.  The
JAX package folds the equations of a traced jaxpr; PyTorch has no trace
to fold, so the port runs the program on ``meta`` tensors (shapes and
dtypes, no data, no device) under a counting ``TorchDispatchMode``:

* :func:`estimate_program_cost` / :func:`model_cost` — run a callable
  (or a model's loss-and-gradient program) on meta copies of its tensor
  arguments and fold every aten operation into a :class:`ProgramCost`;
  a tensor the program captures (a model's resident data) is made meta
  as it is met and counted as a constant, and a tensor it creates is
  created on meta.
* the CUDA kernels count themselves: a ctypes launch is invisible to a
  dispatch mode, and their plain versions' aten ops are not what the
  card runs, so each kernel's ``torch.autograd.Function`` declares its
  operations (:mod:`~multigrad_tpu_torch.ops.kernel_costs`, read off
  ``csrc/*.cu``) and transcendental elements when it meets meta inputs
  here, and returns empty meta outputs.  The dense SMF step so counts
  ``N·E`` erf forward and ``N·E`` exp backward, as the JAX package's.
* collectives: under the count, ``MeshComm.psum``, ``all_gather`` and
  ``ring_shift`` record their payload through
  :func:`~.comm.record_collective` and communicate nothing.
* :func:`predicted_time_s` — the roofline fold ``max(flops / peak,
  bytes / bandwidth, comm)`` against a :data:`DEVICE_SPECS` entry (the
  H100 SXM data sheet's peaks; the CPU entry is order-of-magnitude), and
  :func:`roofline_record`, its join against a *measured* time.

Counting conventions, the JAX package's on aten names: elementwise ops
cost 1 a output element; transcendentals their :data:`TRANSCENDENTAL_FLOPS`
weight an element (``log10``/``log2`` count as ``log``, ``sigmoid`` as
``logistic``, ``softplus`` as one ``exp`` and one ``log1p``, a power with
an integral scalar exponent as ``integer_pow``); matrix products
``2·out·contract``; reductions and ``cumsum`` their input size; views,
copies and factories 0; a kernel its declared operations.  Every op the
program runs is counted once per run: ``torch.utils.checkpoint``'s
recompute runs the chunk's forward again in the backward, so it is
counted again, as the JAX package counts what its remat recomputes (the
recompute re-launches the erf forward kernel, which XLA's dead-code pass
drops from the JAX package's recompute; see ROADMAP Queue 3).  Host
loops run in full, so ``has_dynamic_trips`` stays False.  A program that
reads a value on the host (``.item()``, ``bool(t)``) cannot be counted
and raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..ops.kernel_costs import FP32_OPS_PER_S, HBM_BYTES_PER_S
from .comm import KINDS, CommCounter, leaf_nbytes

__all__ = ["ProgramCost", "estimate_program_cost", "model_cost",
           "DEVICE_SPECS", "SLOW_AXES", "device_spec",
           "predicted_time_s", "roofline_record",
           "TRANSCENDENTAL_FLOPS"]

# f32 lowering cost per element (the JAX package's weights; they matter
# far less than keeping transcendentals an order above FMAs).
TRANSCENDENTAL_FLOPS: Dict[str, float] = {
    "erf": 15.0, "erfc": 15.0, "erf_inv": 20.0,
    "exp": 10.0, "exp2": 10.0, "expm1": 10.0,
    "log": 10.0, "log2": 10.0, "log1p": 10.0, "logistic": 12.0,
    "tanh": 15.0, "sinh": 15.0, "cosh": 15.0,
    "sin": 10.0, "cos": 10.0, "tan": 20.0,
    "asin": 20.0, "acos": 20.0, "atan": 20.0, "atan2": 20.0,
    "pow": 15.0, "cbrt": 10.0, "lgamma": 30.0, "digamma": 30.0,
}

# Narrow-unit but non-transcendental ops (issue off the FMA pipe).
_CHEAP_FLOPS: Dict[str, float] = {
    "div": 4.0, "rem": 4.0, "sqrt": 2.0, "rsqrt": 2.0,
    "integer_pow": 2.0,
}

#: Aten names under the JAX package's primitive names.
_ATEN_PRIMS: Dict[str, tuple] = {
    "erfinv": ("erf_inv",), "log10": ("log",), "sigmoid": ("logistic",),
    "softplus": ("exp", "log1p"), "reciprocal": ("div",),
    "remainder": ("rem",), "fmod": ("rem",), "true_divide": ("div",),
}

_MATMULS = frozenset({"mm", "bmm", "mv", "dot", "vdot", "addmm", "addmv",
                      "baddbmm", "addbmm"})

# Reductions cost one op per INPUT element.
_REDUCTIONS = frozenset({
    "sum", "nansum", "mean", "prod", "amax", "amin", "max", "min",
    "argmax", "argmin", "all", "any", "norm", "linalg_vector_norm",
    "var", "std", "var_mean", "std_mean", "logsumexp", "cumsum",
    "cumprod", "cummax", "cummin", "logcumsumexp", "aminmax"})

# Data movement and allocation: 0 flops (bytes are accounted separately).
_ZERO_FLOP = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "zeros", "zeros_like", "new_zeros", "ones",
    "ones_like", "new_ones", "full", "full_like", "new_full",
    "scalar_tensor", "arange", "linspace", "logspace", "lift_fresh",
    "lift_fresh_copy", "clone", "copy", "_to_copy", "contiguous",
    "cat", "stack", "index", "index_select", "gather", "take", "flip",
    "roll", "repeat", "constant_pad_nd", "fill", "zero",
    "_unsafe_view", "slice_scatter", "select_scatter", "as_strided_scatter",
    "detach", "resize", "set", "_local_scalar_dense",
})


def _elements(t) -> int:
    return math.prod(t.shape) if isinstance(t, torch.Tensor) else 1


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for leaf in tree for t in _tensors(leaf)]
    return []


def _op_name(func) -> str:
    name = func.overloadpacket.__name__
    if name.endswith("_") and not name.startswith("_"):
        name = name[:-1]                  # an in-place op counts as its op
    return name


def _integral(x) -> bool:
    return isinstance(x, (int, np.integer)) or (
        isinstance(x, float) and float(x).is_integer())


def _layout(out):
    """The shapes, strides and dtypes of an op's tensor outputs, or None
    when it returns anything else."""
    if isinstance(out, torch.Tensor):
        return (tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)) and out and all(
            isinstance(t, torch.Tensor) for t in out):
        return (type(out), tuple(_layout(t) for t in out))
    return None


def _rebuild(layout):
    if isinstance(layout[0], type):
        return layout[0](_rebuild(t) for t in layout[1])
    shape, stride, dtype = layout
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


#: Argument types that are neither tensors nor containers of them.
_SCALARS = frozenset({int, float, bool, str, type(None), torch.dtype,
                      torch.device, torch.memory_format, torch.layout})


def _functional(func) -> bool:
    """Whether an op neither mutates its inputs nor returns a view."""
    return not func._schema.is_mutable and all(
        r.alias_info is None for r in func._schema.returns)


@dataclass
class ProgramCost:
    """Static per-execution cost of one program.

    ``flops`` is the weighted total (transcendental weights applied; a
    kernel's declared operations); ``transcendentals`` maps primitive
    name → element count (``cost.transcendentals["erf"] == N·E`` for the
    SMF step); ``flops_by_prim`` the flops by primitive or kernel name.
    ``arg_bytes``/``const_bytes``/``out_bytes`` are the program's
    input/captured/output footprints — ``min_hbm_bytes`` (their sum) is
    the fused ideal of one read per input and one write per output.
    ``comm_bytes``/``comm_calls`` are the collectives' payload and count
    (:func:`~.comm.record_collective`).  The collectives of an
    :func:`~multigrad_tpu_torch.parallel.ensemble_comm` name their axis
    (``data`` or ``replica``) and land in ``comm_bytes_by_axis``; a flat
    comm's name none, so their payload is ``comm_bytes_unattributed``,
    folded against the fast link.
    """

    flops: float = 0.0
    transcendentals: Dict[str, int] = field(default_factory=dict)
    flops_by_prim: Dict[str, float] = field(default_factory=dict)
    arg_bytes: int = 0
    const_bytes: int = 0
    out_bytes: int = 0
    comm_bytes: int = 0
    comm_calls: int = 0
    comm_bytes_by_axis: Dict[str, int] = field(default_factory=dict)
    comm_bytes_unattributed: int = 0
    has_dynamic_trips: bool = False

    @property
    def transcendental_total(self) -> int:
        return int(sum(self.transcendentals.values()))

    @property
    def min_hbm_bytes(self) -> int:
        return int(self.arg_bytes + self.const_bytes + self.out_bytes)

    def record(self, top: int = 6) -> dict:
        """Flat telemetry-ready summary (``costmodel`` event body)."""
        prims = sorted(self.flops_by_prim.items(),
                       key=lambda kv: -kv[1])[:top]
        return {
            "flops": float(self.flops),
            "transcendentals": {k: int(v) for k, v
                                in self.transcendentals.items()},
            "transcendental_total": self.transcendental_total,
            "top_flop_prims": {k: float(v) for k, v in prims},
            "arg_bytes": int(self.arg_bytes),
            "const_bytes": int(self.const_bytes),
            "out_bytes": int(self.out_bytes),
            "min_hbm_bytes": self.min_hbm_bytes,
            "comm_bytes": int(self.comm_bytes),
            "comm_calls": int(self.comm_calls),
            "comm_bytes_by_axis": {k: int(v) for k, v in
                                   self.comm_bytes_by_axis.items()},
            "comm_bytes_unattributed":
                int(self.comm_bytes_unattributed),
            "has_dynamic_trips": bool(self.has_dynamic_trips),
        }


class _CountingMode(TorchDispatchMode):
    """Runs every aten op on meta tensors and folds it into ``cost``; the
    kernels' Functions find it on the mode stack (``declare_kernel``).

    With a ``trace`` (the program trace of :mod:`multigrad_tpu_torch
    .analysis.programs`), the same run also reports each aten op and its
    outputs (``trace.on_op(func, out)``) and each captured tensor the
    first time it is read (``trace.on_const(tensor)``)."""

    def __init__(self, cost: ProgramCost, trace=None):
        super().__init__()
        self.cost = cost
        self.trace = trace
        self._consts: dict = {}
        # An op's output layouts and counts by its inputs' layouts: a
        # count runs the same ops on the same shapes chunk after chunk,
        # and an op's meta kernel (often a Python decomposition) costs far
        # more than this lookup.  Ops that mutate or return views always
        # run.
        self._memo: dict = {}
        self._functional: dict = {}

    def _add(self, flops_by_prim, transcendentals):
        cost = self.cost
        for prim, flops in flops_by_prim:
            cost.flops += flops
            cost.flops_by_prim[prim] = cost.flops_by_prim.get(prim, 0.0) \
                + flops
        for prim, elems in transcendentals:
            cost.transcendentals[prim] = \
                cost.transcendentals.get(prim, 0) + int(elems)

    def declare_kernel(self, name: str, flops: float, transcendentals):
        self._add(((name, float(flops)),), transcendentals.items())

    def _meta(self, x, sig):
        """``x`` with every tensor made meta (a captured one counted as a
        constant, read once), appending its layout to ``sig``."""
        kind = type(x)
        if kind in _SCALARS:
            sig.append(x)
            return x
        if kind is list or kind is tuple:
            sig.append(len(x))
            out = [self._meta(v, sig) for v in x]
            if all(a is b for a, b in zip(out, x)):
                return x
            return kind(out)
        if isinstance(x, torch.Tensor):
            if not x.is_meta:
                if id(x) not in self._consts:
                    self._consts[id(x)] = leaf_nbytes(x)
                    if self.trace is not None:
                        self.trace.on_const(x)
                x = torch.empty_like(x, device="meta")
            sig.append((x.shape, x.stride(), x.storage_offset(), x.dtype))
            return x
        sig.append(x)
        return x

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if kwargs.get("device") is not None:
            kwargs["device"] = torch.device("meta")
        sig = [func]
        args = self._meta(tuple(args), sig)
        for k in sorted(kwargs):
            sig.append(k)
            kwargs[k] = self._meta(kwargs[k], sig)
        key = None
        functional = self._functional.get(func)
        if functional is None:
            functional = self._functional[func] = _functional(func)
        if functional:
            key = tuple(sig)
            try:
                hit = self._memo.get(key)
            except TypeError:             # an unhashable argument
                key = hit = None
            if hit is not None:
                layout, flops, transcendentals = hit
                self._add(flops, transcendentals)
                out = _rebuild(layout)
                if self.trace is not None:
                    self.trace.on_op(func, out)
                return out
        out = func(*args, **kwargs)
        flops, transcendentals = _op_cost(func, args, out)
        self._add(flops, transcendentals)
        layout = _layout(out) if key is not None else None
        if layout is not None:
            self._memo[key] = (layout, flops, transcendentals)
        if self.trace is not None:
            self.trace.on_op(func, out)
        return out


def _op_cost(func, args, out):
    """``(((prim, flops), ...), ((prim, elements), ...))`` of one aten op
    by the JAX package's conventions (see the module docstring)."""
    name = _op_name(func)
    if func.is_view or name in _ZERO_FLOP:
        return (), ()
    out_elems = max((_elements(t) for t in _tensors(out)), default=1)
    if name == "pow":
        base, exponent = args[0], args[1] if len(args) > 1 else None
        if isinstance(base, torch.Tensor) and _integral(exponent):
            name = "integer_pow"
    prims = _ATEN_PRIMS.get(name, (name,))
    if any(p in TRANSCENDENTAL_FLOPS for p in prims):
        return (tuple((p, out_elems * TRANSCENDENTAL_FLOPS[p])
                      for p in prims),
                tuple((p, out_elems) for p in prims))
    prim = prims[0]
    if name in _MATMULS:
        lhs = args[1] if name.startswith("add") or name == "baddbmm" \
            else args[0]
        flops = 2.0 * out_elems * max(int(lhs.shape[-1]), 1)
    elif name in _REDUCTIONS and not (
            name in ("max", "min") and func._overloadname == "other"):
        flops = float(_elements(args[0]))
    elif prim in _CHEAP_FLOPS:
        flops = out_elems * _CHEAP_FLOPS[prim]
    else:
        flops = float(out_elems)
    return ((prim, flops),), ()


def _to_meta(tree):
    """``tree`` with every tensor replaced by an empty meta tensor of its
    shape and dtype (``requires_grad`` kept)."""
    if isinstance(tree, torch.Tensor):
        meta = torch.empty_like(tree.detach(), device="meta")
        return meta.requires_grad_(tree.requires_grad)
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_to_meta(v) for v in tree)
    return tree


def run_counted(fn, args, trace=None):
    """Run ``fn(*args)`` once on meta tensors under the counting mode:
    ``(cost, out)``.  The one run behind :func:`estimate_program_cost`
    and the analyzer's program trace: ``trace``, when given, is a
    :class:`~.comm.CommCounter` (it counts the collectives, and its
    ``per_call`` hook sees each one) that the mode also tells of every
    op and captured tensor (see :class:`_CountingMode`)."""
    cost = ProgramCost()
    meta_args = _to_meta(args)
    cost.arg_bytes = sum(leaf_nbytes(t) for t in _tensors(meta_args))
    mode = _CountingMode(cost, trace)
    with (CommCounter() if trace is None else trace) as comm, mode:
        out = fn(*meta_args)
    cost.out_bytes = sum(leaf_nbytes(t) for t in _tensors(out))
    cost.const_bytes = int(sum(mode._consts.values()))
    cost.comm_bytes = int(comm.total_bytes)
    cost.comm_bytes_by_axis = {axis: int(nbytes) for axis, nbytes
                               in comm.bytes_by_axis.items()}
    cost.comm_bytes_unattributed = cost.comm_bytes \
        - sum(cost.comm_bytes_by_axis.values())
    cost.comm_calls = int(comm.total_calls)
    return cost, out


def estimate_program_cost(fn, *args) -> ProgramCost:
    """Run ``fn(*args)`` on meta tensors and account its cost.

    ``args`` may mix tensors on any device (each becomes an empty meta
    tensor of its shape and dtype: no data is read, no memory taken on
    the card) and Python values, nested in lists, tuples and dicts.  No
    kernel launches and no collective communicates.
    """
    return run_counted(fn, args)[0]


def _program(model, kind: str, with_key: bool):
    """``program(params, aux_leaves, key)`` of ``kind`` over the model's
    data bound through ``_with_leaves``: the kinds the port's
    :func:`~.comm.measure_model_comm` runs."""
    if kind == "loss_and_grad":
        return model.loss_and_grad_fn(with_key)
    if kind == "batched_loss_and_grad":
        return model.batched_loss_and_grad_fn(with_key)
    if kind == "batched_loss_and_grad_sharded":
        # The K-partitioned program on this process's rows of the full
        # (K, ndim) batch, as a replica slice runs it.
        sharded = model.batched_loss_and_grad_fn(with_key, k_sharded=True)
        ks = model.k_sharding(2)

        def program(params, aux_leaves, key=None):
            return sharded(ks.local(params), aux_leaves, key)
        return program
    if kind == "sumstats_jac_rev":
        def program(params, aux_leaves, key=None):
            kwargs = {"randkey": key} if with_key else {}
            return model._with_leaves(aux_leaves) \
                .calc_sumstats_and_jac_from_params(params, mode="rev",
                                                   **kwargs)
        return program
    raise ValueError(f"unknown program kind {kind!r}; expected one of "
                     f"{KINDS}")


def meta_params(params) -> torch.Tensor:
    """An empty float32 meta tensor of ``params``' shape (a tensor, an
    array or a sequence)."""
    if not isinstance(params, torch.Tensor):
        params = torch.as_tensor(np.asarray(params, np.float32))
    return torch.empty(tuple(params.shape), dtype=torch.float32,
                       device="meta")


def model_cost(model, params, kind: str = "loss_and_grad",
               randkey=None) -> ProgramCost:
    """Cost of ONE execution of a model's program ``kind``.

    Runs the program over meta copies of ``model.aux_leaves()`` (bound
    through ``_with_leaves``) at meta ``params`` (``(ndim,)``, or
    ``(K, ndim)`` for ``"batched_loss_and_grad"`` and for
    ``"batched_loss_and_grad_sharded"``, of which this process's replica
    slice's rows are counted): nothing runs on the
    card, no kernel launches and no memory is taken there.  For the
    headline ``"loss_and_grad"`` program of the SMF model:
    ``transcendentals["erf"] == N·E`` (forward), ``transcendentals["exp"]
    == N·E`` (backward), and ``comm_bytes == (|y| + |params|) · 4`` in 2
    calls on a distributed comm.  A process holds its shard, so a
    distributed model reports per-process cost (the per-card roofline's
    denominator).
    """
    with_key = randkey is not None
    key = None
    if with_key:
        from ..optim.adam import init_randkey
        key = init_randkey(randkey)
    return estimate_program_cost(_program(model, kind, with_key),
                                 meta_params(params), model.aux_leaves(),
                                 key)


# ------------------------------------------------------------------ #
# Roofline prediction
# ------------------------------------------------------------------ #
#: Per-device peak envelopes.  The H100 entry is the SXM data sheet's
#: dense FP32 rate outside the tensor cores (the right denominator for
#: the erf/exp-heavy fits this package runs), its HBM3 rate, NVLink 4 in
#: one direction, and one 400 Gb/s NDR link for axes that cross hosts.
#: The CPU entry is an order-of-magnitude single-socket envelope;
#: override per call when you know your host.
DEVICE_SPECS: Dict[str, dict] = {
    "h100": {"flops_per_s": FP32_OPS_PER_S,
             "hbm_bytes_per_s": HBM_BYTES_PER_S,
             "interconnect_bytes_per_s": 4.5e11,
             "slow_axis_bytes_per_s": 5.0e10,
             "source": "NVIDIA H100 SXM data sheet at 700 W: FP32 67 "
                       "TFLOP/s, HBM3 3.35 TB/s, NVLink 4 450 GB/s a "
                       "direction; NDR 400 Gb/s across hosts"},
    "cpu": {"flops_per_s": 1.0e11, "hbm_bytes_per_s": 3.0e10,
            "interconnect_bytes_per_s": 1.0e10,
            "slow_axis_bytes_per_s": 1.0e10,
            "source": "order-of-magnitude host envelope"},
}

#: Axis names the comm fold treats as the slow (across-hosts) link: the
#: outer axes of the JAX package's 2-level layouts.
SLOW_AXES = ("hosts", "replica")


def device_spec(device_kind: Optional[str] = None) -> dict:
    """The :data:`DEVICE_SPECS` entry for a device kind (longest
    matching key, case-insensitive; default: the name of CUDA device 0
    when a card is present, else ``"cpu"``)."""
    if device_kind is None:
        device_kind = torch.cuda.get_device_name(0) \
            if torch.cuda.is_available() else "cpu"
    kind = str(device_kind).lower()
    best = None
    for key in DEVICE_SPECS:
        if key in kind and (best is None or len(key) > len(best)):
            best = key
    spec = dict(DEVICE_SPECS[best or "cpu"])
    spec["device_kind"] = str(device_kind)
    return spec


def predicted_time_s(cost: ProgramCost, spec: Optional[dict] = None,
                     device_kind: Optional[str] = None) -> dict:
    """Roofline fold of a :class:`ProgramCost`.

    ``predicted_s = max(compute_s, memory_s, comm_s)`` with ``bound``
    naming the binding side.  The memory side uses ``min_hbm_bytes`` —
    the one-read-one-write ideal — so the prediction is a *lower* bound
    on the achievable time.  The comm side folds each axis's payload
    against ``slow_axis_bytes_per_s`` for :data:`SLOW_AXES` and
    ``interconnect_bytes_per_s`` otherwise, and the unattributed payload
    against the fast link.
    """
    spec = spec or device_spec(device_kind)
    compute_s = cost.flops / spec["flops_per_s"]
    memory_s = cost.min_hbm_bytes / spec["hbm_bytes_per_s"]
    fast_bw = spec.get("interconnect_bytes_per_s")
    comm_s = 0.0
    if fast_bw:
        slow_bw = spec.get("slow_axis_bytes_per_s", fast_bw)
        for axis, nbytes in cost.comm_bytes_by_axis.items():
            comm_s += nbytes / (slow_bw if axis in SLOW_AXES
                                else fast_bw)
        comm_s += cost.comm_bytes_unattributed / fast_bw
    predicted = max(compute_s, memory_s, comm_s)
    bound = "compute"
    if predicted == memory_s and memory_s > compute_s:
        bound = "memory"
    if predicted == comm_s and comm_s > max(compute_s, memory_s):
        bound = "comm"
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "comm_s": comm_s,
        "predicted_s": predicted,
        "bound": bound,
        "device_kind": spec.get("device_kind"),
        "spec_source": spec.get("source"),
    }


def roofline_record(cost: ProgramCost, measured_s: float,
                    spec: Optional[dict] = None,
                    device_kind: Optional[str] = None,
                    **extra) -> dict:
    """The attribution join: model-predicted vs measured time.

    Returns the flat ``roofline`` telemetry record, where
    ``roofline_frac = predicted_s / measured_s`` (1.0 = the hardware
    envelope, small = the program left the card idle).  ``extra`` fields
    (config name, steps) ride along.
    """
    pred = predicted_time_s(cost, spec=spec, device_kind=device_kind)
    rec = dict(pred)
    rec.update(cost.record())
    rec["measured_s"] = float(measured_s)
    rec["roofline_frac"] = (
        float(pred["predicted_s"] / measured_s)
        if measured_s and measured_s > 0 else None)
    rec.update(extra)
    return rec
