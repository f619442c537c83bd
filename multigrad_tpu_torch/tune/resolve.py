"""``"auto"`` knob resolution: the read side of the tuning table (port of
:mod:`multigrad_tpu.tune.resolve`).

These hooks make the tuner's output the *default* path: consumers ask
for ``"auto"`` and get the tuned winner when the table holds one, or the
hand-set default when it does not — resolution **never** raises and
never changes behavior on a cold table.

Who calls what:

* :class:`~multigrad_tpu_torch.models.smf.SMFModel` /
  :class:`~multigrad_tpu_torch.models.galhalo_hist.GalhaloHistModel`
  ``__post_init__`` → :func:`resolve_auto_aux` — rewrites
  ``bin_mode="auto"`` / ``chunk_size="auto"`` to concrete values once, at
  construction, before any step runs.
* :class:`~multigrad_tpu_torch.data.StreamingOnePointModel`
  ``__post_init__`` → :func:`resolve_stream_knobs` —
  ``chunk_rows="auto"`` / ``remat_policy="auto"``.
* :class:`~multigrad_tpu_torch.serve.FitScheduler` (and fleet workers) →
  :func:`resolve_buckets` — ``buckets="auto"`` becomes the measured
  fits/hour ladder, or ``DEFAULT_BUCKETS`` cold.
* :func:`~multigrad_tpu_torch.ops.binned.binned_erf_counts` →
  :func:`resolve_op_bin_mode` — the standalone-op fallback (models
  resolve first under their class-named key).
* :func:`resolve_donate_carry` keeps the JAX package's hook; the port's
  fits accept ``donate_carry`` and ignore it, so nothing calls it.

Every key's backend and device-kind tags come from the device of the
model's tensors (:func:`~.table.device_tags`).  Lookups read shapes
only, and any table problem — a missing file, a torn write, version skew
— degrades to the hand-set default silently.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .table import (TuningTable, catalog_rows, device_tags, make_key,
                    model_shape_key)

__all__ = ["resolve_auto_aux", "resolve_donate_carry",
           "resolve_stream_knobs", "resolve_buckets",
           "resolve_op_bin_mode", "aux_model_key",
           "DEFAULT_STREAM_CHUNK_ROWS"]

#: Cold-table fallback for ``chunk_rows="auto"`` (bounded, power of two;
#: a catalog smaller than this streams as one chunk).
DEFAULT_STREAM_CHUNK_ROWS = 1 << 20


def _table(table) -> TuningTable:
    return table if isinstance(table, TuningTable) else \
        TuningTable(table)


def _edges_count(aux: dict) -> Optional[int]:
    """Edge count of the model's bin grid, shape-only."""
    for key in ("bin_edges", "smf_bin_edges"):
        e = aux.get(key)
        if e is not None:
            shape = getattr(e, "shape", None)
            if shape is None:
                shape = np.shape(e)
            return int(shape[0]) if len(shape) else None
    return None


def _aux_tags(aux) -> tuple:
    """``(backend, device_kind)`` of the first tensor of ``aux``; the
    default tags when it holds none."""
    from ..utils.util import tree_leaves
    for leaf in tree_leaves(aux):
        if isinstance(leaf, torch.Tensor):
            return device_tags(leaf.device)
    return None, None


def aux_model_key(model_name: str, aux: dict, comm=None,
                  bin_window=None, backend=None,
                  device_kind=None) -> str:
    """The ``model``-kind table key for an aux configuration (write and
    read sides share this; see :func:`~multigrad_tpu_torch.tune.tuner
    .model_key`).  ``backend``/``device_kind`` default to the tags of the
    aux's device."""
    if backend is None and device_kind is None:
        backend, device_kind = _aux_tags(aux)
    n_rows = catalog_rows(aux, comm)
    n_edges = _edges_count(aux)
    if bin_window is None:
        bin_window = aux.get("bin_window")
    if bin_window is None and aux.get("sigma_max") is not None:
        # Mirror the write side (tuner.model_key): an aux carrying a
        # sigma bound but no stored window keys under the window that
        # bound derives, not 0, so read and write never disagree.
        try:
            from ..ops.binned import fused_bin_window
            from .space import find_bin_edges
            edges = find_bin_edges(aux)
            if edges is not None:
                bin_window = fused_bin_window(
                    edges, float(aux["sigma_max"]))
        except Exception:
            pass
    window = int(bin_window) if isinstance(bin_window, (int,
                                                        np.integer)) \
        else 0
    return make_key("model", model_name,
                    model_shape_key(n_rows, n_edges,
                                    window if n_edges else None),
                    backend, device_kind)


def _model_knobs(model_name: str, aux: dict, comm,
                 table) -> Tuple[dict, str]:
    key = aux_model_key(model_name, aux, comm)
    entry = _table(table).lookup(key)
    return (dict(entry.get("knobs", {})) if entry else {}), key


def resolve_auto_aux(model_name: str, aux, comm=None,
                     table=None):
    """Rewrite any ``"auto"`` aux knobs to concrete values.

    Returns ``aux`` unchanged (the same object) when nothing is
    ``"auto"`` — every ``dataclasses.replace`` of a model passes here —
    or a new dict with ``bin_mode``/``chunk_size`` resolved from the
    tuning table (``bin_mode`` → ``"dense"`` cold, ``chunk_size`` →
    ``None`` cold: the hand-set defaults).
    """
    if not isinstance(aux, dict):
        return aux
    auto_bin = aux.get("bin_mode") == "auto"
    auto_chunk = aux.get("chunk_size") == "auto"
    if not (auto_bin or auto_chunk):
        return aux
    try:
        knobs, _key = _model_knobs(model_name, aux, comm, table)
    except Exception:
        knobs = {}
    out = dict(aux)
    if auto_bin:
        mode = knobs.get("bin_mode", "dense")
        out["bin_mode"] = mode if mode in ("dense", "fused") \
            else "dense"
        if out["bin_mode"] == "fused":
            window = knobs.get("bin_window") or aux.get("bin_window")
            if window:
                out["bin_window"] = int(window)
            else:                    # no exact window derivable
                out["bin_mode"] = "dense"
    if auto_chunk:
        chunk = knobs.get("chunk_size")
        out["chunk_size"] = int(chunk) if chunk else None
    return out


def resolve_donate_carry(model, table=None):
    """Tuned ``donate_carry`` verdict for this model's key, or ``None``.
    The port's tuner enumerates no donation candidates and its fits
    ignore the knob; a table written by the JAX package may hold one."""
    try:
        aux = model.aux_data if isinstance(model.aux_data, dict) \
            else {}
        knobs, _ = _model_knobs(type(model).__name__, aux,
                                getattr(model, "comm", None), table)
        donate = knobs.get("donate_carry")
        return bool(donate) if donate is not None else None
    except Exception:
        return None


def stream_key(model_name: str, n_rows: int, comm=None,
               device=None) -> str:
    """The ``stream``-kind table key of a streaming model of ``n_rows``
    global catalog rows (per-process rows in the key) whose chunks go to
    ``device`` (the key's tags; default: the default tags); write and
    read sides share it."""
    per_shard = max(1, int(n_rows) // (comm.size if comm is not None
                                       else 1))
    backend, kind = device_tags(device) if device is not None \
        else (None, None)
    return make_key("stream", model_name, model_shape_key(per_shard),
                    backend, kind)


def resolve_stream_knobs(model_name: str, n_rows: int, comm=None,
                         chunk_rows="auto", remat_policy="auto",
                         table=None, device=None) -> Tuple[int, object]:
    """Concrete ``(chunk_rows, remat_policy)`` for a streaming model of
    ``n_rows`` global catalog rows whose chunks go to ``device``.  Cold
    fallbacks: ``min(n_rows, DEFAULT_STREAM_CHUNK_ROWS)`` and
    ``"dots"``."""
    knobs = {}
    try:
        key = stream_key(model_name, n_rows, comm, device)
        entry = _table(table).lookup(key)
        knobs = dict(entry.get("knobs", {})) if entry else {}
    except Exception:
        pass
    if chunk_rows == "auto":
        chunk_rows = int(knobs.get("chunk_rows") or
                         min(int(n_rows), DEFAULT_STREAM_CHUNK_ROWS))
    if remat_policy == "auto":
        remat_policy = knobs.get("remat_policy", "dots")
    return int(chunk_rows), remat_policy


def buckets_key(model) -> str:
    """The ``buckets``-kind table key of a model (write and read sides)."""
    aux = model.aux_data if isinstance(model.aux_data, dict) else {}
    shape = model_shape_key(
        catalog_rows(aux, getattr(model, "comm", None)))
    return make_key("buckets", type(model).__name__, shape,
                    *device_tags(model.device))


def resolve_buckets(model, table=None) -> tuple:
    """The serve scheduler's bucket ladder for this model: the measured
    fits/hour ladder :func:`~multigrad_tpu_torch.tune.tuner
    .tune_buckets` persisted, or :data:`~multigrad_tpu_torch.serve
    .compile_cache.DEFAULT_BUCKETS` cold."""
    from ..serve.compile_cache import DEFAULT_BUCKETS

    try:
        entry = _table(table).lookup(buckets_key(model))
        if entry:
            buckets = entry.get("knobs", {}).get("buckets")
            if buckets:
                return tuple(sorted(set(int(b) for b in buckets)))
    except Exception:
        pass
    return DEFAULT_BUCKETS


def resolve_op_bin_mode(n_values: int, n_edges: int, bin_window,
                        table=None,
                        device=None) -> Tuple[str, Optional[int]]:
    """Standalone-op ``bin_mode="auto"`` resolution for
    :func:`~multigrad_tpu_torch.ops.binned.binned_erf_counts` on
    ``device`` (the key's tags; model-level resolution normally runs
    first and rewrites the knob; this covers direct op calls).  Dense
    cold, or without a static window."""
    try:
        window = int(bin_window) if bin_window else 0
        backend, kind = device_tags(device) if device is not None \
            else (None, None)
        key = make_key("model", "binned_erf_counts",
                       model_shape_key(int(n_values), int(n_edges),
                                       window), backend, kind)
        entry = _table(table).lookup(key)
        knobs = dict(entry.get("knobs", {})) if entry else {}
        mode = knobs.get("bin_mode", "dense")
        if mode == "fused":
            window = int(knobs.get("bin_window") or window)
            if window >= 2:
                return "fused", window
        return "dense", (int(bin_window) if bin_window else None)
    except Exception:
        return "dense", (int(bin_window) if bin_window else None)
