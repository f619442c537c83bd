"""Knob-space enumeration: which configurations a model can run as (port
of :mod:`multigrad_tpu.tune.space`).

A **candidate** is a plain dict of knob values — aux knobs
(``bin_mode``/``bin_window``/``chunk_size``) applied through
``model.replace_aux`` and the fit knob ``donate_carry`` — with the
hand-set default always candidate 0 (the tuner always measures it, so a
tuned pick can never silently regress the default it replaces).

The space is data- and hardware-aware rather than a raw cross product:

* fused-bin candidates exist only when the model has a concrete bin grid
  and a ``sigma_max`` to derive the float32-exact window from
  (:func:`multigrad_tpu_torch.ops.binned.fused_bin_window`);
* chunk-size candidates only appear at row counts where chunking is a
  real memory/speed tradeoff (a 10k-halo fit has nothing to chunk), and
  on the card only for a model whose chunk changes what runs there: the
  history model's chunk loop does (its launches and recompute), the SMF
  model's ``chunk_size`` does not (it bounds the plain versions' memory
  on the CPU; the CUDA kernels stream any N), so measuring its chunk
  candidates on the card would rank identical programs on noise;
* no donation candidates: the port's fits accept ``donate_carry`` and
  ignore it (a host loop has no carry to donate), and the JAX package
  has none on the CPU either.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["model_candidates", "streaming_candidates",
           "DEFAULT_BUCKET_CANDIDATES",
           "SHARDED_BUCKET_CANDIDATES", "bucket_candidates",
           "find_bin_edges", "MAX_CANDIDATES"]

#: Bucket-size candidates for the serve-scheduler ladder search.
DEFAULT_BUCKET_CANDIDATES = (1, 2, 4, 8, 16, 32, 64)

#: The extended rungs a sharded-K mesh unlocks in the JAX package; the
#: port has no replica axis yet (ROADMAP Queue 1 item 6).
SHARDED_BUCKET_CANDIDATES = DEFAULT_BUCKET_CANDIDATES + (128, 256)


def bucket_candidates(model, nsteps: int, ndim: int = 2,
                      k_sharded: bool = False,
                      budget_bytes=None) -> tuple:
    """The bucket-size candidate set for one model and workload, capped
    by :func:`~multigrad_tpu_torch.inference.max_k_for_budget` when a
    per-device ``budget_bytes`` is given (the cap is derived, never a
    hardcoded max; the smallest rung always survives).  That memory model
    counts the Adam carry only — trajectory and moments — not the
    autograd graph a row of the port's batched call holds until its
    backward (≈0.4 GB a row at 1e8 halos; ROADMAP Queue 2 item 9), so the
    cap admits more than the card can hold at large catalogs.
    ``k_sharded=True`` raises: sharded K is not ported yet."""
    from ..core.model import _require_replicated_k
    from ..inference.ensemble import max_k_for_budget

    _require_replicated_k(k_sharded)
    del model
    cands = DEFAULT_BUCKET_CANDIDATES
    if budget_bytes is None:
        return cands
    cap = max_k_for_budget(int(budget_bytes), int(ndim), int(nsteps))
    kept = tuple(b for b in cands if b <= cap)
    return kept or cands[:1]


#: Cap on the enumerated cross product (the static prune keeps the
#: measured stage short anyway; the cap bounds the counting budget).
MAX_CANDIDATES = 16

#: Chunk the particle axis only above this many per-shard rows — below
#: it the whole catalog is one comfortable block and every chunk
#: candidate is pure loop overhead.
_CHUNK_MIN_ROWS = 1 << 19


def find_bin_edges(aux_data) -> Optional[np.ndarray]:
    """The model's concrete bin grid, if it has one (the shipped models
    store it under ``bin_edges`` / ``smf_bin_edges``), as numpy."""
    if not isinstance(aux_data, dict):
        return None
    for key in ("bin_edges", "smf_bin_edges"):
        edges = aux_data.get(key)
        if edges is not None:
            if isinstance(edges, torch.Tensor):
                edges = edges.detach().cpu().numpy()
            return np.asarray(edges)
    return None


def _chunk_candidates(n_rows: int, current) -> list:
    """Chunk sizes worth trying at this scale (always includes the current
    setting first — the hand-set default)."""
    out = [current]
    if n_rows >= _CHUNK_MIN_ROWS:
        for c in (1 << 18, 1 << 20, 1 << 22):
            if c < n_rows and c != current:
                out.append(c)
    return out


def _model_backend(model) -> str:
    return "cuda" if model.device.type == "cuda" else "cpu"


def model_candidates(model, params=None, sigma_max=None,
                     backend: Optional[str] = None) -> list:
    """Enumerate the knob space for an :class:`~multigrad_tpu_torch.core
    .model.OnePointModel`.

    Returns a list of candidate dicts (default first), each with the
    keys ``bin_mode``, ``bin_window``, ``chunk_size`` (aux knobs) and
    ``donate_carry`` (always ``None``: see the module docstring).
    ``sigma_max`` bounds the smoothing width the fit can reach (read from
    ``aux_data["sigma_max"]`` when not passed); without it no fused
    candidate is generated — the window would not be provably
    float32-exact.  ``backend`` (default: the model's device, ``"cuda"``
    or ``"cpu"``) decides whether the SMF model's chunk sizes are
    candidates.
    """
    from .table import catalog_rows

    del params
    if backend is None:
        backend = _model_backend(model)
    aux = model.aux_data if isinstance(model.aux_data, dict) else {}
    n_rows = catalog_rows(aux, getattr(model, "comm", None))
    edges = find_bin_edges(aux)
    if sigma_max is None:
        sigma_max = aux.get("sigma_max")

    cur_mode = aux.get("bin_mode", "dense")
    cur_window = aux.get("bin_window")
    if cur_mode == "auto":            # tuning resolves "auto" itself
        cur_mode = "dense"
    bin_cands = [(cur_mode, cur_window if cur_mode == "fused"
                  else None)]
    if edges is not None and sigma_max is not None:
        from ..ops.binned import fused_bin_window
        window = fused_bin_window(edges, float(sigma_max))
        for cand in (("dense", None), ("fused", window)):
            if cand not in bin_cands:
                bin_cands.append(cand)

    chunk_cands = [aux.get("chunk_size")]
    if backend != "cuda" or getattr(model, "chunks_on_card", True):
        chunk_cands = _chunk_candidates(n_rows, aux.get("chunk_size"))

    out = []
    for mode, window in bin_cands:
        for chunk in chunk_cands:
            out.append({"bin_mode": mode, "bin_window": window,
                        "chunk_size": chunk, "donate_carry": None})
            if len(out) >= MAX_CANDIDATES:
                return out
    return out


def streaming_candidates(smodel, use_scan: bool = False) -> list:
    """Enumerate the knob space for a :class:`~multigrad_tpu_torch.data
    .StreamingOnePointModel`: ``chunk_rows`` always (a quarter and four
    times the current setting), ``remat_policy`` only with
    ``use_scan=True`` (the per-chunk checkpoint exists only on the scan
    path)."""
    n_rows = smodel.n_rows
    current = int(smodel.chunk_rows)
    rows_cands = [current]
    for c in (current // 4, current * 4):
        if 1024 <= c < n_rows and c not in rows_cands:
            rows_cands.append(c)
    remat_cands = [smodel.remat_policy]
    if use_scan:
        for policy in ("dots", "nothing", "everything"):
            if policy not in remat_cands:
                remat_cands.append(policy)
    out = []
    for rows in rows_cands:
        for policy in remat_cands:
            out.append({"chunk_rows": rows, "remat_policy": policy})
            if len(out) >= MAX_CANDIDATES:
                return out
    return out
