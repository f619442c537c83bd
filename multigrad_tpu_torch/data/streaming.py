"""Out-of-core model fitting: exact streamed loss and gradients (port of
:mod:`multigrad_tpu.data.streaming`).

:class:`StreamingOnePointModel` runs an
:class:`~multigrad_tpu_torch.core.model.OnePointModel` over a catalog that
never needs to be resident on the card (or even in host memory).  The
additivity that makes the communication O(|sumstats| + |params|) also
makes slicing the catalog in time exact:

    y      = Σ_k y_k                    (pass 1: stream the chunks, add
                                         up the sumstats on the device)
    dL/dy  = ∂loss/∂y |_y               (once, O(|y|))
    dL/dp  = Σ_k (∂y_k/∂p)ᵀ · dL/dy    (pass 2: stream them again, add
                                         up each chunk's VJP)

Both passes stream through the double-buffered prefetcher
(:mod:`.prefetch`): the copy of chunk k+1 overlaps the compute on chunk
k, and the card holds at most two chunk buffers.  Each pass adds the
chunks' partials up on the device in chunk order and sums the total over
the comm ONCE: ``y`` (joined with any sumstats aux) after pass 1, the
gradient after pass 2, ``(y, J)`` after the Jacobian pass.  So a streamed
loss and gradient makes 2 all-reduces whatever the number of chunks.
The result equals the resident model's to float32 summation order.

For catalogs that fit on the card but whose backward residuals would not,
:meth:`StreamingOnePointModel.calc_loss_and_grad_scan` makes the chunk
stack resident once and runs the chain rule over it each step, every
chunk's forward under a remat policy (see
:func:`~multigrad_tpu_torch.core.model.resolve_remat_policy`).

Contracts
---------
* the wrapped model's ``aux_data`` must be a dict holding only the
  *resident* leaves, which describe the whole catalog (the SMF's
  ``volume`` is that of all its halos); streamed leaves are bound per
  chunk under their stream names.
* the sumstats must add up over row chunks.  The erf-CDF counts do (the
  SMF and galaxy–halo models); pair counts do not, since their cross
  terms span chunks, so ``WprpModel`` and ``XiModel`` do not stream.
* with ``sumstats_func_has_aux=True`` the aux must be additive over
  chunks and shards (it is accumulated exactly like the sumstats).
* a ``randkey`` is forwarded identically to every chunk, so streamed ==
  resident only holds for sumstats whose randomness is per-row
  independent of position (deterministic kernels always match).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Mapping, Optional, Union

import numpy as np
import torch

from ..core.model import OnePointModel, psum_tree, tree_map
from ..optim import adam as _adam
from ..optim.adam import init_randkey
from ..parallel.collectives import psum
from ..utils.profiling import StreamStats
from .prefetch import _Staging, prefetch_chunks
from .source import CatalogSource, ChunkPlan, _shard_span, as_source

__all__ = ["StreamingOnePointModel"]


def _close(chunks):
    """Stop a chunk stream (a prefetcher's loader, or a generator)."""
    close = getattr(chunks, "close", None)
    if close is not None:
        close()


@dataclass
class StreamingOnePointModel:
    """Stream catalogs through an :class:`OnePointModel`'s algebra.

    Parameters
    ----------
    model : OnePointModel
        The wrapped model (sumstats and loss, the comm, and the resident
        ``aux_data``, which must NOT contain the streamed keys).  Chunks
        go to its device.
    streams : mapping of str -> CatalogSource | array | path
        Per-stream catalog sources, keyed by the ``aux_data`` name the
        model's sumstats method reads.  All streams must be row-aligned.
        Values pass through :func:`~multigrad_tpu_torch.data.source
        .as_source`.
    chunk_rows : int or "auto"
        Global rows per chunk (rounded up to a multiple of the comm size;
        see :func:`~multigrad_tpu_torch.data.source.plan_chunks`).  Each
        process loads only its shard of each chunk.  ``"auto"`` resolves
        the tuned chunk size from the autotuner's table
        (:func:`multigrad_tpu_torch.tune.tune_streaming` writes it), or
        ``min(n_rows, 2**20)`` on a cold table.
    pad_values : float or mapping of str -> float
        Neutral filler of the ragged final chunk, per stream.  Default
        ``inf`` (neutral for the erf-CDF counts).
    prefetch : bool
        Double-buffered background prefetch (default).  ``False`` loads
        chunks in the consumer's thread (the baseline of the stall and
        overlap counters).
    remat_policy : str | callable | None
        The scan path's per-chunk remat policy (see
        :func:`~multigrad_tpu_torch.core.model.resolve_remat_policy`).
        Default ``"dots"``.  ``"auto"`` resolves the tuned policy from
        the autotuner's table (``"dots"`` cold).
    """

    model: OnePointModel
    streams: Mapping[str, Union[CatalogSource, str, np.ndarray]]
    chunk_rows: int
    pad_values: Union[float, Mapping[str, float]] = np.inf
    prefetch: bool = True
    remat_policy: Union[str, Callable, None] = "dots"
    last_stats: Optional[StreamStats] = field(default=None, repr=False)

    def __post_init__(self):
        self.streams = {name: as_source(src)
                        for name, src in self.streams.items()}
        if not self.streams:
            raise ValueError("streams must name at least one catalog")
        lengths = {name: src.n_rows for name, src in self.streams.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(
                f"streams must be row-aligned, got lengths {lengths}")
        if self.chunk_rows == "auto" or self.remat_policy == "auto":
            # Tuned streaming knobs from the autotuner's table, keyed by
            # the device the chunks go to; a cold table gives the
            # hand-set defaults.
            from ..tune.resolve import resolve_stream_knobs
            self.chunk_rows, self.remat_policy = resolve_stream_knobs(
                type(self.model).__name__,
                next(iter(self.streams.values())).n_rows,
                self.model.comm, chunk_rows=self.chunk_rows,
                remat_policy=self.remat_policy, device=self.model.device)
        if isinstance(self.model.aux_data, dict):
            overlap = set(self.streams) & set(self.model.aux_data)
            if overlap:
                raise ValueError(
                    f"aux_data already holds streamed keys {overlap}; "
                    "resident aux and streams must be disjoint")
        self._names = tuple(self.streams)
        self._device = self.model.device
        # The prefetchers' pinned staging, device buffers and copy stream,
        # shared by every pass; the scan path's chunk stack.  Both lazy.
        self._staging = None
        self._scan_stack = None

    # ------------------------------------------------------------------ #
    # Plumbing
    # ------------------------------------------------------------------ #
    @property
    def comm(self):
        return self.model.comm

    @property
    def n_rows(self) -> int:
        return next(iter(self.streams.values())).n_rows

    def plan(self) -> ChunkPlan:
        """The deterministic chunk plan for the current comm."""
        n_shards = self.comm.size if self.comm is not None else 1
        return next(iter(self.streams.values())).plan(
            self.chunk_rows, n_shards)

    def _pad_value(self, name: str):
        if isinstance(self.pad_values, Mapping):
            return self.pad_values[name]
        return self.pad_values

    def _shard_rows(self, plan: ChunkPlan, k: int):
        """This process's rows of chunk ``k`` of each stream, not yet
        copied (the prefetcher stages and pads them)."""
        span = _shard_span(plan, k,
                           self.comm.rank if self.comm is not None else 0)
        return [self.streams[name]._chunk_rows(span, self._pad_value(name))
                for name in self._names]

    def _iter_chunks(self, plan: ChunkPlan, stats: StreamStats,
                     pass_name: Optional[str] = None):
        if self._staging is None and self._device.type == "cuda":
            self._staging = _Staging(self._device)
        return prefetch_chunks(
            lambda k: self._shard_rows(plan, k), plan.n_chunks,
            device=self._device, prefetch=self.prefetch, stats=stats,
            pass_name=pass_name, staging=self._staging)

    @staticmethod
    def _key_arg(randkey):
        return init_randkey(randkey) if randkey is not None else None

    # ------------------------------------------------------------------ #
    # Streamed passes
    # ------------------------------------------------------------------ #
    def _accumulate(self, program, params, randkey,
                    pass_name: Optional[str] = None):
        """Drive a chunk program over the whole plan, adding its outputs
        up on the device in chunk order, then sum the total over the comm
        in one all-reduce; records ``last_stats`` (split under
        ``pass_name``)."""
        params = self.model._params(params)
        key = self._key_arg(randkey)
        stats = StreamStats()
        total = None
        chunks = self._iter_chunks(self.plan(), stats, pass_name)
        try:
            for _k, chunk in chunks:
                out = program(params, chunk, key)
                total = out if total is None else tree_map(torch.add, total,
                                                           out)
        finally:
            _close(chunks)
        self.last_stats = stats
        return psum_tree(total, self.comm)

    def calc_sumstats_from_params(self, params, randkey=None):
        """Total sumstats over the full streamed catalog (pass 1): equal,
        to float32 summation order, to the resident model's
        ``calc_sumstats_from_params()``.  With ``sumstats_func_has_aux``
        returns ``(total, aux_total)``."""
        return self._accumulate(
            self.model.chunk_sumstats_fn(self._names, randkey is not None),
            params, randkey, pass_name="sumstats")

    def calc_sumstats_and_jac_from_params(self, params, randkey=None):
        """Streamed total sumstats and Jacobian, in one pass: ``∂y/∂p =
        Σ_k ∂y_k/∂p`` adds up over chunks like the sumstats, so a Fisher
        matrix (:func:`multigrad_tpu_torch.inference.fisher_information`)
        costs one pass over a catalog of any size.  Sumstats aux values
        (if any) are dropped."""
        return self._accumulate(
            self.model.chunk_jac_fn(self._names, randkey is not None),
            params, randkey, pass_name="jac")

    def _loss_from_total(self, total, randkey):
        """``(loss, dL/dy)`` from the accumulated totals."""
        m = self.model
        y, ss_aux = total if m.sumstats_func_has_aux else (total, None)
        y = y.detach().requires_grad_(True)
        with torch.enable_grad():
            loss, _ = m._loss(y, ss_aux, m._key_kwargs(randkey))
            (ct,) = torch.autograd.grad(loss, y)
        return loss.detach(), ct

    def calc_loss_from_params(self, params, randkey=None):
        """Loss at ``params`` over the streamed catalog (one pass)."""
        total = self.calc_sumstats_from_params(params, randkey=randkey)
        return self._loss_from_total(total, randkey)[0]

    def calc_loss_and_grad_from_params(self, params, randkey=None):
        """Exact loss and gradient by the two-pass streamed chain rule.

        Pass 1 adds up the total sumstats ``y`` chunk by chunk; ``dL/dy``
        is computed once from the total; pass 2 streams the chunks again,
        adding up each chunk's VJP.  Pass 2's prefetcher is built (its
        loader running) BEFORE ``dL/dy`` is computed, so its first chunks
        load meanwhile.  ``last_stats`` holds both passes' counters, split
        as ``passes["sumstats"]`` and ``passes["vjp"]``.
        """
        params = self.model._params(params)
        with_key = randkey is not None
        key = self._key_arg(randkey)
        plan = self.plan()

        total = self.calc_sumstats_from_params(params, randkey=randkey)
        stats = self.last_stats

        chunks = self._iter_chunks(plan, stats, pass_name="vjp")
        try:
            loss, ct = self._loss_from_total(total, randkey)
            program = self.model.chunk_vjp_fn(self._names, with_key)
            grad = None
            for _k, chunk in chunks:
                g = program(params, chunk, ct, key)
                grad = g if grad is None else grad + g
        finally:
            _close(chunks)
        self.last_stats = stats
        return loss, psum(grad, self.comm)

    def calc_dloss_dparams(self, params, randkey=None):
        return self.calc_loss_and_grad_from_params(
            params, randkey=randkey)[1]

    # ------------------------------------------------------------------ #
    # Scan path (chunks resident on the device, per-chunk remat)
    # ------------------------------------------------------------------ #
    def _materialize_scan_stack(self, plan: ChunkPlan):
        """This process's ``(n_chunks, shard_rows, ...)`` chunk stack of
        each stream on the device, built once and kept."""
        if self._scan_stack is None:
            hosts = [np.empty((plan.n_chunks,) + rows.shape, rows.dtype)
                     for rows in self._shard_rows(plan, 0)]
            for k in range(plan.n_chunks):
                for rows, host in zip(self._shard_rows(plan, k), hosts):
                    rows.copy_into(host[k])
            self._scan_stack = [torch.from_numpy(host).to(self._device)
                                for host in hosts]
        return self._scan_stack

    def calc_loss_and_grad_scan(self, params, randkey=None):
        """Loss and gradient over the resident chunk stack (see
        :meth:`~multigrad_tpu_torch.core.model.OnePointModel
        .chunk_scan_loss_and_grad_fn`): the stack must fit on the card;
        use the two-pass path above when it does not."""
        program = self.model.chunk_scan_loss_and_grad_fn(
            self._names, randkey is not None,
            remat_policy=self.remat_policy)
        stacks = self._materialize_scan_stack(self.plan())
        return program(self.model._params(params), stacks,
                       self._key_arg(randkey))

    # ------------------------------------------------------------------ #
    # Telemetry: collective-traffic accounting
    # ------------------------------------------------------------------ #
    def measure_comm(self, params, randkey=None,
                     use_scan: bool = False) -> dict:
        """Collective payload of ONE streamed loss-and-grad step, as a
        ``comm`` record.

        The port counts one real step (the JAX package traces its chunk
        programs): its two all-reduces, ``y`` after pass 1 and the
        gradient after pass 2 (the scan path's: the same two), so
        ``bytes_per_step`` is ``(|y| + |params|)`` floats whatever the
        number of chunks and the catalog's size (the JAX package's
        two-pass stream reduces every chunk).  ``comm=None`` models
        report zero.
        """
        from ..telemetry.comm import CommCounter

        fn = self.calc_loss_and_grad_scan if use_scan \
            else self.calc_loss_and_grad_from_params
        with CommCounter() as cc:
            fn(params, randkey=randkey)
        return cc.step_record(
            scope="streamed_scan_step" if use_scan
            else "streamed_loss_and_grad_step", n_chunks=self.plan().n_chunks)

    # ------------------------------------------------------------------ #
    # Fit loop
    # ------------------------------------------------------------------ #
    def run_adam(self, guess, nsteps=100, param_bounds=None,
                 learning_rate=0.01, randkey=None, progress=True,
                 use_scan: bool = False, checkpoint_dir=None,
                 checkpoint_every=None, telemetry=None,
                 log_every: int = 0, heartbeat_s=None,
                 donate_carry=None, flight=None, live=None,
                 alerts=None, diagnostics: bool = False):
        """Adam with a streamed loss-and-grad every step (the scan path
        with ``use_scan=True``); returns the ``(nsteps+1, ndim)``
        trajectory.  ``checkpoint_dir`` makes the fit resumable (see
        :func:`~multigrad_tpu_torch.optim.adam.run_adam_streamed`; the
        streamed catalog must stay fixed across a resume).
        ``donate_carry`` is accepted and ignored.

        With ``telemetry``: a ``comm`` record up front (:meth:`measure_comm`:
        one more streamed step), ``adam`` records every ``log_every``
        steps, a ``fit`` span, heartbeat and stall records every
        ``heartbeat_s`` seconds, a ``fit_summary`` with the final loss and
        the prefetcher's overlap, and a closing ``stream`` record with the
        last step's :class:`~multigrad_tpu_torch.utils.profiling
        .StreamStats`.  ``flight``, ``live``, ``alerts`` and
        ``diagnostics`` as in :func:`~multigrad_tpu_torch.optim.adam
        .run_adam_streamed`.
        """
        del donate_carry
        from ..telemetry.live import wire_monitoring

        fn = self.calc_loss_and_grad_scan if use_scan \
            else self.calc_loss_and_grad_from_params
        guess = self.model._params(guess)
        telemetry, log_every, owned = wire_monitoring(
            telemetry, log_every, live, alerts)
        try:
            if telemetry is not None:
                telemetry.log("comm", **self.measure_comm(
                    guess, randkey=randkey, use_scan=use_scan))
            traj = _adam.run_adam_streamed(
                fn, guess, nsteps=nsteps, param_bounds=param_bounds,
                learning_rate=learning_rate, randkey=randkey,
                progress=progress, checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every, telemetry=telemetry,
                log_every=log_every, heartbeat_s=heartbeat_s,
                stream_stats=lambda: self.last_stats, flight=flight,
                diagnostics=diagnostics, comm=self.comm)
            if telemetry is not None and self.last_stats is not None:
                telemetry.log("stream", **self.last_stats.summary())
            return traj
        finally:
            if owned is not None:
                owned.close()
