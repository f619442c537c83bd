"""Double-buffered background host→device chunk prefetch (port of
:mod:`multigrad_tpu.data.prefetch`).

The streamed loss-and-grad passes (:mod:`.streaming`) consume catalog
chunks one at a time.  The card runs kernels asynchronously, so hiding
the host→device transfer of chunk k+1 behind the compute on chunk k
needs only a loader thread one chunk ahead of the consumer:

    loader thread:  read chunk k+1 from the source into pinned staging
                    memory, copy it to a device buffer on a copy stream
    consumer:       launch the compute on chunk k (returns at once; the
                    card works while the loader reads and copies)

On the card a :class:`ChunkPrefetcher` copies through ``max_buffers``
slots (2: double buffering), each a pinned host staging buffer and a
device buffer of one chunk, and a CUDA stream of its own for the copies:
made once, and reused by every pass of a streamed model, whose
prefetchers share them.  Per chunk the loader

1. waits on the event of the slot's last copy before refilling its
   staging buffer, and copies the source's rows into it with
   ``np.copyto`` (padding the ragged tail in place);
2. on the copy stream, waits (on the card) for the event the consumer
   recorded on its compute stream when it moved past the slot's previous
   chunk, since the consumer's kernels may still be reading it, then
   copies the staging buffer to the device buffer (``non_blocking``) and
   records an event;
3. waits for that event before it hands the chunk over, so that
   ``StreamStats.stall_s`` is what it is in the JAX package: the host
   time the consumer waits for a chunk that is not on the card yet.

The consumer's stream waits on the chunk's copy event before any of its
kernels reads the chunk.  A chunk's tensors are the slot's buffers: they
hold chunk k until the loader refills the slot with chunk k+max_buffers,
which it may start once the consumer has moved past chunk k, so a
consumer that keeps a chunk clones it.  Pinned memory and the copy
stream are not optional: if either cannot be had, the prefetcher raises
rather than copy from pageable memory.

On the CPU (``device="cpu"``) a chunk is a tensor over the loaded numpy
rows, and nothing else is needed.  Counters (bytes streamed, chunks/s,
stall time) land in a :class:`~multigrad_tpu_torch.utils.profiling
.StreamStats`, split per pass by ``pass_name``.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from .._lockdep import make_lock
from ..utils.profiling import StreamStats
from ..utils.util import resolve_device
from .source import _ChunkRows

__all__ = ["ChunkPrefetcher", "prefetch_chunks"]

_DONE = object()


def _card(device) -> torch.device:
    """``resolve_device(device)``, with the current card's index when a
    CUDA device names none (the loader thread makes it current)."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _leaves(host):
    """What ``load_fn`` returned as a list of arrays, and whether it was
    a list or tuple (else one array)."""
    if isinstance(host, (list, tuple)):
        return list(host), True
    return [host], False


def _host_tensor(leaf) -> torch.Tensor:
    """A CPU tensor over ``leaf``'s rows (copied only when they are
    read-only, a memmap's, say)."""
    arr = np.asarray(leaf)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


def _stage(leaves, views):
    """Copy each leaf into its pinned staging buffer's numpy view."""
    for leaf, view in zip(leaves, views):
        if isinstance(leaf, _ChunkRows):
            leaf.copy_into(view)
        else:
            np.copyto(view, leaf)


def _pinned_like(leaf) -> torch.Tensor:
    """A pinned host tensor of ``leaf``'s shape and dtype; raises when
    the memory cannot be pinned."""
    dtype = torch.from_numpy(np.empty(0, leaf.dtype)).dtype
    host = torch.empty(tuple(leaf.shape), dtype=dtype, pin_memory=True)
    if not host.is_pinned():
        raise RuntimeError("chunk staging memory could not be pinned")
    return host


class _Staging:
    """A loader's buffers for the card, made once and reused by every
    stream handed them (a streamed model's passes and steps): a copy
    stream, and per slot the pinned staging tensors of one chunk (with
    their numpy views) and its device buffers, the event of the slot's
    last copy, and the event the consumer recorded on the compute stream
    (the one current when the staging was made) when it moved past the
    slot's last chunk.  One stream uses them at a time."""

    def __init__(self, device: torch.device, max_buffers: int = 2):
        self.device = device
        self.compute = torch.cuda.current_stream(device)
        self.copy = torch.cuda.Stream(device)
        self.slots = [None] * max_buffers
        self.copied = [None] * max_buffers
        self.released = [None] * max_buffers

    def buffers(self, slot, leaves):
        """The slot's ``(pinned tensors, numpy views, device buffers)``
        for chunks like ``leaves``, made at first use (or for other
        shapes).  The device buffers belong to the copy stream and are
        marked as used by the compute stream, so their memory is not
        reused while the consumer's kernels may still read them."""
        like = [(tuple(leaf.shape), np.dtype(leaf.dtype)) for leaf in leaves]
        if self.slots[slot] is None or self.slots[slot][0] != like:
            if self.copied[slot] is not None:
                self.copied[slot].synchronize()
            pinned, views, bufs = [], [], []
            with torch.cuda.stream(self.copy):
                for leaf in leaves:
                    host = _pinned_like(leaf)
                    buf = torch.empty_like(host, device=self.device)
                    buf.record_stream(self.compute)
                    pinned.append(host)
                    views.append(host.numpy())
                    bufs.append(buf)
            self.slots[slot] = (like, pinned, views, bufs)
        return self.slots[slot][1:]

    def to_card(self, slot, leaves):
        """Stage ``leaves`` in the slot's pinned memory and copy them to
        its device buffers on the copy stream; returns the buffers and the
        copy's event, waited for."""
        pinned, views, bufs = self.buffers(slot, leaves)
        if self.copied[slot] is not None:
            self.copied[slot].synchronize()  # the staging buffer is free
        _stage(leaves, views)
        with torch.cuda.stream(self.copy):
            if self.released[slot] is not None:
                # The consumer's kernels on the slot's last chunk first.
                self.copy.wait_event(self.released[slot])
            for buf, host in zip(bufs, pinned):
                buf.copy_(host, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self.copy)
        self.copied[slot] = copied
        # On the card before it is handed over: the consumer's wait on the
        # queue is then the wait for the chunk (stall_s).
        copied.synchronize()
        return bufs, copied

    def release(self, slot):
        """The consumer moved past the slot's chunk: its kernels on it are
        launched, and the slot may be refilled after them."""
        released = torch.cuda.Event()
        released.record(self.compute)
        self.released[slot] = released


class ChunkPrefetcher:
    """Iterate chunks on ``device``, loading one ahead in the background.

    The loader thread starts at construction, not at the first
    iteration: build the prefetcher as soon as the chunk schedule is
    known, and its first loads overlap whatever the host does before it
    consumes (the streamed backward pass builds its prefetcher before it
    computes the cotangent).

    Parameters
    ----------
    load_fn : callable
        ``load_fn(k) -> host array or list of them`` for chunk ``k``
        (numpy arrays of one shape for every chunk, or the rows of
        :meth:`CatalogSource._chunk_rows`, padded as they are staged).
        Runs on the loader thread; sources are read-only, so they are
        thread-safe.
    n_chunks : int
        Number of chunks in the stream.
    device : optional
        Where the chunks go (``None`` means CUDA, raising without a
        card).  One process per shard: a chunk goes whole to this
        process's device.
    max_buffers : int
        Device chunk buffers the prefetcher holds at once.  2 is double
        buffering; 1 is serial load → compute.
    stats : StreamStats, optional
        Counter sink; a fresh one when omitted.
    pass_name : str, optional
        Label of this stream's split in ``stats.passes``.
    staging : optional
        On the card, the buffers of an earlier stream to reuse (a
        streamed model keeps one for all its passes); made for this
        stream alone when omitted.
    """

    def __init__(self, load_fn: Callable, n_chunks: int, device=None,
                 max_buffers: int = 2,
                 stats: Optional[StreamStats] = None,
                 pass_name: Optional[str] = None, staging=None):
        if max_buffers < 1:
            raise ValueError("max_buffers must be >= 1")
        self.device = _card(device)
        self.load_fn = load_fn
        self.n_chunks = n_chunks
        self.max_buffers = max_buffers
        self.stats = stats if stats is not None else StreamStats()
        self.pass_name = pass_name
        self._tokens = threading.Semaphore(max_buffers)
        self._live = 0
        self._live_lock = make_lock(
            "data.prefetch.ChunkPrefetcher._live_lock")
        self._queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._staging = None
        if self.device.type == "cuda":
            if staging is None:
                staging = _Staging(self.device, max_buffers)
            elif len(staging.slots) != max_buffers:
                raise ValueError("the staging has another number of slots")
            self._staging = staging
        self._thread = threading.Thread(target=self._producer, daemon=True,
                                        name="mgt-torch-chunk-prefetch")
        self._thread.start()

    # -- loader thread ------------------------------------------------------
    def _producer(self):
        try:
            if self._staging is not None:
                # The current device is per thread.
                with torch.cuda.device(self.device):
                    self._produce()
            else:
                self._produce()
            self._queue.put(_DONE)
        except BaseException as e:  # surface on the consumer side
            self._queue.put(e)

    def _produce(self):
        for k in range(self.n_chunks):
            self._tokens.acquire()
            if self._stop.is_set():
                return
            leaves, is_list = _leaves(self.load_fn(k))
            nbytes = sum(int(getattr(leaf, "nbytes", 0)) for leaf in leaves)
            if self._staging is not None:
                dev, copied = self._staging.to_card(k % self.max_buffers,
                                                    leaves)
            else:
                dev, copied = [_host_tensor(leaf) for leaf in leaves], None
            with self._live_lock:
                self._live += 1
                live = self._live
            self.stats.saw_live_buffers(live)
            self.stats.add(self.pass_name, bytes_streamed=nbytes, chunks=1)
            self._queue.put((k, dev if is_list else dev[0], copied))

    # -- consumer side ------------------------------------------------------
    def __iter__(self):
        t_start = time.perf_counter()
        first = True
        try:
            for _ in range(self.n_chunks):
                t0 = time.perf_counter()
                item = self._queue.get()
                waited = time.perf_counter() - t0
                if item is _DONE:
                    break
                if isinstance(item, BaseException):
                    raise item
                self.stats.add(self.pass_name,
                               **{"fill_s" if first else "stall_s": waited})
                first = False
                k, dev, copied = item
                if copied is not None:
                    self._staging.compute.wait_event(copied)
                yield k, dev
                if self._staging is not None:
                    self._staging.release(k % self.max_buffers)
                with self._live_lock:
                    self._live -= 1
                self._tokens.release()
        finally:
            self.stats.add(self.pass_name,
                           wall_s=time.perf_counter() - t_start)
            self.close()

    def close(self):
        """Stop the loader and unblock it if it waits for a slot.  On the
        card every slot is then marked released after all the work the
        consumer launched, so a later stream through the same staging
        refills none of its buffers while that work may still read it
        (the consumer may have stopped early, on an error)."""
        self._stop.set()
        self._tokens.release()
        self._thread.join(timeout=5.0)
        if self._staging is not None and not self._thread.is_alive():
            for slot in range(self.max_buffers):
                self._staging.release(slot)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _serial_chunks(load_fn, n_chunks, device, stats, pass_name, staging):
    """Load, copy and yield each chunk in the consumer's thread: on the
    card through the pinned staging buffer of the staging's first slot,
    the copy on the current stream and waited for before the chunk is
    yielded."""
    t_start = time.perf_counter()
    if device.type == "cuda" and staging is None:
        staging = _Staging(device, 1)
    try:
        for k in range(n_chunks):
            t0 = time.perf_counter()
            leaves, is_list = _leaves(load_fn(k))
            if device.type == "cuda":
                pinned, views, _ = staging.buffers(0, leaves)
                _stage(leaves, views)
                dev = [host.to(device, non_blocking=True) for host in pinned]
                copied = torch.cuda.Event()
                copied.record(torch.cuda.current_stream(device))
                copied.synchronize()
            else:
                dev = [_host_tensor(leaf) for leaf in leaves]
            waited = time.perf_counter() - t0
            stats.add(pass_name, bytes_streamed=sum(
                int(getattr(leaf, "nbytes", 0)) for leaf in leaves),
                chunks=1, **{"fill_s" if k == 0 else "stall_s": waited})
            stats.saw_live_buffers(1)
            yield k, dev if is_list else dev[0]
    finally:
        stats.add(pass_name, wall_s=time.perf_counter() - t_start)


def prefetch_chunks(load_fn, n_chunks, device=None, prefetch=True,
                    stats: Optional[StreamStats] = None,
                    pass_name: Optional[str] = None, staging=None):
    """Iterable of ``(k, chunk)`` for every chunk of a stream, on
    ``device`` (``None`` means CUDA).

    With ``prefetch=True`` (default) and more than one chunk, a live
    :class:`ChunkPrefetcher`, whose loader thread starts at once.  With
    ``prefetch=False``, or a single chunk, a lazy generator that loads
    and copies each chunk in the consumer's thread: the baseline the
    stall and overlap numbers are measured against.  ``staging``: the
    buffers of an earlier stream to reuse on the card.
    """
    device = _card(device)
    stats = stats if stats is not None else StreamStats()
    if prefetch and n_chunks > 1:
        return ChunkPrefetcher(load_fn, n_chunks, device=device, stats=stats,
                               pass_name=pass_name, staging=staging)
    return _serial_chunks(load_fn, n_chunks, device, stats, pass_name,
                          staging)
