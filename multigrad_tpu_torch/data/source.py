"""Catalog sources and the deterministic chunk plan (port of
:mod:`multigrad_tpu.data.source`; the port keeps its own copy).

Additive sumstats make a catalog larger than the card streamable: its
rows reach the card in fixed-size chunks and the totals and gradients
stay exact (:mod:`multigrad_tpu_torch.data.streaming`).  This module has
the two host-side pieces:

* :class:`CatalogSource`: where catalog rows come from.  In-memory
  arrays (:class:`ArraySource`), ``.npz`` archives (:class:`NpzSource`,
  loaded lazily) and ``np.memmap``/``.npy`` files (:class:`MemmapSource`,
  the out-of-core path: a chunk touches only its own pages).
* :class:`ChunkPlan`: the chunk geometry.  Every chunk has the same
  padded shape ``(rows_per_chunk, ...)``, and ``rows_per_chunk`` is a
  multiple of the number of shards, so shard ``s`` of chunk ``k`` holds
  the global rows ``[k·R + s·R/S, k·R + (s+1)·R/S)``.  With one process
  per shard, each process reads only those rows (:func:`_shard_span`).
  The ragged final chunk is padded with the caller's neutral
  ``pad_value`` (``inf`` log-mass for the erf counts: exactly zero
  contribution forward and backward), the convention of
  :func:`~multigrad_tpu_torch.parallel.collectives.scatter_nd`.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["CatalogSource", "ArraySource", "NpzSource", "MemmapSource",
           "ChunkSpec", "ChunkPlan", "plan_chunks", "as_source"]


@dataclass(frozen=True)
class ChunkSpec:
    """One chunk's global row range ``[start, stop)`` plus the rows of
    neutral padding appended to reach the plan's uniform chunk shape."""

    index: int
    start: int
    stop: int
    pad: int

    @property
    def rows(self) -> int:
        """Real (unpadded) rows in this chunk."""
        return self.stop - self.start


@dataclass(frozen=True)
class ChunkPlan:
    """Chunk geometry for an ``n_rows``-row catalog streamed over
    ``n_shards`` shards: every chunk spans ``rows_per_chunk = shard_rows
    * n_shards`` global rows, the final one padded up to it."""

    n_rows: int
    n_shards: int
    shard_rows: int
    chunks: Tuple[ChunkSpec, ...]

    @property
    def rows_per_chunk(self) -> int:
        return self.shard_rows * self.n_shards

    @property
    def n_chunks(self) -> int:
        return len(self.chunks)

    @property
    def pad_rows(self) -> int:
        """Total padding rows (all in the final chunk)."""
        return self.chunks[-1].pad if self.chunks else 0


def plan_chunks(n_rows: int, chunk_rows: int, n_shards: int = 1
                ) -> ChunkPlan:
    """Plan a stream of ``n_rows`` catalog rows in ``chunk_rows``-row
    chunks over ``n_shards`` shards.

    ``chunk_rows`` is the *global* chunk size (rows per chunk summed over
    all shards), rounded up to the next multiple of ``n_shards`` so every
    shard receives equal rows per chunk.  Any ``n_rows >= 1`` works; the
    final chunk records how many padding rows its loader must append.
    """
    if n_rows < 1:
        raise ValueError(f"n_rows must be >= 1, got {n_rows}")
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    rows_per_chunk = -(-chunk_rows // n_shards) * n_shards
    n_chunks = -(-n_rows // rows_per_chunk)
    chunks = []
    for k in range(n_chunks):
        start = k * rows_per_chunk
        stop = min(n_rows, start + rows_per_chunk)
        chunks.append(ChunkSpec(index=k, start=start, stop=stop,
                                pad=rows_per_chunk - (stop - start)))
    return ChunkPlan(n_rows=n_rows, n_shards=n_shards,
                     shard_rows=rows_per_chunk // n_shards,
                     chunks=tuple(chunks))


def _shard_span(plan: ChunkPlan, k: int, shard: int) -> ChunkSpec:
    """The rows of shard ``shard`` in chunk ``k``: global rows
    ``[k·R + s·R/S, k·R + (s+1)·R/S)`` clipped to the catalog, with the
    padding that brings them to ``plan.shard_rows``."""
    lo = plan.chunks[k].start + shard * plan.shard_rows
    start = min(lo, plan.n_rows)
    stop = min(lo + plan.shard_rows, plan.n_rows)
    return ChunkSpec(index=k, start=start, stop=stop,
                     pad=plan.shard_rows - (stop - start))


class _ChunkRows:
    """A chunk's rows, a view into the source where it allows one, and
    the padding to append.  ``np.asarray`` gives the padded chunk;
    :meth:`copy_into` writes it into a buffer of that shape (pinned
    staging memory, say) and pads there, in place, with no other copy."""

    __slots__ = ("rows", "pad", "pad_value")

    def __init__(self, rows: np.ndarray, pad: int, pad_value):
        self.rows, self.pad, self.pad_value = rows, pad, pad_value

    @property
    def shape(self) -> tuple:
        return (self.rows.shape[0] + self.pad,) + tuple(self.rows.shape[1:])

    @property
    def dtype(self):
        return self.rows.dtype

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * self.rows.dtype.itemsize

    def copy_into(self, out: np.ndarray) -> np.ndarray:
        n = self.rows.shape[0]
        np.copyto(out[:n], self.rows)
        if self.pad:
            out[n:] = self.pad_value
        return out

    def __array__(self, dtype=None, copy=None):
        out = self.copy_into(np.empty(self.shape, self.rows.dtype))
        return out if dtype is None else out.astype(dtype, copy=False)


class CatalogSource:
    """A host-side row source for streaming catalogs.

    Subclasses implement ``n_rows`` and :meth:`read` (and may override
    :meth:`_view`); chunk planning and padded chunk loading are shared.
    Rows are indexed along axis 0; trailing axes ride along unchanged.
    """

    @property
    def n_rows(self) -> int:
        raise NotImplementedError

    def read(self, start: int, stop: int) -> np.ndarray:
        """Rows ``[start, stop)`` as a host numpy array."""
        raise NotImplementedError

    def _view(self, start: int, stop: int) -> np.ndarray:
        """Rows ``[start, stop)`` without a copy where the backend allows
        one (an array slice, a memmap slice); :meth:`read` otherwise."""
        return self.read(start, stop)

    def __len__(self) -> int:
        return self.n_rows

    def plan(self, chunk_rows: int, n_shards: int = 1) -> ChunkPlan:
        return plan_chunks(self.n_rows, chunk_rows, n_shards)

    def _chunk_rows(self, spec: ChunkSpec, pad_value=np.inf) -> _ChunkRows:
        """The rows of ``spec`` (a chunk, or a shard of one from
        :func:`_shard_span`) and its padding, not yet copied."""
        return _ChunkRows(self._view(spec.start, spec.stop), spec.pad,
                          pad_value)

    def load_chunk(self, spec: ChunkSpec, pad_value=np.inf) -> np.ndarray:
        """Load one planned chunk, padded to the plan's uniform shape.

        ``pad_value`` must be neutral for the model's sumstats, the same
        contract as ``scatter_nd(pad_value=...)``: ``inf`` is right for
        erf-CDF counts and is the conventional choice here.
        """
        rows = np.asarray(self.read(spec.start, spec.stop))
        if spec.pad:
            pad_width = [(0, spec.pad)] + [(0, 0)] * (rows.ndim - 1)
            rows = np.pad(rows, pad_width, constant_values=pad_value)
        return rows


class ArraySource(CatalogSource):
    """In-memory catalog: wraps an array already resident on the host."""

    def __init__(self, array):
        self._array = np.asarray(array)

    @property
    def n_rows(self) -> int:
        return self._array.shape[0]

    def read(self, start: int, stop: int) -> np.ndarray:
        return self._array[start:stop]


def _npz_member_shape(archive, field) -> tuple:
    """Shape of one npz member from its ``.npy`` header alone.

    ``archive[field].shape`` would decompress the whole member; the shape
    is in the member's uncompressed header, so read that.  Falls back to
    the full read if the header walk meets an unexpected layout.
    """
    try:
        with archive.zip.open(field + ".npy") as f:
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, _, _ = np.lib.format.read_array_header_1_0(f)
            elif version == (2, 0):
                shape, _, _ = np.lib.format.read_array_header_2_0(f)
            else:
                raise ValueError(f"npy format {version}")
        return shape
    except (AttributeError, KeyError, OSError, ValueError):
        # A nonstandard writer: no `.zip` handle (AttributeError), a
        # member not stored as `<field>.npy` (KeyError), a header layout
        # the walk does not know (ValueError) or a short read (OSError).
        # The full read is the authoritative answer for all of them.
        return archive[field].shape


class NpzSource(CatalogSource):
    """One array of an ``.npz`` archive, loaded lazily.

    ``np.load`` decompresses the named field once, on first access, and
    keeps it (npz is zip-compressed, so it cannot be memory-mapped).  For
    catalogs that must never be host-resident in full, use
    :class:`MemmapSource`.
    """

    def __init__(self, path: str, field: str):
        self.path = path
        self.field = field
        self._array: Optional[np.ndarray] = None
        with np.load(path) as archive:  # validate early, load lazily
            if field not in archive.files:
                raise KeyError(
                    f"field {field!r} not in {path!r} "
                    f"(has {archive.files})")
            self._shape = _npz_member_shape(archive, field)

    def _load(self) -> np.ndarray:
        if self._array is None:
            with np.load(self.path) as archive:
                self._array = archive[self.field]
        return self._array

    @property
    def n_rows(self) -> int:
        return self._shape[0]

    def read(self, start: int, stop: int) -> np.ndarray:
        return self._load()[start:stop]


class MemmapSource(CatalogSource):
    """Out-of-core catalog backed by ``np.memmap``.

    ``.npy`` files open with ``np.load(mmap_mode="r")`` (shape and dtype
    from the header); raw binary files need explicit ``dtype`` and
    ``shape``.  Reading a chunk copies just that chunk's rows off disk,
    so host memory stays O(chunk).
    """

    def __init__(self, path: str, dtype=None, shape: Optional[Sequence[int]]
                 = None, offset: int = 0):
        self.path = path
        if os.path.splitext(path)[1] == ".npy":
            self._mm = np.load(path, mmap_mode="r")
        else:
            if dtype is None or shape is None:
                raise ValueError(
                    "raw memmap needs explicit dtype= and shape= "
                    "(a .npy file carries them in its header)")
            self._mm = np.memmap(path, dtype=dtype, mode="r",
                                 shape=tuple(shape), offset=offset)

    @property
    def n_rows(self) -> int:
        return self._mm.shape[0]

    def read(self, start: int, stop: int) -> np.ndarray:
        # A copy out of the mapping: plain host memory, and page-cache
        # pressure bounded by the chunk.
        return np.array(self._mm[start:stop])

    def _view(self, start: int, stop: int) -> np.ndarray:
        # The mapping itself: a copy into staging memory reads the pages
        # once, with no intermediate array.
        return self._mm[start:stop]


def as_source(obj) -> CatalogSource:
    """Coerce ``obj`` into a :class:`CatalogSource`.

    Accepts an existing source (returned as is), an array-like (wrapped
    in :class:`ArraySource`) or a path string: ``.npy`` maps to
    :class:`MemmapSource`; ``.npz`` paths need a field name, so construct
    :class:`NpzSource` explicitly.
    """
    if isinstance(obj, CatalogSource):
        return obj
    if isinstance(obj, str):
        ext = os.path.splitext(obj)[1]
        if ext == ".npy":
            return MemmapSource(obj)
        raise ValueError(
            f"cannot infer a source from path {obj!r}; use "
            "NpzSource(path, field) or MemmapSource(path, dtype, shape)")
    return ArraySource(obj)
