"""Streaming data: out-of-core catalogs with exact gradients (port of
:mod:`multigrad_tpu.data`).

Additive sumstats make the data-parallel algebra sliceable in time as
well as in space: :class:`StreamingOnePointModel` streams a catalog of
any length through the card in fixed-size chunks, through a
double-buffered host→device prefetcher (pinned staging memory and a copy
stream of its own), and reproduces the resident model's loss and
gradient (two passes over the chunks) or runs the chain rule over a
resident chunk stack with per-chunk remat (the scan path).

* :mod:`.source`: :class:`CatalogSource` backends (in memory, ``.npz``,
  ``np.memmap``) and the deterministic :class:`ChunkPlan`.
* :mod:`.prefetch`: :class:`ChunkPrefetcher`, the double-buffered
  background loader (at most 2 device chunk buffers, stall accounting).
* :mod:`.streaming`: :class:`StreamingOnePointModel`, the two-pass and
  scan paths and :meth:`~StreamingOnePointModel.run_adam`.
"""
from .source import (ArraySource, CatalogSource, ChunkPlan,  # noqa: F401
                     ChunkSpec, MemmapSource, NpzSource, as_source,
                     plan_chunks)
from .prefetch import ChunkPrefetcher, prefetch_chunks  # noqa: F401
from .streaming import StreamingOnePointModel  # noqa: F401

__all__ = [
    "CatalogSource", "ArraySource", "NpzSource", "MemmapSource",
    "ChunkSpec", "ChunkPlan", "plan_chunks", "as_source",
    "ChunkPrefetcher", "prefetch_chunks", "StreamingOnePointModel",
]
