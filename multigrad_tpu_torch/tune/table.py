"""On-disk tuning table: persisted autotuner decisions, shared like the
kernel libraries (port of :mod:`multigrad_tpu.tune.table`).

The persistence half of the autotuner (:mod:`.tuner` writes,
:mod:`.resolve` reads): one JSON file mapping **tuning keys** —
``(kind, model class, catalog-shape bucket, backend, device kind)``
flattened to a string — to the winning knob set plus provenance (the
static prediction, the measured confirmation, trial counts, versions).
The format and the key are the JAX package's, so a table written by
either package reads in the other where the tags match.

The default location is **beside the kernel-library directory**
(``<ops.cuda_build.build_dir()>.tuning.json``), the port's compile cache:
both are a warm start for a fresh process, and the workers of a
:class:`~multigrad_tpu_torch.serve.FleetRouter`, which share the
router's library directory, share the table.  Override with the
``MGT_TUNING_TABLE`` environment variable or an explicit path.

Tags come from the device the model's tensors live on: the backend is
``"cuda"`` or ``"cpu"``, the device kind the card's name
(``torch.cuda.get_device_name``) or ``"cpu"``, normalized by
:func:`device_kind_tag`.

Shape bucketing: catalog sizes are keyed by ``round(log2(rows))``, rows
**per process** (the shard each process holds: the same denominator the
static cost model uses), and binned-kernel keys carry the edge count
and the derived fused window, because the window-to-grid ratio is what
can flip the fused-vs-dense verdict.

Concurrency: writes are read-merge-replace under an ``flock`` with an
atomic ``os.replace`` — two processes tuning different keys both land;
two racing the *same* key keep one winner.  Reads re-load on mtime
change, so a long-lived serving process sees entries a tuner adds later.
"""
from __future__ import annotations

import json
import math
import os
import tempfile
import time
from typing import Optional

import torch

__all__ = ["TuningTable", "default_table_path", "make_key",
           "rows_bucket", "model_shape_key", "catalog_rows",
           "device_kind_tag", "TABLE_VERSION"]

TABLE_VERSION = 1

#: Environment override for the default table location (tests set it to
#: keep themselves hermetic; fleets set it to a shared volume).
ENV_TABLE = "MGT_TUNING_TABLE"


def default_table_path() -> str:
    """The table's default home: beside the kernel-library directory
    (``<build_dir>.tuning.json``, :func:`~multigrad_tpu_torch.ops
    .cuda_build.build_dir`).  ``MGT_TUNING_TABLE`` overrides it."""
    env = os.environ.get(ENV_TABLE)
    if env:
        return env
    from ..ops.cuda_build import build_dir
    return str(build_dir()).rstrip("/\\") + ".tuning.json"


def rows_bucket(n_rows: int) -> int:
    """Catalog-shape bucket of a row count: ``round(log2(rows))``."""
    return int(round(math.log2(max(int(n_rows), 1))))


def device_kind_tag(device_kind: Optional[str] = None) -> str:
    """Normalized device-kind tag (default: CUDA device 0's name when a
    card is present, else ``"cpu"``), safe to embed in a key string."""
    if device_kind is None:
        device_kind = torch.cuda.get_device_name(0) \
            if torch.cuda.is_available() else "cpu"
    return str(device_kind).strip().lower().replace(" ", "_")


def _backend_tag(backend: Optional[str] = None) -> str:
    if backend is None:
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    return str(backend)


def device_tags(device) -> tuple:
    """``(backend, device_kind)`` of a ``torch.device``: ``("cuda", the
    card's name)`` or ``("cpu", "cpu")``."""
    device = torch.device(device)
    if device.type == "cuda":
        return "cuda", torch.cuda.get_device_name(device)
    return "cpu", "cpu"


def make_key(kind: str, model: str, shape: str,
             backend: Optional[str] = None,
             device_kind: Optional[str] = None) -> str:
    """Flatten key components to the table's string key form:
    ``kind|model|shape|backend|device_kind``."""
    return "|".join((kind, model, shape, _backend_tag(backend),
                     device_kind_tag(device_kind)))


def catalog_rows(aux_data, comm=None) -> int:
    """Per-process catalog rows of a model's aux tree: the largest leading
    dimension among its tensor and array leaves.  A process of the port
    holds only its shard (``make_smf_data`` with a comm), so its rows are
    already per shard: ``comm`` is accepted for the JAX package's
    signature and not divided by again.  Only shapes are read."""
    del comm
    from ..utils.util import tree_leaves
    rows = 0
    for leaf in tree_leaves(aux_data):
        shape = getattr(leaf, "shape", None)
        if shape:
            rows = max(rows, int(shape[0]))
    return rows


def model_shape_key(n_rows: int, n_edges: Optional[int] = None,
                    bin_window: Optional[int] = None) -> str:
    """Catalog-shape bucket string for model-knob keys: ``rows2^B``
    always; ``|e{E}|w{W}`` when the model runs the binned kernels (the
    window, derived from the fit's ``sigma_max``, is the sigma-regime
    discriminator)."""
    shape = f"rows2^{rows_bucket(n_rows)}"
    if n_edges is not None:
        shape += f"|e{int(n_edges)}"
        shape += f"|w{int(bin_window)}" if bin_window else "|w0"
    return shape


class TuningTable:
    """One on-disk tuning table (see the module docstring).

    Parameters
    ----------
    path : str, optional
        Table file.  Default: :func:`default_table_path` — beside the
        kernel-library directory, shared by every process that shares it.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = os.path.abspath(path or default_table_path())
        self._entries: dict = {}
        self._mtime: Optional[float] = None

    def _load(self) -> dict:
        try:
            mtime = os.path.getmtime(self.path)
        except OSError:
            self._entries, self._mtime = {}, None
            return self._entries
        if mtime != self._mtime:
            try:
                with open(self.path) as f:
                    raw = json.load(f)
                entries = raw.get("entries", {})
                self._entries = entries if isinstance(entries, dict) \
                    else {}
            except (OSError, ValueError):
                # A torn table is a cache miss, never a crash: the tuner
                # measures again and the next write repairs it.
                self._entries = {}
            self._mtime = mtime
        return self._entries

    def entries(self) -> dict:
        """All entries, freshly loaded (re-read on mtime change)."""
        return dict(self._load())

    def lookup(self, key: str) -> Optional[dict]:
        """The entry for ``key``, or ``None`` (a miss resolves to the
        hand-set default: a lookup never fails a model build)."""
        try:
            return self._load().get(key)
        except Exception:
            return None

    def record(self, key: str, knobs: dict, **meta) -> dict:
        """Persist a winning knob set under ``key`` (read-merge-replace
        under a lock, atomic).  ``meta`` carries provenance
        (``predicted_s``, ``measured_s``, ``baseline_s``, ``trials``,
        ...).  Returns the stored entry."""
        entry = {"knobs": dict(knobs), "created": time.time(),
                 "table_version": TABLE_VERSION}
        entry.update(meta)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        # Without the lock, two processes tuning different keys could
        # load the same base state and the second replace would drop the
        # first one's entry.
        lock_fd = None
        try:
            import fcntl
            lock_fd = os.open(self.path + ".lock",
                              os.O_CREAT | os.O_RDWR, 0o644)
            fcntl.flock(lock_fd, fcntl.LOCK_EX)
        except Exception:       # no fcntl / unlockable fs: best-effort
            if lock_fd is not None:
                os.close(lock_fd)
                lock_fd = None
        try:
            self._mtime = None
            merged = dict(self._load())
            merged[key] = entry
            payload = {"table_version": TABLE_VERSION, "entries": merged}
            fd, tmp = tempfile.mkstemp(
                prefix=os.path.basename(self.path) + ".",
                dir=os.path.dirname(self.path) or ".")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(payload, f, indent=1, sort_keys=True)
                os.replace(tmp, self.path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        finally:
            if lock_fd is not None:
                os.close(lock_fd)       # releases the flock
        self._entries, self._mtime = merged, None
        return entry

    def __len__(self):
        return len(self._load())

    def __repr__(self):
        return f"TuningTable({self.path!r}, {len(self)} entries)"

