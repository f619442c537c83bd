"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ctypes at first use.
The library goes to ``build/multigrad_tpu_torch/`` beside the package (or
the directory :func:`set_build_dir` names: the serving layer's compile
cache), under a name that carries the hash of the source, the shared
headers and the flags, so an edited source is rebuilt.  :func:`build`
starts one ``nvcc`` per source that needs it, all at once, and reports
each library to the kernel-build observers of
:func:`~multigrad_tpu_torch.utils.util.add_compile_observer`.

The wrappers share one call path, kept short because at the history
model's 1e6-particle launches a call's host time is of the order of the
kernel's device time: :func:`load` returns a loaded library without a
lock, :func:`stream` the raw handle of the current stream,
:func:`workspace` the SM count, that handle and the stream's scratch of
the one-launch kernels (one dictionary lookup), and :func:`call` makes
one ctypes call, with the tensor's device made current only when it is
not.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import NamedTuple

import torch

from ..utils.util import _notify_compile

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: Every kernel source of the port, one shared library each.
SOURCES = ("erf_counts.cu", "fused_counts.cu", "hist_history.cu",
           "pair_counts.cu")
#: Where the shared libraries are built by default:
#: ``build/multigrad_tpu_torch/`` beside the package.
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "multigrad_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_THREADS = 256  # = erfk::kThreads (csrc/erf_common.cuh)

#: Floats of each stream's partials buffer (16 MB): the blocks' partial
#: rows of the one-launch kernels, (grid, columns).
PARTIALS = 1 << 22
#: Items a block of a one-launch kernel takes at least, and blocks an SM
#: it runs at most (see :func:`one_launch_grid`).
PER_BLOCK = 4096
MAX_BLOCKS_PER_SM = 16
#: The workspace's ticket counters, one a kernel (an index into
#: :attr:`Workspace.counters`).
ERF_FWD, ERF_BWD, FUSED_FWD, FUSED_BWD, HIST_BWD = range(5)

_LIBS: dict = {}
_LOCK = threading.Lock()
_build_dir = BUILD_DIR
# (device index, stream) -> Workspace.
_WORKSPACES: dict = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" \
        / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the kernels are built from "
                       f"{CSRC} at first use")


def sources_digest() -> str:
    """The hash of every kernel source, the shared headers and the flags
    (16 hex digits): what identifies the kernels a build runs."""
    digest = hashlib.sha256()
    for path in [CSRC / s for s in SOURCES] + sorted(CSRC.glob("*.cuh")):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def build_dir() -> Path:
    """The directory the kernel libraries are built into and loaded
    from (process-wide)."""
    return _build_dir


def set_build_dir(path) -> Path:
    """Make ``path`` the directory the kernel libraries are built into
    and loaded from, for every later :func:`build` and :func:`load` of
    this process (libraries already loaded stay loaded); returns it."""
    global _build_dir
    _build_dir = Path(path).resolve()
    return _build_dir


def library_path(source: str) -> Path:
    """Where the library of ``csrc/<source>`` is (or will be) built."""
    digest = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return _build_dir / f"lib{Path(source).stem}_{digest.hexdigest()[:16]}.so"


def build(sources=SOURCES):
    """Compile each of ``sources`` (names under ``csrc/``) unless a library
    built from the same inputs exists, one ``nvcc`` each, in parallel;
    return the libraries' paths."""
    paths = [library_path(s) for s in sources]
    todo = [(s, p) for s, p in zip(sources, paths) if not p.exists()]
    for source, path in zip(sources, paths):
        if (source, path) not in todo:
            _notify_compile(source, 0.0, True)
    if not todo:
        return paths
    out_dir = paths[0].parent
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    t0 = time.perf_counter()
    try:
        for source, lib in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((source, lib, tmp, proc))
        failed = []
        for source, lib, tmp, proc in jobs:
            out = proc.communicate()[0]
            if proc.returncode == 0:
                os.replace(tmp, lib)
                _notify_compile(source, time.perf_counter() - t0, False)
            else:
                failed.append(f"nvcc failed on {CSRC / source}:\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return paths


def load(source: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built at first use, with
    ``signatures`` (``{name: argtypes}``, each returning a C int) set on
    its functions."""
    lib = _LIBS.get(source)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            # lock-ok: blocking-under-lock the lock exists to make one build of each library: a thread that needs a library must wait for its nvcc either way, no other lock is taken under it, and the path is taken once a source per process (load() returns loaded libraries without the lock)
            lib = ctypes.CDLL(str(build((source,))[0]))
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIBS[source] = lib
        return lib


class Workspace(NamedTuple):
    """What a launch on one stream needs besides its tensors."""
    sms: int            # the device's multiprocessors
    stream: int         # the raw handle of the stream
    counters: int       # pointer to the ticket counters, int32 (5,)
    partials: int       # pointer to the partials buffer, float32
    tensors: tuple      # the two buffers, kept alive

    def counter(self, kernel: int) -> int:
        """Pointer to the ticket counter of ``kernel`` (``ERF_FWD``, ...)."""
        return self.counters + 4 * kernel


def stream(device) -> int:
    """The raw handle of the current CUDA stream on ``device``."""
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if get is not None:
        return get(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def workspace(device) -> Workspace:
    """The :class:`Workspace` of the current stream on ``device``: the
    ticket counters (zeroed once here; the last block of every launch puts
    its counter back to 0) and the partials buffer (``PARTIALS`` floats)
    of the one-launch kernels.  Launches on one stream run in order, so
    they share its workspace."""
    key = (device.index, stream(device))
    ws = _WORKSPACES.get(key)
    if ws is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        counters = torch.zeros(HIST_BWD + 1, dtype=torch.int32,
                               device=device)
        partials = torch.empty(PARTIALS, dtype=torch.float32, device=device)
        ws = _WORKSPACES[key] = Workspace(
            sms, key[1], counters.data_ptr(), partials.data_ptr(),
            (counters, partials))
    return ws


def call(device, fn, *args) -> int:
    """``fn(*args)`` (a C launcher) with ``device`` the current device, as
    a launch on one of its streams needs; the C function's return code."""
    if torch.cuda.current_device() == device.index:
        return fn(*args)
    with torch.cuda.device(device):
        return fn(*args)


def one_launch_grid(n: int, sms: int, cols: int) -> int:
    """Blocks of a one-launch kernel (a grid-stride loop over ``n`` items
    whose every block writes a row of ``cols`` partials for the last block
    to add up) on ``sms`` SMs: one per ``PER_BLOCK`` items, rounded up to
    the same number of blocks on every SM (a grid that is not a multiple
    of the SM count leaves some SMs a block more to run), at most
    ``MAX_BLOCKS_PER_SM`` an SM, and at most the rows ``PARTIALS`` holds.
    The grid of the dense and the fused erf kernels
    (``erf_kernels.erf_grid``, ``fused_kernels.fused_grid``), measured on
    an H100 by ``tools/erf_kernels_ab.py``'s and
    ``tools/fused_kernels_ab.py``'s sweeps (``PERF.md`` §6)."""
    per_sm = min(-(-n // (PER_BLOCK * sms)), MAX_BLOCKS_PER_SM)
    return max(1, min(sms * per_sm, PARTIALS // cols))


def row_blocks(n: int) -> int:
    """Blocks for one thread per item: ``ceil(n / _THREADS)``, at least
    one."""
    return max(1, -(-n // _THREADS))


def raise_on(code: int, name: str):
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code}")
