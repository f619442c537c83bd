"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ctypes at first use.
The library goes to ``build/multigrad_tpu_torch/`` beside the package,
under a name that carries the hash of the source, the shared headers and
the flags, so an edited source is rebuilt.  :func:`build` starts one
``nvcc`` per source that needs it, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: Every kernel source of the port, one shared library each.
SOURCES = ("erf_counts.cu", "fused_masses.cu")
#: Where the shared libraries are built: ``build/multigrad_tpu_torch/``
#: beside the package.
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "multigrad_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_THREADS = 256  # = erfk::kThreads (csrc/erf_common.cuh)
_BLOCKS_PER_SM = 8

_LIBS: dict = {}
_LOCK = threading.Lock()


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


def library_path(source: str) -> Path:
    """Where the library of ``csrc/<source>`` is (or will be) built."""
    digest = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(source).stem}_{digest.hexdigest()[:16]}.so"


def build(sources=SOURCES):
    """Compile each of ``sources`` (names under ``csrc/``) unless a library
    built from the same inputs exists, one ``nvcc`` each, in parallel;
    return the libraries' paths."""
    paths = [library_path(s) for s in sources]
    todo = [(s, p) for s, p in zip(sources, paths) if not p.exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    try:
        for source, lib in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
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
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build((source,))[0]))
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIBS[source] = lib
        return lib


def grid(n: int, device) -> int:
    """Blocks for a grid-stride loop over ``n`` items: one per
    ``_THREADS`` items, capped at ``_BLOCKS_PER_SM`` resident blocks on
    every SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-n // _THREADS), sms * _BLOCKS_PER_SM))


def raise_on(code: int, name: str):
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code}")
