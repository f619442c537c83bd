"""Multi-process bootstrap (port of
:mod:`multigrad_tpu.parallel.distributed`).

The port runs one process per shard, as the original MPI multigrad did.
A launcher (``torchrun``, a batch system) starts the processes and gives
each its place in the environment: ``MASTER_ADDR`` and ``MASTER_PORT``
(where rank 0 listens), ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (the
card of this process on its node).  Every process then calls
:func:`initialize` before its first collective::

    from multigrad_tpu_torch.parallel import distributed
    distributed.initialize()        # NCCL, this process on its card
    comm = multigrad_tpu_torch.global_comm()

It binds the process to card ``LOCAL_RANK`` and brings the default
process group up over ``torch.distributed.init_process_group``: NCCL
for the card, gloo with ``device="cpu"``.  Without a launcher or
arguments it is a single process and brings nothing up.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.util import resolve_device

_initialized = False


def _is_already_initialized_error(e: BaseException) -> bool:
    """Classify a bootstrap ``RuntimeError``.

    True only for the benign "the group is already up" family ("already
    initialized", "can only be called once", ...), which is safe to
    swallow (an idempotent re-init).  Everything else (an unreachable
    master, a timeout, a failed bootstrap) must re-raise: a silent
    single process would fit a fraction of the data with no error.  A
    bare "already" is not enough: "address already in use" (a stale
    process holding the master's port) is a failed bootstrap.
    """
    msg = str(e).lower()
    return ("already initialized" in msg
            or "already been called" in msg
            or "already been initialized" in msg
            or ("initialize" in msg and "once" in msg))


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value is None else int(value)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device=None,
               **kwargs) -> None:
    """Bring up the default process group (idempotent).

    ``coordinator_address`` (``"host:port"`` of rank 0), ``num_processes``
    and ``process_id`` default to the launcher's ``MASTER_ADDR`` /
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.  With none of them
    given or set, the run is a single process and nothing is brought up.
    The backend is NCCL for the card (``device=None`` means CUDA), after
    ``torch.cuda.set_device(LOCAL_RANK)`` (``rank % device_count`` without
    ``LOCAL_RANK``), and gloo for ``device="cpu"``.

    A second call, or a group the launcher brought up already, is a
    no-op.  A failed bootstrap (an unreachable master, a timeout, an
    address already in use) raises and never degrades to a single
    process; a missing rendezvous (``init_process_group``'s
    ``ValueError``) is a single process, as in the JAX package.  Other
    keyword arguments (e.g. ``timeout``) pass through to
    ``torch.distributed.init_process_group``.
    """
    global _initialized
    if _initialized:
        return
    if dist.is_available() and dist.is_initialized():
        _initialized = True   # brought up by the launcher
        return
    address = coordinator_address
    if address is None and "MASTER_ADDR" in os.environ:
        address = (f"{os.environ['MASTER_ADDR']}:"
                   f"{os.environ.get('MASTER_PORT', '29500')}")
    rank = process_id if process_id is not None else _env_int("RANK")
    world = num_processes if num_processes is not None \
        else _env_int("WORLD_SIZE")
    if address is None and rank is None and world is None:
        _initialized = True   # no launcher and no arguments
        return
    backend = "gloo" if resolve_device(device).type == "cpu" else "nccl"
    if backend == "nccl":
        local = _env_int("LOCAL_RANK")
        if local is None:
            local = (rank or 0) % torch.cuda.device_count()
        torch.cuda.set_device(local)
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://{address}" if address else "env://",
            rank=-1 if rank is None else rank,
            world_size=-1 if world is None else world, **kwargs)
        _initialized = True
    except RuntimeError as e:
        if not _is_already_initialized_error(e):
            raise
        _initialized = True
    except ValueError:
        # No rendezvous to join: a single process.
        _initialized = True


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def process_count() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() \
        if dist.is_available() and dist.is_initialized() else 1


def is_main_process() -> bool:
    """True on the process that should print and plot (rank 0)."""
    return process_index() == 0
