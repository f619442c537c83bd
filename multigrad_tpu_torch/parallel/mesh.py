"""Communicator over ``torch.distributed`` (port of
:mod:`multigrad_tpu.parallel.mesh`).

The JAX package runs one controller over a device mesh.  The port runs
one process per shard, as the original MPI multigrad did: each process
holds its own shard of the data, computes its partial sumstats, and
all-reduces the O(|sumstats| + |params|) results.  When
``torch.distributed`` is not initialised the comm is the single-process
identity.

The caller sets up the process group itself
(``torch.distributed.init_process_group`` with its address, world size
and rank): NCCL for CUDA tensors, gloo for CPU tensors.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


class MeshComm:
    """This process's view of a process group.

    Parameters
    ----------
    group : ProcessGroup, optional
        The group to reduce over; ``None`` is the default (world) group.
    """

    def __init__(self, group: Optional[dist.ProcessGroup] = None):
        self.group = group

    @property
    def distributed(self) -> bool:
        return dist.is_available() and dist.is_initialized()

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group) if self.distributed else 0

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group) if self.distributed else 1

    def __len__(self) -> int:
        return self.size

    def __repr__(self) -> str:
        return f"MeshComm(rank={self.rank}, size={self.size})"

    def psum(self, value: torch.Tensor) -> torch.Tensor:
        """Sum of ``value`` over the group, on every process (a new
        tensor; the input is left as it was)."""
        if self.size == 1:
            return value
        out = value.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out


def global_comm() -> MeshComm:
    """A comm over every process of the default group (the identity when
    ``torch.distributed`` is not initialised)."""
    return MeshComm()
