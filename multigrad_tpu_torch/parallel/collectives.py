"""Collectives (port of :mod:`multigrad_tpu.parallel.collectives`).

=================================  ====================================
reference / JAX package            this module
=================================  ====================================
``reduce_sum`` / ``lax.psum``      ``torch.distributed.all_reduce``
``all_gather``                     ``all_gather_into_tensor`` (NCCL) or
                                   ``all_gather`` (gloo), concatenated
``scatter_nd``                     this process's shard of the array
``scatter_from_local``             this process's own array, shapes
                                   checked across the comm
``lax.ppermute`` (i → i+1 ring)    ``ring_shift`` (``batch_isend_irecv``)
=================================  ====================================
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .mesh import MeshComm
from ..ops.kernel_costs import counting_mode
from ..telemetry.comm import record_collective
from ..utils.util import pad_to_multiple


def psum(value, comm: Optional[MeshComm] = None):
    """Sum ``value`` over ``comm``'s processes; identity for ``None``."""
    return value if comm is None else comm.psum(value)


def _on_comm_device(tensor: torch.Tensor, comm: MeshComm) -> torch.Tensor:
    """``tensor`` where ``comm``'s backend can reduce it: under NCCL,
    which takes only CUDA tensors, a host tensor goes to the current CUDA
    device; otherwise it stays where it is."""
    if (tensor.device.type == "cpu" and comm.distributed
            and dist.get_backend(comm.group) == "nccl"):
        return tensor.to(torch.device("cuda", torch.cuda.current_device()))
    return tensor


def reduce_sum(value, root: Optional[int] = None,
               comm: Optional[MeshComm] = None):
    """Sum each process's contribution ``value`` over ``comm``.

    The result is valid on every process (an all-reduce, a superset of
    the reference's reduce-to-root).  Python scalars come back as
    Python scalars, tensors on the device they came from: under NCCL,
    which reduces only CUDA tensors, a host value goes through the
    current CUDA device.  ``comm=None`` is the single-process identity.
    """
    del root
    if comm is None:
        return value
    is_py_scalar = isinstance(value, (bool, int, float))
    tensor = torch.as_tensor(value)
    home = tensor.device
    out = comm.psum(_on_comm_device(tensor, comm))
    return out.item() if is_py_scalar else out.to(home)


def scatter_nd(array, axis: int = 0, comm: Optional[MeshComm] = None,
               root: int = 0, pad_value=None, return_pad_count: bool = False):
    """This process's shard of ``array`` along ``axis``.

    Shards are equal: a length that ``comm.size`` does not divide is
    padded first with ``pad_value``, which must be neutral for the
    model's statistic (``inf`` log-mass for the erf counts).  Without
    ``pad_value`` a ragged axis raises.  ``comm=None`` returns the array.
    ``root`` is accepted and ignored, as in the JAX package (every
    process takes its own shard).  With ``return_pad_count=True`` the
    return is ``(shard, pad_count)``, ``pad_count`` the number of rows
    appended to the global axis (0 when it divided evenly, and for
    ``comm=None``).
    """
    del root
    array = torch.as_tensor(array)
    if comm is None:
        return (array, 0) if return_pad_count else array
    n = array.shape[axis]
    pad_count = (-n) % comm.size
    if pad_count:
        if pad_value is None:
            raise ValueError(
                f"scatter_nd: axis {axis} of length {n} is not divisible "
                f"by comm.size={comm.size}; pass pad_value= (a "
                f"model-neutral filler) or pad first (see "
                f"utils.pad_to_multiple)")
        array, _ = pad_to_multiple(array, comm.size, axis=axis,
                                   pad_value=pad_value)
    per = array.shape[axis] // comm.size
    shard = array.narrow(axis, comm.rank * per, per).contiguous()
    return (shard, pad_count) if return_pad_count else shard


def all_gather(value, comm: Optional[MeshComm] = None, axis: int = 0):
    """Every process's ``value`` of ``comm``, concatenated along ``axis``
    in rank order, on every process (the reference's ``comm.allgather``).
    The values must have one shape.  A host value under NCCL comes back on
    the card.  The identity for ``comm=None`` or a comm of one process."""
    tensor = torch.as_tensor(value)
    if comm is None or comm.size == 1:
        return tensor
    tensor = _on_comm_device(tensor, comm).contiguous()
    record_collective("all_gather", tensor)
    if tensor.is_meta:              # the static cost model: counted only
        counting_mode("all_gather")
        return torch.cat([torch.empty_like(tensor)] * comm.size, dim=axis)
    if dist.get_backend(comm.group) == "nccl":
        stacked = torch.empty((comm.size,) + tuple(tensor.shape),
                              dtype=tensor.dtype, device=tensor.device)
        dist.all_gather_into_tensor(stacked, tensor, group=comm.group)
        parts = list(stacked.unbind(0))
    else:
        parts = [torch.empty_like(tensor) for _ in range(comm.size)]
        dist.all_gather(parts, tensor, group=comm.group)
    return torch.cat([p.reshape(tensor.shape) for p in parts], dim=axis)


#: Largest number of dimensions whose shapes ``scatter_from_local`` checks.
_MAX_DIMS = 16


def scatter_from_local(local_array, comm: MeshComm, axis: int = 0):
    """This process's shard of an array sharded along ``axis`` over
    ``comm``, from the data this process loaded itself.

    With one process per shard, a process's local array *is* its shard:
    the reference's per-rank loading (``smf_grad_descent.py:23-28``),
    where no process holds the whole catalog.  The array comes back as a
    tensor (on the card under NCCL).  One all-gather of the shapes checks
    that every process's array has the same number of dimensions and the
    same shape off ``axis``; a mismatch raises ``ValueError`` on every
    process.
    """
    local = torch.as_tensor(local_array)
    if comm is None or comm.size == 1:
        return local
    local = _on_comm_device(local, comm)
    if local.dim() > _MAX_DIMS:
        raise ValueError(f"scatter_from_local: {local.dim()} dimensions, "
                         f"at most {_MAX_DIMS}")
    off_axis = list(local.shape)
    if off_axis:
        off_axis[axis] = 0
    row = torch.zeros((1, 1 + _MAX_DIMS), dtype=torch.int64)
    row[0, 0] = local.dim()
    row[0, 1:1 + len(off_axis)] = torch.tensor(off_axis, dtype=torch.int64)
    shapes = all_gather(row, comm).cpu()
    if not bool((shapes == shapes[0]).all()):
        got = [tuple(r[1:1 + int(r[0])].tolist()) for r in shapes]
        raise ValueError(
            f"scatter_from_local: the local arrays differ off axis {axis} "
            f"(shapes with axis {axis} set to 0, by rank: {got})")
    return local


def _ring_pass(tensor, comm: MeshComm, shift: int):
    """``tensor`` sent to rank ``rank + shift`` of the comm, and the one of
    rank ``rank - shift`` received, both at once (a blocking send before
    the receive would deadlock the ring)."""
    rank, size = comm.rank, comm.size

    def peer(r):
        r %= size
        if comm.group is None:
            return r
        return dist.get_global_rank(comm.group, r)

    out = torch.empty_like(tensor)
    record_collective("ppermute", tensor)
    if tensor.is_meta:              # the static cost model: counted only
        counting_mode("ring_shift")
        return out
    ops = [dist.P2POp(dist.isend, tensor.contiguous(), peer(rank + shift),
                      comm.group),
           dist.P2POp(dist.irecv, out, peer(rank - shift), comm.group)]
    for request in dist.batch_isend_irecv(ops):
        request.wait()
    return out


class _RingShift(torch.autograd.Function):
    """Forward: receive the block of rank − 1, send ours to rank + 1.
    Backward: the reverse ring (``ppermute``'s transpose), which carries
    each visiting block's cotangent back to the rank it came from."""

    @staticmethod
    def forward(ctx, tensor, comm):
        ctx.comm = comm
        return _ring_pass(tensor.detach(), comm, 1)

    @staticmethod
    def backward(ctx, g):
        return _ring_pass(g, ctx.comm, -1), None


def ring_shift(tensor, comm: Optional[MeshComm] = None):
    """This process's neighbour's ``tensor`` one step around the ring: rank
    ``r`` receives the tensor of rank ``r − 1`` (the counterpart of
    ``lax.ppermute(x, axis, perm=[(i, i + 1)])``).  Differentiable: the
    gradient goes back around the reverse ring.  Every process of the comm
    must make the same calls in the same order, forward and backward.
    The identity for ``comm`` None or of size 1."""
    if comm is None or comm.size == 1:
        return tensor
    return _RingShift.apply(tensor, comm)
