"""Collectives (port of :mod:`multigrad_tpu.parallel.collectives`).

=================================  ====================================
reference / JAX package            this module
=================================  ====================================
``reduce_sum`` / ``lax.psum``      ``torch.distributed.all_reduce``
``scatter_nd``                     this process's shard of the array
``lax.ppermute`` (i → i+1 ring)    ``ring_shift`` (``batch_isend_irecv``)
=================================  ====================================
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .mesh import MeshComm
from ..utils.util import pad_to_multiple


def psum(value, comm: Optional[MeshComm] = None):
    """Sum ``value`` over ``comm``'s processes; identity for ``None``."""
    return value if comm is None else comm.psum(value)


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
    if (home.type == "cpu" and comm.distributed
            and dist.get_backend(comm.group) == "nccl"):
        tensor = tensor.to(torch.device("cuda", torch.cuda.current_device()))
    out = comm.psum(tensor)
    return out.item() if is_py_scalar else out.to(home)


def scatter_nd(array, axis: int = 0, comm: Optional[MeshComm] = None,
               pad_value=None):
    """This process's shard of ``array`` along ``axis``.

    Shards are equal: a length that ``comm.size`` does not divide is
    padded first with ``pad_value``, which must be neutral for the
    model's statistic (``inf`` log-mass for the erf counts).  Without
    ``pad_value`` a ragged axis raises.  ``comm=None`` returns the array.
    """
    array = torch.as_tensor(array)
    if comm is None:
        return array
    n = array.shape[axis]
    if n % comm.size:
        if pad_value is None:
            raise ValueError(
                f"scatter_nd: axis {axis} of length {n} is not divisible "
                f"by comm.size={comm.size}; pass pad_value= (a "
                f"model-neutral filler) or pad first (see "
                f"utils.pad_to_multiple)")
        array, _ = pad_to_multiple(array, comm.size, axis=axis,
                                   pad_value=pad_value)
    per = array.shape[axis] // comm.size
    return array.narrow(axis, comm.rank * per, per).contiguous()


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
