"""Collectives (port of :mod:`multigrad_tpu.parallel.collectives`).

=================================  ====================================
reference / JAX package            this module
=================================  ====================================
``reduce_sum`` / ``lax.psum``      ``torch.distributed.all_reduce``
``scatter_nd``                     this process's shard of the array
=================================  ====================================
"""
from __future__ import annotations

from typing import Optional

import torch

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
    Python scalars.  ``comm=None`` is the single-process identity.
    """
    del root
    if comm is None:
        return value
    is_py_scalar = isinstance(value, (bool, int, float))
    out = comm.psum(torch.as_tensor(value))
    return out.item() if is_py_scalar else out


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
