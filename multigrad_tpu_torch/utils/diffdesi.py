"""Halo-catalog index utilities (port of :mod:`multigrad_tpu.utils
.diffdesi`).

Host-halo resolution by pointer-jumping ``indices[indices]`` to a
fixpoint, and sort-and-reindex helpers that reorder catalogs by ultimate
host halo.  The NumPy functions are the JAX package's own, copied (the
port imports nothing of it); :func:`find_ultimate_top_indices_torch`
takes the place of its ``lax.while_loop`` variant, as a bounded loop on
the tensor's own device.
"""
from __future__ import annotations

import numpy as np
import torch

MAX_RECURSION = 50


def sort_all_by_ultimate_top_dump(ultimate_dump, arrays_to_sort=(),
                                  arrays_to_sort_and_reindex=()):
    """Sort catalog arrays by ultimate host index; index-valued arrays
    are additionally remapped into the sorted order."""
    hosts = find_ultimate_top_indices(ultimate_dump)
    order = np.argsort(hosts)
    inverse = np.argsort(order)  # old position -> new position
    return ([np.asarray(x)[order] for x in arrays_to_sort],
            [sort_and_reindex(x, order, inverse)
             for x in arrays_to_sort_and_reindex])


def find_ultimate_top_indices(indices):
    """Resolve each entry to its ultimate host index by pointer doubling.

    Each pass replaces every pointer with its parent's pointer, so chain
    depth halves per pass; a cycle (or a chain deeper than
    2**MAX_RECURSION) raises ``RecursionError``.
    """
    idx = np.array(indices)
    for _ in range(MAX_RECURSION):
        parent = idx[idx]
        if np.array_equal(parent, idx):
            return idx
        idx = parent
    raise RecursionError(
        f"Host search hasn't finished after {MAX_RECURSION} steps")


def sort_and_reindex(indices, order=None, inverse=None):
    """Reorder an index-valued array by ``order`` while remapping its
    values to the positions they moved to."""
    indices = np.asarray(indices)
    if order is None:
        order = np.argsort(indices)
    if inverse is None:
        inverse = np.argsort(order)
    return inverse[indices][order]


def find_ultimate_top_indices_torch(indices):
    """The fixpoint of :func:`find_ultimate_top_indices` as a loop of at
    most :data:`MAX_RECURSION` gathers on the tensor's device (the JAX
    package's ``find_ultimate_top_indices_jax``).

    Returns ``(resolved_indices, converged)``, ``converged`` a 0-d bool
    tensor: a cycle, or a chain deeper than 2**MAX_RECURSION, gives
    ``False`` where the NumPy function raises.  Each step reads one bool
    back to the host to decide whether to go on.
    """
    idx = torch.as_tensor(indices)
    for _ in range(MAX_RECURSION):
        parent = idx[idx]
        if torch.equal(parent, idx):
            break
        idx = parent
    return idx, (idx[idx] == idx).all()
