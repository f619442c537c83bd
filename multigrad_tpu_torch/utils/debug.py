"""Replication checks over a comm (port of :mod:`multigrad_tpu.utils.debug`).

Every process of a comm must hold the same parameters, losses and
optimizer state after its all-reduces; a process-local value leaking in
breaks that silently.  :func:`assert_replicated` makes it a checked
invariant::

    from multigrad_tpu_torch.utils import debug
    debug.assert_replicated(grad, comm, name="grad")    # raises if not

The JAX package checks inside the compiled program and raises from the
host afterwards (``check_replication``); with one process per shard the
check is one all-gather and raises at once.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..parallel.collectives import all_gather
from ..parallel.mesh import MeshComm
from .checkpoint import _flatten


def _leaves(tree):
    return [torch.as_tensor(leaf) for leaf in _flatten(tree)]


def replication_spread(tree, comm: Optional[MeshComm]) -> float:
    """The largest ``max − min`` over the comm's ranks of any element of
    ``tree``'s leaves: exactly 0 iff every process holds the same values.

    Each leaf is widened to float64 (exact for float32 and for integers
    below 2^53) and every leaf rides in one all-gather.  0 for
    ``comm=None`` or a comm of one process.
    """
    leaves = _leaves(tree)
    if comm is None or comm.size == 1 or not leaves:
        return 0.0
    flat = torch.cat([leaf.detach().reshape(-1).to(torch.float64)
                      for leaf in leaves])
    rows = all_gather(flat[None], comm)
    return float((rows.amax(0) - rows.amin(0)).abs().max()) \
        if flat.numel() else 0.0


def assert_replicated(tree, comm: Optional[MeshComm], tol: float = 0.0,
                      name: str = "value"):
    """Raise ``AssertionError`` when ``tree`` differs across ``comm``'s
    processes by more than ``tol`` (see :func:`replication_spread`);
    return ``tree`` unchanged, so it can sit in the dataflow.  Collective:
    every process of the comm calls it.  The identity for ``comm=None``
    or a comm of one process."""
    spread = replication_spread(tree, comm)
    if spread > tol:
        raise AssertionError(
            f"replication invariant violated: {name} varies across the "
            f"comm by {spread:.3e} (tol={tol:.3e})")
    return tree
