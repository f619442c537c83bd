"""Communicator, collectives and the multi-process bootstrap over
``torch.distributed``."""
from .collectives import (all_gather, psum, reduce_sum,  # noqa: F401
                          scatter_from_local, scatter_nd)
from .mesh import (KSharding, MeshComm, ensemble_comm,  # noqa: F401
                   global_comm, hybrid_comm, split_subcomms,
                   split_subcomms_by_node)
from . import distributed  # noqa: F401

__all__ = [
    "MeshComm", "KSharding", "ensemble_comm", "global_comm",
    "hybrid_comm", "split_subcomms",
    "split_subcomms_by_node", "all_gather", "psum", "reduce_sum",
    "scatter_from_local", "scatter_nd", "distributed",
]
