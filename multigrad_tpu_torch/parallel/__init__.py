"""Communicator and collectives over ``torch.distributed``."""
from .collectives import (all_gather, psum, reduce_sum,  # noqa: F401
                          scatter_from_local, scatter_nd)
from .mesh import (MeshComm, global_comm, split_subcomms,  # noqa: F401
                   split_subcomms_by_node)
