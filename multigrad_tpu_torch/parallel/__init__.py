"""Communicator and collectives over ``torch.distributed``."""
from .collectives import psum, reduce_sum, scatter_nd  # noqa: F401
from .mesh import MeshComm, global_comm  # noqa: F401
