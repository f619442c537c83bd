"""Communicator over ``torch.distributed`` (port of
:mod:`multigrad_tpu.parallel.mesh`).

The JAX package runs one controller over a device mesh.  The port runs
one process per shard, as the original MPI multigrad did: each process
holds its own shard of the data, computes its partial sumstats, and
all-reduces the O(|sumstats| + |params|) results.  When
``torch.distributed`` is not initialised the comm is the single-process
identity.

Each process brings the process group up with
:func:`~multigrad_tpu_torch.parallel.distributed.initialize`, from its
launcher's environment or explicit arguments: NCCL for CUDA tensors, the
process bound to its card, gloo for CPU tensors.

Sub-communicators (:func:`split_subcomms`, :func:`split_subcomms_by_node`,
:func:`ensemble_comm`) are ``torch.distributed.new_group`` groups.  Creating a group is
collective over the whole world: every process creates every group, in
the same order, and is a member of its own groups only.  A process may
hold a :class:`MeshComm` of a group it is not in (``is_member`` is then
False); such a comm has no rank or size there and reduces nothing.
"""
from __future__ import annotations

import math
import socket
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..ops.kernel_costs import active_counting_mode, counting_mode
from ..telemetry.comm import record_axis_collective


class MeshComm:
    """This process's view of a process group.

    Parameters
    ----------
    group : ProcessGroup, optional
        The group to reduce over; ``None`` is the default (world) group.
    ranks : sequence of int, optional
        The group's global ranks, in group-rank order (``None``: every
        rank of the world).  Set by :func:`split_subcomms`.
    name : str
        The comm's name (``"WORLD"``, ``"0"``, ``"1"``, ... for the
        groups of a split, as in the JAX package).
    axes : tuple of str
        The names of the axes the comm reduces over: ``(data_axis,)`` for
        an :func:`ensemble_comm`, its replica comm ``(replica_axis,)``.
        Empty for every other comm, whose collectives name no axis (their
        bytes are unattributed in the cost model).
    replica : MeshComm, optional
        An ensemble comm's replica comm: this process's group across the
        replica slices, the axis the K batch axis shards over (see
        :attr:`free_axes` and :class:`KSharding`).
    """

    def __init__(self, group: Optional[dist.ProcessGroup] = None,
                 ranks: Optional[Sequence[int]] = None, name: str = "WORLD",
                 axes: Sequence[str] = (),
                 replica: Optional["MeshComm"] = None):
        self.group = group
        self._ranks = None if ranks is None else tuple(int(r) for r in ranks)
        self.name = name
        self._axes = tuple(axes)
        self.replica = replica

    @property
    def axes(self) -> tuple:
        """The names of the axes the comm reduces over (empty for a comm
        that names none; the JAX package's flat comm names its one
        axis)."""
        return self._axes

    @property
    def axis(self) -> Optional[str]:
        """The axis the comm's collectives are recorded under (its last
        reduced axis; ``None`` for a comm that names none)."""
        return self.axes[-1] if self.axes else None

    @property
    def free_axes(self) -> tuple:
        """The axes the comm does NOT reduce over: an ensemble comm's
        replica axis, else empty (the JAX property over a 2-level
        mesh)."""
        return self.replica.axes if self.replica is not None else ()

    @property
    def distributed(self) -> bool:
        return dist.is_available() and dist.is_initialized()

    @property
    def ranks(self) -> tuple:
        """The global ranks of the group, in group-rank order."""
        if self._ranks is not None:
            return self._ranks
        return tuple(range(dist.get_world_size())) if self.distributed \
            else (0,)

    @property
    def is_member(self) -> bool:
        """Whether this process belongs to the group."""
        return (self._ranks is None or not self.distributed
                or dist.get_rank() in self._ranks)

    def _require_member(self, what: str):
        if not self.is_member:
            raise ValueError(
                f"MeshComm {self.name!r}: this process (global rank "
                f"{dist.get_rank()}) is not a member of the group (ranks "
                f"{list(self._ranks)}), so it has no {what}")

    @property
    def rank(self) -> int:
        if not self.distributed:
            return 0
        self._require_member("rank")
        return dist.get_rank(self.group)

    @property
    def size(self) -> int:
        if not self.distributed:
            return 1
        self._require_member("size")
        return dist.get_world_size(self.group)

    def __len__(self) -> int:
        return self.size

    def __repr__(self) -> str:
        if not self.is_member:
            return f"MeshComm({self.name!r}, not a member)"
        return f"MeshComm({self.name!r}, rank={self.rank}, size={self.size})"

    def _all_reduce(self, op: str, value, reduce_op) -> torch.Tensor:
        """``value`` all-reduced with ``reduce_op`` over the group, on
        every process (a new tensor), its payload recorded under the JAX
        op name ``op``; ``value`` as it is without a process group."""
        if not self.distributed:
            return value
        self._require_member(op)
        out = torch.as_tensor(value).detach().clone()
        record_axis_collective(self.axis, op, out)
        if out.is_meta:             # the static cost model: counted only
            counting_mode(op)
            return out
        staged = on_backend_device(out, self.group)
        dist.all_reduce(staged, op=reduce_op, group=self.group)
        return out if staged is out else staged.to(out.device)

    def psum(self, value: torch.Tensor) -> torch.Tensor:
        """Sum of ``value`` over the group, on every process (a new
        tensor; the input is left as it was).  Under a process group the
        all-reduce runs whatever the group's size, one process too (where
        it is the identity); without one, ``value`` comes back as it
        is."""
        return self._all_reduce("psum", value, dist.ReduceOp.SUM)

    def pmean(self, value: torch.Tensor) -> torch.Tensor:
        """Mean of ``value`` over the group: a SUM all-reduce divided by
        the size (gloo has no AVG), recorded as ``"pmean"``."""
        if not self.distributed:
            return value
        return self._all_reduce("pmean", value, dist.ReduceOp.SUM) \
            / self.size

    def pmax(self, value: torch.Tensor) -> torch.Tensor:
        """Elementwise maximum of ``value`` over the group."""
        return self._all_reduce("pmax", value, dist.ReduceOp.MAX)

    def pmin(self, value: torch.Tensor) -> torch.Tensor:
        """Elementwise minimum of ``value`` over the group."""
        return self._all_reduce("pmin", value, dist.ReduceOp.MIN)

    def all_gather(self, value, axis: int = 0, tiled: bool = True):
        """Every process's ``value``, in rank order, on every process, as
        ``jax.lax.all_gather``: concatenated along ``axis`` (``tiled``) or
        stacked on a new axis ``axis`` (``tiled=False``), through
        :func:`~multigrad_tpu_torch.parallel.collectives.all_gather`.
        Recorded as ``"all_gather"`` with the payload of ``value``, one
        process too.  Without a process group the one-process result:
        ``value`` (stacked: on a new axis of size 1)."""
        from .collectives import all_gather
        value = torch.as_tensor(value)
        if not tiled:
            value = value.unsqueeze(axis)
        if not self.distributed:
            return value
        self._require_member("gather")
        if self.size > 1:
            return all_gather(value, self, axis)
        out = value.detach().clone()
        record_axis_collective(self.axis, "all_gather", out)
        if out.is_meta:             # the static cost model: counted only
            counting_mode("all_gather")
        return out

    def axis_index(self) -> torch.Tensor:
        """This process's index in the group (its rank), an int32 scalar
        on the comm's device: the card under NCCL, else the host.  0
        without a process group (on meta inside the static cost model).
        Moves no data, so, as the JAX method, it records nothing."""
        device = "cpu"
        if active_counting_mode() is not None:
            device = "meta"         # the static cost model: no card memory
        elif self.distributed and dist.get_backend(self.group) == "nccl":
            device = torch.device("cuda", torch.cuda.current_device())
        return torch.tensor(self.rank, dtype=torch.int32, device=device)


def on_backend_device(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """``tensor`` where the group's backend reduces it: a card tensor
    under gloo goes through host memory (gloo's own path for card tensors
    is not used); anything else stays where it is."""
    if tensor.device.type == "cuda" and dist.get_backend(group) == "gloo":
        return tensor.cpu()
    return tensor


class KSharding:
    """The port's ``k_sharding``: the leading (ensemble, chain or bucket)
    axis of a ``(K, ...)`` batch partitioned over an :func:`ensemble_comm`'s
    replica axis, replica slice ``r`` holding rows ``[r·K/R, (r+1)·K/R)``
    (the layout of the JAX package's ``NamedSharding``).

    Each process keeps only its rows (:meth:`local`), and a result comes
    back whole through one all-gather over the replica comm
    (:meth:`gather`, in replica order).
    """

    def __init__(self, replica: MeshComm):
        self.replica = replica

    @property
    def axis(self) -> Optional[str]:
        """The replica axis' name."""
        return self.replica.axis

    @property
    def n_replicas(self) -> int:
        return self.replica.size

    @property
    def index(self) -> int:
        """This process's replica slice."""
        return self.replica.rank

    def local(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """This process's rows of ``x`` along ``axis`` (a view); ``K`` must
        be a multiple of the replica count."""
        k, r = int(x.shape[axis]), self.n_replicas
        if k % r:
            raise ValueError(
                f"a K-sharded batch needs K divisible by the replica "
                f"count: K = {k} rows on {r} replica slices (pad with "
                "inference.pad_k_to_replicas)")
        per = k // r
        return x.narrow(axis, self.index * per, per)

    def gather(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """Every replica slice's ``x``, concatenated along ``axis`` in
        replica order, on every process (one all-gather over the replica
        comm, recorded under its axis)."""
        return self.replica.all_gather(x, axis=axis)

    def __repr__(self) -> str:
        return (f"KSharding(axis={self.axis!r}, n_replicas="
                f"{self.n_replicas}, index={self.index})")


def global_comm() -> MeshComm:
    """A comm over every process of the default group (the identity when
    ``torch.distributed`` is not initialised)."""
    return MeshComm()


def _group_labels(size: int, num_groups: Optional[int] = None,
                  ranks_per_group: Optional[Sequence[int]] = None):
    """The group of each of ``size`` ranks, and the number of groups: the
    JAX package's rule (``multigrad_tpu/parallel/mesh.py:244-258``) and
    its errors."""
    main_msg = "Specify either num_groups OR ranks_per_group"
    if num_groups is not None:
        if ranks_per_group is not None:
            raise ValueError(main_msg)
        if size < num_groups:
            raise ValueError(
                "Cannot create more subcomms than there are ranks: "
                f"num_groups={num_groups} > comm.size={size}")
        num_groups = int(num_groups)
        # A (num_groups, ceil(size/num_groups)) label grid, raveled and
        # re-split into `size` chunks with np.array_split; each rank takes
        # its chunk's first label.  Every group is non-empty (8 ranks, 5
        # groups -> sizes [1, 1, 2, 2, 2]).
        grid = (np.ones(math.ceil(size / num_groups))[None, :]
                * np.arange(num_groups)[:, None])[:size]
        raveled = grid.ravel().astype(int)
        labels = np.array([chunk[0] for chunk in
                           np.array_split(raveled, size)])
    else:
        if ranks_per_group is None:
            raise ValueError(main_msg)
        if sum(ranks_per_group) != size:
            raise ValueError(
                "The sum of ranks_per_group must equal comm.size: "
                f"sum({list(ranks_per_group)}) != {size}")
        if min(ranks_per_group) < 1:
            raise ValueError(
                "Every group needs at least one rank: "
                f"ranks_per_group={list(ranks_per_group)}")
        num_groups = len(ranks_per_group)
        labels = np.repeat(np.arange(num_groups), ranks_per_group)
    return labels, num_groups


def _new_groups(comm: MeshComm, labels, num_groups: int):
    """One ``new_group`` per label, created by every process in label
    order; ``(subcomms, my_group)``."""
    parent = comm.ranks
    subcomms = []
    for g in range(num_groups):
        ranks = [parent[i] for i in np.flatnonzero(labels == g)]
        name = f"{comm.name}.{g}".replace("WORLD.", "")
        subcomms.append(MeshComm(dist.new_group(ranks), ranks, name))
    me = dist.get_rank()
    my_group = next((g for g, sub in enumerate(subcomms)
                     if me in sub.ranks), None)
    return tuple(subcomms), my_group


def split_subcomms(num_groups: Optional[int] = None,
                   ranks_per_group: Optional[Sequence[int]] = None,
                   comm: Optional[MeshComm] = None):
    """Split a comm's ranks into disjoint sub-communicators.

    Either ``num_groups`` groups of near-equal size or explicit
    ``ranks_per_group`` sizes, with the JAX package's grouping rule.  The
    call is collective over the world: every process makes it with the
    same arguments (a process outside ``comm`` too).

    Returns
    -------
    subcomms : tuple[MeshComm]
        One comm per group, on every process; this process is a member
        of one of them (see :attr:`MeshComm.is_member`).
    num_groups : int
    my_group : int
        The index of this process's group (``None`` for a process outside
        ``comm``).
    """
    if comm is None:
        comm = global_comm()
    size = len(comm.ranks)
    labels, num_groups = _group_labels(size, num_groups, ranks_per_group)
    if not comm.distributed:
        return (MeshComm(name=comm.name),), num_groups, 0
    subcomms, my_group = _new_groups(comm, labels, num_groups)
    return subcomms, num_groups, my_group


def ensemble_comm(n_replicas: int, data_axis: str = "data",
                  replica_axis: str = "replica",
                  name: str = "WORLD") -> MeshComm:
    """The communicator of sharded-K ensembles: the world's P processes as
    an ``(R, D)`` grid, ``R = n_replicas`` replica slices of ``D = P / R``
    data shards, the replica axis outermost as in the JAX package (global
    rank ``r·D + d``).

    The comm returned reduces over this process's data group (its replica
    slice's D ranks), so a model on it behaves as on a one-axis comm:
    sumstats and gradients all-reduce over ``data_axis``, ``scatter_nd``
    shards a catalog over the slice, each slice holding a whole copy.  It
    also carries its replica comm (``.replica``: this process's rank in
    every slice, the free axis :attr:`MeshComm.free_axes`), which the
    K-sharded entry points partition the ensemble axis over:
    ``batched_loss_and_grad_fn(k_sharded=True)``,
    ``run_adam_scan(carry_sharding=...)``, ``run_multistart_adam(
    k_sharded=...)``, ``run_hmc(k_sharded=True)`` and ``FitScheduler(
    k_sharded=...)`` each hold K/R rows a process (see
    :class:`KSharding`).

    The trade, as in the JAX package: a slice holds a whole catalog over
    D shards (×R the catalog a process of a flat comm of P holds), against
    K/R rows of optimizer state and of the port's autograd graphs
    (:func:`~multigrad_tpu_torch.inference.ensemble_memory_model`).

    Collective over the world: every process calls ``new_group`` for the
    R data groups, then the D replica groups, in order.  ``n_replicas``
    must divide the process count (``ValueError``).  Without a process
    group the one process is a 1×1 grid.
    """
    n_replicas = int(n_replicas)
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    world = MeshComm(name=name)
    size = len(world.ranks)
    if size % n_replicas:
        raise ValueError(
            f"n_replicas={n_replicas} must divide the process count "
            f"({size})")
    if not world.distributed:
        return MeshComm(name=name, axes=(data_axis,), replica=MeshComm(
            name=f"{name}.{replica_axis}", axes=(replica_axis,)))
    width = size // n_replicas
    ranks = np.arange(size)
    data, my_data = _new_groups(world, ranks // width, n_replicas)
    replicas, my_replica = _new_groups(world, ranks % width, width)
    replica = replicas[my_replica]
    return MeshComm(
        data[my_data].group, data[my_data].ranks, name, axes=(data_axis,),
        replica=MeshComm(replica.group, replica.ranks,
                         f"{name}.{replica_axis}", axes=(replica_axis,)))


def split_subcomms_by_node(comm: Optional[MeshComm] = None):
    """One sub-communicator per host: the ranks of ``comm`` grouped by
    host name (exchanged with ``all_gather_object`` over the world), hosts
    in the order of their lowest rank.  Collective over the world, like
    :func:`split_subcomms`; returns ``(subcomms, num_groups, my_group)``."""
    if comm is None:
        comm = global_comm()
    if not comm.distributed:
        return (MeshComm(name=comm.name),), 1, 0
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    names = [hosts[r] for r in comm.ranks]
    order = list(dict.fromkeys(names))
    labels = np.array([order.index(h) for h in names])
    subcomms, my_group = _new_groups(comm, labels, len(order))
    return subcomms, len(order), my_group


def _node_major(hosts) -> bool:
    """Whether each host's ranks are one contiguous block of ``hosts``
    (the host name of each rank, in rank order)."""
    runs = [h for i, h in enumerate(hosts) if i == 0 or h != hosts[i - 1]]
    return len(runs) == len(set(runs))


def hybrid_comm(ici_axis: str = "data", dcn_axis: str = "hosts",
                name: str = "WORLD") -> MeshComm:
    """The world comm, its ranks checked node-major: each host's ranks one
    contiguous block, so a shard scattered over it is host-major (the
    layout of the JAX package's ``hybrid_comm``, whose mesh puts the
    inter-host axis outermost).  The host names are exchanged with
    ``all_gather_object``, as :func:`split_subcomms_by_node` does; a
    layout that is not node-major raises ``ValueError``.  The axis names
    keep the JAX package's signature and name no mesh axis here: NCCL
    picks the links of an all-reduce itself.  Collective over the
    world."""
    del ici_axis, dcn_axis
    comm = MeshComm(name=name)
    if comm.distributed:
        hosts = [None] * dist.get_world_size()
        dist.all_gather_object(hosts, socket.gethostname())
        if not _node_major(hosts):
            raise ValueError(
                "hybrid_comm: the ranks are not node-major (each host's "
                f"ranks one contiguous block); hosts by rank: {hosts}")
    return comm
