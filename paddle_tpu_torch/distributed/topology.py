"""The N-D parallel topology of the PyTorch port: rank arithmetic, the
mesh, and the hybrid group.

Counterpart of ``paddle_tpu/distributed/topology.py``.
``CommunicateTopology`` (``:29-80``) is pure rank arithmetic and is
copied. The reference's mesh is a ``jax.sharding.Mesh`` over the devices of
one process (``build_mesh``, ``:111-124``); the port's is a ``Mesh`` over
the ranks of the default process group, each rank one process. Rank ``i``
sits where the reference's device ``i`` sits in ``devices.reshape(shape)``
(row-major over the axes in the order given), so rank ``i`` holds the shard
that the reference's device ``i`` holds. Its process groups are those of
a ``torch.distributed.device_mesh.DeviceMesh`` built the same way; with no
process group and a world of one, the mesh has no groups and every
collective over it is the identity, as in the reference's single process.

The axis order stays the reference's ``["data", "pipe", "sharding", "sep",
"model"]`` (``:23``).
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import env as _env

_DEFAULT_ORDER = ["data", "pipe", "sharding", "sep", "model"]

_global_hcg: Optional["HybridCommunicateGroup"] = None
_global_mesh: Optional["Mesh"] = None


class CommunicateTopology:
    """Rank <-> coordinate arithmetic over named axes (``:29-80``)."""

    def __init__(self, hybrid_group_names: Sequence[str] = _DEFAULT_ORDER,
                 dims: Sequence[int] = (1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = list(itertools.product(
            *(range(d) for d in self._dims)))
        self._coord2rank = {c: i for i, c in enumerate(self.coordinate)}

    def get_hybrid_group_names(self) -> List[str]:
        return self._parallel_names

    def get_dim(self, axis_name: str) -> int:
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self) -> int:
        return int(np.prod(self._dims))

    def get_rank(self, **kwargs) -> int:
        coord = tuple(kwargs[name] for name in self._parallel_names)
        return self._coord2rank[coord]

    def get_coord(self, rank: int):
        return self.coordinate[rank]

    def get_axis_list(self, axis_name: str, index: int) -> List[int]:
        axis = self._parallel_names.index(axis_name)
        return [r for r, c in enumerate(self.coordinate) if c[axis] == index]

    def get_comm_list(self, axis_name: str) -> List[List[int]]:
        """All groups along ``axis_name`` (each: the ranks that differ only
        there)."""
        axis = self._parallel_names.index(axis_name)
        other = [self._dims[i] for i in range(len(self._dims)) if i != axis]
        comm = []
        for fixed in itertools.product(*(range(d) for d in other)):
            ranks = []
            for v in range(self._dims[axis]):
                coord = list(fixed)
                coord.insert(axis, v)
                ranks.append(self._coord2rank[tuple(coord)])
            comm.append(ranks)
        return comm

    def get_rank_from_stage(self, global_rank: int, **kwargs) -> int:
        coord = list(self.get_coord(global_rank))
        for k, v in kwargs.items():
            coord[self._parallel_names.index(k)] = v
        return self._coord2rank[tuple(coord)]


class ParallelGroup:
    """A group of ranks (``paddle.distributed.collective.Group``): the
    reference's view (``ranks``, ``nranks``, ``rank``, ``axis_name``,
    ``id``) and the ``torch.distributed`` process group its collectives
    run on (None when the world is one process with no group)."""

    def __init__(self, ranks: List[int], rank: int, axis_name: str,
                 group_id: int = 0, process_group=None):
        self.ranks = list(ranks)
        self.nranks = len(self.ranks)
        self.axis_name = axis_name
        self.id = group_id
        self.process_group = process_group
        self._rank_in_group = (self.ranks.index(rank) if rank in self.ranks
                               else -1)

    @property
    def rank(self):
        return self._rank_in_group

    @property
    def world_size(self):
        return self.nranks

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    def __repr__(self):
        return (f"ParallelGroup(axis={self.axis_name}, ranks={self.ranks}, "
                f"rank={self._rank_in_group})")


class Mesh:
    """Named axes over the ranks of the default group (the reference's
    ``jax.sharding.Mesh``): ``axis_names``, ``shape`` ({axis: size}),
    ``devices`` (the ranks, reshaped), ``coordinate(axis)`` (this rank's
    index along an axis) and ``group(axis)`` (a ``ParallelGroup`` over the
    ranks that differ only there). ``device_mesh`` is the
    ``torch.distributed.device_mesh.DeviceMesh`` that made the groups
    (None without a process group)."""

    def __init__(self, dims: Dict[str, int]):
        self.axis_names = tuple(dims)
        self.shape = {k: int(v) for k, v in dims.items()}
        size = int(np.prod(list(self.shape.values()) or [1]))
        world = _env.get_world_size()
        if size != world:
            raise ValueError(
                f"topology {dict(dims)} needs {size} ranks, the world has "
                f"{world}")
        self.devices = np.arange(size).reshape(tuple(self.shape.values()))
        self.rank = _env.get_rank()
        self.device_mesh = None
        if _env.is_initialized():
            import torch.distributed as dist
            from torch.distributed.device_mesh import init_device_mesh
            kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
            self.device_mesh = init_device_mesh(
                kind, tuple(self.shape.values()),
                mesh_dim_names=self.axis_names)
        self._topo = CommunicateTopology(list(self.axis_names),
                                         list(self.shape.values()))
        self._groups = {}

    def coordinate(self, axis: str) -> int:
        return self._topo.get_coord(self.rank)[self.axis_names.index(axis)]

    def group(self, axis: str) -> ParallelGroup:
        if axis not in self._groups:
            ranks = next(r for r in self._topo.get_comm_list(axis)
                         if self.rank in r)
            pg = (self.device_mesh.get_group(axis)
                  if self.device_mesh is not None else None)
            self._groups[axis] = ParallelGroup(ranks, self.rank, axis,
                                               process_group=pg)
        return self._groups[axis]

    def __repr__(self):
        return f"Mesh({self.shape})"


def build_mesh(dims: Dict[str, int], devices=None) -> Mesh:
    """The mesh of ``dims`` ({axis: size}, outermost first; axes of size 1
    kept) over the ranks of the default group, whose size must be the
    product. ``devices`` is accepted for the reference's signature and must
    be None or the ranks in order."""
    if devices is not None and list(np.asarray(devices).ravel()) != list(
            range(int(np.prod(list(dims.values()))))):
        raise ValueError("build_mesh places rank i at position i; other "
                         "device orders are not supported")
    return Mesh(dims)


def set_global_mesh(mesh: Optional[Mesh]):
    global _global_mesh
    _global_mesh = mesh


def get_global_mesh() -> Optional[Mesh]:
    return _global_mesh


class HybridCommunicateGroup:
    """The hybrid group (``:136-275``): the topology, its mesh and one
    ``ParallelGroup`` per axis, taken from the mesh's per-axis process
    groups, with the reference's getters."""

    def __init__(self, topology: CommunicateTopology):
        self._topo = topology
        self.global_rank = _env.get_rank()
        self.nranks = topology.world_size()
        self._dp_degree = self._get_dim("data")
        self._pp_degree = self._get_dim("pipe")
        self._sharding_degree = self._get_dim("sharding")
        self._sep_degree = self._get_dim("sep")
        self._mp_degree = self._get_dim("model")
        self.mesh = build_mesh({name: topology.get_dim(name) for name in
                                topology.get_hybrid_group_names()})
        set_global_mesh(self.mesh)
        self._groups = {name: self.mesh.group(name)
                        for name in topology.get_hybrid_group_names()}

    def _get_dim(self, name):
        try:
            return self._topo.get_dim(name)
        except ValueError:
            return 1

    def topology(self):
        return self._topo

    def get_parallel_mode(self):
        if self._mp_degree > 1 or self._pp_degree > 1:
            return "hybrid"
        if self._sharding_degree > 1:
            return "sharding_parallel"
        if self._dp_degree > 1:
            return "data_parallel"
        return "single"

    # ---- data parallel ----
    def get_data_parallel_rank(self):
        return self._groups["data"].rank

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_group(self):
        return self._groups["data"]

    def get_data_parallel_group_src_rank(self):
        return self._groups["data"].ranks[0]

    # ---- model (tensor) parallel ----
    def get_model_parallel_rank(self):
        return self._groups["model"].rank

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_group(self):
        return self._groups["model"]

    def get_model_parallel_group_src_rank(self):
        return self._groups["model"].ranks[0]

    # ---- pipeline parallel ----
    def get_stage_id(self):
        return self._groups["pipe"].rank

    def get_pipe_parallel_rank(self):
        return self._groups["pipe"].rank

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_pipe_parallel_group(self):
        return self._groups["pipe"]

    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self._pp_degree - 1

    # ---- sharding ----
    def get_sharding_parallel_rank(self):
        return self._groups["sharding"].rank

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_group(self):
        return self._groups["sharding"]

    def get_sharding_parallel_group_src_rank(self):
        return self._groups["sharding"].ranks[0]

    # ---- sep (sequence / context parallel) ----
    def get_sep_parallel_rank(self):
        return self._groups["sep"].rank

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    def get_sep_parallel_group(self):
        return self._groups["sep"]

    # ---- check / global ----
    def get_global_rank(self):
        return self.global_rank

    def get_rank_from_stage(self, stage_id, **kwargs):
        return self._topo.get_rank_from_stage(self.global_rank,
                                              pipe=stage_id, **kwargs)


def set_hybrid_communicate_group(hcg: Optional[HybridCommunicateGroup]):
    global _global_hcg
    _global_hcg = hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _global_hcg


def shard_of(array, spec, mesh_shape: Dict[str, int], coords: Dict[str, int]):
    """The block of ``array`` that the rank at ``coords`` ({axis: index})
    holds under ``spec`` (one mesh axis name or None per dimension, as a
    ``PartitionSpec``; axes not in the mesh replicate): each named
    dimension cut into ``mesh_shape[axis]`` equal contiguous blocks. The
    reference's ``addressable_shards[r].data`` for the rank's coordinates."""
    out = array
    for dim, axis in enumerate(tuple(spec or ())):
        if axis is None or axis not in mesh_shape or mesh_shape[axis] == 1:
            continue
        n = mesh_shape[axis]
        if out.shape[dim] % n:
            raise ValueError(f"dimension {dim} ({out.shape[dim]}) does not "
                             f"divide over {axis}={n}")
        size = out.shape[dim] // n
        index = [slice(None)] * out.ndim
        index[dim] = slice(coords[axis] * size, (coords[axis] + 1) * size)
        out = out[tuple(index)]
    return out


def coords_of(mesh_shape: Dict[str, int], rank: int) -> Dict[str, int]:
    """{axis: index} of ``rank`` in a row-major mesh of ``mesh_shape``."""
    topo = CommunicateTopology(list(mesh_shape), list(mesh_shape.values()))
    return dict(zip(mesh_shape, topo.get_coord(rank)))
