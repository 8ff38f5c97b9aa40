"""The device mesh of the port: who each rank is on the data and seq axes.

Port of the subset of ``deepspeed_tpu/parallel/topology.py`` that data
parallelism, ZeRO and ring sequence parallelism read.  The JAX package
builds one ``Mesh`` whose named axes play the parallel groups; here the
ranks are ``torch.distributed`` processes laid out in the JAX axis order
(outer ``data``, inner ``seq``: rank = data_rank · sp + seq_rank), and an
axis's group is a process group of the ranks that differ only in that axis
(the whole world, ``dist.group.WORLD``, when the axis is the only one above
one).  ZeRO splits its state over the ranks that differ in any ZeRO axis
(the JAX ``ZERO_AXES``: here data and seq), which is the whole world while
no other axis is above one: with rank = data_rank · sp + seq_rank, a
leaf's shard index over ``(data, seq)`` is the global rank.  Tensor,
pipeline and expert axes above one raise (ROADMAP Queue A item 10).
``-1`` for ``data`` (or no ``data`` at all, as in the JAX config) means
the ranks the seq axis leaves over: the initialised world divided by seq,
or 1 without a process group.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch.distributed as dist

PIPE_AXIS = "pipe"
DATA_AXIS = "data"
SUBDATA_AXIS = "subdata"
EXPERT_AXIS = "expert"
SEQ_AXIS = "seq"
TENSOR_AXIS = "tensor"
MESH_AXES = (PIPE_AXIS, DATA_AXIS, SUBDATA_AXIS, EXPERT_AXIS, SEQ_AXIS,
             TENSOR_AXIS)

# Axes over which the global batch is sharded (ref: DP world =
# data×expert; groups._create_expert_and_data_parallel, groups.py:240).
BATCH_AXES: Tuple[str, ...] = (DATA_AXIS, SUBDATA_AXIS, EXPERT_AXIS)
# Axes over which ZeRO partitions optimizer/gradient/parameter state.
ZERO_AXES: Tuple[str, ...] = (DATA_AXIS, SUBDATA_AXIS, EXPERT_AXIS, SEQ_AXIS)

_GLOBAL_TOPOLOGY: Optional["MeshTopology"] = None


def resolve_data_axis(sizes: Dict[str, int]) -> int:
    """The data axis size of ``sizes``: as given, or for ``-1`` (and a
    missing ``data``) the world the other axes leave over."""
    data = int(sizes.get(DATA_AXIS, -1))
    if data != -1:
        return data
    if not dist.is_initialized():
        return 1
    rest = 1
    for ax, v in sizes.items():
        if ax != DATA_AXIS and v not in (1, -1):
            rest *= int(v)
    world = dist.get_world_size()
    if world % rest:
        raise ValueError(f"a world of {world} ranks does not divide by the "
                         f"other mesh axes ({rest})")
    return world // rest


class MeshTopology:
    """Axis sizes of the mesh (missing axes are 1, ``data`` as
    :func:`resolve_data_axis`), this rank's place on the data and seq axes
    and their process groups.  ZeRO's world is the whole world
    (``world_group``, ``rank``, ``world_size``) while only data and seq
    exist.

    A mesh above one rank needs an initialised default group of exactly its
    size; this raises otherwise.  A mesh of one rank has no groups (None)
    and runs no collective."""

    def __init__(self, sizes: Optional[Dict[str, int]] = None):
        sizes = dict(sizes or {})
        unknown = set(sizes) - set(MESH_AXES)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; expected "
                             f"some of {MESH_AXES}")
        above = {k: v for k, v in sizes.items()
                 if k not in (SEQ_AXIS, DATA_AXIS) and v not in (1, -1)}
        if above:
            raise NotImplementedError(
                f"mesh axes {above} above one are not ported to "
                "deepspeed_tpu_torch yet (ROADMAP Queue A item 10)")
        self.sp_size = int(sizes.get(SEQ_AXIS, 1))
        if self.sp_size < 1:
            raise ValueError(f"seq axis size must be >= 1, got {self.sp_size}")
        self.dp_size = resolve_data_axis(sizes)
        if self.dp_size < 1:
            raise ValueError(f"data axis size must be >= 1, got {self.dp_size}")
        self.sizes = {ax: 1 for ax in MESH_AXES}
        self.sizes.update({DATA_AXIS: self.dp_size, SEQ_AXIS: self.sp_size})
        self.world_size = self.dp_size * self.sp_size
        self.tp_size = self.pp_size = self.ep_size = 1
        self.rank = self.dp_rank = self.sp_rank = 0
        self.data_group = self.seq_group = self.world_group = None
        if self.world_size > 1:
            if not dist.is_initialized():
                raise RuntimeError(
                    f"a mesh of {self.world_size} ranks (data "
                    f"{self.dp_size} x seq {self.sp_size}) needs an "
                    "initialised process group of that size "
                    "(comm.init_distributed, or "
                    "deepspeed_tpu_torch.launcher.launch)")
            size = dist.get_world_size()
            if size != self.world_size:
                raise ValueError(
                    f"the mesh has {self.world_size} ranks (data "
                    f"{self.dp_size} x seq {self.sp_size}) but its process "
                    f"group has {size}")
            self.rank = dist.get_rank()
            self.dp_rank, self.sp_rank = divmod(self.rank, self.sp_size)
            self.world_group = dist.group.WORLD
            self.seq_group = self._axis_group(
                [[d * self.sp_size + s for s in range(self.sp_size)]
                 for d in range(self.dp_size)])
            self.data_group = self._axis_group(
                [[d * self.sp_size + s for d in range(self.dp_size)]
                 for s in range(self.sp_size)])

    def _axis_group(self, slices: List[List[int]]):
        """This rank's group among ``slices`` (every rank creates every
        group, in one order, as ``dist.new_group`` requires); the world's
        group when one slice holds every rank."""
        if len(slices) == 1:
            return dist.group.WORLD
        mine = None
        for ranks in slices:
            group = dist.new_group(ranks)
            if self.rank in ranks:
                mine = group
        return mine

    def axis_size(self, axis: str) -> int:
        return self.sizes[axis]

    def __repr__(self) -> str:  # pragma: no cover
        return (f"MeshTopology(data={self.dp_size}, seq={self.sp_size}, "
                f"dp_rank={self.dp_rank}, sp_rank={self.sp_rank})")


def set_topology(topo: Optional[MeshTopology]) -> None:
    """Make ``topo`` the topology the group getters answer from (the
    engine sets its own)."""
    global _GLOBAL_TOPOLOGY
    _GLOBAL_TOPOLOGY = topo


def get_topology() -> Optional[MeshTopology]:
    return _GLOBAL_TOPOLOGY
