"""The device mesh of the port: who each rank is on the data, subdata and
seq axes.

Port of the subset of ``deepspeed_tpu/parallel/topology.py`` that data
parallelism, ZeRO (with hpZ's and MiCS's factored data axis) and ring
sequence parallelism read.  The JAX package builds one ``Mesh`` whose
named axes play the parallel groups; here the ranks are
``torch.distributed`` processes laid out in the JAX axis order (outer
``data``, then ``subdata``, inner ``seq``: rank = (data_rank · subdata +
subdata_rank) · sp + seq_rank), and a group is a process group of the
ranks that differ only in some axes (the whole world,
``dist.group.WORLD``, when they are all the ranks):

* the batch group (``data_group``): data × subdata, the JAX
  ``BATCH_AXES``, over which the global batch's rows are split;
* the inner group: subdata × seq, the JAX ``ZERO_INNER_AXES`` (the expert
  axis is one), hpZ's secondary partition and MiCS's shard group;
* the outer group: data alone, across which hpZ's and MiCS's inner groups
  repeat;
* the seq group (the ring) and the world (ZeRO's ``ZERO_AXES``: a leaf's
  shard index over ``(data, subdata, seq)`` is the global rank).

Without hpZ or MiCS ``subdata`` is one: the inner group is the seq group
and the outer group the data group.  :func:`factor_data_axis` splits the
data axis into ``data`` (outer) and ``subdata`` (inner), as the JAX engine
does before it builds its mesh.  Tensor, pipeline and expert axes above
one raise (ROADMAP Queue A item 10).  ``-1`` for ``data`` (or no ``data``
at all, as in the JAX config) means the ranks the other axes leave over:
the initialised world divided by them, or 1 without a process group.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

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
# Inner ZeRO axes: the secondary partition group for hpZ params / the MiCS
# shard group.
ZERO_INNER_AXES: Tuple[str, ...] = (SUBDATA_AXIS, EXPERT_AXIS, SEQ_AXIS)

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


def factor_data_axis(sizes: Dict[str, int], shard_size: int) -> Dict[str, int]:
    """Factor the resolved data axis into (outer=data, inner=subdata) for
    hierarchical partitioning (hpZ secondary partition / MiCS sub-groups):
    ``shard_size`` ranks form the inner shard group and the rest of the
    data-parallel world replicates across them (the JAX function)."""
    sizes = dict(sizes)
    data = sizes.get(DATA_AXIS, 1) * sizes.get(SUBDATA_AXIS, 1)
    if shard_size <= 0 or data % shard_size != 0:
        raise ValueError(f"data-parallel world {data} not divisible by "
                         f"secondary partition size {shard_size}")
    sizes[DATA_AXIS] = data // shard_size
    sizes[SUBDATA_AXIS] = shard_size
    return sizes


class Level(NamedTuple):
    """One cut of a leaf over a group: the group whose ranks hold the
    ``size`` chunks, and this rank's chunk (its rank in the group)."""
    group: Any
    size: int
    index: int


class MeshTopology:
    """Axis sizes of the mesh (missing axes are 1, ``data`` as
    :func:`resolve_data_axis`), this rank's place on the data, subdata and
    seq axes and the groups of the module docstring.  ``dp_size``/
    ``dp_rank`` are the batch group's (data · subdata, the JAX
    ``dp_size``), ``outer_*`` the data axis's and ``inner_*`` subdata ·
    seq's; ZeRO's whole world is ``world_group``, ``rank``,
    ``world_size``.

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
                 if k not in (SEQ_AXIS, DATA_AXIS, SUBDATA_AXIS)
                 and v not in (1, -1)}
        if above:
            raise NotImplementedError(
                f"mesh axes {above} above one are not ported to "
                "deepspeed_tpu_torch yet (ROADMAP Queue A item 10)")
        self.sp_size = int(sizes.get(SEQ_AXIS, 1))
        if self.sp_size < 1:
            raise ValueError(f"seq axis size must be >= 1, got {self.sp_size}")
        self.subdata_size = int(sizes.get(SUBDATA_AXIS, 1))
        if self.subdata_size < 1:
            raise ValueError("subdata axis size must be >= 1, got "
                             f"{self.subdata_size}")
        self.outer_size = resolve_data_axis(sizes)
        if self.outer_size < 1:
            raise ValueError(f"data axis size must be >= 1, got "
                             f"{self.outer_size}")
        self.dp_size = self.outer_size * self.subdata_size
        self.inner_size = self.subdata_size * self.sp_size
        self.sizes = {ax: 1 for ax in MESH_AXES}
        self.sizes.update({DATA_AXIS: self.outer_size,
                           SUBDATA_AXIS: self.subdata_size,
                           SEQ_AXIS: self.sp_size})
        self.world_size = self.dp_size * self.sp_size
        self.tp_size = self.pp_size = self.ep_size = 1
        self.rank = self.dp_rank = self.sp_rank = 0
        self.outer_rank = self.inner_rank = 0
        self.data_group = self.seq_group = self.world_group = None
        self.inner_group = self.outer_group = None
        if self.world_size > 1:
            if not dist.is_initialized():
                raise RuntimeError(
                    f"a mesh of {self.world_size} ranks ({self._desc()}) "
                    "needs an initialised process group of that size "
                    "(comm.init_distributed, or "
                    "deepspeed_tpu_torch.launcher.launch)")
            size = dist.get_world_size()
            if size != self.world_size:
                raise ValueError(
                    f"the mesh has {self.world_size} ranks ({self._desc()}) "
                    f"but its process group has {size}")
            self.rank = dist.get_rank()
            sp, inner = self.sp_size, self.inner_size
            self.dp_rank, self.sp_rank = divmod(self.rank, sp)
            self.outer_rank, self.inner_rank = divmod(self.rank, inner)
            self.world_group = dist.group.WORLD
            # every rank creates every group in this order; a set of
            # slices made once is reused (without subdata the inner group
            # is the seq group and the outer group the data group)
            self._made: Dict[tuple, Any] = {}
            self.seq_group = self._axis_group(
                [[b * sp + s for s in range(sp)] for b in range(self.dp_size)])
            self.data_group = self._axis_group(
                [[b * sp + s for b in range(self.dp_size)] for s in range(sp)])
            self.inner_group = self._axis_group(
                [[o * inner + i for i in range(inner)]
                 for o in range(self.outer_size)])
            self.outer_group = self._axis_group(
                [[o * inner + i for o in range(self.outer_size)]
                 for i in range(inner)])
            del self._made
            from deepspeed_tpu_torch.comm import comm

            for name, group in (("world", self.world_group),
                                ("inner", self.inner_group),
                                ("outer", self.outer_group),
                                ("batch", self.data_group),
                                ("seq", self.seq_group)):
                comm.name_group(group, name)

    def level(self, kind: str) -> Level:
        """This rank's :class:`Level` over ``"world"``, ``"inner"`` or
        ``"outer"``."""
        if kind == "world":
            return Level(self.world_group, self.world_size, self.rank)
        if kind == "inner":
            return Level(self.inner_group, self.inner_size, self.inner_rank)
        if kind == "outer":
            return Level(self.outer_group, self.outer_size, self.outer_rank)
        raise ValueError(f"group kind {kind!r}: expected world, inner or "
                         "outer")

    def _desc(self) -> str:
        return (f"data {self.outer_size} x subdata {self.subdata_size} x "
                f"seq {self.sp_size}")

    def _axis_group(self, slices: List[List[int]]):
        """This rank's group among ``slices`` (every rank creates every
        group, in one order, as ``dist.new_group`` requires); the world's
        group when one slice holds every rank."""
        if len(slices) == 1:
            return dist.group.WORLD
        key = tuple(tuple(r) for r in slices)
        if key not in self._made:
            mine = None
            for ranks in slices:
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    mine = group
            self._made[key] = mine
        return self._made[key]

    def axis_size(self, axis: str) -> int:
        return self.sizes[axis]

    def __repr__(self) -> str:  # pragma: no cover
        return (f"MeshTopology({self._desc()}, rank={self.rank})")


def set_topology(topo: Optional[MeshTopology]) -> None:
    """Make ``topo`` the topology the group getters answer from (the
    engine sets its own)."""
    global _GLOBAL_TOPOLOGY
    _GLOBAL_TOPOLOGY = topo


def get_topology() -> Optional[MeshTopology]:
    return _GLOBAL_TOPOLOGY
