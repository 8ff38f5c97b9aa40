"""The device mesh of the port: who each rank is in the sequence ring.

Port of the subset of ``deepspeed_tpu/parallel/topology.py`` that ring
sequence parallelism reads.  The JAX package builds one ``Mesh`` whose
named axes play the parallel groups; here the ranks are
``torch.distributed`` processes, and the one axis above one that the port
runs is ``seq``: its group is the process group the launcher initialised
(every rank of it), and each rank holds one shard of the sequence.  Data,
tensor, pipeline and expert axes above one raise (ROADMAP Queue A items 4
and 10).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch.distributed as dist

PIPE_AXIS = "pipe"
DATA_AXIS = "data"
SUBDATA_AXIS = "subdata"
EXPERT_AXIS = "expert"
SEQ_AXIS = "seq"
TENSOR_AXIS = "tensor"
MESH_AXES = (PIPE_AXIS, DATA_AXIS, SUBDATA_AXIS, EXPERT_AXIS, SEQ_AXIS,
             TENSOR_AXIS)


class MeshTopology:
    """Axis sizes of the mesh (missing axes are 1; ``-1`` for an axis other
    than ``seq`` means "what is left", which is 1 here) and the seq group.

    The ring's group is the whole world of the initialised default group:
    a ``seq`` axis above one needs one of exactly that size; this raises
    otherwise."""

    def __init__(self, sizes: Optional[Dict[str, int]] = None):
        sizes = dict(sizes or {})
        unknown = set(sizes) - set(MESH_AXES)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; expected "
                             f"some of {MESH_AXES}")
        above = {k: v for k, v in sizes.items()
                 if k != SEQ_AXIS and v not in (1, -1)}
        if above:
            raise NotImplementedError(
                f"mesh axes {above} above one are not ported to "
                "deepspeed_tpu_torch yet (ROADMAP Queue A item 4 for data, "
                "item 10 for tensor, pipe and expert)")
        self.sp_size = int(sizes.get(SEQ_AXIS, 1))
        if self.sp_size < 1:
            raise ValueError(f"seq axis size must be >= 1, got {self.sp_size}")
        self.seq_group = None
        self.sp_rank = 0
        if self.sp_size > 1:
            if not dist.is_initialized():
                raise RuntimeError(
                    f"a seq axis of {self.sp_size} needs an initialised "
                    "process group of that size (comm.init_distributed, or "
                    "deepspeed_tpu_torch.launcher.launch)")
            self.seq_group = dist.group.WORLD
            size = dist.get_world_size(self.seq_group)
            if size != self.sp_size:
                raise ValueError(f"the seq axis is {self.sp_size} but its "
                                 f"process group has {size} ranks")
            self.sp_rank = dist.get_rank(self.seq_group)

    def __repr__(self) -> str:  # pragma: no cover
        return f"MeshTopology(seq={self.sp_size}, sp_rank={self.sp_rank})"
