"""Process-group getters over the port's topology.

Port of ``deepspeed_tpu/utils/groups.py`` (the reference's
``deepspeed/utils/groups.py`` getters).  The JAX package answers with mesh
axis names; here a group is the ``torch.distributed`` process group of
that axis in the live topology (``parallel/topology.py``, set by the
engine), usable as ``group=`` in ``comm/comm.py`` and ``torch.distributed``.
An axis of size one has no group: its getter returns None and its world
size and rank are 1 and 0, and no collective runs over it.  The tensor,
pipeline and expert axes are always one in the port (ROADMAP Queue A item
10), as they are in the JAX package on a mesh without them.
"""

from __future__ import annotations

from deepspeed_tpu_torch.parallel.topology import MeshTopology, get_topology


def _topo() -> MeshTopology:
    topo = get_topology()
    if topo is None:
        raise RuntimeError(
            "no topology initialized — build the engine (ds.initialize) "
            "first")
    return topo


# -- data parallel ----------------------------------------------------
def get_data_parallel_group():
    """The data-parallel group: data × subdata (the JAX package's
    ``BATCH_AXES``; subdata is above one under hpZ and MiCS, which factor
    the data axis).  ZeRO reduces gradients and partitions state over the
    data, subdata and seq axes, the whole world, or hpZ's and MiCS's
    inner group."""
    topo = _topo()
    return topo.data_group if topo.dp_size > 1 else None


def get_data_parallel_world_size() -> int:
    return _topo().dp_size


def get_data_parallel_rank() -> int:
    return _topo().dp_rank


# -- sequence parallel ------------------------------------------------
def get_sequence_parallel_group():
    topo = _topo()
    return topo.seq_group if topo.sp_size > 1 else None


def get_sequence_parallel_world_size() -> int:
    return _topo().sp_size


def get_sequence_parallel_rank() -> int:
    return _topo().sp_rank


# -- tensor / model parallel, pipeline, expert: one rank each ----------
def get_tensor_model_parallel_group():
    return None


get_model_parallel_group = get_tensor_model_parallel_group


def get_tensor_model_parallel_world_size() -> int:
    return _topo().tp_size


get_model_parallel_world_size = get_tensor_model_parallel_world_size


def get_tensor_model_parallel_rank() -> int:
    _topo()
    return 0


get_model_parallel_rank = get_tensor_model_parallel_rank


def get_pipeline_model_parallel_group():
    return None


def get_pipeline_model_parallel_world_size() -> int:
    return _topo().pp_size


def get_pipeline_model_parallel_rank() -> int:
    _topo()
    return 0


def _get_expert_parallel_group(group_name: str = ""):
    return None


def _get_expert_parallel_world_size(group_name: str = "") -> int:
    return _topo().ep_size


def _get_expert_parallel_rank(group_name: str = "") -> int:
    _topo()
    return 0


def _get_expert_data_parallel_group(group_name: str = ""):
    """DP-within-experts: data × subdata (the expert axis is one)."""
    return get_data_parallel_group()


def _get_expert_data_parallel_world_size(group_name: str = "") -> int:
    return _topo().dp_size


def _get_expert_data_parallel_rank(group_name: str = "") -> int:
    return _topo().dp_rank


# -- world --------------------------------------------------------------
def get_world_group():
    topo = _topo()
    return topo.world_group if topo.world_size > 1 else None


def get_world_size() -> int:
    return _topo().world_size
