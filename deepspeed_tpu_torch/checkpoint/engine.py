"""Checkpoint save/load: the pickle engine.

Port of ``deepspeed_tpu/checkpoint/engine.py`` (the reference's
``runtime/engine.py:3610/3262`` save_checkpoint/load_checkpoint): one
pickle a tag, ``<tag>/mp_rank_00_model_states.pt``, and a ``latest``
pointer, with the JAX package's keys (``module``, ``optimizer``,
``loss_scale_state``, ``lr_scheduler``, ``global_steps``, ``micro_steps``,
``skipped_steps``, ``client_state``, ``ds_config``, ``mesh_sizes``).  The
pickle holds plain dicts of numpy arrays, no torch object: ``module`` is
the full fp32 master tree, ``optimizer`` the optimizer state laid out as
the JAX optax chain's (``{"0": {".count", ".mu", ".nu"}}``, the names a
JAX state flattens to: ``0/.count``, ``0/.mu/<param path>``).

Over a data axis the state is split by ZeRO (``resilience/oracle.py``):
every rank gathers each leaf through its split dim, rank 0 writes, and
every rank returns after the save's success is agreed (a collective), so
a failed write raises on every rank.  Over a seq axis the state is whole
on every rank and rank 0 (seq rank 0 of data rank 0) writes.  Loading
reads the full leaves and keeps each rank's slice for the loading
engine's own data axis, on the engine's device.

The leaf naming, the optimizer name maps and the gather live here, shared
by ``fast_engine.py`` and ``universal.py``.
"""

from __future__ import annotations

import os
import pickle
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.utils.logging import log_dist, logger

LATEST_FILE = "latest"
MODEL_FILE = "mp_rank_00_model_states.pt"


@dataclass
class CkptLeaf:
    """One saved leaf of an engine: its name (``module/<path>``,
    ``optimizer/0/.mu/<path>``, ``optimizer/0/.count``), this rank's
    tensor, the dim it is split on over the data axis (None: whole on
    every rank) and its full shape."""
    name: str
    tensor: torch.Tensor
    dim: Optional[int]
    shape: Tuple[int, ...]


@dataclass(frozen=True)
class LeafSpec:
    """A template leaf: the full shape and the numpy dtype a leaf is
    saved as."""
    shape: Tuple[int, ...]
    dtype: np.dtype


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host (bfloat16 widens to float32,
    which holds every bfloat16 value exactly)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a leaf of ``dtype`` is saved as."""
    if dtype == torch.bfloat16:
        return np.dtype(np.float32)
    return torch.empty((), dtype=dtype).numpy().dtype


def nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    """``{"a/b/c": x}`` → ``{"a": {"b": {"c": x}}}``."""
    out: Dict[str, Any] = {}
    for name, v in flat.items():
        node = out
        *head, last = name.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """A nested dict as ``{"a/b/c": leaf}`` (the JAX ``path_str`` names)."""
    out: Dict[str, Any] = {}

    def visit(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                visit(v, path + (str(k),))
        else:
            out["/".join(path)] = node

    visit(tree, (prefix,) if prefix else ())
    return out


# -- optimizer names: the port's state keys as the JAX optax chain's ------
# Both optimizers the port runs are ``optax.chain``s whose first element
# holds every leaf (``deepspeed_tpu/runtime/optimizers.py:58-68`` and the
# fused AdamW chain :118-121: ScaleByAdamState(count, mu, nu); Lion
# :174-177: ScaleByLionState(count, mu)); the weight-decay element after it
# is an EmptyState with no leaves.  Adam with L2 (add_decayed_weights at
# index 0) raises in the port (runtime/optimizers.py), so it has no map.
CHAIN_NAMES = {
    "fused_adamw": {"count": "0/.count", "mu": "0/.mu", "nu": "0/.nu"},
    "fused_lion": {"count": "0/.count", "mu": "0/.mu"},
}


def chain_names(optimizer) -> Dict[str, str]:
    names = CHAIN_NAMES.get(getattr(optimizer, "name", None))
    if names is None:
        raise ValueError(f"optimizer {type(optimizer).__name__} has no "
                         "checkpoint name map (one per optimizer type: "
                         f"{sorted(CHAIN_NAMES)})")
    return names


# -- gather and load -------------------------------------------------------
def _writer(engine) -> bool:
    return engine.topology.rank == 0


def _gather(engine, leaf: CkptLeaf, keep: bool) -> Optional[np.ndarray]:
    """The full value of ``leaf`` as numpy on the host where ``keep``
    (every rank of the ZeRO group joins a split leaf's gather)."""
    import torch.distributed as dist

    from deepspeed_tpu_torch.comm import comm

    t = leaf.tensor.detach()
    if leaf.dim is not None and engine.topology.world_size > 1:
        group = engine.topology.world_group
        if dist.get_backend(group) == "gloo":
            # gloo gathers host tensors: gather there, where the result
            # is wanted, not through pinned staging and back to the card
            t = t.cpu()
        t = comm.all_gather(t, leaf.dim, group)
    return to_numpy(t) if keep else None


def gather_state(engine, keep: bool, optimizer: bool = True
                 ) -> Dict[str, np.ndarray]:
    """``{name: full array}`` of every leaf (on ranks where ``keep``; the
    others join the gathers and get ``{}``)."""
    out = {}
    for leaf in engine._checkpoint_leaves(optimizer=optimizer):
        arr = _gather(engine, leaf, keep)
        if keep:
            out[leaf.name] = arr
    return out


def all_ok(engine, ok: bool) -> bool:
    """True where every rank of the engine's world passed ``ok`` (a
    collective over the world; the answer itself on one rank)."""
    topo = engine.topology
    if topo.world_size <= 1:
        return ok
    import torch.distributed as dist

    dev = engine.device if dist.get_backend() == "nccl" else "cpu"
    flag = torch.tensor([1 if ok else 0], dtype=torch.int32, device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


def _ckpt_path(save_dir: str, tag: str) -> str:
    return os.path.join(save_dir, str(tag), MODEL_FILE)


def read_latest(load_dir: str) -> Optional[str]:
    latest = os.path.join(load_dir, LATEST_FILE)
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        return f.read().strip()


def write_latest(save_dir: str, tag: str) -> None:
    with open(os.path.join(save_dir, LATEST_FILE), "w") as f:
        f.write(str(tag))


def save_checkpoint(engine, save_dir: str, tag: Optional[str] = None,
                    client_state: Optional[Dict[str, Any]] = None) -> str:
    """Gather the state, write ``<tag>/mp_rank_00_model_states.pt`` and
    ``latest`` on rank 0; every rank returns the path once all agree the
    write landed, and raises otherwise."""
    tag = tag if tag is not None else f"global_step{engine.global_steps}"
    path = _ckpt_path(save_dir, tag)
    writer = _writer(engine)
    ok = False
    try:
        t0 = time.perf_counter()
        flat = gather_state(engine, keep=writer)
        gather_s = time.perf_counter() - t0
        if writer:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            module = {k[len("module/"):]: v for k, v in flat.items()
                      if k.startswith("module/")}
            opt = {k[len("optimizer/"):]: v for k, v in flat.items()
                   if k.startswith("optimizer/")}
            state = {
                "module": nest(module),
                "optimizer": nest(opt),
                "loss_scale_state": dict(engine.loss_scale_state),
                "lr_scheduler": engine.lr_scheduler.state_dict(),
                "global_steps": engine.global_steps,
                "micro_steps": engine.micro_steps,
                "skipped_steps": engine.skipped_steps,
                "client_state": client_state or {},
                "ds_config": engine.config.to_dict(),
                "mesh_sizes": dict(engine.topology.sizes),
            }
            with open(path, "wb") as f:
                pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
            write_latest(save_dir, tag)
        # host seconds of this rank's gather and of the whole save
        engine.last_checkpoint_stats = {
            "gather_s": gather_s, "save_s": time.perf_counter() - t0}
        ok = True
    finally:
        # every rank reaches the agreement, even where this rank's write
        # threw: the others must not wait in a collective forever
        agreed = all_ok(engine, ok)
    if not agreed:
        raise RuntimeError(f"checkpoint save of tag '{tag}' failed on "
                           "another rank")
    log_dist(f"saved checkpoint: {path}")
    return path


def load_checkpoint(engine, load_dir: str, tag: Optional[str] = None,
                    load_optimizer_states: bool = True,
                    load_lr_scheduler_states: bool = True):
    """Load a pickle checkpoint into ``engine`` (each rank keeps its slices
    for the engine's own data axis); returns ``(path, client_state)``, or
    ``(None, {})`` with a warning when there is nothing to load."""
    if tag is None:
        tag = read_latest(load_dir)
        if tag is None:
            logger.warning(f"no '{LATEST_FILE}' file in {load_dir}; "
                           "nothing loaded")
            return None, {}
    path = _ckpt_path(load_dir, tag)
    if not os.path.exists(path):
        logger.warning(f"checkpoint {path} not found")
        return None, {}
    with open(path, "rb") as f:
        state = pickle.load(f)
    flat = flatten(state["module"], "module")
    if load_optimizer_states and state.get("optimizer") is not None:
        flat.update(flatten(state["optimizer"], "optimizer"))
    engine._load_leaves(flat, optimizer=load_optimizer_states)
    if "loss_scale_state" in state:
        engine.loss_scale_state = dict(state["loss_scale_state"])
    if load_lr_scheduler_states and state.get("lr_scheduler") is not None:
        engine.lr_scheduler.load_state_dict(state["lr_scheduler"])
    engine.global_steps = int(state.get("global_steps", 0))
    engine.micro_steps = int(state.get("micro_steps", 0))
    log_dist(f"loaded checkpoint: {path} (step {engine.global_steps})")
    return path, state.get("client_state", {})


class PickleCheckpointEngine:
    """The default writer (``checkpoint.writer.type`` ""): the pickle
    ``save_checkpoint``/``load_checkpoint`` above behind the ``save``,
    ``load`` and ``wait`` of the fast and decoupled engines."""

    name = "pickle"

    def save(self, engine, save_dir: str, tag: str,
             client_state: Optional[Dict[str, Any]] = None) -> str:
        return save_checkpoint(engine, save_dir, tag=tag,
                               client_state=client_state)

    def load(self, engine, load_dir: str, tag: Optional[str] = None,
             load_optimizer_states: bool = True,
             load_lr_scheduler_states: bool = True):
        return load_checkpoint(
            engine, load_dir, tag=tag,
            load_optimizer_states=load_optimizer_states,
            load_lr_scheduler_states=load_lr_scheduler_states)

    def wait(self) -> None:  # synchronous engine
        pass


def check_leaf(name: str, arr: np.ndarray, shape, dtype) -> None:
    """Raise (the JAX ``_unflatten_like`` messages) unless ``arr`` has the
    leaf's full ``shape`` and a dtype same-kind castable to ``dtype``."""
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"shape mismatch for '{name}': "
                         f"checkpoint {arr.shape} vs model {tuple(shape)}")
    target = np.dtype(dtype)
    if target != arr.dtype and not np.can_cast(arr.dtype, target,
                                               casting="same_kind"):
        raise ValueError(
            f"dtype mismatch for '{name}': checkpoint {arr.dtype} is not "
            f"same-kind castable to model {target} — the checkpoint "
            "belongs to a differently-typed model")


def check_leaves(leaves: Iterable[CkptLeaf], flat: Dict[str, np.ndarray],
                 what: str = "checkpoint") -> List[Tuple[CkptLeaf, np.ndarray]]:
    """Pair each leaf with its saved full array, checking presence, shape
    and dtype of every one first; raises before anything is changed."""
    pairs = []
    for leaf in leaves:
        if leaf.name not in flat:
            raise KeyError(f"{what} missing entry '{leaf.name}'")
        arr = np.asarray(flat[leaf.name])
        check_leaf(leaf.name, arr, leaf.shape, numpy_dtype(leaf.tensor.dtype))
        pairs.append((leaf, arr))
    return pairs
