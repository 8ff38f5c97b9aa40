"""Fast + decoupled checkpoint engines.

Port of ``deepspeed_tpu/checkpoint/fast_engine.py`` (the reference's
``deepspeed/runtime/checkpoint_engine/``): ``FastCheckpointEngine``
writes one indexed tensor file a tag through the double-buffered
``io.FastFileWriter``, and ``DecoupledCheckpointEngine`` saves on a worker
thread with a commit protocol (ref ``CheckpointCommitInfo`` :15: the
``latest`` pointer only advances after every file of the tag has landed,
so a crash mid-save never leaves a half checkpoint as the resume target).

Leaf names are the JAX package's (``module/<path>``,
``optimizer/0/.mu/<path>``, ``loss_scale/scale``) and so is the file
format, so a tag written by either package reads in the other.  Over a
data axis each rank writes its own file (``model_states_p<rank>.bin``)
holding its slices of the split leaves with their bounds in the full leaf
(``shard_index_p<rank>.json``, the JAX package's multi-process layout),
and rank 0 writes the whole leaves; a load reassembles each leaf and
keeps the loading rank's slice.

The decoupled snapshot is where the port differs: JAX arrays are
immutable, so the JAX engine's snapshot is free, while the port's fused
AdamW and Lion step params and moments in place.  ``save`` therefore
copies every leaf into host memory (pinned for a CUDA tensor) on the
current stream and synchronizes before it returns; only then does the
worker thread write.  ``last_save_blocked_s`` is how long that held the
caller, ``last_write_s`` how long the worker's write took.
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.checkpoint.engine import (CkptLeaf, all_ok,
                                                   read_latest, to_numpy,
                                                   write_latest)
from deepspeed_tpu_torch.io.fast_file_writer import (FastFileWriter,
                                                     read_tensor_entry,
                                                     read_tensor_index,
                                                     write_tensor_file)
from deepspeed_tpu_torch.utils.logging import log_dist, logger


def _flatten(engine) -> "tuple[Dict[str, np.ndarray], Dict[str, Dict]]":
    """This rank's entries and shard index: a split leaf as this rank's
    slice, named ``<leaf>@p<rank>s0`` with its bounds in the full leaf
    (one replica of each slice writes it: MiCS's outer replicas hold the
    same slices); a whole leaf (and the loss-scale state) from rank 0
    only.  One rank: one full entry a leaf."""
    topo = engine.topology
    rank = topo.rank
    entries: Dict[str, np.ndarray] = {}
    index: Dict[str, Dict] = {}
    for leaf in engine._checkpoint_leaves(optimizer=True):
        if leaf.split is None:
            if rank == 0:
                entries[leaf.name] = to_numpy(leaf.tensor)
            continue
        if not leaf.split.writer:
            continue
        dim = leaf.split.dim
        bounds = [[0, s] for s in leaf.shape]
        bounds[dim] = list(leaf.split.bounds(leaf.shape[dim]))
        ename = f"{leaf.name}@p{rank}s0"
        entries[ename] = to_numpy(leaf.tensor)
        index[ename] = {"leaf": leaf.name, "shape": list(leaf.shape),
                        "slices": bounds}
    if rank == 0:
        for k, v in engine.loss_scale_state.items():
            entries[f"loss_scale/{k}"] = np.asarray(v)
    return entries, index


def _as_shape(arr: np.ndarray, shape) -> np.ndarray:
    """``arr`` reshaped to ``shape`` where the element counts agree (else
    as it is, for the shape check to name)."""
    return arr.reshape(shape) if arr.size == int(np.prod(shape)) else arr


class _CheckpointReader:
    """View over every rank's tensor file + shard index in a tag dir: only
    the small JSON indices are read up front; a leaf's bytes are read when
    it is asked for (targeted seeks)."""

    def __init__(self, d: str):
        bins = sorted(glob.glob(os.path.join(d, "model_states*.bin")))
        if not bins:
            raise FileNotFoundError(f"no model_states*.bin under {d}")
        self.entry_meta: Dict[str, tuple] = {}
        for b in bins:
            index, base = read_tensor_index(b)
            for name, m in index.items():
                self.entry_meta[name] = (b, base, m)
        self.shard_index: Dict[str, Dict] = {}
        for j in sorted(glob.glob(os.path.join(d, "shard_index*.json"))):
            with open(j) as f:
                self.shard_index.update(json.load(f))
        self.by_leaf: Dict[str, list] = {}
        for ename, info in self.shard_index.items():
            self.by_leaf.setdefault(info["leaf"], []).append((ename, info))

    def has_prefix(self, prefix: str) -> bool:
        p = prefix + "/"
        return any(n.startswith(p) for n in self.entry_meta) or any(
            i["leaf"].startswith(p) for i in self.shard_index.values())

    def has(self, name: str) -> bool:
        return name in self.by_leaf or (name in self.entry_meta
                                        and name not in self.shard_index)

    def _fetch(self, ename: str) -> np.ndarray:
        path, base, meta = self.entry_meta[ename]
        return read_tensor_entry(path, base, meta)

    def read_leaf(self, name: str) -> np.ndarray:
        if name in self.entry_meta and name not in self.shard_index:
            return self._fetch(name)
        if name in self.by_leaf:
            pieces = self.by_leaf[name]
            shape = tuple(pieces[0][1]["shape"])
            first = self._fetch(pieces[0][0])
            arr = np.empty(shape, first.dtype)
            covered = 0
            for k, (ename, info) in enumerate(pieces):
                data = first if k == 0 else self._fetch(ename)
                sl = tuple(slice(a, b) for a, b in info["slices"])
                arr[sl] = data
                covered += data.size
            if covered < arr.size:
                raise ValueError(f"incomplete shards for '{name}': "
                                 f"{covered}/{arr.size} elements")
            return arr
        raise KeyError(f"checkpoint missing entry '{name}'")


class FastCheckpointEngine:
    """Indexed-binary checkpoint via FastFileWriter (ref
    FastCheckpointEngine): one ``model_states.bin`` per tag (one a rank
    over a data axis) holding params + optimizer state, and a JSON meta
    sidecar."""

    name = "fast"

    def __init__(self, buffer_bytes: int = 32 << 20):
        self.buffer_bytes = buffer_bytes
        self.last_stats: Dict[str, Any] = {}

    def _paths(self, topology, save_dir: str, tag: str):
        d = os.path.join(save_dir, str(tag))
        # per-rank files: ranks on a shared file system must not clobber
        # each other (only 'latest' and meta.json are rank-0 files)
        rank, world = topology.rank, topology.world_size
        stem = "model_states" if world == 1 else f"model_states_p{rank:03d}"
        return (d, os.path.join(d, stem + ".bin"),
                os.path.join(d, "meta.json"),
                os.path.join(d, "shard_index.json" if world == 1
                             else f"shard_index_p{rank:03d}.json"))

    def save(self, engine, save_dir: str, tag: str,
             client_state: Optional[Dict[str, Any]] = None) -> str:
        topo = engine.topology
        d, bin_path, meta_path, idx_path = self._paths(topo, save_dir, tag)
        ok = False
        stats: Dict[str, Any] = {}
        try:
            os.makedirs(d, exist_ok=True)
            # clear a previous save of this tag (possibly from a different
            # rank count: stale files would be merged back in on load);
            # rank 0 cleans, the others wait for it
            if topo.rank == 0:
                for stale in (glob.glob(os.path.join(d, "model_states*.bin"))
                              + glob.glob(os.path.join(d, "shard_index*.json"))):
                    os.unlink(stale)
            ok = True
        finally:
            ok = all_ok(engine, ok)
        if not ok:
            raise RuntimeError(f"fast checkpoint save of tag '{tag}': "
                               "clearing the tag dir failed")
        ok = False
        try:
            tensors, shard_idx = _flatten(engine)
            stats = write_tensor_file(bin_path, tensors, FastFileWriter,
                                      buffer_bytes=self.buffer_bytes)
            if shard_idx or topo.world_size > 1:
                with open(idx_path, "w") as f:
                    json.dump(shard_idx, f)
            if topo.rank == 0:
                meta = {"global_steps": engine.global_steps,
                        "micro_steps": engine.micro_steps,
                        "lr_scheduler": engine.lr_scheduler.state_dict(),
                        "client_state": client_state or {},
                        "mesh_sizes": dict(topo.sizes),
                        "process_count": topo.world_size,
                        "io_stats": stats}
                with open(meta_path, "w") as f:
                    json.dump(meta, f)
            ok = True
        finally:
            # every rank's file must land before the commit: the agreement
            # is reached even where this rank's write threw, and 'latest'
            # advances only when every rank's file landed
            all_landed = all_ok(engine, ok)
        if not all_landed:
            raise RuntimeError(
                f"fast checkpoint save of tag '{tag}' failed on another "
                "rank; 'latest' not advanced")
        if topo.rank == 0:
            write_latest(save_dir, tag)
        self.last_stats = stats
        log_dist(f"fast checkpoint saved: {bin_path} "
                 f"({stats['bytes_written']} bytes)")
        return bin_path

    def load(self, engine, load_dir: str, tag: Optional[str] = None,
             load_optimizer_states: bool = True,
             load_lr_scheduler_states: bool = True):
        if tag is None:
            tag = read_latest(load_dir)
            if tag is None:
                logger.warning(f"no latest in {load_dir}")
                return None, {}
        d, _bin, meta_path, _ = self._paths(engine.topology, load_dir, tag)
        reader = _CheckpointReader(d)
        with_opt = load_optimizer_states and reader.has_prefix("optimizer")
        # the file records a 0-d leaf as shape [1] (np.ascontiguousarray,
        # in both packages): take each leaf in the engine's shape, as the
        # JAX loader reshapes
        flat = {leaf.name: _as_shape(reader.read_leaf(leaf.name), leaf.shape)
                for leaf in engine._checkpoint_leaves(optimizer=with_opt)
                if reader.has(leaf.name)}
        engine._load_leaves(flat, optimizer=with_opt)
        with open(meta_path) as f:
            meta = json.load(f)
        engine.global_steps = int(meta["global_steps"])
        engine.micro_steps = int(meta["micro_steps"])
        if load_lr_scheduler_states and meta.get("lr_scheduler"):
            engine.lr_scheduler.load_state_dict(meta["lr_scheduler"])
        log_dist(f"fast checkpoint loaded: {d}")
        # the tag DIRECTORY: per-rank file names depend on the rank count
        # at save time, which may differ from now
        return d, meta.get("client_state", {})

    def wait(self) -> None:  # synchronous engine
        pass


class _Snapshot:
    """What ``FastCheckpointEngine.save`` reads of an engine, frozen in
    host memory at ``DecoupledCheckpointEngine.save`` time."""

    def __init__(self, engine, leaves: List[CkptLeaf]):
        self._leaves = leaves
        self.topology = engine.topology
        self.global_steps = engine.global_steps
        self.micro_steps = engine.micro_steps
        self.loss_scale_state = dict(engine.loss_scale_state)
        sd = engine.lr_scheduler.state_dict()   # captured now, not at write
        self.lr_scheduler = type("_FrozenSched", (), {
            "state_dict": staticmethod(lambda: sd)})()

    def _checkpoint_leaves(self, optimizer: bool = True) -> List[CkptLeaf]:
        return self._leaves


class DecoupledCheckpointEngine:
    """Asynchronous save with a commit protocol (ref
    DecoupledCheckpointEngine): ``save`` snapshots host copies and
    returns; a worker thread writes them and commits ``latest`` last.
    ``wait()`` blocks until the commit and raises what the worker
    raised."""

    name = "decoupled"

    def __init__(self, inner: Optional[FastCheckpointEngine] = None):
        self.inner = inner or FastCheckpointEngine()
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._host: Dict[str, torch.Tensor] = {}
        self.last_save_blocked_s = 0.0
        self.last_write_s = 0.0

    def _host_copy(self, leaf: CkptLeaf) -> torch.Tensor:
        """``leaf``'s tensor copied into a host buffer kept for the next
        save (pinned for a CUDA tensor), on the current stream."""
        t = leaf.tensor.detach()
        buf = self._host.get(leaf.name)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype,
                              pin_memory=t.device.type == "cuda")
            self._host[leaf.name] = buf
        buf.copy_(t, non_blocking=t.device.type == "cuda")
        return buf

    def save(self, engine, save_dir: str, tag: str,
             client_state: Optional[Dict[str, Any]] = None) -> str:
        self.wait()
        if engine.topology.world_size > 1:
            # the inner save runs collectives (the cleanup and commit
            # agreements) that must not run on a side thread racing the
            # training loop's own: save synchronously, as the JAX engine
            # does over several processes
            logger.warning("decoupled checkpointing is single-rank only; "
                           "falling back to a synchronous save")
            return self.inner.save(engine, save_dir, tag, client_state)
        t0 = time.perf_counter()
        # snapshot NOW: the fused optimizers step params and moments in
        # place, so the write must not read the live tensors
        leaves = [CkptLeaf(leaf.name, self._host_copy(leaf), leaf.split,
                           leaf.shape)
                  for leaf in engine._checkpoint_leaves(optimizer=True)]
        if torch.device(engine.device).type == "cuda":
            torch.cuda.current_stream(engine.device).synchronize()
        snap = _Snapshot(engine, leaves)
        self.last_save_blocked_s = time.perf_counter() - t0

        def work():
            t_write = time.perf_counter()
            try:
                self.inner.save(snap, save_dir, tag, client_state)
            except BaseException as e:  # raised again by wait()
                self._error = e
            self.last_write_s = time.perf_counter() - t_write

        self._worker = threading.Thread(target=work, daemon=True)
        self._worker.start()
        return os.path.join(save_dir, str(tag))

    def load(self, engine, load_dir: str, tag: Optional[str] = None, **kw):
        self.wait()
        return self.inner.load(engine, load_dir, tag, **kw)

    def wait(self) -> None:
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"decoupled checkpoint save failed: {err}")
