"""Universal checkpoint: per-parameter atomic format + any-topology reload.

Port of ``deepspeed_tpu/checkpoint/universal.py`` (the reference's UCP,
``deepspeed/checkpoint/ds_to_universal.py``, its loader
``universal_checkpoint.py:22`` and ``utils/zero_to_fp32.py``).  The
converter writes one ``.npy`` per parameter path and per optimizer leaf
from a pickle checkpoint (``checkpoint/engine.py``), whose leaves are
already whole (gathered at save time); a reload keeps each rank's slice
for the loading engine's own data axis (its
:class:`~deepspeed_tpu_torch.resilience.oracle.PartitionOracle` decides),
so a run saved at one data axis resumes at another.  File names, the
``meta.json`` keys and the optimizer names (the JAX optax chain's,
``0/.count``, ``0/.mu/<param path>``) are the JAX package's, so a
universal dir written by either package loads in the other.

Crash atomicity, as in the JAX package: the converter writes into a
``universal.tmp-<pid>`` staging directory, stamps a completion marker
(:data:`COMMIT_MARKER`) as its LAST file, and ``os.replace``s the staged
dir into place (a previous conversion of the tag is swapped aside to
``.old-<pid>`` first, and stale staging dirs of killed conversions are
swept), so the final path either does not exist or is complete.
:func:`resolve_universal_dir` requires the marker and falls back to the
newest committed tag when the ``latest`` pointer names an uncommitted one
(what a worker killed mid-save leaves behind).

Layout:
    <dir>/universal/
        meta.json                 # step counters, config, param manifest
        .committed                # completion marker (written last)
        params/<path>.npy         # fp32 master weights, "/" -> "__"
        optimizer/<name>.npy      # optimizer state leaves, "/" -> "__"
"""

from __future__ import annotations

import glob
import json
import os
import pickle
import shutil
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.checkpoint.engine import (LATEST_FILE, LeafSpec,
                                                   _ckpt_path, all_ok,
                                                   check_leaf, flatten, nest,
                                                   numpy_dtype, read_latest)
from deepspeed_tpu_torch.utils.logging import log_dist, logger

COMMIT_MARKER = ".committed"


class _SizesOnlyTopology:
    """Stand-in for MeshTopology when only axis SIZES matter: the oracle's
    ``flat_specs`` reads nothing else, so the converter records the source
    run's specs without that many ranks."""

    def __init__(self, sizes: Dict[str, int]):
        from deepspeed_tpu_torch.parallel.topology import MESH_AXES

        self.sizes = {ax: int(sizes.get(ax, 1)) for ax in MESH_AXES}

    def axis_size(self, axis: str) -> int:
        return self.sizes[axis]

    @property
    def tp_size(self) -> int:
        return self.sizes["tensor"]

    @property
    def pp_size(self) -> int:
        return self.sizes["pipe"]

    @property
    def ep_size(self) -> int:
        return self.sizes["expert"]

    @property
    def sp_size(self) -> int:
        return self.sizes["seq"]


def _spec_str(oracle, path: str, shape: Tuple[int, ...],
              dim: Optional[int]) -> str:
    """A split dim written as the JAX package writes its PartitionSpec
    (``PartitionSpec()`` where no rule names the path, else one entry a
    dim), so the two packages' ``source_specs`` read alike."""
    if oracle._logical_dims(path, len(shape)) is None:
        return "PartitionSpec()"
    parts: list = [None] * len(shape)
    if dim is not None:
        axes = oracle.fsdp_axes()
        parts[dim] = axes[0] if len(axes) == 1 else tuple(axes)
    return "PartitionSpec" + repr(tuple(parts))


def _source_specs(mesh_sizes: Dict[str, int], ds_config: Dict[str, Any],
                  manifest: Dict[str, Tuple[int, ...]]) -> Dict[str, str]:
    """The source run's oracle-derived param specs, recorded for
    forensics: a resumed engine can diff its own oracle's answers against
    what the saving run intended."""
    from deepspeed_tpu_torch.resilience.oracle import PartitionOracle

    topo = _SizesOnlyTopology(mesh_sizes or {})
    try:
        # the engine's own construction recipe (the step_schedule
        # persistence override included)
        from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

        oracle = PartitionOracle.from_config(topo, DeepSpeedConfig(ds_config))
    except Exception as e:
        # a partial or foreign ds_config must not make the checkpoint
        # unconvertible: degrade to the static zero block
        logger.warning(f"source_specs: ds_config no longer parses, "
                       f"falling back to the static zero block ({e})")
        zc = (ds_config or {}).get("zero_optimization", {}) or {}
        oracle = PartitionOracle(
            topo, zero_stage=int(zc.get("stage", 0)),
            persist_threshold=int(zc.get("param_persistence_threshold", 0) or 0))
    return {k: _spec_str(oracle, k, tuple(manifest[k]), v)
            for k, v in oracle.flat_specs(manifest).items()}


def _save_flat(flat: Dict[str, np.ndarray], root: str) -> None:
    for path, arr in flat.items():
        fname = os.path.join(root, path.replace("/", "__") + ".npy")
        np.save(fname, arr)


def _load_flat(root: str) -> Dict[str, np.ndarray]:
    out = {}
    for fname in sorted(os.listdir(root)):
        if fname.endswith(".npy"):
            out[fname[:-4].replace("__", "/")] = np.load(os.path.join(root, fname))
    return out


def is_committed(universal_dir: str) -> bool:
    """A universal dir is readable iff its completion marker exists."""
    return (os.path.exists(os.path.join(universal_dir, "meta.json"))
            and os.path.exists(os.path.join(universal_dir, COMMIT_MARKER)))


def _ranks_share(engine) -> bool:
    """Whether a live engine's ranks call the conversion together."""
    return engine is not None and engine.topology.world_size > 1


def ds_to_universal(ckpt_dir: str, tag: Optional[str] = None,
                    output_dir: Optional[str] = None, engine=None) -> str:
    """Convert a saved pickle checkpoint to the universal per-param format
    (ref ds_to_universal.py main flow).  Crash-atomic: everything lands in
    a staging dir that is renamed into place only after the completion
    marker is written.  Called from every rank of a live engine's world
    (``engine`` given), rank 0 converts and the others return after it
    has, raising where it failed."""
    if tag is None:
        tag = read_latest(ckpt_dir)
        if tag is None:
            raise FileNotFoundError(f"no '{LATEST_FILE}' file in {ckpt_dir}")
    out = output_dir or os.path.join(ckpt_dir, str(tag), "universal")
    if _ranks_share(engine) and engine.topology.rank != 0:
        if not all_ok(engine, True):
            raise RuntimeError("universal conversion failed on rank 0")
        return out

    staging = f"{out}.tmp-{os.getpid()}"
    ok = False
    try:
        with open(_ckpt_path(ckpt_dir, tag), "rb") as f:
            state = pickle.load(f)

        # sweep debris from earlier killed conversions (any pid): torn
        # staging dirs and aside dirs a swap never finished deleting
        for stale in glob.glob(f"{out}.tmp-*") + glob.glob(f"{out}.old-*"):
            shutil.rmtree(stale, ignore_errors=True)
        if os.path.exists(staging):
            shutil.rmtree(staging)
        os.makedirs(os.path.join(staging, "params"))
        os.makedirs(os.path.join(staging, "optimizer"))

        params_flat = {k: np.asarray(v)
                       for k, v in flatten(state["module"]).items()}
        _save_flat(params_flat, os.path.join(staging, "params"))
        opt_flat = {k: np.asarray(v)
                    for k, v in flatten(state["optimizer"]).items()}
        _save_flat(opt_flat, os.path.join(staging, "optimizer"))

        manifest = {k: tuple(v.shape) for k, v in params_flat.items()}
        meta = {
            "global_steps": state.get("global_steps", 0),
            "micro_steps": state.get("micro_steps", 0),
            "lr_scheduler": state.get("lr_scheduler"),
            "loss_scale_state": {k: float(np.asarray(v))
                                 for k, v in state.get("loss_scale_state",
                                                       {}).items()},
            "param_manifest": {k: list(v) for k, v in manifest.items()},
            "param_dtypes": {k: str(v.dtype) for k, v in params_flat.items()},
            "opt_treedef_leaves": len(opt_flat),
            "ds_config": state.get("ds_config", {}),
            "source_mesh": state.get("mesh_sizes", {}),
            "source_specs": _source_specs(state.get("mesh_sizes", {}),
                                          state.get("ds_config", {}),
                                          manifest),
        }
        with open(os.path.join(staging, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2)
        # marker LAST, then the atomic publish: the final path either
        # doesn't exist or is complete (a mid-save kill leaves only a
        # .tmp-* dir, which resolve_universal_dir never reads)
        with open(os.path.join(staging, COMMIT_MARKER), "w") as f:
            json.dump({"time_unix": time.time(), "pid": os.getpid()}, f)
        old = None
        if os.path.exists(out):
            # swap the previous conversion ASIDE (one rename) instead of
            # deleting it first: a kill during a tree delete would destroy
            # the only committed copy of this tag while the new one sits
            # unpublished in staging
            old = f"{out}.old-{os.getpid()}"
            if os.path.exists(old):
                shutil.rmtree(old)
            os.replace(out, old)
        os.replace(staging, out)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
        ok = True
    finally:
        if not ok and os.path.isdir(staging):
            shutil.rmtree(staging, ignore_errors=True)
        if _ranks_share(engine):
            # ALWAYS release the other ranks, and tell them whether the
            # conversion succeeded
            all_ok(engine, ok)
    log_dist(f"universal checkpoint written: {out}")
    return out


def _scan_committed(load_dir: str) -> Optional[str]:
    """Newest committed ``<load_dir>/<tag>/universal`` by step count
    (mtime breaks ties): the fall-back when the ``latest`` pointer names a
    tag whose conversion never committed."""
    best = None
    best_key = None
    try:
        tags = sorted(os.listdir(load_dir))
    except OSError:
        return None
    for t in tags:
        cand = os.path.join(load_dir, t, "universal")
        if not is_committed(cand):
            continue
        try:
            with open(os.path.join(cand, "meta.json")) as f:
                steps = int(json.load(f).get("global_steps", 0))
        except (OSError, ValueError):
            continue
        key = (steps, os.path.getmtime(os.path.join(cand, COMMIT_MARKER)))
        if best_key is None or key > best_key:
            best, best_key = cand, key
    return best


def resolve_universal_dir(load_dir: str, tag: Optional[str] = None) -> str:
    """Accept the universal dir itself, a checkpoint root (+tag), or a
    root with a ``latest`` file.  Uncommitted dirs (no completion marker:
    a save died mid-write) are SKIPPED: when ``latest`` names a torn tag,
    the newest committed tag under the root wins.  An explicitly requested
    ``tag`` never falls back: a missing requested tag raises."""
    if os.path.exists(os.path.join(load_dir, "meta.json")):
        if not is_committed(load_dir):
            raise FileNotFoundError(
                f"universal checkpoint {load_dir} is uncommitted "
                f"(missing {COMMIT_MARKER}) — either the save died "
                f"mid-write, or the dir predates the crash-atomic commit "
                f"protocol; re-run ds_to_universal on the source "
                f"checkpoint to regenerate it")
        return load_dir
    explicit_tag = tag is not None
    if tag is None:
        tag = read_latest(load_dir)
    if tag is not None:
        cand = os.path.join(load_dir, str(tag), "universal")
        if is_committed(cand):
            return cand
        if explicit_tag:
            # a caller-requested tag is a contract: resuming from another
            # (older) committed tag would load the wrong checkpoint
            raise FileNotFoundError(
                f"universal checkpoint for requested tag {tag!r} is "
                f"missing or uncommitted under {load_dir}")
        fallback = _scan_committed(load_dir)
        if fallback is not None:
            logger.warning(
                f"universal checkpoint for tag {tag!r} is missing or "
                f"uncommitted; resuming from {fallback} instead")
            return fallback
    else:
        fallback = _scan_committed(load_dir)
        if fallback is not None:
            return fallback
    raise FileNotFoundError(f"no committed universal checkpoint under "
                            f"{load_dir} (tag={tag})")


def load_universal(engine, universal_dir: str) -> None:
    """Load a universal checkpoint into an engine of ANY data axis (ref
    load_hp_checkpoint_state, universal_checkpoint.py:22): each rank keeps
    its slice of every leaf along the split dim its own oracle gives, on
    the engine's device.  Every leaf is shape- and dtype-checked against
    the engine's template before any state changes."""
    universal_dir = resolve_universal_dir(universal_dir)
    with open(os.path.join(universal_dir, "meta.json")) as f:
        meta = json.load(f)

    params_flat = _load_flat(os.path.join(universal_dir, "params"))
    params = _unflatten_like(_params_template(engine), params_flat,
                             what="params")

    opt_flat = _load_flat(os.path.join(universal_dir, "optimizer"))
    opt_template = engine._opt_state_template()
    opt_state = None
    if opt_flat and opt_template is not None:
        opt_state = _unflatten_like(opt_template, opt_flat, what="optimizer")

    # both trees checked: only now change the engine
    flat = flatten(params, "module")
    if opt_state is not None:
        flat.update(flatten(opt_state, "optimizer"))
    engine._load_leaves(flat, optimizer=opt_state is not None)

    ls = meta.get("loss_scale_state")
    if ls:
        engine.loss_scale_state = {
            "scale": np.asarray(ls.get("scale", 1.0), np.float32),
            "good_steps": np.asarray(int(ls.get("good_steps", 0)), np.int32),
            "skipped": np.asarray(int(ls.get("skipped", 0)), np.int32)}
    if meta.get("lr_scheduler"):
        engine.lr_scheduler.load_state_dict(meta["lr_scheduler"])
    engine.global_steps = int(meta.get("global_steps", 0))
    engine.micro_steps = int(meta.get("micro_steps", 0))
    log_dist(f"universal checkpoint loaded from {universal_dir} "
             f"(source mesh {meta.get('source_mesh')} → "
             f"{engine.topology.sizes})")


def _params_template(engine):
    """The engine's param tree as :class:`LeafSpec` leaves of full
    shape."""
    return nest({leaf.name[len("module/"):]: LeafSpec(
        leaf.shape, numpy_dtype(leaf.tensor.dtype))
        for leaf in engine._checkpoint_leaves(optimizer=False)})


def _unflatten_like(template, flat: Dict[str, np.ndarray],
                    what: str = "checkpoint"):
    """Rebuild a tree with ``template``'s structure from a path→array
    dict, validating every leaf's shape and dtype compatibility first
    (``template`` leaves: anything with ``shape`` and ``dtype``)."""
    out: Dict[str, np.ndarray] = {}
    for key, leaf in flatten(template).items():
        if key not in flat:
            raise KeyError(f"universal {what} missing entry '{key}'")
        arr = flat[key]
        check_leaf(key, arr, leaf.shape, leaf.dtype)
        out[key] = arr.astype(leaf.dtype, copy=False)
    return nest(out)


def zero_to_fp32(ckpt_dir: str, output_file: str,
                 tag: Optional[str] = None) -> str:
    """Offline consolidation to a single fp32 state dict file (ref
    utils/zero_to_fp32.py): a flat ``{path: np.float32 array}`` pickle
    loadable without the engine."""
    if tag is None:
        tag = read_latest(ckpt_dir)
        if tag is None:
            raise FileNotFoundError(f"no '{LATEST_FILE}' file in {ckpt_dir}")
    with open(_ckpt_path(ckpt_dir, tag), "rb") as f:
        state = pickle.load(f)
    flat = {k: np.asarray(v).astype(np.float32)
            for k, v in flatten(state["module"]).items()}
    with open(output_file, "wb") as f:
        pickle.dump(flat, f, protocol=pickle.HIGHEST_PROTOCOL)
    log_dist(f"fp32 consolidated state dict: {output_file} ({len(flat)} tensors)")
    return output_file
