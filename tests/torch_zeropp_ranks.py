"""Rank bodies for ``test_torch_zeropp_hier.py``, run by
``deepspeed_tpu_torch.launcher`` in spawned CPU ranks over gloo.

Spawned ranks import this module afresh, so it imports no JAX (the tests
that drive it do) and starts nothing when imported.  Every body returns
numpy arrays and plain Python values.
"""

import numpy as np
import torch


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


def hier_runs(rank, world, runs):
    """``runs``: dicts with ``name``, ``model`` (registry name),
    ``model_kw``, ``params`` (a full tree of CPU tensors, or None), ``cfg``,
    ``batch`` and ``steps``.  Per run: this rank's place (global, inner and
    outer rank), each leaf's layout before any step (param, master and
    AdamW ``mu`` shapes, the full shape) and this rank's master slices
    then; per step the loss, the grad norm and the collectives and bytes
    by group (``comm.group_calls``, ``comm.group_nbytes``); the warnings
    logged;
    and the params after the steps, gathered (rank 0's tree, every rank's
    checksum)."""
    torch.set_num_threads(1)
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch import zero
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models import get_model_config
    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.utils import logging as tlog

    warned = []
    orig = tlog.logger.warning
    tlog.logger.warning = lambda msg, *a, **k: (warned.append(str(msg)),
                                                orig(msg, *a, **k))
    out = {}
    try:
        for run in runs:
            del warned[:]
            model = get_model_config(run["model"], **run.get("model_kw", {}))
            eng, *_ = ds.initialize(model=model, config=run["cfg"],
                                    device="cpu",
                                    model_parameters=run.get("params"))
            topo = eng.topology
            masters = _flat(eng._masters)
            mu = _flat(eng.opt_state["mu"]) if "mu" in eng.opt_state else {}
            layout = {path: {"param": tuple(p.shape),
                             "master": tuple(masters[path].shape),
                             "mu": tuple(mu[path].shape) if path in mu
                             else None,
                             "full": tuple(getattr(p, "ds_full_shape",
                                                   p.shape))}
                      for path, p in _flat(eng.params).items()}
            masters0 = {k: v.detach().numpy().copy()
                        for k, v in masters.items()}
            losses, norms, steps = [], [], []
            for _ in range(run["steps"]):
                comm.clear_counts()
                losses.append(float(eng.train_batch(run["batch"])))
                norms.append(eng.get_global_grad_norm())
                steps.append({"calls": {k: dict(v) for k, v in
                                        comm.group_calls.items()},
                              "nbytes": {k: dict(v) for k, v in
                                         comm.group_nbytes.items()}})
            with zero.GatheredParameters(eng.params) as full:
                params = _numpy_tree(full)
            out[run["name"]] = {
                "place": (topo.rank, topo.inner_rank, topo.outer_rank,
                          topo.inner_size, topo.outer_size),
                "layout": layout, "masters0": masters0,
                "losses": losses, "grad_norms": norms, "steps": steps,
                "onebit": eng._onebit_variant, "qwz": eng._qwz,
                "warnings": list(warned),
                "checksum": float(sum(float(np.sum(p, dtype=np.float64))
                                      for p in tf.tree_leaves(params))),
                "params": params if rank == 0 else None}
            del eng
    finally:
        tlog.logger.warning = orig
    return out


def ckpt_runs(rank, world, run):
    """``torch_mesh_ranks.ckpt_save_and_resume`` at ``run["cfg"]``'s mesh
    (the pickle, universal and fast forms), then the fast checkpoint's
    shard index files and the universal ``meta.json`` as rank 0 reads
    them."""
    import glob
    import json
    import os

    import torch_mesh_ranks

    out = torch_mesh_ranks.ckpt_save_and_resume(rank, world, run)
    if rank == 0:
        index = {}
        for path in sorted(glob.glob(os.path.join(run["ckpt"], "fast",
                                                  "shard_index*.json"))):
            with open(path) as f:
                index[os.path.basename(path)] = json.load(f)
        out["shard_index"] = index
        with open(os.path.join(run["ckpt"], "pickle", "universal",
                               "meta.json")) as f:
            out["universal_meta"] = json.load(f)
    return out
