"""Rank bodies for ``test_torch_zero_engine.py``, run by
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


def engine_runs(rank, world, runs):
    """``runs``: dicts with ``name``, ``model`` (registry name),
    ``model_kw``, ``params`` (a full tree of CPU tensors, or None for the
    engine's own init), ``cfg``, ``batch`` and ``steps``; with ``grads``
    true the run also returns its params' ``.grad`` after the first step
    (whole at stage 0; before AdamW's steps make the runs' params differ
    by rounding).  Per run: the losses and grad norms of each
    ``train_batch``, whether the fused gather-matmul is on, the warnings the
    engine logged, and the params after the steps, gathered
    (``zero.GatheredParameters``; rank 0's tree, and every rank's checksum
    of it)."""
    torch.set_num_threads(1)
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch import zero
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
                                    model_parameters=run.get("params"),
                                    seed=run.get("seed"))
            losses, norms, grads = [], [], None
            for _ in range(run["steps"]):
                losses.append(float(eng.train_batch(run["batch"])))
                norms.append(eng.get_global_grad_norm())
                if run.get("grads") and grads is None:
                    grads = tf.tree_map_with_path(
                        lambda _p, x: x.grad.detach().numpy().copy(),
                        eng.params)
            with zero.GatheredParameters(eng.params) as full:
                params = _numpy_tree(full)
            res = {"losses": losses, "grad_norms": norms,
                   "fused": bool(eng.model_config.fused_gather_matmul),
                   "warnings": list(warned),
                   "checksum": float(sum(float(np.sum(p, dtype=np.float64))
                                         for p in tf.tree_leaves(params))),
                   "params": params if rank == 0 else None}
            if grads is not None:
                res["grads"] = grads
            out[run["name"]] = res
    finally:
        tlog.logger.warning = orig
    return out
