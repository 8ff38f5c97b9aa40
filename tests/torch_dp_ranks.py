"""Rank bodies for ``test_torch_dp_compression.py``, run by
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


def collectives(rank, world, cases):
    """``cases``: dicts with ``op`` and, per op, the GLOBAL inputs
    ``x`` [world, n] (rank r takes row r) and keywords.  Ops:

    * ``rs``/``ar``: ``quantized_reduce_scatter``/``quantized_all_reduce``
      (``wire``, ``group_size``; ``residual`` [world, n] or None;
      ``steps`` repeats the call feeding the residual back);
    * ``qgz``: ``all_to_all_quant_reduce`` at one level (``group_size``);
    * ``loco``: ``loco_quant_reduce`` with ``err`` [world, n];
    * ``compressed``: ``compressed_allreduce`` with ``werr`` [world, n]
      and ``serr`` [world, n / world], and ``CompressedBackend``'s
      (its size, and whether each output equals the function's);
    * ``a2a``: ``comm.all_to_all`` of ``x`` (any dtype);
    * ``coalesced``: ``reduce_scatter_coalesced`` of the tree ``{"b": x[:5],
      "a": {"w": x[5:].reshape(-1, 3)}}``, then ``all_gather_coalesced``
      of the shard (with ``tree_meta``).

    Returns per case a list of numpy outputs, and the bytes recorded a
    case under each op name (``comm.nbytes()``)."""
    torch.set_num_threads(1)
    from deepspeed_tpu_torch.comm import coalesced_collectives as cc
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.comm import compressed as cp
    from deepspeed_tpu_torch.comm import quantized as tq

    out = []
    for case in cases:
        comm.clear_counts()
        x = torch.tensor(case["x"][rank])
        op = case["op"]
        if op in ("rs", "ar"):
            fn = tq.quantized_reduce_scatter if op == "rs" \
                else tq.quantized_all_reduce
            res = case.get("residual")
            res = None if res is None else torch.tensor(res[rank])
            got = []
            for _ in range(case.get("steps", 1)):
                y, res = fn(x, None, world, wire_dtype=case["wire"],
                            group_size=case["group_size"], residual=res,
                            mean=case.get("mean", True))
                got.append(y.numpy().copy())
            res_np = None if res is None else res.numpy().copy()
            out.append({"out": np.stack(got), "residual": res_np})
        elif op == "qgz":
            shard, _ = cc.all_to_all_quant_reduce(
                {"g": x}, None, None, world, 1,
                group_size=case["group_size"])
            out.append({"out": shard.numpy().copy()})
        elif op == "loco":
            shard, _, err = cc.loco_quant_reduce(
                {"g": x}, {"g": torch.tensor(case["err"][rank])}, None, None,
                world, 1, group_size=case["group_size"])
            out.append({"out": shard.numpy().copy(),
                        "err": err["g"].numpy().copy()})
        elif op == "compressed":
            errs = (torch.tensor(case["werr"][rank]),
                    torch.tensor(case["serr"][rank]))
            avg, werr, serr = cp.compressed_allreduce(x, *errs, None, world)
            backend = cp.CompressedBackend(None, world)
            same = [torch.equal(a, b) for a, b in zip(
                (avg, werr, serr), backend.compressed_allreduce(x, *errs))]
            out.append({"out": avg.numpy().copy(),
                        "werr": werr.numpy().copy(),
                        "serr": serr.numpy().copy(),
                        "backend": (backend.size, same)})
        elif op == "a2a":
            out.append({"out": comm.all_to_all(x).numpy().copy()})
        elif op == "coalesced":
            tree = {"b": x[:5], "a": {"w": x[5:].reshape(-1, 3)}}
            shard, meta = cc.reduce_scatter_coalesced(tree, None, world)
            shapes, dtypes = cc.tree_meta(tree)
            back = cc.all_gather_coalesced(shard, meta, shapes, dtypes)
            out.append({"out": shard.numpy().copy(),
                        "b": back["b"].numpy().copy(),
                        "w": back["a"]["w"].numpy().copy()})
        else:
            raise ValueError(op)
        out[-1]["nbytes"] = comm.nbytes()
    return out


def engine_runs(rank, world, runs):
    """``runs``: dicts with ``name``, ``model`` (registry name),
    ``model_kw``, ``params`` (a full tree of CPU tensors), ``cfg``,
    ``batch`` and ``steps``.  Per run: the losses and grad norms of each
    ``train_batch``, the reduction modes the engine's gates chose, the
    warnings it logged, the bytes a step under each op name of the last
    step (``comm.nbytes()``) and the params after the steps, gathered
    (rank 0's tree, and every rank's checksum of it)."""
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
            losses, norms = [], []
            for _ in range(run["steps"]):
                comm.clear_counts()
                losses.append(float(eng.train_batch(run["batch"])))
                norms.append(eng.get_global_grad_norm())
            with zero.GatheredParameters(eng.params) as full:
                params = _numpy_tree(full)
            out[run["name"]] = {
                "losses": losses, "grad_norms": norms,
                "modes": {"comm_quant": eng._comm_quant is not None,
                          "onebit": eng._onebit_variant,
                          "decomposed": eng._decomposed,
                          "fused_rs": eng._fused_rs,
                          "residual": getattr(eng, "_quant_residual", None)
                          is not None,
                          "scatter_buckets": len(eng._scatter_buckets)},
                "nbytes": comm.nbytes(),
                "warnings": list(warned),
                "checksum": float(sum(float(np.sum(p, dtype=np.float64))
                                      for p in tf.tree_leaves(params))),
                "params": params if rank == 0 else None}
            del eng
    finally:
        tlog.logger.warning = orig
    return out
