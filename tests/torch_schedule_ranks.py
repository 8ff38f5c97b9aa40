"""Rank bodies for ``test_torch_zero_schedule.py``, run by
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


def schedule_runs(rank, world, runs):
    """``runs``: dicts with ``name``, ``model`` (registry name),
    ``model_kw``, ``params`` (a full tree of CPU tensors, or None),
    ``cfg``, ``batch`` and ``steps``.  Per run: the losses and grad norms
    of each ``train_batch``; per step the collectives issued
    (``comm.calls()``), the stage-3 gradients in the order the reducer got
    them (their sizes), the reducer's buckets a micro-step, the elements
    of each reduce-scattered bucket, and the buffers every all-gather
    moved (dtype, elements); the engine's
    prefetch depth, qwZ wire, stage-2 scatter buckets, whether the fused
    gather-matmul ran, the warnings it logged; and the params after the
    steps, gathered (rank 0's tree, every rank's checksum)."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch import zero
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models import get_model_config
    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.utils import logging as tlog

    warned, arrived, moved, buckets = [], [], [], []
    orig_warn = tlog.logger.warning
    orig_add = zero.Stage3Reducer.add
    orig_gather = dist.all_gather_into_tensor
    orig_bucket = comm.reduce_scatter_bucket
    tlog.logger.warning = lambda msg, *a, **k: (warned.append(str(msg)),
                                                orig_warn(msg, *a, **k))

    def add(self, grad, piece):
        arrived.append(grad.numel())
        return orig_add(self, grad, piece)

    def gather(out, src, *a, **k):
        moved.append((str(src.dtype), src.numel()))
        return orig_gather(out, src, *a, **k)

    def bucket(tensors, *a, **k):
        buckets.append(sum(t.numel() for t in tensors))
        return orig_bucket(tensors, *a, **k)

    zero.Stage3Reducer.add = add
    dist.all_gather_into_tensor = gather
    comm.reduce_scatter_bucket = bucket
    out = {}
    try:
        for run in runs:
            del warned[:]
            model = get_model_config(run["model"], **run.get("model_kw", {}))
            eng, *_ = ds.initialize(model=model, config=run["cfg"],
                                    device="cpu",
                                    model_parameters=run.get("params"))
            losses, norms, steps = [], [], []
            for _ in range(run["steps"]):
                comm.clear_counts()
                del arrived[:], moved[:], buckets[:]
                losses.append(float(eng.train_batch(run["batch"])))
                norms.append(eng.get_global_grad_norm())
                steps.append({"calls": comm.calls(),
                              "arrived": list(arrived),
                              "buckets": eng.stage3_buckets,
                              "bucket_sizes": list(buckets),
                              "moved": list(moved)})
            with zero.GatheredParameters(eng.params) as full:
                params = _numpy_tree(full)
            mc = eng.model_config
            out[run["name"]] = {
                "losses": losses, "grad_norms": norms, "steps": steps,
                "depth": eng._prefetch_depth, "qwz": eng._qwz,
                "scatter_buckets": len(eng._scatter_buckets),
                "fused": bool(mc.fused_gather_matmul) if mc else False,
                "warnings": list(warned),
                "checksum": float(sum(float(np.sum(p, dtype=np.float64))
                                      for p in tf.tree_leaves(params))),
                "params": params if rank == 0 else None}
    finally:
        tlog.logger.warning = orig_warn
        zero.Stage3Reducer.add = orig_add
        dist.all_gather_into_tensor = orig_gather
        comm.reduce_scatter_bucket = orig_bucket
    return out


def gathered_edits(rank, world, params, cfg):
    """``zero.GatheredParameters``'s ``updated`` tree and
    ``zero.gathered_update`` on a ZeRO-3 engine's params at ``cfg``: the
    same edit through both (``embed/tokens`` row 0 set to 1.5, every
    ``final_norm`` leaf doubled); returns both trees gathered again
    (rank 0) and whether each updated leaf keeps its shard's dim, shape,
    dtype and device."""
    torch.set_num_threads(1)
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch import zero
    from deepspeed_tpu_torch.models import get_model_config
    from deepspeed_tpu_torch.models import transformer as tf

    eng, *_ = ds.initialize(model=get_model_config("gpt2-tiny"), config=cfg,
                            device="cpu", model_parameters=params)

    def edit(full):
        full["embed"]["tokens"][0] = 1.5
        full["final_norm"] = {k: v * 2 for k, v in full["final_norm"].items()}
        return full

    ctx = zero.GatheredParameters(eng.params)
    with ctx as full:
        full["embed"]["tokens"][0] = 1.5
        for k in full["final_norm"]:
            full["final_norm"][k] *= 2
    ctx_tree = ctx.updated
    fn_tree = zero.gathered_update(eng.params, edit)

    def layout_kept(new, old):
        return all(getattr(a, "ds_shard_dim", None)
                   == getattr(b, "ds_shard_dim", None)
                   and a.shape == b.shape and a.dtype == b.dtype
                   and a.device == b.device
                   for a, b in zip(tf.tree_leaves(new), tf.tree_leaves(old)))

    res = {"kept": layout_kept(ctx_tree, eng.params)
           and layout_kept(fn_tree, eng.params)}
    with zero.GatheredParameters(ctx_tree) as full:
        res["updated"] = _numpy_tree(full) if rank == 0 else None
    with zero.GatheredParameters(fn_tree) as full:
        res["gathered_update"] = _numpy_tree(full) if rank == 0 else None
    return res


def gather_bucket_cases(rank, world):
    """``comm.all_gather_bucket`` against one ``comm.all_gather`` a tensor:
    fp32 cast to bf16 as it is packed, fp32, int8 and uint8 payloads, odd
    byte counts, along dims 0, 1 and the last; returns, per tensor, whether
    the two agree bit for bit (dtype and shape included), the blocking and
    the asynchronous call alike."""
    torch.set_num_threads(1)
    from deepspeed_tpu_torch.comm import comm

    gen = torch.Generator().manual_seed(30 + rank)
    tensors = [torch.randn((3, 5), generator=gen),
               torch.randn((2, 7, 3), generator=gen),
               torch.randint(-128, 128, (5, 3), generator=gen,
                             dtype=torch.int8),
               torch.randint(0, 256, (7,), generator=gen, dtype=torch.uint8),
               torch.randn((4, 1), generator=gen)]
    dims = [0, 1, 1, 0, 1]
    dtypes = [torch.bfloat16, None, None, None, None]
    want = [comm.all_gather(t.to(dt or t.dtype), d)
            for t, d, dt in zip(tensors, dims, dtypes)]
    got = comm.all_gather_bucket(tensors, dims, dtypes=dtypes)
    later = comm.all_gather_bucket(tensors, dims, dtypes=dtypes,
                                   async_op=True).wait()
    return [bool(torch.equal(a, w) and torch.equal(b, w)
                 and a.dtype == b.dtype == w.dtype)
            for a, b, w in zip(got, later, want)]
