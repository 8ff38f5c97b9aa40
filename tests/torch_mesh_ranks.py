"""Rank bodies for ``test_torch_mesh_engine.py``, run by
``deepspeed_tpu_torch.launcher`` in spawned CPU ranks over gloo.

Spawned ranks import this module afresh, so it imports no JAX (the tests
that drive it do) and starts nothing when imported.  Every body returns
numpy arrays and plain Python values.
"""

import numpy as np
import torch

PROJ = ("gate", "up", "down")


class LoRAStack:
    """The duck-typed trainable of ``test_torch_linear.py`` (residual
    SwiGLU MLP blocks over quantized frozen bases; the params are the
    adapters), here without the JAX half so that a spawned rank can build
    it."""

    def __init__(self, weights, q_bits, group_size, lora_r):
        import deepspeed_tpu_torch.linear as tlin

        self.lora_config = tlin.LoRAConfig(lora_r=lora_r, delay_lora_init=True)
        qc = tlin.QuantizationConfig(q_bits=q_bits, group_size=group_size)
        self.blocks = [{name: tlin.OptimizedLinear(
            torch.as_tensor(w), lora_config=self.lora_config,
            quantization_config=qc) for name, w in zip(PROJ, block)}
            for block in weights]

    def init(self, generator):
        import deepspeed_tpu_torch.linear as tlin

        return {f"block{i}": {name: tlin.init_lora_params(
            generator, *lin.base.shape, self.lora_config)
            for name, lin in block.items()}
            for i, block in enumerate(self.blocks)}

    def loss(self, params, batch):
        h = batch["x"].float()
        for i, block in enumerate(self.blocks):
            p = params[f"block{i}"]
            g = block["gate"](h, **p["gate"])
            u = block["up"](h, **p["up"])
            h = h + block["down"](torch.nn.functional.silu(g) * u, **p["down"])
        return torch.mean(torch.square(h - batch["y"]))


class Regression:
    """A duck-typed trainable of one leaf, ``lm_head``, which an oracle
    rule names: at ZeRO-3 it is split, and the engine gathers it whole
    before ``loss`` reads it."""

    def __init__(self, hidden, out):
        self.shape = (hidden, out)

    def init(self, generator):
        return {"lm_head": torch.randn(self.shape, generator=generator) * 0.1}

    def loss(self, params, batch):
        return torch.mean(torch.square(batch["x"] @ params["lm_head"]
                                       - batch["y"]))


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def _model(run):
    if "lora" in run:
        return LoRAStack(**run["lora"])
    if "regression" in run:
        return Regression(**run["regression"])
    from deepspeed_tpu_torch.models import get_model_config

    return get_model_config(run["model"], **run.get("model_kw", {}))


def _engine(run, seed=None, cfg=None):
    import deepspeed_tpu_torch as ds

    eng, *_ = ds.initialize(model=_model(run), config=cfg or run["cfg"],
                            device="cpu", model_parameters=run.get("params"),
                            seed=seed if seed is not None else run.get("seed"))
    return eng


def engine_runs(rank, world, runs):
    """``runs``: dicts with ``name``, ``model`` (registry name) and
    ``model_kw``, or ``lora`` (``LoRAStack``'s arguments) or ``regression``
    (``Regression``'s), ``params`` (a full
    tree of CPU tensors, or None), ``cfg``, ``batch`` and ``steps``.  Per
    run: the losses and grad norms of each ``train_batch``, the bucket
    count, whether every all-reduced leaf's gradient is a view of its
    bucket and every reduce-scattered leaf's full gradient was dropped,
    the ring's wire, and the params after the steps, gathered
    (``zero.GatheredParameters``; rank 0's tree, every rank's checksum)."""
    torch.set_num_threads(1)
    from deepspeed_tpu_torch import zero
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models import transformer as tf

    out = {}
    for run in runs:
        eng = _engine(run)
        losses, norms = [], []
        for _ in range(run["steps"]):
            losses.append(float(eng.train_batch(run["batch"])))
            norms.append(eng.get_global_grad_norm())
        with zero.GatheredParameters(eng.params) as full:
            params = _numpy_tree(full)
        views = all(comm._views_of([eng._leaves[i].grad for i in idx], flat)
                    for idx, flat in eng._reduce_buckets)
        dropped = all(eng._leaves[i].grad is None
                      for idx, _dims, _acc in eng._scatter_buckets
                      for i in idx)
        mc = eng.model_config
        out[run["name"]] = {
            "losses": losses, "grad_norms": norms,
            "buckets": eng.grad_bucket_count,
            "reduce_buckets": len(eng._reduce_buckets),
            "scatter_buckets": len(eng._scatter_buckets),
            "grads_are_bucket_views": views,
            "scattered_grads_dropped": dropped,
            "wire": mc.ring_wire_dtype if mc is not None else None,
            "checksum": float(sum(float(np.sum(p, dtype=np.float64))
                                  for p in tf.tree_leaves(params))),
            "params": params if rank == 0 else None}
    return out


def zero_slices(rank, world, runs):
    """Per run (``params``, ``cfg``; no step): this rank's ZeRO state,
    leaf by leaf in path order, as ``(path, what the optimizer steps)``:
    a stage-3 slice, a slice copy of a leaf whose state alone is split,
    or the whole leaf; beside it the shape of its AdamW moment."""
    torch.set_num_threads(1)
    from deepspeed_tpu_torch.models import transformer as tf

    out = {}
    for run in runs:
        eng = _engine(run)
        paths = []
        tf.tree_map_with_path(lambda p, _x: paths.append(p), eng.params)
        masters = tf.tree_leaves(eng._masters)
        moments = tf.tree_leaves(eng.opt_state["mu"])
        out[run["name"]] = [(p, m.detach().numpy().copy(), tuple(mu.shape))
                            for p, m, mu in zip(paths, masters, moments)]
    return out


def _exact(rng, shape):
    """Multiples of 2^-10 below 2^3 in magnitude: sums of a few are exact
    in fp32, whatever their order."""
    return torch.from_numpy(
        (rng.integers(-8192, 8192, shape) / 1024.0).astype(np.float32))


def bucket_cases(rank, world, limits, exact, runs):
    """The flat buckets against the per-leaf collectives over the world,
    for each bucket size of ``limits``: all-reduce (the tensors as views of
    one flat buffer) and the rank-major
    reduce-scatter along dims 0 and 1.  ``exact``: inputs whose sums do not
    depend on the order (``_exact``), else standard normals.  Returns
    ``cases`` (per case, whether every tensor equals the per-leaf result
    bit for bit and the largest difference; the bucket counts) and the
    ``engine_runs`` of ``runs``."""
    torch.set_num_threads(1)
    from deepspeed_tpu_torch.comm import comm

    rng = np.random.default_rng(100 + rank)

    def draw(shape):
        return (_exact(rng, shape) if exact else torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)))

    # all-reduce: a leaf larger than the two smaller buckets, several small
    shapes = [(7, 4), (64, 33), (1000,), (3, 8, 16), (129, 2), (5,)]
    leaves = [draw(s) for s in shapes]
    per_leaf = [t.clone() for t in leaves]
    for t in per_leaf:
        comm.all_reduce(t)
    # reduce-scatter along dims 0 and 1
    rs_shapes = [(8, 12), (4, 16, 8), (world * 6,), (12, world * 10),
                 (world * 64, 3), (2, world * 3, 5)]
    rs_dims = [0, 1, 0, 1, 0, 1]
    rs_leaves = [draw(s) for s in rs_shapes]
    rs_per_leaf = [comm.reduce_scatter(t.clone(), d)
                   for t, d in zip(rs_leaves, rs_dims)]
    # the per-leaf reduce-scatter against the all-reduce's slice
    rs_summed = [comm.all_reduce(t.clone()).chunk(world, d)[rank]
                 for t, d in zip(rs_leaves, rs_dims)]

    def compare(got, want):
        return (all(torch.equal(a, b) for a, b in zip(got, want)),
                max(float((a - b).abs().max()) for a, b in zip(got, want)))

    out = {("reduce_scatter", "per-leaf-vs-all-reduce"):
           compare(rs_per_leaf, rs_summed)}
    for limit in limits:
        plan = comm.plan_buckets([t.numel() for t in leaves], limit)
        flats = []
        for idx in plan:
            flat = torch.cat([leaves[i].reshape(-1) for i in idx])
            flats.append((idx, flat,
                          comm.flat_views(flat, [shapes[i] for i in idx])))
        views = []
        for idx, flat, vs in flats:
            comm.all_reduce_bucket(vs, flat)
            views += vs
        out[("all_reduce", "views", limit)] = compare(views, per_leaf)
        out[("all_reduce", "buckets", limit)] = len(plan)
        slices = []
        rs_plan = comm.plan_buckets([t.numel() for t in rs_leaves], limit)
        for idx in rs_plan:
            seg = comm.reduce_scatter_bucket([rs_leaves[i] for i in idx],
                                             [rs_dims[i] for i in idx])
            slices += comm.flat_views(seg, [rs_per_leaf[i].shape for i in idx])
        out[("reduce_scatter", "rank-major", limit)] = compare(slices,
                                                               rs_per_leaf)
        out[("reduce_scatter", "buckets", limit)] = len(rs_plan)
    return {"cases": out, "runs": engine_runs(rank, world, runs)}


def _copied(state):
    """``gather_state``'s arrays as copies: on the CPU a whole leaf's array
    shares the tensor's memory, which the next steps change."""
    return {k: np.array(v, copy=True) for k, v in state.items()}


def ckpt_save_and_resume(rank, world, run):
    """At ``run["cfg"]``'s mesh: ``steps`` steps, the full state
    gathered (``gather_state``), saves through the pickle engine (then
    converted to universal), the fast engine, ``steps`` more steps; each
    form resumed at the same mesh by a fresh engine of another seed; and,
    with ``jax_universal``, that dir loaded through the config flag at
    the same mesh and ``steps`` steps from it.  Returns the losses, rank 0's gathered
    state, and each resume's losses and state right after its load."""
    torch.set_num_threads(1)
    from deepspeed_tpu_torch.checkpoint.engine import gather_state
    from deepspeed_tpu_torch.checkpoint.fast_engine import FastCheckpointEngine
    from deepspeed_tpu_torch.checkpoint.universal import ds_to_universal

    ckpt, keep = run["ckpt"], rank == 0

    def steps(eng):
        return [float(eng.train_batch(run["batch"]))
                for _ in range(run["steps"])]

    eng = _engine(run, seed=5)
    before = steps(eng)
    saved = _copied(gather_state(eng, keep))
    eng.save_checkpoint(ckpt, tag="pickle")
    ds_to_universal(ckpt, tag="pickle", engine=eng)
    FastCheckpointEngine().save(eng, ckpt, "fast")
    out = {"before": before, "after": steps(eng), "saved": saved,
           "resumed": resume_forms(rank, world, {**run, "params": None},
                                   own_group=False)}
    if run.get("jax_universal"):
        e3 = _engine({**run, "params": None}, seed=7, cfg={
            **run["cfg"], "load_universal_checkpoint": True})
        e3.load_checkpoint(run["jax_universal"])
        out["jax_universal"] = {"global_steps": e3.global_steps,
                                "losses": steps(e3)}
    return out


def resume_forms(rank, world, run, own_group=True):
    """For each form ``ckpt_save_and_resume`` saved under ``run["ckpt"]``:
    a fresh engine of another seed at ``run["cfg"]``'s mesh loads it;
    its gathered state right after the load (rank 0) and the losses of
    ``steps`` steps from there."""
    if own_group:
        torch.set_num_threads(1)
    from deepspeed_tpu_torch.checkpoint.engine import gather_state
    from deepspeed_tpu_torch.checkpoint.fast_engine import FastCheckpointEngine
    from deepspeed_tpu_torch.checkpoint.universal import load_universal

    ckpt = run["ckpt"]
    out = {}
    for form in ("pickle", "fast", "universal"):
        e2 = _engine(run, seed=99)
        if form == "pickle":
            e2.load_checkpoint(ckpt, tag="pickle")
        elif form == "fast":
            FastCheckpointEngine().load(e2, ckpt, "fast")
        else:
            load_universal(e2, f"{ckpt}/pickle/universal")
        state = _copied(gather_state(e2, rank == 0))
        out[form] = {"global_steps": e2.global_steps, "state": state,
                     "losses": [float(e2.train_batch(run["batch"]))
                                for _ in range(run["steps"])]}
    return out
