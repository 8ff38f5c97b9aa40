"""The port's engine over data × seq meshes, ZeRO over both axes and the
flat buckets of the gradient reduction, against the JAX engine, on the
CPU.

The port trains in spawned gloo CPU ranks (rank bodies in
``torch_mesh_ranks.py``) from the JAX engine's initial params
(``params_from_jax``) on the same global batch as the JAX engine on the
conftest's CPU devices:

* llama-tiny, ``seq_impl="ring"``, striped and contiguous, at
  ``{"data": 2, "seq": 2}`` (four ranks, one launch) against the JAX mesh
  ``{"data": 2, "seq": 2}``, ZeRO stages 0-3;
* ZeRO-2 over ``{"seq": 2}``, the fp32 and the int8 ring wire (``bench.py``'s
  ring row at tiny size), against the JAX engine on ``{"seq": 2}``;
* a duck-typed trainable (the LoRA stack of ``test_torch_linear.py``) at
  ``{"data": 2}`` against the JAX engine at ``{"data": 2}``.

Tolerances are those of ``test_torch_zero_engine.py``: losses and grad
norms to 1e-5 relative (fp32), the params after the steps with each leaf's
update within 1e-3 relative L2 of the JAX engine's (but ``NO_GRADIENT``'s
leaves, whose gradient is zero up to rounding) and every element within
lr; the int8 wire at ``test_torch_ring_engine.py``'s ``WIRE_RTOL``.  The
ZeRO state at ``{"data": 2, "seq": 2}`` is split four ways as the JAX
``NamedSharding`` over ``(data, seq)`` splits it, leaf by leaf.

The flat buckets equal the per-leaf collectives bit for bit on 2 and 4
ranks at three bucket sizes (below the largest leaf, spanning several
leaves, one bucket), for the all-reduce and the rank-major reduce-scatter
along dims 0 and 1.  On 4 ranks gloo's all-reduce sums an element in an
order that depends on where it lies in the buffer (a bucket and a per-leaf
call differed by 4.8e-7 on standard normals), so there the inputs are
multiples of 2^-10, whose sums are exact in any order and hold the layout
bit for bit; on 2 ranks a sum has two terms and standard normals are used.
Whole ``train_batch`` runs at those sizes and at the per-leaf size 1
equal the run at ``reduce_bucket_size`` 500,000,000 bit for bit on 2
ranks (stages 1 and 2), and on 4 ranks at stage 2, whose buckets are
reduce-scattered by the point-to-point ring.  On 4 ranks at stage 1,
whose buckets gloo all-reduces, bit for bit equality holds only on exact
inputs: the runs are held to ``SUM_ORDER_RTOL`` instead.

Checkpoints over the ZeRO world: a ZeRO-2 run saved at ``{"data": 2,
"seq": 2}`` resumes from its pickle, fast and universal forms at that
mesh, at ``{"seq": 2}`` and at data 1 with every saved leaf bit for bit;
at its own mesh its losses bit for bit, at the others equal across the
forms and within 1e-5 of its own (another summation order).  A JAX
universal checkpoint loads into the port at ``{"data": 2, "seq": 2}`` and
continues within 1e-5 of the JAX engine.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu as dsj
import deepspeed_tpu_torch as dst
from deepspeed_tpu.checkpoint import universal as jun
from deepspeed_tpu.models import get_model_config as jax_model_config
from deepspeed_tpu.parallel import topology as jtopology
from deepspeed_tpu_torch.launcher import launch
from deepspeed_tpu_torch.models import get_model_config
from deepspeed_tpu_torch.models.bridge import params_from_jax

import torch_mesh_ranks
from test_torch_engine_v2 import one_torch_thread  # noqa: F401
from test_torch_linear import JaxLoRAStack, _adapters, _stack_weights
from test_torch_ring_engine import WIRE_RTOL

LR = 2e-3
CFG = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
       "optimizer": {"type": "AdamW", "params": {"lr": LR,
                                                 "weight_decay": 0.1}},
       "gradient_clipping": 1.0, "steps_per_print": 10_000,
       "activation_checkpointing": {"remat_policy": "none"}}
MESH = {"data": 2, "seq": 2}
STEPS = 2
SEQ = 32
PLACEMENTS = ("contiguous", "striped")
# A key bias's gradient is zero up to rounding (the softmax cancels it);
# llama-tiny has none, gpt2-tiny has one.
NO_GRADIENT = {("layers", "attn", "bk")}
RING = {"seq_impl": "ring"}
# Whole runs whose all-reduce sums in another order (4 gloo ranks, buckets
# against per-leaf calls): losses, grad norms and each leaf's update
# relative to the reference run.  Each fp32 sum of four terms may differ
# by 2 (4 - 1) 2^-24 of its magnitude from another order; two AdamW steps
# and the clipping carry that through: 1.0e-7 in a loss, 7.3e-8 in a grad
# norm and 4.1e-6 in a leaf's update at most, measured on this test's runs.
# The file's fp32 tolerance.
SUM_ORDER_RTOL = 1e-5


def _batch(rows, seed=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, (rows, SEQ + 1)).astype(np.int32)
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:].copy()}
    batch["labels"][0, :5] = -100         # the global token count matters
    return batch


def _zero(stage, mesh=MESH, **extra):
    return {**CFG, "mesh": dict(mesh), **extra,
            "zero_optimization": {"stage": stage,
                                  "param_persistence_threshold": 0}}


def _jax_mesh(cfg):
    """The JAX config of a port config: a mesh without ``data`` gets
    ``data: 1`` (it defaults to -1, which would take every CPU device)."""
    return {**cfg, "mesh": {"data": 1, **cfg["mesh"]}}


def _jax_run(model, cfg, batch, steps=STEPS, seed=5):
    try:
        eng, *_ = dsj.initialize(model=model, seed=seed, config=_jax_mesh(cfg))
        p0 = jax.tree.map(np.asarray, eng.params)
        losses, norms = [], []
        for _ in range(steps):
            losses.append(float(np.asarray(eng.train_batch(batch))))
            norms.append(eng.get_global_grad_norm())
        return {"p0": p0, "losses": losses, "grad_norms": norms,
                "params": jax.tree.map(np.asarray, eng.params)}
    finally:
        jtopology.set_topology(None)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _check(got, want, rtol=(1e-5, 1e-5), params=True, lr=LR,
           no_gradient=NO_GRADIENT):
    """Losses and grad norms (``rtol`` per step), then the params: every
    element within ``lr``, and each leaf's update within 1e-3 relative L2
    but the leaves of ``no_gradient`` (True: held elementwise only)."""
    for i, tol in enumerate(rtol[:len(want["losses"])]):
        assert got["losses"][i] == pytest.approx(want["losses"][i], rel=tol)
        assert got["grad_norms"][i] == pytest.approx(want["grad_norms"][i],
                                                     rel=tol)
    assert got["losses"][-1] < got["losses"][0]
    if not params:
        return
    for path, a in _paths(want["params"]):
        mine = _get(got["params"], path)
        update = a - _get(want["p0"], path)
        if no_gradient is not True and path not in no_gradient:
            assert np.linalg.norm(mine - a) <= 1e-3 * np.linalg.norm(update), path
        assert np.abs(mine - a).max() <= lr, path


def _same_on_every_rank(ranks, name):
    first = ranks[0][name]
    for r in ranks[1:]:
        assert r[name]["losses"] == first["losses"], name
        assert r[name]["checksum"] == first["checksum"], name


# ----------------------------------------------------------------------
# data x seq, ZeRO over both axes
# ----------------------------------------------------------------------
def test_data_by_seq_mesh_matches_the_jax_mesh():
    """Four ranks at ``{"data": 2, "seq": 2}``, llama-tiny's ring under
    both placements, stages 0-3 (one launch), each against the JAX engine
    on the same mesh and stage.  Stages 0/1 all-reduce whole leaves whose
    gradients are views of their bucket; stages 2/3 reduce-scatter and
    drop the full gradients."""
    batch = _batch(CFG["train_micro_batch_size_per_gpu"]
                   * CFG["gradient_accumulation_steps"] * MESH["data"])
    # the JAX init depends on the seed only: the port's ranks train from
    # it while the JAX engines run here
    p0 = jax.tree.map(np.asarray, _jax_init("llama-tiny", RING))
    params = params_from_jax(p0, get_model_config("llama-tiny"), device="cpu")
    configs = {f"{placement}-stage{stage}": (placement, _zero(stage))
               for placement in PLACEMENTS for stage in range(4)}
    runs = [{"name": name, "model": "llama-tiny",
             "model_kw": {**RING, "ring_placement": placement},
             "params": params, "cfg": cfg, "batch": batch, "steps": STEPS}
            for name, (placement, cfg) in configs.items()]
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(launch, torch_mesh_ranks.engine_runs, 4,
                           args=(runs,), backend="gloo", device="cpu")
        wants = {name: _jax_run(jax_model_config(
            "llama-tiny", **RING, ring_placement=placement), cfg, batch)
            for name, (placement, cfg) in configs.items()}
        ranks = port.result()
    for name, want in wants.items():
        for path, a in _paths(want["p0"]):
            np.testing.assert_array_equal(_get(p0, path), a)
        got = ranks[0][name]
        _check(got, want)
        _same_on_every_rank(ranks, name)
        stage = int(name[-1])
        # every llama-tiny leaf divides by 4: stage 2 splits all of them,
        # stage 3 too, and its slices' gradients are reduced by the gathers
        buckets = {0: (1, 0), 1: (1, 0), 2: (0, 1), 3: (0, 0)}[int(name[-1])]
        assert (got["reduce_buckets"], got["scatter_buckets"]) == buckets
        assert got["grads_are_bucket_views"]
        assert got["scattered_grads_dropped"]


def test_zero2_over_a_seq_axis_matches_the_jax_seq_mesh():
    """``bench.py``'s ring row at tiny size: ZeRO-2 over ``{"seq": 2}``,
    striped, the fp32 and the int8 ring wire, in one launch; each against
    the JAX engine on ``{"seq": 2}``."""
    batch = _batch(CFG["train_micro_batch_size_per_gpu"]
                   * CFG["gradient_accumulation_steps"])
    kw = {**RING, "ring_placement": "striped"}
    runs, wants = [], {}
    for wire in ("fp32", "int8"):
        extra = ({} if wire == "fp32" else {"comm_quantization": {
            "enabled": True, "ring_rotation": wire}})
        cfg = _zero(2, {"seq": 2}, **extra)
        wants[wire] = _jax_run(jax_model_config("llama-tiny", **kw), cfg,
                               batch, seed=7)
        runs.append({"name": wire, "model": "llama-tiny", "model_kw": kw,
                     "params": params_from_jax(wants[wire]["p0"],
                                               get_model_config("llama-tiny"),
                                               device="cpu"),
                     "cfg": cfg, "batch": batch, "steps": STEPS})
    ranks = launch(torch_mesh_ranks.engine_runs, 2, args=(runs,),
                   backend="gloo", device="cpu")
    _check(ranks[0]["fp32"], wants["fp32"])
    # the int8 wire: the second step after an AdamW step from grads whose
    # traveling dk/dv may hold an element one wire step apart
    _check(ranks[0]["int8"], wants["int8"], rtol=WIRE_RTOL, params=False)
    for wire in ("fp32", "int8"):
        _same_on_every_rank(ranks, wire)
        assert ranks[0][wire]["wire"] == wire
        assert ranks[0][wire]["scatter_buckets"] == 1


def test_duck_typed_trainable_over_a_data_axis_matches_jax():
    """The LoRA stack (int8 bases) at ``{"data": 2}``: each rank's loss on
    its half of the rows, the gradients averaged, against the JAX engine's
    loss over the sharded batch, three steps; the adapters match no oracle
    rule and stay whole (AdamW state too).  In the same launch a
    trainable whose one leaf an oracle rule splits (``lm_head``) trains
    at ZeRO-3, gathered whole for its ``loss``, as in this process at
    data 1 (losses and params within 1e-6).  The adapters are held
    elementwise within lr: already at data 1 one element of
    ``block1/gate/lora_A`` lands 1.3e-3 away from the JAX engine's after
    one step (its gradient sits next to zero and AdamW's first step moves
    it by lr on its sign), 5.8e-3 of that leaf's update in L2, while the
    JAX engine's own data 1 and data 2 runs differ by at most 3.9e-4."""
    hidden, inter, blocks, r = 64, 128, 2, 8
    weights = _stack_weights(hidden, inter, blocks, seed=10)
    adapters = _adapters(hidden, inter, blocks, r, seed=11)
    cfg = {**CFG, "mesh": {"data": 2}, "zero_optimization": {"stage": 2},
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}}}
    rng = np.random.default_rng(12)
    rows = 2 * 2 * 2
    batch = {"x": rng.standard_normal((rows, 8, hidden)).astype(np.float32),
             "y": rng.standard_normal((rows, 8, hidden)).astype(np.float32)}
    try:
        jeng, *_ = dsj.initialize(
            model=JaxLoRAStack(weights, 8, 64, r), config=cfg,
            model_parameters=jax.tree.map(jax.numpy.asarray, adapters))
        want = {"losses": [], "grad_norms": []}
        for _ in range(3):
            want["losses"].append(float(np.asarray(jeng.train_batch(batch))))
            want["grad_norms"].append(jeng.get_global_grad_norm())
        want["params"] = jax.tree.map(np.asarray, jeng.params)
    finally:
        jtopology.set_topology(None)
    want["p0"] = adapters
    run = {"name": "lora", "lora": {"weights": weights, "q_bits": 8,
                                    "group_size": 64, "lora_r": r},
           "params": params_from_jax(adapters, None, device="cpu"),
           "cfg": cfg, "batch": batch, "steps": 3}
    reg = {"name": "regression", "regression": {"hidden": 16, "out": 6},
           "params": {"lm_head": torch.from_numpy(
               rng.standard_normal((16, 6)).astype(np.float32))},
           "cfg": {**_zero(3, {"data": 2}), "train_micro_batch_size_per_gpu": 2},
           "batch": {"x": rng.standard_normal((rows, 16)).astype(np.float32),
                     "y": rng.standard_normal((rows, 6)).astype(np.float32)},
           "steps": 3}
    ranks = launch(torch_mesh_ranks.engine_runs, 2, args=([run, reg],),
                   backend="gloo", device="cpu")
    got = ranks[0]["lora"]
    _check(got, want, rtol=(1e-5,) * 3, lr=1e-2, no_gradient=True)
    _same_on_every_rank(ranks, "lora")
    assert got["reduce_buckets"] == 1 and got["scatter_buckets"] == 0
    one, *_ = dst.initialize(
        model=torch_mesh_ranks.Regression(16, 6), device="cpu",
        config={**reg["cfg"], "mesh": {"data": 1},
                "train_micro_batch_size_per_gpu": 4},
        model_parameters={"lm_head": reg["params"]["lm_head"].clone()})
    losses = [float(one.train_batch(reg["batch"])) for _ in range(3)]
    got = ranks[0]["regression"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-6)
    np.testing.assert_allclose(got["params"]["lm_head"],
                               one.params["lm_head"].detach().numpy(),
                               rtol=1e-6, atol=1e-7)
    # the leaf was a ZeRO-3 slice: its gradient took no bucket
    assert got["reduce_buckets"] == got["scatter_buckets"] == 0


# ----------------------------------------------------------------------
# the ZeRO world's split against the JAX NamedSharding
# ----------------------------------------------------------------------
def _jax_shard_index(tree, mesh):
    """``{path: {shard index over (data, seq): index tuple}}`` of every
    array of ``tree`` (dict keys only in the paths)."""
    names = mesh.axis_names
    rank_of = {}
    for pos in np.ndindex(mesh.devices.shape):
        rank_of[mesh.devices[pos]] = (pos[names.index("data")] * MESH["seq"]
                                      + pos[names.index("seq")])
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = tuple(k.key for k in path if isinstance(k, jax.tree_util.DictKey))
        out[keys] = {rank_of[d]: idx for d, idx in
                     leaf.sharding.devices_indices_map(leaf.shape).items()}
    return out


def test_zero_world_split_matches_the_jax_named_sharding():
    """At ``{"data": 2, "seq": 2}`` each rank's ZeRO state, leaf by leaf,
    is the slice the JAX engine's sharding over ``(data, seq)`` gives its
    device: the stage-3 params (JAX params) and the stage-2 optimizer
    slices (JAX AdamW ``mu``), whole leaves included (gpt2-tiny with
    ``intermediate_size`` 102: its MLP bias does not divide by 4).  Every
    AdamW moment has its master's shape."""
    kw = {**RING, "intermediate_size": 102}
    runs, want = [], {}
    for stage in (2, 3):
        cfg = _zero(stage)
        try:
            jeng, *_ = dsj.initialize(model=jax_model_config("gpt2-tiny", **kw),
                                      seed=5, config=cfg)
            mesh = jtopology.get_topology().mesh
            p0 = jax.tree.map(np.asarray, jeng.params)
            mu = [s for s in jax.tree_util.tree_leaves(
                jeng.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(s, "mu")][0].mu
            want[stage] = (p0, _jax_shard_index(
                jeng.params if stage == 3 else mu, mesh))
        finally:
            jtopology.set_topology(None)
        runs.append({"name": f"stage{stage}", "model": "gpt2-tiny",
                     "model_kw": kw, "cfg": cfg,
                     "params": params_from_jax(p0, get_model_config(
                         "gpt2-tiny", **kw), device="cpu")})
    ranks = launch(torch_mesh_ranks.zero_slices, 4, args=(runs,),
                   backend="gloo", device="cpu")
    for stage, (p0, index) in want.items():
        whole = split = 0
        for rank, r in enumerate(ranks):
            for path, mine, moment in r[f"stage{stage}"]:
                full = _get(p0, path)
                want_slice = full[index[path][rank]]
                np.testing.assert_array_equal(mine, want_slice,
                                              err_msg=str((stage, path, rank)))
                assert moment == mine.shape
                if rank == 0:
                    whole += mine.shape == full.shape
                    split += mine.shape != full.shape
        assert whole and split, (whole, split)


# ----------------------------------------------------------------------
# flat buckets against the per-leaf reduction
# ----------------------------------------------------------------------
@pytest.mark.parametrize("world", [2, 4])
def test_flat_buckets_equal_the_per_leaf_reduction(world):
    """The bucketed collectives at three sizes against the per-leaf ones,
    bit for bit; whole ``train_batch`` runs at those sizes (and size 1)
    against size 500,000,000: bit for bit, but on 4 ranks at stage 1
    within ``SUM_ORDER_RTOL``."""
    limits = (300, 2500, 10 ** 9)
    if world == 2:
        model, kw, mesh = "gpt2-tiny", {}, {"data": 2}
    else:
        model, kw, mesh = ("llama-tiny", {**RING, "ring_placement": "striped"},
                           MESH)
    stages = (1, 2)
    params = params_from_jax(
        jax.tree.map(np.asarray, _jax_init(model, kw)),
        get_model_config(model, **kw), device="cpu")
    batch = _batch(CFG["train_micro_batch_size_per_gpu"]
                   * CFG["gradient_accumulation_steps"] * mesh["data"])
    leaves = [x for _p, x in _paths(params)]
    largest = max(x.numel() for x in leaves)
    total = sum(x.numel() for x in leaves)
    sizes = {"below-largest-leaf": largest // 2,
             "several-leaves": largest + largest // 2, "one-bucket": total,
             "per-leaf": 1}
    runs = []
    for stage in stages:
        for name, size in [("reference", 500_000_000), *sizes.items()]:
            cfg = _zero(stage, mesh)
            cfg["zero_optimization"]["reduce_bucket_size"] = size
            runs.append({"name": f"stage{stage}-{name}", "model": model,
                         "model_kw": kw, "params": params, "cfg": cfg,
                         "batch": batch, "steps": STEPS})
    ranks = launch(torch_mesh_ranks.bucket_cases, world,
                   args=(limits, world > 2, runs), backend="gloo",
                   device="cpu")
    for r in ranks:
        cases = r["cases"]
        equal, diff = cases[("reduce_scatter", "per-leaf-vs-all-reduce")]
        assert equal, diff
        for limit in limits:
            for key in (("all_reduce", "views"),
                        ("reduce_scatter", "rank-major")):
                equal, diff = cases[key + (limit,)]
                assert equal, (key, limit, diff)
        # below the largest leaf, spanning several leaves, one bucket
        assert [cases[("all_reduce", "buckets", n)] for n in limits] == [5, 2, 1]
        assert [cases[("reduce_scatter", "buckets", n)]
                for n in limits][-1] == 1
    runs_out = ranks[0]["runs"]
    for stage in stages:
        ref = runs_out[f"stage{stage}-reference"]
        assert ref["buckets"] < runs_out[f"stage{stage}-per-leaf"]["buckets"]
        exact = world == 2 or stage >= 2
        for name, got in runs_out.items():
            if not name.startswith(f"stage{stage}-"):
                continue
            assert got["grads_are_bucket_views"], name
            assert got["scattered_grads_dropped"], name
            assert (got["scatter_buckets"] > 0) == (stage >= 2), name
            if exact:
                assert got["losses"] == ref["losses"], name
                assert got["grad_norms"] == ref["grad_norms"], name
                for path, a in _paths(ref["params"]):
                    np.testing.assert_array_equal(
                        _get(got["params"], path), a,
                        err_msg=str((name, path)))
                continue
            # the first loss comes before any reduction
            assert got["losses"][0] == ref["losses"][0], name
            np.testing.assert_allclose(got["losses"], ref["losses"],
                                       rtol=SUM_ORDER_RTOL, err_msg=name)
            np.testing.assert_allclose(got["grad_norms"], ref["grad_norms"],
                                       rtol=SUM_ORDER_RTOL, err_msg=name)
            for path, a in _paths(ref["params"]):
                mine = _get(got["params"], path)
                update = a - _get(params, path).numpy()
                assert (np.linalg.norm(mine - a)
                        <= SUM_ORDER_RTOL * np.linalg.norm(update)), (name, path)


def _jax_init(model, kw):
    try:
        eng, *_ = dsj.initialize(model=jax_model_config(model, **kw), seed=5,
                                 config={**CFG, "mesh": {"data": 1}})
        return eng.params
    finally:
        jtopology.set_topology(None)


# ----------------------------------------------------------------------
# checkpoints over the ZeRO world
# ----------------------------------------------------------------------
def _assert_state(got, want, what):
    assert sorted(got) == sorted(want), what
    for name, a in want.items():
        np.testing.assert_array_equal(got[name], a, err_msg=f"{what} {name}")


def test_zero2_saved_at_data2_seq2_resumes_across_meshes(tmp_path):
    """A ZeRO-2 run at ``{"data": 2, "seq": 2}`` (four ranks) saves its
    pickle, universal and fast forms, and a JAX universal checkpoint of the
    same model loads through the config flag at that mesh.  Every form
    resumes with each saved leaf bit for bit: at the saving mesh (losses
    bit for bit), at ``{"seq": 2}`` (two ranks) and at data 1 (this
    process), where the forms' losses are equal and within 1e-5 of the
    saving mesh's.  The JAX checkpoint's continuation is within 1e-5 of
    the JAX engine's."""
    kw = {**RING, "ring_placement": "striped"}
    rows = (CFG["train_micro_batch_size_per_gpu"]
            * CFG["gradient_accumulation_steps"] * MESH["data"])
    batch = _batch(rows, seed=9)
    # the JAX run: data 1, micro 4 (the same global rows a micro-step)
    jcfg = {**CFG, "train_micro_batch_size_per_gpu": 4,
            "zero_optimization": {"stage": 2}, "mesh": {"data": 1}}
    try:
        jeng, *_ = dsj.initialize(model=jax_model_config("llama-tiny", **kw),
                                  seed=5, config=jcfg)
        p0 = jax.tree.map(np.asarray, jeng.params)
        for _ in range(3):
            jeng.train_batch(batch)
        jeng.save_checkpoint(str(tmp_path / "jax"), tag="ck")
        udir = jun.ds_to_universal(str(tmp_path / "jax"), tag="ck")
        jax_after = [float(np.asarray(jeng.train_batch(batch)))
                     for _ in range(STEPS)]
    finally:
        jtopology.set_topology(None)
    params = params_from_jax(p0, get_model_config("llama-tiny"), device="cpu")
    run = {"model": "llama-tiny", "model_kw": kw, "params": params,
           "cfg": _zero(2), "batch": batch, "steps": STEPS,
           "ckpt": str(tmp_path / "port"), "jax_universal": udir}
    ranks = launch(torch_mesh_ranks.ckpt_save_and_resume, 4, args=(run,),
                   backend="gloo", device="cpu")
    saved, after = ranks[0]["saved"], ranks[0]["after"]
    assert any(".mu/" in name for name in saved)
    for r in ranks:
        assert r["after"] == after
        for form, res in r["resumed"].items():
            assert res["global_steps"] == STEPS and res["losses"] == after, form
        assert r["jax_universal"]["global_steps"] == 3
        np.testing.assert_allclose(r["jax_universal"]["losses"], jax_after,
                                   rtol=1e-5)
    for form, res in ranks[0]["resumed"].items():
        _assert_state(res["state"], saved, f"data2xseq2 {form}")
    one = {**run, "cfg": {**_zero(2, {"data": 1}),
                          "train_micro_batch_size_per_gpu": 4}}
    seq2 = launch(torch_mesh_ranks.resume_forms, 2,
                  args=({**one, "cfg": {**one["cfg"], "mesh": {"seq": 2}}},),
                  backend="gloo", device="cpu")
    data1 = torch_mesh_ranks.resume_forms(0, 1, one)
    for where, res in (("seq2", seq2[0]), ("data1", data1)):
        losses = res["pickle"]["losses"]
        np.testing.assert_allclose(losses, after, rtol=1e-5, err_msg=where)
        for form, got in res.items():
            assert got["global_steps"] == STEPS
            assert got["losses"] == losses, (where, form)
            _assert_state(got["state"], saved, f"{where} {form}")
    assert seq2[1]["pickle"]["losses"] == seq2[0]["pickle"]["losses"]
