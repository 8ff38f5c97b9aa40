"""The port's engine with ring sequence parallelism against the JAX engine,
on the CPU.

llama-tiny with ``seq_impl="ring"`` trains in 2 spawned gloo CPU ranks
(``{"mesh": {"seq": 2}}``) from the JAX engine's initial params (carried
over by ``params_from_jax``) on the same global batch as the JAX engine on
a CPU mesh ``{"seq": 2, "data": 1}``, for both placements: three
``train_batch`` losses and grad norms to 1e-5 relative (fp32), the eval
loss afterwards, and the params after the steps: each leaf's update
(params after minus before) within 1e-3 relative L2 of the JAX engine's,
and every element within lr (one AdamW step) of it.  Elementwise, AdamW turns the
summation-order noise of a near-zero gradient into a step of up to lr
(the ring sums the attention in other orders than the JAX mesh), which
1e-5 · (1 + |p|) would flag on 1 to 3 elements of a leaf.  Both ranks
must hold the same params, bit for bit.  The model rejects ring attention with a block-sparse
layout, a key-padding mask or ALiBi (as the JAX model raises); Ulysses
over a seq axis (beside a data axis too) needs a process group as the
ring does (it trains in ``test_torch_ulysses.py``); a quantized gradient
reduction and the decomposed update over a seq axis are read as the JAX
config reads them.  With
``comm_quantization.ring_rotation: "int8"`` (or fp8) the same engine runs
the quantized ring wire in both ranks against the JAX engine with that
block on its seq mesh: the first step's loss and grad norm to 1e-5
relative (the two rings encode the same bits; summation order only), the
second's to 1e-3 (``WIRE_RTOL`` says why).  Without a seq
axis the block warns and keeps the fp32 wire, as in JAX.  The launcher re-raises a rank's failure, and
the process group takes only the backend the caller names.
"""

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu as dsj
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import get_model_config as jax_model_config
from deepspeed_tpu.parallel import topology as jtopology
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu_torch.launcher import launch
from deepspeed_tpu_torch.models import get_model_config
from deepspeed_tpu_torch.models.bridge import params_from_jax
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

import torch_ring_ranks
from test_torch_engine_v2 import one_torch_thread  # noqa: F401

LR = 2e-3
CFG = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
       "optimizer": {"type": "AdamW", "params": {"lr": LR,
                                                 "weight_decay": 0.1}},
       "gradient_clipping": 1.0, "steps_per_print": 10_000,
       "activation_checkpointing": {"remat_policy": "none"}}
STEPS = 3
PLACEMENTS = ("contiguous", "striped")


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


def _jax_run(placement, batch, seed):
    model = jax_model_config("llama-tiny", seq_impl="ring",
                             ring_placement=placement)
    try:
        eng, *_ = dsj.initialize(model=model, seed=seed, config={
            **CFG, "mesh": {"seq": 2, "data": 1}})
        p0 = jax.tree.map(np.asarray, eng.params)
        losses, norms = [], []
        for _ in range(STEPS):
            losses.append(float(np.asarray(eng.train_batch(batch))))
            norms.append(eng.get_global_grad_norm())
        evl = float(np.asarray(eng.eval_batch(
            {k: v[:2] for k, v in batch.items()})))
        return p0, losses, norms, evl, jax.tree.map(np.asarray, eng.params)
    finally:
        jtopology.set_topology(None)


def test_two_gloo_ranks_train_like_the_jax_seq_mesh():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 512, (4, 33)).astype(np.int32)
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:].copy()}
    batch["labels"][0, :5] = -100         # the global token count matters
    jax_runs = {p: _jax_run(p, batch, seed=5) for p in PLACEMENTS}
    # the JAX init does not depend on the placement
    p0 = jax_runs["contiguous"][0]
    params = params_from_jax(p0, get_model_config("llama-tiny"),
                             device="cpu")
    ranks = launch(torch_ring_ranks.ring_engine_steps, 2,
                   args=("llama-tiny", params, batch,
                         {**CFG, "mesh": {"seq": 2}}, STEPS, PLACEMENTS),
                   backend="gloo", device="cpu")
    for placement in PLACEMENTS:
        _, losses, norms, evl, pj = jax_runs[placement]
        got = [r[placement] for r in ranks]
        np.testing.assert_allclose(got[0]["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(got[0]["grad_norms"], norms, rtol=1e-5)
        assert got[0]["eval"] == pytest.approx(evl, rel=1e-5)
        assert got[0]["losses"][-1] < got[0]["losses"][0]
        for path, a in _paths(pj):
            mine = _get(got[0]["params"], path)
            update = a - _get(p0, path)
            assert np.linalg.norm(mine - a) <= 1e-3 * np.linalg.norm(update), path
            assert np.abs(mine - a).max() <= LR, path
            # the ranks step the same replicated params
            np.testing.assert_array_equal(_get(got[1]["params"], path), mine)
        assert got[0]["losses"] == got[1]["losses"]
    errors = ranks[0]["errors"]
    assert set(errors) == {"sparse", "alibi", "mask"}, errors
    assert "sparse" in errors["sparse"] and "alibi" in errors["alibi"] \
        and "attention_mask" in errors["mask"]


@pytest.mark.parametrize("extra,model_kw,item", [
    ({"mesh": {"seq": 2, "data": 2}}, {"seq_impl": "ulysses"},
     "process group"),
    ({"mesh": {"seq": 2}}, {"seq_impl": "ulysses"}, "process group"),
    ({"sequence_parallel_size": 2}, {}, "process group"),
    ({"mesh": {"seq": 2}, "comm_quantization": {
        "enabled": True, "grad_reduce": "int8", "ring_rotation": "int8"}},
     {"seq_impl": "ring"}, None),
    ({"mesh": {"seq": 2}, "step_schedule": {"weight_update": "decomposed"}},
     {"seq_impl": "ring"}, None),
], ids=["data-with-seq", "ulysses", "sp-size-ulysses", "int8-wire",
        "step-schedule"])
def test_seq_axis_rejections_name_their_item(extra, model_kw, item):
    """Ulysses over a seq axis (beside a data axis too) is taken, and
    without an initialised group of the axis's size it raises as the ring
    does.  ``grad_reduce`` int8 and the decomposed update over a seq axis
    are read as the JAX config reads them (the engine's gates decide over
    two ranks, ``test_torch_dp_compression.py``: the quantized reduce
    warns and keeps the buckets, the decomposed update splits over the seq
    world)."""
    cfg = {"train_micro_batch_size_per_gpu": 2, **extra}
    if item is None:
        mine, want = DeepSpeedConfig(cfg), JaxConfig(cfg)
        for block, key in (("comm_quantization", "grad_reduce"),
                           ("comm_quantization", "ring_rotation"),
                           ("step_schedule", "weight_update")):
            assert getattr(getattr(mine, block), key) == \
                getattr(getattr(want, block), key), key
        return
    with pytest.raises(RuntimeError, match=item):
        dst.initialize(model=get_model_config("llama-tiny", **model_kw),
                       config=cfg, device="cpu")


WIRE_STEPS = 2
# the first step's loss and grad norm: the same wire bits, summation order
# only; the second step's after one AdamW step from grads whose traveling
# dk/dv may hold an element one wire step apart (a sum on a rounding
# boundary of the wire, test_torch_ring_attention.py), which AdamW's first
# step turns into an update of up to lr on a near-zero gradient element
# (seen: 1.6e-4 int8, 7.9e-5 fp8)
WIRE_RTOL = (1e-5, 1e-3)


@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_quantized_ring_wire_trains_like_the_jax_seq_mesh(wire):
    """llama-tiny (2 layers) with ``ring_rotation`` over 2 gloo ranks and
    the JAX engine on a ``{"seq": 2}`` CPU mesh, striped: the losses and
    grad norms of WIRE_STEPS steps at WIRE_RTOL."""
    cq = {"comm_quantization": {"enabled": True, "ring_rotation": wire}}
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 512, (4, 33)).astype(np.int32)
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:].copy()}
    model = jax_model_config("llama-tiny", seq_impl="ring",
                             ring_placement="striped")
    assert model.num_layers == 2
    try:
        eng, *_ = dsj.initialize(model=model, seed=7, config={
            **CFG, **cq, "mesh": {"seq": 2, "data": 1}})
        assert eng.model_config.ring_wire_dtype == wire
        p0 = jax.tree.map(np.asarray, eng.params)
        want = []
        for _ in range(WIRE_STEPS):
            want.append((float(np.asarray(eng.train_batch(batch))),
                         eng.get_global_grad_norm()))
    finally:
        jtopology.set_topology(None)
    params = params_from_jax(p0, get_model_config("llama-tiny"), device="cpu")
    ranks = launch(torch_ring_ranks.ring_engine_steps, 2,
                   args=("llama-tiny", params, batch,
                         {**CFG, **cq, "mesh": {"seq": 2}}, WIRE_STEPS,
                         ("striped",)),
                   backend="gloo", device="cpu")
    for r in ranks:
        assert r["wire"] == wire
        got = r["striped"]
        for i, rtol in enumerate(WIRE_RTOL):
            assert got["losses"][i] == pytest.approx(want[i][0], rel=rtol)
            assert got["grad_norms"][i] == pytest.approx(want[i][1], rel=rtol)
    assert ranks[0]["striped"]["losses"] == ranks[1]["striped"]["losses"]


def test_ring_wire_without_a_seq_axis_keeps_fp32(monkeypatch):
    """As in JAX: no seq axis above one (or no ring) warns and keeps the
    fp32 wire; a switched-off block sets nothing."""
    from deepspeed_tpu_torch.runtime import engine as engine_mod

    seen = []
    monkeypatch.setattr(engine_mod.logger, "warning",
                        lambda msg, *a, **k: seen.append(msg))
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "comm_quantization": {"enabled": True, "ring_rotation": "int8"}}
    for model_kw in ({"seq_impl": "ring"}, {}):
        eng, *_ = dst.initialize(model=get_model_config(
            "llama-tiny", **model_kw), config=cfg, device="cpu")
        assert eng.model_config.ring_wire_dtype == "fp32"
        assert any("keeping the fp32 wire" in m for m in seen), seen
        seen.clear()
    off = {**cfg, "comm_quantization": {"enabled": False,
                                        "ring_rotation": "int8"}}
    eng, *_ = dst.initialize(model=get_model_config("llama-tiny",
                                                    seq_impl="ring"),
                             config=off, device="cpu")
    assert eng.model_config.ring_wire_dtype == "fp32" and not seen


def test_seq_axis_needs_a_process_group():
    """Without an initialised group of the seq axis's size, initialize
    raises instead of training one shard alone."""
    with pytest.raises(RuntimeError, match="process group"):
        dst.initialize(model=get_model_config("llama-tiny", seq_impl="ring"),
                       config={"train_micro_batch_size_per_gpu": 2,
                               "mesh": {"seq": 2}}, device="cpu")


def test_ring_interleave_maps_to_the_model():
    eng, *_ = dst.initialize(
        model=get_model_config("llama-tiny", seq_impl="ring"), device="cpu",
        config={"train_micro_batch_size_per_gpu": 2,
                "step_schedule": {"ring_interleave": 2}})
    assert eng.model_config.ring_interleave == 2
    with pytest.raises(Exception, match="ring_interleave"):
        dst.initialize(model=get_model_config("llama-tiny"), device="cpu",
                       config={"train_micro_batch_size_per_gpu": 2,
                               "step_schedule": {"ring_interleave": 3}})


def test_launch_reraises_a_rank_failure():
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        launch(torch_ring_ranks.failing_rank, 2, backend="gloo", device="cpu")


def test_launch_needs_a_named_backend():
    with pytest.raises(TypeError, match="backend"):
        launch(torch_ring_ranks.failing_rank, 2, device="cpu")


def test_init_distributed_takes_only_the_named_backends():
    from deepspeed_tpu_torch.comm import comm

    with pytest.raises(ValueError, match="backend"):
        comm.init_distributed("mpi", 0, 1, "file:///nonexistent")
