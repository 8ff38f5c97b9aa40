"""The port's engine over a data axis (ZeRO stages 1-3 and the ZeRO-3 fused
gather-matmul) against the JAX engine, and the split-invariance of its
dropout masks and striped ``loss_mask``, on the CPU.

The port trains in 2 spawned gloo CPU ranks (``{"mesh": {"data": 2}}``,
rank bodies in ``torch_zero_ranks.py``) from the JAX engine's initial
params (``params_from_jax``) on the same global batch as the JAX engine
on a CPU mesh ``{"data": 2}``: two ``train_batch`` losses and grad norms
to 1e-5 relative (fp32), and the params after the steps, gathered
(``zero.GatheredParameters``): each leaf's update within 1e-3 relative L2
of the JAX engine's (but the key bias, whose gradient is zero up to
rounding) and every element within lr of it (AdamW turns the
summation-order noise of a near-zero gradient into a step of up to lr, as
``test_torch_ring_engine.py`` explains); both ranks gather the same
params.  Stages 1, 2 and 3 on gpt2-tiny; stage 3 with
``step_schedule.fused_gather_matmul`` on gpt2-tiny (gelu with the ``bi``
bias) and on llama-tiny (SwiGLU's ``wg``; the JAX Pallas matmul
interpreted); and the two configurations where the JAX gate refuses the
fused path (an MLP bias the data axis does not divide, the default
persistence threshold), where the port warns with the JAX reason, keeps
the unfused path and trains to the JAX losses.

With dropout 0.1 the port's engine gives the losses (two steps) and the
first step's gradients of its one-rank run at data 2 and at seq 2 (ring
attention, both placements), within 1e-6; with a non-uniform ``loss_mask`` its striped ring run equals
its contiguous run (the port stripes ``loss_mask`` with the labels, where
the JAX engine's ``_maybe_stripe_ring`` does not: ROADMAP Queue C).
"""

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu as dsj
import deepspeed_tpu.ops.pallas.gather_matmul as gm
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import get_model_config as jax_model_config
from deepspeed_tpu.parallel import topology as jtopology
from deepspeed_tpu_torch.launcher import launch
from deepspeed_tpu_torch.models import get_model_config
from deepspeed_tpu_torch.models import transformer as tf
from deepspeed_tpu_torch.models.bridge import params_from_jax

import torch_zero_ranks
from test_torch_engine_v2 import one_torch_thread  # noqa: F401

LR = 2e-3
CFG = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
       "optimizer": {"type": "AdamW", "params": {"lr": LR,
                                                 "weight_decay": 0.1}},
       "gradient_clipping": 1.0, "steps_per_print": 10_000,
       "activation_checkpointing": {"remat_policy": "none"}}
STEPS = 2
SEQ = 32
# The key bias shifts every score of a query by the same q·bk, which the
# softmax cancels: its gradient is zero up to rounding, and AdamW's update
# of it is that rounding noise normalised (two engines agree on it only
# elementwise, within lr).
NO_GRADIENT = {("layers", "attn", "bk")}


def _batch(rows, seed=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, (rows, SEQ + 1)).astype(np.int32)
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:].copy()}
    batch["labels"][0, :5] = -100         # the global token count matters
    return batch


def _zero_cfg(stage, fused=False, persistence=0, **extra):
    zc = {"stage": stage}
    if persistence is not None:
        zc["param_persistence_threshold"] = persistence
    cfg = {**CFG, "mesh": {"data": 2}, "zero_optimization": zc, **extra}
    if fused:
        cfg["step_schedule"] = {"fused_gather_matmul": True}
    return cfg


def _jax_run(model_name, model_kw, cfg, batch, interpret=False):
    old = gm.INTERPRET
    gm.INTERPRET = interpret
    try:
        eng, *_ = dsj.initialize(model=jax_model_config(model_name, **model_kw),
                                 seed=5, config=cfg)
        p0 = jax.tree.map(np.asarray, eng.params)
        losses, norms = [], []
        for _ in range(STEPS):
            losses.append(float(np.asarray(eng.train_batch(batch))))
            norms.append(eng.get_global_grad_norm())
        return {"p0": p0, "losses": losses, "grad_norms": norms,
                "fused": bool(eng.model_config.fused_gather_matmul),
                "params": jax.tree.map(np.asarray, eng.params)}
    finally:
        gm.INTERPRET = old
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


def _port_vs_jax(model_name, model_kw, cfg, interpret=False):
    """The JAX engine and the port's two ranks on one config; returns both
    results after checking losses, grad norms and params."""
    batch = _batch(CFG["gradient_accumulation_steps"]
                   * CFG["train_micro_batch_size_per_gpu"] * 2)
    want = _jax_run(model_name, model_kw, cfg, batch, interpret)
    params = params_from_jax(want["p0"], get_model_config(model_name, **model_kw),
                             device="cpu")
    run = {"name": "run", "model": model_name, "model_kw": model_kw,
           "params": params, "cfg": cfg, "batch": batch, "steps": STEPS}
    ranks = launch(torch_zero_ranks.engine_runs, 2, args=([run],),
                   backend="gloo", device="cpu")
    got = ranks[0]["run"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"], rtol=1e-5)
    assert got["losses"][-1] < got["losses"][0]
    assert ranks[1]["run"]["losses"] == got["losses"]
    assert ranks[1]["run"]["checksum"] == got["checksum"]
    for path, a in _paths(want["params"]):
        mine = _get(got["params"], path)
        update = a - _get(want["p0"], path)
        if path not in NO_GRADIENT:
            assert np.linalg.norm(mine - a) <= 1e-3 * np.linalg.norm(update), path
        assert np.abs(mine - a).max() <= LR, path
    return got, want


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_stages_over_two_gloo_ranks_match_the_jax_data_mesh(stage):
    got, want = _port_vs_jax("gpt2-tiny", {}, _zero_cfg(stage))
    assert not got["fused"] and not want["fused"]


@pytest.mark.parametrize("model_name", ["gpt2-tiny", "llama-tiny"],
                         ids=["gelu-bias", "swiglu"])
def test_fused_gather_matmul_matches_the_jax_data_mesh(model_name):
    got, want = _port_vs_jax(model_name, {}, _zero_cfg(3, fused=True),
                             interpret=model_name == "llama-tiny")
    assert got["fused"] and want["fused"]
    assert not any("unsupported" in w for w in got["warnings"])


@pytest.mark.parametrize("model_kw,persistence", [
    ({"intermediate_size": 101}, 0),
    ({}, None),
], ids=["indivisible-bias", "default-persistence"])
def test_fused_gate_falls_back_where_the_jax_gate_does(model_kw, persistence):
    got, want = _port_vs_jax("gpt2-tiny", model_kw,
                             _zero_cfg(3, fused=True, persistence=persistence))
    assert not got["fused"] and not want["fused"]
    assert all(np.isfinite(got["losses"]))
    assert any("fused_gather_matmul: unsupported with this configuration "
               "(MLP weights do not carry the expected fsdp sharding "
               "pattern" in w for w in got["warnings"]), got["warnings"]


# ----------------------------------------------------------------------
# split invariance: dropout masks and the striped loss_mask
# ----------------------------------------------------------------------
def _one_rank(model_name, model_kw, cfg, params, batch):
    eng, *_ = dst.initialize(model=get_model_config(model_name, **model_kw),
                             config=cfg, device="cpu",
                             model_parameters=params)
    losses = [float(eng.train_batch(batch))]
    grads = tf.tree_map_with_path(
        lambda _p, x: x.grad.detach().numpy().copy(), eng.params)
    losses += [float(eng.train_batch(batch)) for _ in range(STEPS - 1)]
    return losses, grads


def _assert_same(got, want_losses, want_grads):
    """Losses within 1e-6 relative, grads within 1e-6 absolute (the
    grads here are up to ~3e-2; the two runs sum in other orders, and a
    mask that moved would change them by their own size)."""
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-6)
    for path, g in _paths(want_grads):
        np.testing.assert_allclose(_get(got["grads"], path), g, rtol=0,
                                   atol=1e-6, err_msg=str(path))


def test_dropout_masks_do_not_depend_on_the_split():
    """Dropout 0.1: gpt2-tiny at data 2 against data 1 (micro·2 rows a
    micro-step), and llama-tiny's ring at seq 2, contiguous and striped,
    against seq 1, on one global batch: losses and grads within 1e-6."""
    gpt = {"dropout": 0.1}
    ring = {"dropout": 0.1, "seq_impl": "ring"}
    batch = _batch(8)
    base = {**CFG, "gradient_clipping": 0.0}
    p_gpt = tf.init_params(get_model_config("gpt2-tiny", **gpt), seed=2,
                           device="cpu")
    p_llama = tf.init_params(get_model_config("llama-tiny", **ring), seed=3,
                             device="cpu")
    runs = [{"name": "data2", "model": "gpt2-tiny", "model_kw": gpt,
             "params": p_gpt, "cfg": {**base, "mesh": {"data": 2}},
             "batch": batch, "steps": STEPS, "grads": True}]
    ring_batch = {k: v[:4] for k, v in batch.items()}
    for placement in ("contiguous", "striped"):
        runs.append({"name": f"seq2-{placement}", "model": "llama-tiny",
                     "model_kw": {**ring, "ring_placement": placement},
                     "params": p_llama, "cfg": {**base, "mesh": {"seq": 2}},
                     "batch": ring_batch, "steps": STEPS, "grads": True})
    ranks = launch(torch_zero_ranks.engine_runs, 2, args=(runs,),
                   backend="gloo", device="cpu")
    losses, grads = _one_rank("gpt2-tiny", gpt, {
        **base, "train_micro_batch_size_per_gpu": 4}, p_gpt, batch)
    assert losses[0] != losses[1]
    _assert_same(ranks[0]["data2"], losses, grads)
    losses, grads = _one_rank("llama-tiny", ring, base, p_llama, ring_batch)
    for placement in ("contiguous", "striped"):
        _assert_same(ranks[0][f"seq2-{placement}"], losses, grads)
        assert ranks[1][f"seq2-{placement}"]["losses"] == \
            ranks[0][f"seq2-{placement}"]["losses"]


def test_striped_loss_mask_equals_the_contiguous_run():
    """A non-uniform loss_mask: the striped ring run (the port stripes the
    mask with the labels) gives the contiguous run's losses and grads, and
    both the one-rank run's."""
    ring = {"seq_impl": "ring"}
    batch = _batch(4, seed=7)
    rng = np.random.default_rng(8)
    batch["loss_mask"] = (rng.random(batch["labels"].shape) < 0.6).astype(np.int32)
    batch["loss_mask"][1, :SEQ // 2] = 0
    params = tf.init_params(get_model_config("llama-tiny", **ring), seed=4,
                            device="cpu")
    runs = [{"name": placement, "model": "llama-tiny",
             "model_kw": {**ring, "ring_placement": placement},
             "params": params, "cfg": {**CFG, "mesh": {"seq": 2}},
             "batch": batch, "steps": STEPS, "grads": True}
            for placement in ("contiguous", "striped")]
    ranks = launch(torch_zero_ranks.engine_runs, 2, args=(runs,),
                   backend="gloo", device="cpu")
    contiguous = ranks[0]["contiguous"]
    _assert_same(ranks[0]["striped"], contiguous["losses"], contiguous["grads"])
    losses, grads = _one_rank("llama-tiny", ring, CFG, params, batch)
    _assert_same(contiguous, losses, grads)
