"""The port's training path against the JAX package's, on the CPU.

``forward``/``loss_fn`` of ``deepspeed_tpu_torch/models/transformer.py``
against the JAX ones, and ``initialize()`` → ``train_batch`` of the port's
engine against the JAX engine, from the same weights (the JAX init,
carried over by ``params_from_jax``) and the same batches (numpy).

The JAX engine runs on a one-device mesh (``"mesh": {"data": 1}``), so
both engines see the same micro-batch rows.  The block-sparse + Lion
cases (DeepSpeed's BSLongformer layout, unidirectional) compare the JAX
model through its interpreted Pallas kernel for the gradients and through
its dense-masked lowering in the engine (every row of that layout sees a
key, where the two agree).  Tolerances (fp32): logits and
loss 1e-5 relative, gradients 1e-4 of the leaf's largest gradient (or of
the tree's, for a leaf whose true gradient is zero, such as the key bias
that softmax ignores), the 5-step loss curve 1e-5.  In bf16 the two
frameworks round elementwise chains at other points (XLA fuses them in
fp32, PyTorch rounds per op), so the curve is held to a band: 2e-2
relative.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dsj
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import get_model_config as jax_model_config
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.runtime.config import DeepSpeedConfigError as JaxConfigError
from deepspeed_tpu_torch.models import get_model_config
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.bridge import params_from_jax, params_to_numpy
from deepspeed_tpu_torch.ops import block_sparse_mha as tbsm
from deepspeed_tpu_torch.ops import flash_mha as tfm
from deepspeed_tpu_torch.ops import fused_optimizer as tfo
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, DeepSpeedConfigError

from test_torch_engine_v2 import one_torch_thread  # noqa: F401


def _batch(vocab, rows, seq, seed):
    ids = np.random.default_rng(seed).integers(0, vocab, (rows, seq + 1)).astype(np.int32)
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:].copy()}


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


# gpt2 (MHA, learned positions, biased gelu), llama (GQA, rope, swiglu,
# rmsnorm), and the other branches of the forward: sliding window
# (mistral), GPT-Neo alternating windows, parallel block (falcon), partial
# rotary (phi), interleaved rotary (gpt-j), ALiBi (bloom), post-norm with
# an MLM head and a key-padding mask (bert)
MODELS = ["gpt2-tiny", "llama-tiny", "mistral-tiny", "gptneo-tiny",
          "falcon-tiny", "phi-tiny", "gptj-tiny", "bloom-tiny", "bert-tiny"]


@pytest.mark.parametrize("name", MODELS)
def test_forward_loss_and_grads_match_jax(name):
    _check_forward_loss_and_grads(name)


def _check_forward_loss_and_grads(name, **replace):
    jc = jax_model_config(name).replace(dtype=jnp.float32, **replace)
    tc = get_model_config(name).replace(dtype=torch.float32, remat_policy="none",
                                        **replace)
    jp = jtf.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    for _path, leaf in _paths(tp):
        leaf.requires_grad_(True)
    b = _batch(jc.vocab_size, 2, 48, seed=1)
    b["labels"][0, :5] = -100   # ignored positions
    if not jc.causal:
        b["attention_mask"] = np.ones_like(b["input_ids"])
        b["attention_mask"][1, 40:] = 0   # right padding
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}

    mask = {"attention_mask": jb["attention_mask"]} if not jc.causal else {}
    (jloss, jlogits), jgrads = jax.value_and_grad(
        lambda p: (jtf.loss_fn(p, jb, jc),
                   jtf.forward(p, jb["input_ids"], jc, **mask)),
        has_aux=True)(jp)
    jlogits = np.asarray(jlogits)
    tlogits = ttf.forward(tp, tb["input_ids"], tc, attention_mask=tb.get(
        "attention_mask")).detach().numpy()
    assert np.abs(tlogits - jlogits).max() <= 1e-5 * np.abs(jlogits).max()

    tloss = ttf.loss_fn(tp, tb, tc)
    tloss.backward()
    assert abs(float(tloss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    gmax = max(float(np.abs(g).max()) for g in jax.tree.leaves(jgrads))
    for path, leaf in _paths(tp):
        ref = np.asarray(_get(jgrads, path))
        scale = max(float(np.abs(ref).max()), gmax)
        # a leaf the loss does not reach (ln2 of a parallel block with one
        # shared norm) has no torch gradient and a zero JAX one
        got = leaf.grad.numpy() if leaf.grad is not None else np.zeros_like(ref)
        assert np.abs(got - ref).max() <= 1e-4 * scale, path


def _engines(model_name, cfg, dtype_flag, **replace):
    cfg = dict(cfg)
    if dtype_flag:
        cfg["bf16"] = {"enabled": True}
    jeng, *_ = dsj.initialize(model=jax_model_config(model_name).replace(**replace),
                              config={**cfg, "mesh": {"data": 1}})
    tmodel = get_model_config(model_name).replace(**replace)
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params), tmodel,
                             device="cpu")
    teng, opt, _, sched = dst.initialize(model=tmodel, config=cfg, device="cpu",
                                         model_parameters=params)
    assert opt is teng.optimizer and sched is teng.lr_scheduler
    return jeng, teng


TRAIN_CFG = {
    "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
    "optimizer": {"type": "AdamW", "params": {"lr": 2e-3, "weight_decay": 0.1}},
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_min_lr": 1e-4, "warmup_max_lr": 2e-3,
                             "warmup_num_steps": 3}},
    "gradient_clipping": 1.0,
    "activation_checkpointing": {"remat_policy": "none"},
}


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_train_batch_loss_curve_matches_jax_engine(bf16):
    jeng, teng = _engines("gpt2-tiny", TRAIN_CFG, bf16)
    assert teng.model_config.dtype == (torch.bfloat16 if bf16 else torch.float32)
    batch = _batch(512, 4, 32, seed=2)
    rtol = 2e-2 if bf16 else 1e-5
    jl, tl = [], []
    for _ in range(5):
        jl.append(float(np.asarray(jeng.train_batch(batch))))
        tl.append(float(teng.train_batch(batch)))
        assert abs(jeng.get_global_grad_norm() - teng.get_global_grad_norm()) \
            <= rtol * jeng.get_global_grad_norm()
        assert teng.get_lr() == pytest.approx(jeng.get_lr())
    np.testing.assert_allclose(tl, jl, rtol=rtol)
    assert tl[-1] < tl[0]   # learns the fixed batch
    assert teng.global_steps == 5 and int(teng.opt_state["count"]) == 5
    if not bf16:
        # the key bias is left out: its true gradient is zero (softmax
        # ignores it), and Adam turns each side's summation noise into
        # +-lr steps of independent sign
        pj = jax.tree.map(np.asarray, jeng.params)
        pt = params_to_numpy(teng.params)
        for path, a in _paths(pj):
            if path != ("layers", "attn", "bk"):
                assert np.all(np.abs(_get(pt, path) - a)
                              <= 1e-5 * (1 + np.abs(a))), path


@pytest.mark.parametrize("policy", ["full", "nothing_saveable"])
def test_remat_equals_no_remat(policy):
    """A checkpointed layer reruns its forward in the backward (counted in
    flash_fwd's launches on the card) and gives the same step."""
    batch = _batch(512, 4, 32, seed=3)
    out = {}
    for p in ("none", policy):
        cfg = {**TRAIN_CFG, "activation_checkpointing": {"remat_policy": p}}
        eng, *_ = dst.initialize(model=get_model_config("gpt2-tiny"),
                                 config=cfg, device="cpu", seed=7)
        assert eng.model_config.remat_policy == p
        losses = [float(eng.train_batch(batch)) for _ in range(2)]
        out[p] = (losses, params_to_numpy(eng.params))
    assert out["none"][0] == out[policy][0]
    for path, a in _paths(out["none"][1]):
        np.testing.assert_array_equal(_get(out[policy][1], path), a)


def test_eval_batch_matches_jax_loss():
    jeng, teng = _engines("llama-tiny", {**TRAIN_CFG}, False)
    b = _batch(512, 2, 40, seed=4)
    jl = float(np.asarray(jeng.eval_batch(b)))
    assert float(teng.eval_batch(b)) == pytest.approx(jl, rel=1e-5)


@pytest.mark.parametrize("impl", ["auto", "pallas_flash", "xla"])
def test_attn_impl_forward_matches_jax(impl):
    """The flash path and the unfused one, each against JAX's forward with
    the same ``attn_impl`` (fp32, 1e-5 of the largest logit)."""
    jc = jax_model_config("llama-tiny").replace(dtype=jnp.float32,
                                                attn_impl=impl)
    tc = get_model_config("llama-tiny").replace(dtype=torch.float32,
                                                attn_impl=impl)
    jp = jtf.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    ids = _batch(jc.vocab_size, 2, 40, seed=8)["input_ids"]
    jl = np.asarray(jtf.forward(jp, jnp.asarray(ids), jc))
    tl = ttf.forward(tp, torch.from_numpy(ids), tc).detach().numpy()
    assert np.abs(tl - jl).max() <= 1e-5 * np.abs(jl).max()


@pytest.mark.parametrize("impl,device,err,extra", [
    ("xla", "meta", NotImplementedError, {}),   # off the CPU: no plain path
    ("sparse", "cpu", NotImplementedError, {"use_alibi": True}),
    ("dense", "cpu", ValueError, {}),
], ids=["xla-off-cpu", "sparse", "unknown"])
def test_attn_impl_rejections(impl, device, err, extra):
    """``attn_impl="xla"`` runs the plain attention only on CPU tensors
    (the card runs these inputs through the flash kernel), block-sparse
    attention takes no alibi bias or padding mask (as in JAX), and an
    unknown name raises."""
    cfg = get_model_config("gpt2-tiny").replace(dtype=torch.float32,
                                                attn_impl=impl, **extra)
    h, width = cfg.hidden_size, cfg.num_heads * cfg.dim_per_head
    p = {n: torch.zeros(h, width, device=device) for n in ("wq", "wk", "wv")}
    p["wo"] = torch.zeros(width, h, device=device)
    x = torch.zeros(1, 8, h, device=device)
    with pytest.raises(err, match="attn_impl|block-sparse"):
        ttf._attn_block(x, p, None, cfg)


def test_dropout_is_replayable_under_remat():
    """Dropout masks come from per-(step, micro-step, layer) seeds, so the
    rerun forward of a checkpointed layer draws the same masks."""
    model = get_model_config("gpt2-tiny").replace(dropout=0.1)
    batch = _batch(512, 4, 32, seed=5)
    losses = {}
    for p in ("none", "full"):
        cfg = {**TRAIN_CFG, "activation_checkpointing": {"remat_policy": p}}
        eng, *_ = dst.initialize(model=model, config=cfg, device="cpu", seed=3)
        losses[p] = [float(eng.train_batch(batch)) for _ in range(2)]
    assert losses["none"] == losses["full"]
    eng, *_ = dst.initialize(model=get_model_config("gpt2-tiny"),
                             config=TRAIN_CFG, device="cpu", seed=3)
    assert float(eng.train_batch(batch)) != losses["none"][0]


@pytest.mark.parametrize("cfg", [
    {"train_batch_size": 6, "train_micro_batch_size_per_gpu": 4},
    {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2,
     "gradient_accumulation_steps": 3},
    {"train_batch_size": 8, "zero_optimization": {"stage": 5}},
    {"train_batch_size": 8, "fp16": {"enabled": True}, "bf16": {"enabled": True}},
    {},
], ids=["indivisible", "inconsistent", "stage5", "fp16+bf16", "no-batch"])
def test_config_rejections_match_jax(cfg):
    with pytest.raises(JaxConfigError):
        JaxConfig(cfg)
    with pytest.raises(DeepSpeedConfigError):
        DeepSpeedConfig(cfg)


def test_config_resolves_batch_like_jax():
    cfg = {"train_batch_size": 32, "gradient_accumulation_steps": 4,
           "gradient_clipping": 1.0, "steps_per_print": 5,
           "zero_optimization": {"stage": 1},
           "activation_checkpointing": {"remat_policy": "full"}}
    j, t = JaxConfig(cfg), DeepSpeedConfig(cfg)
    for key in ("train_batch_size", "train_micro_batch_size_per_gpu",
                "gradient_accumulation_steps", "gradient_clipping",
                "steps_per_print", "seed"):
        assert getattr(t, key) == getattr(j, key), key
    assert t.zero_optimization_stage == 1
    assert t.activation_checkpointing.remat_policy == "full"


def test_unread_config_keys_are_logged_and_ignored(monkeypatch):
    """Keys of the JAX schema that change no step on one device are
    accepted with a warning each, and the config keeps no value for them."""
    from deepspeed_tpu_torch.runtime import config as tconfig

    warned = []
    monkeypatch.setattr(tconfig.logger, "warning", warned.append)
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "zero_optimization": {"stage": 1, "overlap_comm": True,
                                 "allgather_bucket_size": 5e8},
           "bf16": {"enabled": True, "immediate_grad_update": False},
           "fp16": {"enabled": False, "loss_scale": 0},
           "activation_checkpointing": {"remat_policy": "full",
                                        "number_checkpoints": 4}}
    JaxConfig(cfg)
    t = DeepSpeedConfig(cfg)
    assert t.zero_optimization_stage == 1 and t.bf16.enabled
    for block, key in (("zero_config", "overlap_comm"),
                       ("zero_config", "allgather_bucket_size"),
                       ("bf16", "immediate_grad_update"),
                       ("fp16", "loss_scale"),
                       ("activation_checkpointing", "number_checkpoints")):
        assert not hasattr(getattr(t, block), key)
        assert any(f"'{key}'" in w for w in warned), key
    assert len(warned) == 5


@pytest.mark.parametrize("extra", [
    {"fp16": {"enabled": True}},
    {"zero_optimization": {"stage": 3, "offload_param": {"device": "cpu"}}},
    {"zero_optimization": {"stage": 1, "offload_optimizer": {"device": "cpu"}}},
    {"mesh": {"data": 2, "tensor": 2}},
    {"tensor_parallel": {"autotp_size": 2}},
    {"activation_checkpointing": {"remat_policy": "dots_flash_saveable"}},
    {"data_types": {"grad_accum_dtype": "bf16"}},
    {"telemetry": {"enabled": True}},
    {"optimizer": {"type": "Lamb", "params": {"lr": 1e-4}}},
    {"optimizer": {"type": "Adam", "params": {"adam_w_mode": False}}},
], ids=["fp16", "offload-param", "offload", "mesh", "tp", "named-remat",
        "grad-accum-bf16", "telemetry", "lamb", "adam-l2"])
def test_unported_features_raise_naming_the_roadmap(extra):
    cfg = {"train_micro_batch_size_per_gpu": 2, **extra}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dst.initialize(model=get_model_config("gpt2-tiny"), config=cfg,
                       device="cpu")


def test_initialize_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dst.initialize(model=get_model_config("gpt2-tiny"),
                       config={"train_micro_batch_size_per_gpu": 2})


def test_cpu_training_never_launches_a_kernel():
    before = dict(tfm.flash_mha.launches)
    eng, *_ = dst.initialize(model=get_model_config("llama-tiny"),
                             config=TRAIN_CFG, device="cpu")
    eng.train_batch(_batch(512, 4, 16, seed=6))
    assert tfm.flash_mha.launches == before


SPARSE = {"mode": "bslongformer", "block": 16, "num_sliding_window_blocks": 3,
          "global_block_indices": [0], "attention": "unidirectional"}
# a constant learning rate: Lion moves a param whose momentum sum lands
# next to 0 by +-lr on a sign the two frameworks' summation noise decides
SPARSE_LION_CFG = {**{k: v for k, v in TRAIN_CFG.items() if k != "scheduler"},
                   "optimizer": {"type": "Lion", "params": {
                       "lr": 3e-4, "betas": [0.9, 0.99], "weight_decay": 0.1}}}


@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-tiny"])
def test_sparse_forward_loss_and_grads_match_jax(name, monkeypatch):
    """attn_impl="sparse": logits, loss and grads against jax.grad through
    the interpreted Pallas block-sparse kernel (S 48: a tail tile)."""
    jfm = importlib.import_module("deepspeed_tpu.ops.pallas.flash_mha")
    monkeypatch.setattr(jfm, "INTERPRET", True)
    _check_forward_loss_and_grads(name, attn_impl="sparse",
                                  sparse_attention=SPARSE)


@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-tiny"])
def test_sparse_lion_loss_curve_matches_jax_engine(name):
    """The slice's step at tiny size: block-sparse attention and Lion,
    fp32, five train_batch steps against the JAX engine (loss 1e-5, grad
    norm 1e-5); the loss falls on the fixed batch.  Params agree to 1e-5
    but where Lion took the sign of summation noise (the key bias, whose
    true gradient is zero; a rare momentum sum next to 0): at most 2 lr a
    step there, and in under 1 % of any leaf's elements."""
    jeng, teng = _engines(name, SPARSE_LION_CFG, False, attn_impl="sparse",
                          sparse_attention=SPARSE)
    assert teng.optimizer.name == "fused_lion"
    batch = _batch(512, 4, 128, seed=9)
    jl, tl = [], []
    for _ in range(5):
        jl.append(float(np.asarray(jeng.train_batch(batch))))
        tl.append(float(teng.train_batch(batch)))
        assert abs(jeng.get_global_grad_norm() - teng.get_global_grad_norm()) \
            <= 1e-5 * jeng.get_global_grad_norm()
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    assert int(teng.opt_state["count"]) == 5 and set(teng.opt_state) == {"count", "mu"}
    pj = jax.tree.map(np.asarray, jeng.params)
    pt = params_to_numpy(teng.params)
    lr = SPARSE_LION_CFG["optimizer"]["params"]["lr"]
    for path, a in _paths(pj):
        diff = np.abs(_get(pt, path) - a)
        assert diff.max() <= 2 * lr * 5 + 1e-5, path
        if path != ("layers", "attn", "bk"):
            assert np.mean(diff > 1e-5 * (1 + np.abs(a))) < 1e-2, path


def test_cpu_sparse_lion_training_never_launches_a_kernel():
    before = (dict(tbsm.block_sparse_mha.launches), dict(tfo.fused_lion.launches),
              dict(tfm.flash_mha.launches))
    model = get_model_config("llama-tiny").replace(attn_impl="sparse",
                                                   sparse_attention=SPARSE)
    eng, *_ = dst.initialize(model=model, config=SPARSE_LION_CFG, device="cpu")
    eng.train_batch(_batch(512, 4, 32, seed=6))
    assert (tbsm.block_sparse_mha.launches, tfo.fused_lion.launches,
            tfm.flash_mha.launches) == before
