"""The port's ragged paged-KV forward (deepspeed_tpu_torch/inference/v2/
model.py) against the JAX package's ``ragged_forward``, and the parameter
bridge between the two trees.

The same weights (JAX ``init_params``, carried over by ``params_from_jax``)
and the same ragged batches (built once with numpy) go through both.  In
fp32 the logits and caches agree to 1e-5 relative.  A bf16 cache rounds
the same fp32 rows, so it agrees to one bf16 ulp; an int8 cache may
quantize a row element one step apart where k/scale lies on a rounding
boundary, which moves the logits by about 1e-3.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2.model import ragged_forward as jax_ragged_forward
from deepspeed_tpu.models import get_model_config as jax_model_config
from deepspeed_tpu.models.transformer import init_params as jax_init_params
from deepspeed_tpu_torch.inference.v2.model import ragged_forward
from deepspeed_tpu_torch.inference.v2.ragged import (DSStateManager,
                                                     build_ragged_batch)
from deepspeed_tpu_torch.inference.v2.scheduler import SplitFuseScheduler
from deepspeed_tpu_torch.models import get_model_config, init_params
from deepspeed_tpu_torch.models.bridge import params_from_jax, params_to_numpy

from test_torch_engine_v2 import one_torch_thread  # noqa: F401

BS, NUM_BLOCKS, MAX_SEQS, BUDGET, MAX_BLOCKS = 4, 32, 4, 32, 8
ARRAYS = ("token_ids", "token_slot", "token_pos", "token_dest",
          "block_tables", "ctx_lens", "logits_idx")


def _models(name, **overrides):
    jcfg = jax_model_config(name, **overrides).replace(dtype=jnp.float32)
    tcfg = get_model_config(name, **overrides).replace(dtype=torch.float32)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _batches(vocab):
    """Two ragged steps: prompts of 5, 9 and 26 tokens fill the 32-token
    budget (the third is split), then a mixed step of two decodes, the rest
    of the split prompt and a new 6-token prompt."""
    mgr = DSStateManager(MAX_SEQS, NUM_BLOCKS, BS, MAX_BLOCKS)
    sched = SplitFuseScheduler(mgr, token_budget=BUDGET)
    rng = np.random.default_rng(1)
    for uid, n in enumerate((5, 9, 26)):
        mgr.open(uid, rng.integers(1, vocab, n).tolist())
        sched.add(uid)
    rb1 = build_ragged_batch(sched.next_schedule(), mgr, BUDGET)
    for uid in rb1.uids_by_slot.values():
        mgr.extend(uid, int(rng.integers(1, vocab)))
    mgr.open(3, rng.integers(1, vocab, 6).tolist())
    sched.add(3)
    rb2 = build_ragged_batch(sched.next_schedule(), mgr, BUDGET)
    assert rb1.n_tokens == 32 and rb2.n_tokens == 16
    return [[getattr(rb, a) for a in ARRAYS] for rb in (rb1, rb2)]


def _caches(cfg_shape, kv):
    """(jax caches, torch caches) of kind ``kv``: fp32, bf16 or int8."""
    shape = (cfg_shape.num_layers, cfg_shape.kv_heads, NUM_BLOCKS * BS,
             cfg_shape.dim_per_head)
    if kv == "int8":
        j = [{"q": jnp.zeros(shape, jnp.int8),
              "s": jnp.zeros(shape[:-1], jnp.float32)} for _ in range(2)]
        t = [{"q": torch.zeros(shape, dtype=torch.int8),
              "s": torch.zeros(shape[:-1])} for _ in range(2)]
        return j, t
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if kv == "bf16"
                else (jnp.float32, torch.float32))
    return ([jnp.zeros(shape, jdt)] * 2,
            [torch.zeros(shape, dtype=tdt) for _ in range(2)])


def _to_np(x):
    if isinstance(x, dict):
        return {k: _to_np(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _run(name, kv="fp32", attention=None, **overrides):
    jcfg, jp, tcfg, tp = _models(name, **overrides)
    if attention:
        tcfg = tcfg.replace(v2_modules=(("attention", attention),))
    (jk, jv), (tk, tv) = _caches(jcfg, kv)
    jstep = jax.jit(partial(jax_ragged_forward, cfg=jcfg, block_size=BS))
    out = []
    for arrays in _batches(jcfg.vocab_size):
        jl, jk, jv = jstep(jp, jk, jv, *[jnp.asarray(a) for a in arrays])
        tl, tk, tv = ragged_forward(tp, tk, tv,
                                    *[torch.from_numpy(a) for a in arrays],
                                    cfg=tcfg, block_size=BS)
        out.append((np.asarray(jl), tl.numpy()))
    return out, (_to_np(jk), _to_np(jv)), (_to_np(tk), _to_np(tv))


def _close(got, ref, rtol):
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


@pytest.mark.parametrize("name,attention,overrides", [
    ("llama-tiny", None, {}),                 # GQA, rope, rmsnorm, swiglu
    ("llama-tiny", "paged_kernel", {}),       # the kernel module's path
    ("gpt2-tiny", None, {}),                  # MHA, learned positions, gelu
    ("mistral-tiny", "paged_kernel", {"sliding_window": 8}),  # window
    ("mistral-tiny", None, {"sliding_window": 8}),
    ("bloom-tiny", None, {}),                 # ALiBi, embedding norm, biases
    ("phi-tiny", None, {}),                   # parallel block, partial rope
    ("gptneo-tiny", None, {"sliding_window": 8}),  # alternating windows
], ids=["llama", "llama-kernel", "gpt2", "mistral-window-kernel",
        "mistral-window", "bloom-alibi", "phi-parallel", "gptneo-alt"])
def test_ragged_forward_matches_jax_fp32(name, attention, overrides):
    steps, jcache, tcache = _run(name, attention=attention, **overrides)
    for jl, tl in steps:
        assert tl.shape == jl.shape and tl.dtype == np.float32
        _close(tl, jl, 1e-5)
    for j, t in zip(jcache, tcache):
        _close(t, j, 1e-5)


def test_ragged_forward_bf16_cache_matches_jax():
    steps, (jk, jv), (tk, tv) = _run("llama-tiny", kv="bf16")
    for jl, tl in steps:
        _close(tl, jl, 1e-3)
    for j, t in ((jk, tk), (jv, tv)):
        np.testing.assert_allclose(t, j, rtol=2.0 ** -7, atol=1e-6)


def test_ragged_forward_int8_cache_matches_jax():
    steps, (jk, jv), (tk, tv) = _run("llama-tiny", kv="int8")
    for jl, tl in steps:
        _close(tl, jl, 1e-3)
    for j, t in ((jk, tk), (jv, tv)):
        diff = np.abs(t["q"] - j["q"])
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
        np.testing.assert_allclose(t["s"], j["s"], rtol=1e-5, atol=0)
        assert (t["s"] > 0).any()


def test_bridge_round_trip_is_bitwise():
    jcfg = jax_model_config("llama-tiny")
    tcfg = get_model_config("llama-tiny")
    jp = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(4)))
    back = params_to_numpy(params_from_jax(jp, tcfg, device="cpu"))
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_t)
    for path, a in flat_j:
        b = flat_t[path]
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), path


def test_bridge_bf16_bits_and_engine_cast():
    """bf16 leaves carry their bit patterns; ``dtype=`` casts every leaf
    but the norms, which the forward casts to fp32 at use (the JAX
    engine's rounding)."""
    jcfg = jax_model_config("gpt2-tiny")
    tcfg = get_model_config("gpt2-tiny")
    jp32 = jax_init_params(jcfg, jax.random.PRNGKey(5))
    jp16 = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), jp32)
    tp16 = params_from_jax(jp16, tcfg, device="cpu")
    a, t = jp16["layers"]["attn"]["wq"], tp16["layers"]["attn"]["wq"]
    assert t.dtype == torch.bfloat16
    assert (t.view(torch.int16).numpy() == a.view(np.int16)).all()
    np.testing.assert_array_equal(params_to_numpy(tp16)["embed"]["tokens"],
                                  jp16["embed"]["tokens"].astype(np.float32))
    cast = params_from_jax(jax.tree.map(np.asarray, jp32), tcfg,
                           device="cpu", dtype=torch.bfloat16)
    assert cast["layers"]["ln1"]["scale"].dtype == torch.float32
    assert cast["final_norm"]["bias"].dtype == torch.float32
    assert (cast["layers"]["mlp"]["wi"].view(torch.int16).numpy()
            == jp16["layers"]["mlp"]["wi"].view(np.int16)).all()
    with pytest.raises(ValueError, match="layers"):
        params_from_jax(jp16, tcfg.replace(num_layers=3), device="cpu")


@pytest.mark.parametrize("name", ["llama-tiny", "gpt2-tiny", "bloom-tiny"])
def test_init_params_tree_matches_jax(name):
    """Same key paths, shapes and dtypes as the JAX init; norms are ones
    and zeros, matrices carry the JAX scales (values differ: other RNG)."""
    jcfg = jax_model_config(name)
    jtree = jax.eval_shape(partial(jax_init_params, jcfg),
                           jax.random.PRNGKey(0))
    ttree = init_params(get_model_config(name), seed=0, device="cpu")
    jflat = dict(jax.tree_util.tree_leaves_with_path(jtree))
    tflat = dict(jax.tree_util.tree_leaves_with_path(ttree))
    assert set(jflat) == set(tflat)
    for path, s in jflat.items():
        assert tuple(tflat[path].shape) == s.shape, path
        assert tflat[path].dtype == torch.float32
    wq = ttree["layers"]["attn"]["wq"]
    assert abs(float(wq.std()) * np.sqrt(jcfg.hidden_size) - 1.0) < 0.05
    assert torch.equal(ttree["final_norm"]["scale"],
                       torch.ones(jcfg.hidden_size))
    again = init_params(get_model_config(name), seed=0, device="cpu")
    assert torch.equal(again["embed"]["tokens"], ttree["embed"]["tokens"])
