"""The port's ``linear/`` and its duck-typed training path against the JAX
package's, on the CPU.

``deepspeed_tpu_torch/linear`` against ``deepspeed_tpu/linear``:
``QuantizedParameter`` for q_bits 4, 6 and 8 (the same stored bytes, the
same dequantized weight, the same ``nbytes``), ``lora_linear`` forward and
gradients for (x, A, B) against ``jax.grad`` (dx through the FP6 custom
VJP with a non-zero B), ``OptimizedLinear``, the bridge of a JAX
``QuantizedParameter`` and its adapters, and a 2-block ``LoRAStack`` (a
duck-typed trainable: a residual stack of SwiGLU MLP blocks whose gate, up
and down projections are ``OptimizedLinear``s over quantized frozen bases)
trained 3 steps by ``initialize()`` → ``train_batch`` in both engines from
the same adapters.

The JAX side runs as its own tests run it: the FP6 product through the
interpreted Pallas kernel (``fp6_linear.INTERPRET``), int bases quantized
by its default CPU route (the jnp arithmetic, which the port matches bit
for bit; ``tests/test_torch_quantizer.py`` compares the interpreted
quantize kernel) and dequantized by the interpreted kernel, and its engine
on a one-device mesh.  Tolerances, fp32: forward 1e-5 and gradients 1e-5
relative to their largest entry (summation order), the loss curve 1e-5.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dsj
import deepspeed_tpu.linear as jlin
import deepspeed_tpu_torch as dst
import deepspeed_tpu_torch.linear as tlin
from deepspeed_tpu_torch.models.bridge import params_from_jax, quantized_from_jax
from deepspeed_tpu_torch.ops import fp6_linear as t6
from deepspeed_tpu_torch.ops import quantize as tqk

from test_torch_engine_v2 import one_torch_thread  # noqa: F401

f6 = importlib.import_module("deepspeed_tpu.ops.pallas.fp6_linear")
pq = importlib.import_module("deepspeed_tpu.ops.pallas.quantize")


@pytest.fixture(autouse=True)
def _interpret_fp6():
    old = f6.INTERPRET
    f6.INTERPRET = True
    yield
    f6.INTERPRET = old


@pytest.fixture
def interpret_quantize():
    old = pq.INTERPRET
    pq.INTERPRET = True
    yield
    pq.INTERPRET = old


def _w(k, n, seed, scale=0.1):
    return (np.random.default_rng(seed).standard_normal((k, n)) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.abs(got - ref).max() <= rtol * max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("q_bits,shape,group", [
    (8, (64, 512), 128), (8, (64, 96), 512), (4, (64, 512), 128),
    (4, (32, 100), 512), (6, (128, 256), 512)])
def test_quantized_parameter_matches_jax(q_bits, shape, group):
    w = _w(*shape, seed=q_bits)
    jq = jlin.QuantizedParameter(jnp.asarray(w), q_bits=q_bits,
                                 group_size=group)
    tq = tlin.QuantizedParameter(_t(w), q_bits=q_bits, group_size=group)
    assert tq.group_size == jq.group_size and tq.shape == jq.shape
    np.testing.assert_array_equal(tq.data.numpy(), np.asarray(jq.data))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    assert tq.nbytes == jq.nbytes
    np.testing.assert_array_equal(tq.dequantized().numpy(),
                                  np.asarray(jq.dequantized()))
    assert [n for n, _ in tq.named_parameters()] == []
    assert {n for n, _ in tq.named_buffers()} == {"data", "scale"}


@pytest.mark.parametrize("q_bits", [4, 6, 8, None])
def test_lora_linear_forward_and_grads_match_jax(q_bits):
    rng = np.random.default_rng(5)
    w = _w(64, 256, seed=6)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    a = rng.uniform(-0.3, 0.3, (64, 8)).astype(np.float32)
    b = (rng.standard_normal((8, 256)) * 0.1).astype(np.float32)  # B != 0
    if q_bits is None:
        jbase, tbase = jnp.asarray(w), _t(w)
    else:
        jbase = jlin.QuantizedParameter(jnp.asarray(w), q_bits=q_bits,
                                        group_size=128)
        tbase = tlin.QuantizedParameter(_t(w), q_bits=q_bits, group_size=128)

    def jloss(x_, a_, b_):
        y = jlin.lora_linear(x_, jbase, a_, b_, lora_alpha=16.0, lora_r=8)
        return jnp.sum(y * jnp.sin(y)), y

    (lj, yj), gj = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b))
    xt, at, bt = (_t(v).requires_grad_(True) for v in (x, a, b))
    yt = tlin.lora_linear(xt, tbase, at, bt, lora_alpha=16.0, lora_r=8)
    torch.sum(yt * torch.sin(yt)).backward()
    _close(yt.detach().numpy(), yj, 1e-5)
    for got, ref in zip((xt.grad, at.grad, bt.grad), gj):
        assert float(torch.abs(got).sum()) > 0
        _close(got.numpy(), ref, 1e-5)


def test_fp6_base_takes_no_gradient_and_counts_nothing_on_cpu():
    w = _w(64, 128, seed=7)
    lin = tlin.OptimizedLinear(_t(w), lora_config=tlin.LoRAConfig(lora_r=8),
                               quantization_config=tlin.QuantizationConfig(q_bits=6))
    assert sorted(lin.trainable_params()) == ["lora_A", "lora_B"]
    assert sorted(n for n, _ in lin.named_parameters()) == ["lora_A", "lora_B"]
    assert {n for n, _ in lin.named_buffers()} == {"base.data", "base.scale"}
    assert lin.base.data.dtype == torch.uint8 and not lin.base.data.requires_grad
    before = dict(t6.fp6_matmul.launches)
    x = torch.randn(4, 64, requires_grad=True)
    lin(x).sum().backward()
    assert x.grad is not None and lin.lora_B.grad is not None
    assert t6.fp6_matmul.launches == before
    # delay_lora_init: no adapter of its own, one per call
    lazy = tlin.OptimizedLinear(_t(w), lora_config=tlin.LoRAConfig(
        lora_r=8, delay_lora_init=True))
    assert lazy.trainable_params() == {}
    p = tlin.init_lora_params(torch.Generator().manual_seed(0), 64, 128,
                              tlin.LoRAConfig(lora_r=8))
    assert p["lora_A"].shape == (64, 8) and not p["lora_B"].any()
    assert abs(float(p["lora_A"].abs().max())) <= (6.0 / 64) ** 0.5
    torch.testing.assert_close(lazy(x, **p), x @ _t(w), rtol=0, atol=0)


@pytest.mark.parametrize("q_bits", [4, 6, 8])
def test_bridge_carries_jax_quantized_parameter(q_bits, interpret_quantize):
    """A JAX base (int bases quantized here by the interpreted Pallas
    kernel) comes across by its fields with the same bytes."""
    w = _w(64, 256, seed=8)
    jq = jlin.QuantizedParameter(jnp.asarray(w).astype(jnp.bfloat16),
                                 q_bits=q_bits, group_size=128)
    tq = quantized_from_jax(
        np.asarray(jq.data), np.asarray(jq.scale),
        None if jq.zero is None else np.asarray(jq.zero), jq.q_bits,
        jq.shape, jq.dtype, jq.group_size, device="cpu")
    assert tq.dtype == torch.bfloat16 and tq.shape == jq.shape
    np.testing.assert_array_equal(tq.data.numpy(), np.asarray(jq.data))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    np.testing.assert_array_equal(tq.dequantized().float().numpy(),
                                  np.asarray(jq.dequantized().astype(jnp.float32)))
    adapters = jlin.init_lora_params(jax.random.PRNGKey(0), 64, 256,
                                     jlin.LoRAConfig(lora_r=8))
    tree = params_from_jax(jax.tree.map(np.asarray, {"proj": adapters}),
                           None, device="cpu")
    np.testing.assert_array_equal(tree["proj"]["lora_A"].numpy(),
                                  np.asarray(adapters["lora_A"]))


# ----------------------------------------------------------------------
# the duck-typed trainable, in both frameworks (same code shape)
# ----------------------------------------------------------------------
PROJ = ("gate", "up", "down")


class JaxLoRAStack:
    """Residual SwiGLU MLP blocks over quantized frozen bases; params are
    the adapters only."""

    def __init__(self, weights, q_bits, group_size, lora_r, dtype=jnp.float32):
        self.lora_config = jlin.LoRAConfig(lora_r=lora_r, delay_lora_init=True)
        qc = jlin.QuantizationConfig(q_bits=q_bits, group_size=group_size)
        self.dtype = dtype
        self.blocks = [{name: jlin.OptimizedLinear(jnp.asarray(w).astype(dtype),
                                                   lora_config=self.lora_config,
                                                   quantization_config=qc)
                        for name, w in zip(PROJ, block)} for block in weights]

    def init(self, rng):
        params = {}
        for i, block in enumerate(self.blocks):
            for name, lin in block.items():
                rng, key = jax.random.split(rng)
                params.setdefault(f"block{i}", {})[name] = jlin.init_lora_params(
                    key, *lin.base.shape, self.lora_config)
        return params

    def loss(self, params, batch):
        h = batch["x"].astype(self.dtype)
        for i, block in enumerate(self.blocks):
            p = params[f"block{i}"]
            g = block["gate"](h, **p["gate"])
            u = block["up"](h, **p["up"])
            h = h + block["down"](jax.nn.silu(g) * u, **p["down"])
        return jnp.mean((h.astype(jnp.float32) - batch["y"]) ** 2)


class TorchLoRAStack:
    """The same trainable in the port."""

    def __init__(self, weights, q_bits, group_size, lora_r,
                 dtype=torch.float32, device="cpu"):
        self.lora_config = tlin.LoRAConfig(lora_r=lora_r, delay_lora_init=True)
        qc = tlin.QuantizationConfig(q_bits=q_bits, group_size=group_size)
        self.dtype = dtype
        self.blocks = [{name: tlin.OptimizedLinear(
            torch.as_tensor(w, device=device).to(dtype),
            lora_config=self.lora_config, quantization_config=qc)
            for name, w in zip(PROJ, block)} for block in weights]

    def init(self, generator):
        params = {}
        for i, block in enumerate(self.blocks):
            for name, lin in block.items():
                params.setdefault(f"block{i}", {})[name] = tlin.init_lora_params(
                    generator, *lin.base.shape, self.lora_config)
        return params

    def loss(self, params, batch):
        h = batch["x"].to(self.dtype)
        for i, block in enumerate(self.blocks):
            p = params[f"block{i}"]
            g = block["gate"](h, **p["gate"])
            u = block["up"](h, **p["up"])
            h = h + block["down"](torch.nn.functional.silu(g) * u, **p["down"])
        return torch.mean(torch.square(h.float() - batch["y"]))


def _stack_weights(hidden, inter, blocks, seed):
    rng = np.random.default_rng(seed)
    return [[(rng.standard_normal(s) * 0.1).astype(np.float32)
             for s in ((hidden, inter), (hidden, inter), (inter, hidden))]
            for _ in range(blocks)]


def _adapters(hidden, inter, blocks, r, seed):
    """Non-zero A and B (B = 0 at init would leave dL/dA zero on step 1)."""
    rng = np.random.default_rng(seed)
    dims = {"gate": (hidden, inter), "up": (hidden, inter), "down": (inter, hidden)}
    return {f"block{i}": {n: {"lora_A": rng.uniform(-0.2, 0.2, (d[0], r)).astype(np.float32),
                              "lora_B": (rng.standard_normal((r, d[1])) * 0.05).astype(np.float32)}
                          for n, d in dims.items()} for i in range(blocks)}


@pytest.mark.parametrize("q_bits,group", [(4, 128), (6, 512), (8, 64), (8, 128)])
def test_lora_stack_trains_like_jax_engine(q_bits, group):
    hidden, inter, blocks, r = 64, 128, 2, 8
    weights = _stack_weights(hidden, inter, blocks, seed=10)
    adapters = _adapters(hidden, inter, blocks, r, seed=11)
    cfg = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}},
           "gradient_clipping": 1.0, "steps_per_print": 10_000}
    rng = np.random.default_rng(12)
    batch = {"x": rng.standard_normal((4, 8, hidden)).astype(np.float32),
             "y": rng.standard_normal((4, 8, hidden)).astype(np.float32)}

    jeng, *_ = dsj.initialize(
        model=JaxLoRAStack(weights, q_bits, group, r),
        config={**cfg, "mesh": {"data": 1}},
        model_parameters=jax.tree.map(jnp.asarray, adapters))
    tmodel = TorchLoRAStack(weights, q_bits, group, r)
    teng, *_ = dst.initialize(model=tmodel, config=cfg, device="cpu",
                              model_parameters=params_from_jax(adapters, None,
                                                               device="cpu"))
    assert len(teng.opt_state["mu"]) == blocks
    jl = [float(jeng.train_batch(batch)) for _ in range(3)]
    tl = [float(teng.train_batch(batch)) for _ in range(3)]
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(teng.get_global_grad_norm(),
                               float(jeng.get_global_grad_norm()), rtol=1e-5)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    np.testing.assert_allclose(float(teng.eval_batch(tb)),
                               float(jeng.eval_batch(batch)), rtol=1e-5)
    assert tqk.launches == dict.fromkeys(tqk.launches, 0)


def test_configs_hold_only_fields_that_are_read():
    """The port's configs are the JAX ones less the fields that nothing in
    either package reads; setting one of those is an error, not a no-op."""
    from dataclasses import fields

    names = lambda cls: {f.name for f in fields(cls)}  # noqa: E731
    assert names(tlin.LoRAConfig) == names(jlin.LoRAConfig) - {
        "base_weight_sharding", "offload", "offload_ratio"}
    assert names(tlin.QuantizationConfig) == names(jlin.QuantizationConfig) - {
        "mantissa_bits"}
    with pytest.raises(TypeError, match="offload"):
        tlin.LoRAConfig(offload=True)
    with pytest.raises(TypeError, match="mantissa_bits"):
        tlin.QuantizationConfig(q_bits=6, mantissa_bits=2)


def test_duck_typed_engine_logs_bf16_flag_as_ignored(monkeypatch):
    from deepspeed_tpu_torch.runtime import engine as tengine

    warned = []
    monkeypatch.setattr(tengine, "log_dist",
                        lambda msg, **kw: warned.append((msg, kw.get("level"))))
    model = TorchLoRAStack(_stack_weights(64, 128, 1, seed=13), 8, 128, 4)
    cfg = {"train_micro_batch_size_per_gpu": 1, "gradient_accumulation_steps": 1}
    dst.initialize(model=model, config=cfg, device="cpu")
    assert warned == []
    eng, *_ = dst.initialize(model=model, config={**cfg, "bf16": {"enabled": True}},
                             device="cpu")
    assert [w for w in warned if "bf16" in w[0]] == [
        ("bf16.enabled is ignored for a duck-typed trainable: it computes in "
         "the dtype it chooses itself", "warning")]
    assert eng.model_config is None
    assert eng.params["block0"]["gate"]["lora_A"].dtype == torch.float32


def test_duck_typed_engine_init_and_rejections():
    weights = _stack_weights(64, 128, 1, seed=13)
    model = TorchLoRAStack(weights, 8, 128, 4)
    cfg = {"train_micro_batch_size_per_gpu": 1, "gradient_accumulation_steps": 1}
    eng, *_ = dst.initialize(model=model, config=cfg, device="cpu", seed=3)
    leaves = [eng.params["block0"][n][k] for n in PROJ for k in ("lora_A", "lora_B")]
    assert all(p.requires_grad and p.dtype == torch.float32 for p in leaves)
    assert not any(p.any() for p in leaves[1::2])            # B = 0 at init
    again, *_ = dst.initialize(model=model, config=cfg, device="cpu", seed=3)
    assert torch.equal(again.params["block0"]["up"]["lora_A"],
                       eng.params["block0"]["up"]["lora_A"])
    rng = np.random.default_rng(0)
    loss = eng.train_batch({"x": torch.from_numpy(rng.standard_normal((1, 4, 64)).astype(np.float32)),
                            "y": rng.standard_normal((1, 4, 64)).astype(np.float32)})
    assert np.isfinite(float(loss))
    with pytest.raises(TypeError, match="init"):
        dst.initialize(model=object(), config=cfg, device="cpu")
