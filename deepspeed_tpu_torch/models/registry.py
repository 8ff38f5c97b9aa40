"""Model presets (flagship + test-scale configs)."""

from __future__ import annotations

from deepspeed_tpu_torch.models.transformer import TransformerConfig

_REGISTRY = {}


def register(name: str, cfg: TransformerConfig) -> TransformerConfig:
    _REGISTRY[name] = cfg
    return cfg


def get_model_config(name: str, **overrides) -> TransformerConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; known: {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]
    return cfg.replace(**overrides) if overrides else cfg


def list_models():
    return sorted(_REGISTRY)


# -- GPT-2 family ------------------------------------------------------
register("gpt2-125m", TransformerConfig(
    vocab_size=50304,  # padded to 128 multiple for MXU tiling
    hidden_size=768, intermediate_size=3072, num_layers=12, num_heads=12,
    max_seq_len=1024, arch="gpt2", norm="layernorm", activation="gelu"))

register("gpt2-350m", TransformerConfig(
    vocab_size=50304, hidden_size=1024, intermediate_size=4096, num_layers=24,
    num_heads=16, max_seq_len=1024, arch="gpt2"))

register("gpt2-1.3b", TransformerConfig(
    vocab_size=50304, hidden_size=2048, intermediate_size=8192, num_layers=24,
    num_heads=32, max_seq_len=2048, arch="gpt2"))

# GPT-3 6.7B-class geometry — the peak_params ladder's chunked-offload
# rung builds this shape from gpt2-1.3b overrides; registered so the
# plan compiler (tools/plan.py --model gpt2-6.7b) can name it directly
register("gpt2-6.7b", TransformerConfig(
    vocab_size=50304, hidden_size=4096, intermediate_size=16384,
    num_layers=32, num_heads=32, max_seq_len=2048, arch="gpt2"))

# ~1B-total MoE with 8 routed experts: the planner's expert-parallel
# sight-unseen target (moe_1b_ep8) — experts dominate the param count,
# so expert-parallel meshes beat replicated-expert DP on wire bytes
register("moe-1b-ep8", TransformerConfig(
    vocab_size=32000, hidden_size=1024, intermediate_size=2816,
    num_layers=12, num_heads=16, num_kv_heads=8, max_seq_len=2048,
    arch="llama", norm="rmsnorm", activation="swiglu", use_rope=True,
    tie_embeddings=False, num_experts=8, top_k=2, moe_layer_freq=1))

# -- Llama family ------------------------------------------------------
_llama = dict(arch="llama", norm="rmsnorm", activation="swiglu", use_rope=True,
              tie_embeddings=False, rope_theta=500000.0)

register("llama3-8b", TransformerConfig(
    vocab_size=128256, hidden_size=4096, intermediate_size=14336, num_layers=32,
    num_heads=32, num_kv_heads=8, max_seq_len=8192, **_llama))

register("llama3-70b", TransformerConfig(
    vocab_size=128256, hidden_size=8192, intermediate_size=28672, num_layers=80,
    num_heads=64, num_kv_heads=8, max_seq_len=8192, **_llama))

register("llama-tiny", TransformerConfig(
    vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
    num_heads=4, num_kv_heads=2, max_seq_len=256, arch="llama", norm="rmsnorm",
    activation="swiglu", use_rope=True, tie_embeddings=False, rope_theta=10000.0))

# -- Mixtral-style MoE -------------------------------------------------
register("mixtral-tiny", TransformerConfig(
    vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
    num_heads=4, num_kv_heads=2, max_seq_len=256, arch="llama", norm="rmsnorm",
    activation="swiglu", use_rope=True, tie_embeddings=False,
    num_experts=4, top_k=2, moe_layer_freq=1))

# Qwen2-MoE style: narrower routed experts + a gated shared expert
register("qwen2moe-tiny", TransformerConfig(
    vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
    num_heads=4, num_kv_heads=2, max_seq_len=256, arch="llama",
    norm="rmsnorm", activation="swiglu", use_rope=True,
    tie_embeddings=False, qkv_bias=True, num_experts=4, top_k=2,
    moe_layer_freq=1, moe_intermediate_size=64, moe_shared_expert_size=128))

register("qwen2moe-a14b", TransformerConfig(  # Qwen2-57B-A14B geometry
    vocab_size=151936, hidden_size=3584, intermediate_size=18944,
    num_layers=28, num_heads=28, num_kv_heads=4, max_seq_len=32768,
    arch="llama", norm="rmsnorm", activation="swiglu", use_rope=True,
    tie_embeddings=False, qkv_bias=True, num_experts=64, top_k=8,
    moe_layer_freq=1, moe_intermediate_size=2560,
    moe_shared_expert_size=20480))

register("mixtral-8x7b", TransformerConfig(
    vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_layers=32,
    num_heads=32, num_kv_heads=8, max_seq_len=8192, arch="llama", norm="rmsnorm",
    activation="swiglu", use_rope=True, tie_embeddings=False, rope_theta=1e6,
    num_experts=8, top_k=2, moe_layer_freq=1))

# -- OPT family (ref inference/v2/model_implementations/opt) -----------
_opt = dict(arch="opt", norm="layernorm", activation="relu",
            learned_positions=True, use_bias=True, tie_embeddings=True)

register("opt-125m", TransformerConfig(
    vocab_size=50272, hidden_size=768, intermediate_size=3072, num_layers=12,
    num_heads=12, max_seq_len=2048, **_opt))

register("opt-1.3b", TransformerConfig(
    vocab_size=50272, hidden_size=2048, intermediate_size=8192, num_layers=24,
    num_heads=32, max_seq_len=2048, **_opt))

# -- Mistral (ref v2 mistral: llama + sliding window) ------------------
register("mistral-7b", TransformerConfig(
    vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_layers=32,
    num_heads=32, num_kv_heads=8, max_seq_len=8192, arch="mistral",
    norm="rmsnorm", activation="swiglu", use_rope=True, tie_embeddings=False,
    rope_theta=10000.0, sliding_window=4096))

# -- Qwen2 (ref v2 qwen_v2: llama + qkv bias) --------------------------
register("qwen2-7b", TransformerConfig(
    vocab_size=152064, hidden_size=3584, intermediate_size=18944,
    num_layers=28, num_heads=28, num_kv_heads=4, max_seq_len=8192,
    arch="qwen2", norm="rmsnorm", activation="swiglu", use_rope=True,
    tie_embeddings=False, rope_theta=1e6, qkv_bias=True))

# -- Falcon (ref v2 falcon: multi-query + parallel block) --------------
register("falcon-7b", TransformerConfig(
    vocab_size=65024, hidden_size=4544, intermediate_size=18176,
    num_layers=32, num_heads=71, num_kv_heads=1, max_seq_len=2048,
    arch="falcon", norm="layernorm", activation="gelu", use_rope=True,
    tie_embeddings=True, parallel_block=True, use_bias=False))

# -- Phi (ref v2 phi: parallel block + partial rotary + biases) --------
register("phi-2", TransformerConfig(
    vocab_size=51200, hidden_size=2560, intermediate_size=10240,
    num_layers=32, num_heads=32, max_seq_len=2048, arch="phi",
    norm="layernorm", activation="gelu", use_rope=True, rotary_pct=0.4,
    tie_embeddings=False, parallel_block=True, use_bias=True))

# -- test-scale --------------------------------------------------------
register("gpt2-tiny", TransformerConfig(
    vocab_size=512, hidden_size=128, intermediate_size=512, num_layers=2,
    num_heads=4, max_seq_len=256, arch="gpt2"))

register("opt-tiny", TransformerConfig(
    vocab_size=512, hidden_size=128, intermediate_size=512, num_layers=2,
    num_heads=4, max_seq_len=256, **_opt))

register("mistral-tiny", TransformerConfig(
    vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
    num_heads=4, num_kv_heads=2, max_seq_len=256, arch="mistral",
    norm="rmsnorm", activation="swiglu", use_rope=True, tie_embeddings=False,
    sliding_window=32))

register("qwen2-tiny", TransformerConfig(
    vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
    num_heads=4, num_kv_heads=2, max_seq_len=256, arch="qwen2",
    norm="rmsnorm", activation="swiglu", use_rope=True, tie_embeddings=False,
    qkv_bias=True))

register("falcon-tiny", TransformerConfig(
    vocab_size=512, hidden_size=128, intermediate_size=512, num_layers=2,
    num_heads=8, num_kv_heads=1, max_seq_len=256, arch="falcon",
    norm="layernorm", activation="gelu", use_rope=True, tie_embeddings=True,
    parallel_block=True, use_bias=False))

register("phi-tiny", TransformerConfig(
    vocab_size=512, hidden_size=128, intermediate_size=512, num_layers=2,
    num_heads=4, max_seq_len=256, arch="phi", norm="layernorm",
    activation="gelu", use_rope=True, rotary_pct=0.5, tie_embeddings=False,
    parallel_block=True, use_bias=True))


# -- Encoder (BERT-class) family ---------------------------------------
# Ref: the reference trains these through its fused transformer kernel
# (ops/transformer/transformer.py:296) and serves them via the
# bert/distil_bert v1 injection containers (module_inject/containers).
_bert = dict(arch="bert", norm="layernorm", activation="gelu_exact",
             causal=False, norm_position="post", embed_norm=True,
             mlm_head=True, tie_embeddings=True, layernorm_eps=1e-12)

register("bert-base-uncased", TransformerConfig(
    vocab_size=30522, hidden_size=768, intermediate_size=3072,
    num_layers=12, num_heads=12, max_seq_len=512, type_vocab_size=2,
    dropout=0.1, **_bert))

register("bert-large-uncased", TransformerConfig(
    vocab_size=30522, hidden_size=1024, intermediate_size=4096,
    num_layers=24, num_heads=16, max_seq_len=512, type_vocab_size=2,
    dropout=0.1, **_bert))

register("bert-tiny", TransformerConfig(
    vocab_size=512, hidden_size=128, intermediate_size=512, num_layers=2,
    num_heads=4, max_seq_len=256, type_vocab_size=2, **_bert))

register("distilbert-base-uncased", TransformerConfig(
    vocab_size=30522, hidden_size=768, intermediate_size=3072,
    num_layers=6, num_heads=12, max_seq_len=512, dropout=0.1,
    **{**_bert, "arch": "distilbert"}))

register("distilbert-tiny", TransformerConfig(
    vocab_size=512, hidden_size=128, intermediate_size=512, num_layers=2,
    num_heads=4, max_seq_len=256, **{**_bert, "arch": "distilbert"}))


# -- Bloom / GPT-J / GPT-NeoX (v1 injection breadth) -------------------
# Ref containers: module_inject/containers/{bloom,gptj,gptneox}.py
register("bloom-560m", TransformerConfig(
    vocab_size=250880, hidden_size=1024, intermediate_size=4096,
    num_layers=24, num_heads=16, max_seq_len=2048, arch="bloom",
    norm="layernorm", activation="gelu", use_alibi=True, embed_norm=True,
    use_bias=True, tie_embeddings=True))

register("bloom-tiny", TransformerConfig(
    vocab_size=512, hidden_size=128, intermediate_size=512, num_layers=2,
    num_heads=4, max_seq_len=256, arch="bloom", norm="layernorm",
    activation="gelu", use_alibi=True, embed_norm=True, use_bias=True,
    tie_embeddings=True))

register("gptj-6b", TransformerConfig(
    vocab_size=50400, hidden_size=4096, intermediate_size=16384,
    num_layers=28, num_heads=16, max_seq_len=2048, arch="gptj",
    norm="layernorm", activation="gelu", use_rope=True,
    rope_interleaved=True, rotary_pct=64 / 256, parallel_block=True,
    use_bias=False, mlp_bias=True, tie_embeddings=False))

register("gptj-tiny", TransformerConfig(
    vocab_size=512, hidden_size=128, intermediate_size=512, num_layers=2,
    num_heads=4, max_seq_len=256, arch="gptj", norm="layernorm",
    activation="gelu", use_rope=True, rope_interleaved=True,
    rotary_pct=0.5, parallel_block=True, use_bias=False, mlp_bias=True,
    tie_embeddings=False))

register("gptneox-20b", TransformerConfig(
    vocab_size=50432, hidden_size=6144, intermediate_size=24576,
    num_layers=44, num_heads=64, max_seq_len=2048, arch="gptneox",
    norm="layernorm", activation="gelu_exact", use_rope=True,
    rotary_pct=0.25, parallel_block=True, parallel_norms=True,
    use_bias=True, tie_embeddings=False))

register("gptneox-tiny", TransformerConfig(
    vocab_size=512, hidden_size=128, intermediate_size=512, num_layers=2,
    num_heads=4, max_seq_len=256, arch="gptneox", norm="layernorm",
    activation="gelu_exact", use_rope=True, rotary_pct=0.25,
    parallel_block=True, parallel_norms=True, use_bias=True,
    tie_embeddings=False))


register("gptneo-1.3b", TransformerConfig(
    vocab_size=50257, hidden_size=2048, intermediate_size=8192,
    num_layers=24, num_heads=16, max_seq_len=2048, arch="gptneo",
    norm="layernorm", activation="gelu", learned_positions=True,
    use_bias=False, mlp_bias=True, attn_out_bias=True, alt_window=True,
    sliding_window=256,
    attn_scale=1.0, tie_embeddings=True))

register("gptneo-tiny", TransformerConfig(
    vocab_size=512, hidden_size=128, intermediate_size=512, num_layers=2,
    num_heads=4, max_seq_len=256, arch="gptneo", norm="layernorm",
    activation="gelu", learned_positions=True, use_bias=False,
    mlp_bias=True, attn_out_bias=True, alt_window=True,
    sliding_window=16, attn_scale=1.0,
    tie_embeddings=True))
