"""Functional transformer model family (GPT-2 and Llama class), PyTorch.

Port of ``deepspeed_tpu/models/transformer.py``: the main-path subset the
ragged serving forward needs.  The parameter tree keeps the JAX package's
key paths and its ``[in, out]`` kernel layout (``x @ W``, no
``nn.Linear`` transpose), with the per-layer leaves stacked on axis 0, so
a JAX param tree carries over through numpy as an identity copy
(``models/bridge.py``).

Of the branches not ported yet, MoE layers and the ZeRO-3 fused
gather-matmul are the ones this subset can reach: ``init_params`` and the
ragged forward raise ``NotImplementedError`` for them, naming the ROADMAP
item.  The ring, sparse and pipeline branches live in the training
forward, which is not ported yet (ROADMAP Queue A items 2 and 9 to 11).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.utils.device import resolve_device

Params = Dict[str, Any]

@dataclass(frozen=True)
class TransformerConfig:
    """Architecture hyperparameters covering GPT-2 and Llama families."""
    vocab_size: int = 50257
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: Optional[int] = None  # < num_heads → GQA (Llama-3)
    head_dim: Optional[int] = None
    max_seq_len: int = 1024
    # architecture switches
    arch: str = "gpt2"  # "gpt2" | "llama" | "opt" | "mistral" | "qwen2" | "falcon" | "phi"
    norm: str = "layernorm"  # "layernorm" | "rmsnorm"
    activation: str = "gelu"  # "gelu" | "swiglu" | "relu"
    use_rope: bool = False
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0  # Phi-style partial rotary (fraction of head dim)
    tie_embeddings: bool = True
    # family features (ref inference/v2/model_implementations/{opt,phi,qwen,
    # falcon,mistral}): learned absolute positions, projection biases,
    # sliding-window attention, parallel attn+MLP residual blocks
    learned_positions: Optional[bool] = None  # None → arch == "gpt2"/"opt"
    use_bias: Optional[bool] = None  # all proj biases; None → gpt2/opt
    qkv_bias: bool = False  # qkv-only bias (Qwen2)
    sliding_window: Optional[int] = None  # Mistral
    # GPT-Neo attention_types: ODD global layer indices use
    # sliding_window ("local"), even ones attend globally.  Realized by
    # scanning layer PAIRS with a static per-member config — no dynamic
    # masks (ref module_inject/containers/gptneo.py)
    alt_window: bool = False
    # attention score scale; None → 1/sqrt(head_dim).  GPT-Neo famously
    # omits the sqrt(d) scaling (scale = 1.0)
    attn_scale: Optional[float] = None
    # ALiBi positional bias (Bloom): score += slope[h] · key_position —
    # used instead of rope/learned positions
    use_alibi: bool = False
    # GPT-J rotary layout: dims pair as (2i, 2i+1) ("rotate every two")
    # instead of the llama/neox half-split
    rope_interleaved: bool = False
    # MLP bias independent of attention bias (GPT-J: biasless attention,
    # biased MLP); None → follows has_bias
    mlp_bias: Optional[bool] = None
    # attention OUT-projection bias independent of q/k/v bias (GPT-Neo:
    # biasless q/k/v, biased out_proj); None → follows has_bias
    attn_out_bias: Optional[bool] = None
    # False = bidirectional (encoder/BERT-class) attention.  The reference
    # trains encoders through its fused transformer kernel
    # (ops/transformer/transformer.py:296 DeepSpeedTransformerLayer) and
    # serves bert/distilbert via v1 injection containers.
    causal: bool = True
    # "pre" (GPT/llama) | "post" (BERT: residual-add then LayerNorm; the
    # final norm is per-layer, so no final_norm is applied)
    norm_position: str = "pre"
    # BERT segment embeddings: 0 = none; batch may carry "token_type_ids"
    type_vocab_size: int = 0
    # BERT: LayerNorm (+dropout) applied to the summed embeddings
    embed_norm: bool = False
    # BERT MLM head: LN(gelu(h @ W + b)) @ embed.T + bias instead of the
    # plain lm_head matmul (HF BertLMPredictionHead)
    mlm_head: bool = False
    # vocab-size output bias added to the logits (GPT-J ships a nonzero
    # lm_head.bias; HF applies it, so serving parity requires it too)
    lm_head_bias: bool = False
    parallel_block: bool = False  # Falcon/Phi: x + attn(n) + mlp(n)
    # Falcon new_decoder_architecture (40B/180B, num_ln_in_parallel_attn=2):
    # the parallel block gets separate input norms — attn uses ln1 (HF
    # ln_attn) and the MLP uses ln2 (HF ln_mlp) on the same residual input.
    parallel_norms: bool = False
    # MoE (0 ⇒ dense; ref deepspeed/moe)
    num_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    # routed-expert FFN width when it differs from the dense layers'
    # intermediate_size (HF qwen2_moe moe_intermediate_size); None → same
    moe_intermediate_size: Optional[int] = None
    # Qwen2-MoE shared expert: a dense FFN of this width added to the
    # routed output, gated by sigmoid(x @ shared_gate); 0 = none
    moe_shared_expert_size: int = 0
    # True: renormalize top-k weights to sum to 1 (HF mixtral
    # norm_topk_prob); False: deepspeed top2gating drop-aware scaling
    moe_norm_topk: bool = False
    # Residual MoE (PR-MoE, ref moe/layer.py:29 use_residual /
    # arXiv:2201.05596): a dense expert-shaped MLP runs every token and a
    # learned 2-way coefficient softmax mixes it with the routed output
    moe_use_residual: bool = False
    # "auto" | "einsum" | "sorted": [T,E,C] one-hot einsum dispatch vs
    # argsort-by-expert gather dispatch (auto switches on one-hot size)
    moe_dispatch: str = "auto"
    # "1f1b" (training loss runs the interleaved schedule with O(pp) live
    # microbatches, ref runtime/pipe/schedule.py:189) | "gpipe" (fill-drain
    # forward scan differentiated by AD)
    pipeline_schedule: str = "1f1b"
    # ZeRO-Infinity: stacked layer params live in pinned host memory and
    # stream one layer at a time through the scan, fwd and bwd
    # (runtime/infinity.py; set by the engine from offload_param config)
    param_stream: bool = False
    moe_layer_freq: int = 2  # every Nth layer is MoE, matching ref PR-MoE style
    # pipeline parallelism: microbatches per forward call, i.e. per
    # gradient-accumulation micro-step (0 → pp size); must divide the
    # per-call batch dim
    pipeline_microbatches: int = 0
    # random-LTD (ref data_routing/basic_layer.py): a band of middle layers
    # [ltd_start, ltd_end) runs on ltd_kept random tokens; 0 = disabled.
    # ltd_kept is static per compile — the engine re-jits when the
    # schedule raises it (same recompile cadence as the reference's
    # shape changes).
    ltd_kept: int = 0
    ltd_start: int = 1
    ltd_end: Optional[int] = None
    # reference noisy gating (TopKGate noisy_gate_policy): 'RSample' |
    # 'Jitter' | None; active only while training threads a dropout/noise
    # key through the batch
    moe_noisy_gate_policy: Optional[str] = None
    # sequence-tiled logits+loss (ALST, sequence/alst.py): never
    # materialises [B, S, V]; 0 = full logits
    loss_tiles: int = 0
    # sequence-parallel attention form over the "seq" mesh axis:
    # "ulysses" (all-to-all head exchange; needs heads % (tp·sp) == 0) |
    # "ring" (K/V blocks rotate the ring with online softmax; no head
    # divisibility requirement — sequence/ring.py)
    seq_impl: str = "ulysses"
    # ring attention block placement over the seq mesh: "contiguous"
    # (shard r owns rows [r·S_l, (r+1)·S_l)) | "striped" (shard r owns
    # rows r, r+sp, … — Striped Attention causal load balancing: every
    # hop is ~half-masked on every rank, so the flash kernel's tile skip
    # halves causal compute uniformly instead of idling early ranks).
    # Striped feeds require stripe-permuted ids/labels; the engine
    # applies the permutation host-side and forward() derives matching
    # positions, so training is turnkey (sequence/ring.py helpers).
    ring_placement: str = "contiguous"
    # ring hop/compute interleave depth (step_schedule.ring_interleave;
    # sequence/ring.py): 1 = attend then rotate, 2 = rotate-ahead (next
    # hop's ppermute issued before the current hop's attend so the
    # transfer overlaps the hop's kernels)
    ring_interleave: int = 1
    # ring rotation wire dtype (comm_quantization.ring_rotation; set by
    # the engine): "fp32" | "int8" | "fp8" — quantized payloads + fp32
    # per-row scales travel every ring hop, dequantized in the consuming
    # flash kernel's epilogue (sequence/ring.py)
    ring_wire_dtype: str = "fp32"
    # layer-scan unroll factor (XLA overlaps across unrolled iterations)
    scan_unroll: int = 1
    # ZeRO-3 fused gather-matmul (step_schedule.fused_gather_matmul;
    # ops/pallas/gather_matmul.py): the MLP matmuls run inside an
    # explicit shard_map over `fused_gather_axes` that issues the
    # following matmul's param all-gather ahead of the current one.  Set
    # by the engine after it verifies the MLP weights actually carry the
    # expected fsdp sharding pattern.
    fused_gather_matmul: bool = False
    fused_gather_axes: Tuple[str, ...] = ()
    # residual/embedding dropout rate (GPT-2/BERT-class training; llama
    # pretraining leaves it 0).  Applied when the engine threads a
    # per-step PRNG key through the batch ("dropout_key"); inference and
    # eval paths pass no key, so dropout is identically off there.
    # Attention-probability dropout is folded into the residual drops
    # (the flash kernel keeps its probabilities in VMEM).  Under remat,
    # explicit keys make the recompute bitwise-identical — the property
    # the reference's CudaRNGStatesTracker exists to enforce.
    dropout: float = 0.0
    # numerics
    dtype: Any = torch.bfloat16  # compute dtype
    param_dtype: Any = torch.float32  # master dtype
    layernorm_eps: float = 1e-5
    # per-op autocast policy (ref runtime/torch_autocast.py): which op
    # classes stay fp32 regardless of the compute dtype.  None → the safe
    # default below.  Configured via the "torch_autocast" config block
    # ("fp32_ops"); dropping entries is the aggressive full-low-precision
    # mode.  NOTE: the Pallas flash kernels always accumulate softmax in
    # fp32 (hardware-right on TPU) — "softmax" here gates the XLA path.
    fp32_ops: Optional[Tuple[str, ...]] = None
    # module classes allowed to run in the low compute dtype; None → all.
    # Modules NOT listed are promoted to fp32 (the torch autocast
    # "lower_precision_safe_modules" contract).
    autocast_safe_modules: Optional[Tuple[str, ...]] = None
    # remat policy name: none|full|nothing_saveable|dots_saveable|dots_with_no_batch_dims_saveable
    remat_policy: str = "nothing_saveable"
    attn_impl: str = "auto"  # "auto" | "xla" | "pallas_flash" | "sparse"
    # block-sparse attention config (ref ops/sparse_attention sparsity
    # configs): {"mode": "fixed"|"bigbird"|"bslongformer"|"variable",
    # "block": 16, ...mode kwargs}; selected when attn_impl == "sparse"
    sparse_attention: Optional[Any] = None
    # inference-v2 module overrides as (kind, name) pairs — resolved via
    # inference/v2/modules.py (ref inference/v2/modules/heuristics.py)
    v2_modules: Optional[Tuple[Tuple[str, str], ...]] = None

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def dim_per_head(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def has_learned_positions(self) -> bool:
        if self.learned_positions is not None:
            return self.learned_positions
        return self.arch in ("gpt2", "opt", "bert", "distilbert")

    @property
    def has_bias(self) -> bool:
        if self.use_bias is not None:
            return self.use_bias
        return self.arch in ("gpt2", "opt", "phi", "bert", "distilbert")

    @property
    def has_mlp_bias(self) -> bool:
        return self.has_bias if self.mlp_bias is None else self.mlp_bias

    @property
    def has_attn_out_bias(self) -> bool:
        return (self.has_bias if self.attn_out_bias is None
                else self.attn_out_bias)

    def replace(self, **kw) -> "TransformerConfig":
        return dataclasses.replace(self, **kw)



# ----------------------------------------------------------------------
# Init
# ----------------------------------------------------------------------
_NORM_KEYS = ("ln1", "ln2", "final_norm", "norm")


def is_norm_path(path: Tuple[str, ...]) -> bool:
    """Norm scale/bias leaves: the forward casts them to the norm's
    compute dtype (fp32 by default) at use, so an engine keeps them in the
    master dtype while everything else is cast once to the compute dtype."""
    return any(k in _NORM_KEYS for k in path)


def _unsupported(cfg: TransformerConfig) -> None:
    if cfg.is_moe:
        raise NotImplementedError(
            "MoE layers are not ported yet (ROADMAP Queue A item 10)")
    if cfg.fused_gather_matmul:
        raise NotImplementedError(
            "the ZeRO-3 fused gather-matmul is not ported yet (ROADMAP "
            "Queue A item 8, Queue B item 6)")


def init_params(cfg: TransformerConfig, seed: int = 0, device=None,
                dtype: Optional[torch.dtype] = None) -> Params:
    """Full model params with per-layer params stacked on axis 0.

    Same tree, shapes and scales as the JAX ``init_params``; the values
    come from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (``None`` → CUDA, raising when no card is present), so they differ
    from ``jax.random``'s.  Matrices are drawn in fp32 and cast to
    ``dtype`` (default ``cfg.param_dtype``); norm leaves stay in
    ``cfg.param_dtype``.  Each stacked leaf is filled one layer at a time,
    so the peak extra memory is one layer's fp32 draw."""
    _unsupported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    pd = cfg.param_dtype
    wd = dtype or pd
    h, ffn, nl = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.dim_per_head
    scale = 1.0 / math.sqrt(h)
    out_scale = scale / math.sqrt(2 * nl)  # GPT-2 style residual scaling

    def dense(shape, sc, stacked=True):
        if not stacked:
            return (torch.randn(shape, generator=gen, device=dev,
                                dtype=torch.float32) * sc).to(wd)
        out = torch.empty((nl,) + shape, device=dev, dtype=wd)
        for i in range(nl):
            out[i] = torch.randn(shape, generator=gen, device=dev,
                                 dtype=torch.float32) * sc
        return out

    def const(shape, value, dt, stacked=True):
        return torch.full(((nl,) if stacked else ()) + shape, value,
                          device=dev, dtype=dt)

    attn = {"wq": dense((h, nh * hd), scale), "wk": dense((h, nkv * hd), scale),
            "wv": dense((h, nkv * hd), scale),
            "wo": dense((nh * hd, h), out_scale)}
    if cfg.has_bias or cfg.qkv_bias:
        attn["bq"] = const((nh * hd,), 0.0, wd)
        attn["bk"] = const((nkv * hd,), 0.0, wd)
        attn["bv"] = const((nkv * hd,), 0.0, wd)
    if cfg.has_attn_out_bias:
        attn["bo"] = const((h,), 0.0, wd)
    if cfg.activation == "swiglu":
        mlp = {"wi": dense((h, ffn), scale), "wg": dense((h, ffn), scale),
               "wo": dense((ffn, h), out_scale)}
    else:
        mlp = {"wi": dense((h, ffn), scale), "wo": dense((ffn, h), out_scale)}
        if cfg.has_mlp_bias:
            mlp["bi"] = const((ffn,), 0.0, wd)
            mlp["bo"] = const((h,), 0.0, wd)

    def norm_params(stacked=True):
        p = {"scale": const((h,), 1.0, pd, stacked)}
        if cfg.norm == "layernorm":
            p["bias"] = const((h,), 0.0, pd, stacked)
        return p

    params: Params = {
        "embed": {"tokens": dense((cfg.vocab_size, h), scale, False)},
        "layers": {"attn": attn, "mlp": mlp, "ln1": norm_params(),
                   "ln2": norm_params()},
        "final_norm": norm_params(False),
    }
    if cfg.has_learned_positions:
        params["embed"]["positions"] = dense((cfg.max_seq_len, h), scale,
                                             False)
    if cfg.type_vocab_size:
        params["embed"]["token_types"] = dense((cfg.type_vocab_size, h),
                                               scale, False)
    if cfg.embed_norm:
        params["embed"]["norm"] = {"scale": const((h,), 1.0, pd, False),
                                   "bias": const((h,), 0.0, pd, False)}
    if cfg.mlm_head:
        params["mlm_head"] = {
            "w": dense((h, h), scale, False),
            "b": const((h,), 0.0, wd, False),
            "ln": {"scale": const((h,), 1.0, pd, False),
                   "bias": const((h,), 0.0, pd, False)},
            "bias": const((cfg.vocab_size,), 0.0, wd, False),
        }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((h, cfg.vocab_size), scale, False)
    if cfg.lm_head_bias and not cfg.mlm_head:
        params["lm_head_bias"] = const((cfg.vocab_size,), 0.0, wd, False)
    return params


def tree_map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a nested dict of tensors/arrays."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


# ----------------------------------------------------------------------
# Forward pieces
# ----------------------------------------------------------------------
_DEFAULT_FP32_OPS = ("layernorm", "softmax", "rope", "router", "loss")


def op_fp32(cfg, op: str) -> bool:
    """Whether op class ``op`` runs in fp32 under the autocast policy."""
    ops = getattr(cfg, "fp32_ops", None)
    return op in (ops if ops is not None else _DEFAULT_FP32_OPS)


def _module_dtype(cfg: TransformerConfig, name: str, default_dt):
    """Compute dtype for module class ``name``: safe-listed (or no list →
    everything) runs in the low dtype, the rest is promoted to fp32."""
    if cfg.autocast_safe_modules is None:
        return default_dt
    if any(pat in name for pat in cfg.autocast_safe_modules):
        return default_dt
    return torch.float32


def _norm(x, p, cfg: TransformerConfig):
    dt = x.dtype
    ct = torch.float32 if op_fp32(cfg, "layernorm") else dt
    xc = x.to(ct)
    if cfg.norm == "rmsnorm":
        var = torch.mean(torch.square(xc), dim=-1, keepdim=True)
        out = xc * torch.rsqrt(var + cfg.layernorm_eps) * p["scale"].to(ct)
    else:
        mean = torch.mean(xc, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xc - mean), dim=-1, keepdim=True)
        out = (xc - mean) * torch.rsqrt(var + cfg.layernorm_eps)
        out = out * p["scale"].to(ct) + p["bias"].to(ct)
    return out.to(dt)


def alibi_slopes(nh: int, device=None) -> torch.Tensor:
    """ALiBi head slopes (Press et al.; HF build_alibi_tensor semantics,
    including the non-power-of-two head interleave)."""
    cp2 = 2 ** math.floor(math.log2(nh))
    base = 2.0 ** (-(2.0 ** -(math.log2(cp2) - 3)))
    slopes = [base ** (i + 1) for i in range(cp2)]
    if cp2 != nh:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * cp2) - 3)))
        slopes += [extra_base ** (i + 1)
                   for i in range(0, 2 * (nh - cp2), 2)]
    return torch.tensor(slopes, dtype=torch.float32, device=device)


def _mlp_block(x, p, cfg: TransformerConfig):
    dt0 = x.dtype
    dt = _module_dtype(cfg, "mlp", dt0)
    x = x.to(dt)
    if cfg.fused_gather_matmul and cfg.fused_gather_axes:
        _unsupported(cfg)
    if cfg.activation == "swiglu":
        gate = F.silu(x @ p["wg"].to(dt))
        up = x @ p["wi"].to(dt)
        return ((gate * up) @ p["wo"].to(dt)).to(dt0)
    y = x @ p["wi"].to(dt)
    if p.get("bi") is not None:
        y = y + p["bi"].to(dt)
    # "gelu_exact" = erf gelu (HF BERT's hidden_act="gelu"); "gelu" keeps
    # the tanh approximation the decoder families use
    if cfg.activation == "relu":
        y = F.relu(y)
    else:
        y = F.gelu(y, approximate="none" if cfg.activation == "gelu_exact"
                   else "tanh")
    y = y @ p["wo"].to(dt)
    if p.get("bo") is not None:
        y = y + p["bo"].to(dt)
    return y.to(dt0)
