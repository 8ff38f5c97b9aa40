"""Functional transformer model family (GPT-2 and Llama class), PyTorch.

Port of ``deepspeed_tpu/models/transformer.py``: what the ragged serving
forward and the one-GPU training step need (``forward`` over the stacked
layers, ``loss_fn``).  The parameter tree keeps the JAX package's key
paths and its ``[in, out]`` kernel layout (``x @ W``, no ``nn.Linear``
transpose), with the per-layer leaves stacked on axis 0, so a JAX param
tree carries over through numpy as an identity copy (``models/bridge.py``).

Casts sit where the JAX code has them (``x @ w.to(dt)`` inside the
differentiated function, no ``torch.autocast``), so bf16 rounds where it
rounds in JAX and fp32 master leaves receive fp32 gradients.

Sequence parallelism runs when a topology with a ``seq`` axis above one
is passed (``topo``; the engine passes its own): each rank's forward takes
its shard of the sequence and the shard's global positions.  Attention
goes through ``sequence/ring.py`` under ``seq_impl="ring"`` (positions
follow the ring placement) or, under ``seq_impl="ulysses"`` (contiguous
shards), through ``sequence/layer.py``'s all-to-all around the same local
attention the unsplit model runs.  With ``cfg.loss_tiles`` the loss goes
through ``sequence/alst.py``'s tiled logits, never holding ``[B, S, V]``.
Over a data axis each rank's forward takes its rows of the batch.  Dropout masks are drawn over the
global ``[B·dp, S·sp, H]`` positions and each rank keeps its rows and its
sequence positions, so they do not depend on the split, as the masks of
``jax.random.bernoulli`` over the global array do not under GSPMD.

Under ZeRO-3 the params are this rank's shards and a
:class:`~deepspeed_tpu_torch.zero.ParamGather` (``zero``; the engine
passes its own) gathers them through its window: the embedding, final
norm and head once a forward, a layer's leaves (one layer's slice of each
stacked leaf, never the stack) in one flat all-gather issued
``gather_prefetch_depth`` - 1 layers ahead of the layer, through the
stage-3 gather ``Function``, so the backward reduces their gradients.
With ``cfg.fused_gather_matmul`` the MLP's wi/wo/wg/bi stay shards
(``zero.Deferred``) and ``ops/gather_matmul.py`` ``fused_gather_mlp``
gathers them itself, its prefetches issued ahead of the matmuls.

Branches not ported yet raise ``NotImplementedError`` naming the ROADMAP
item: MoE layers, the pipeline path, parameter streaming, random-LTD and
progressive layer drop.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.ops import sparse_attention as sa
from deepspeed_tpu_torch.ops.flash_attention import flash_attention
from deepspeed_tpu_torch.ops.gather_matmul import fused_gather_mlp
from deepspeed_tpu_torch.sequence import ring
from deepspeed_tpu_torch.sequence.alst import tiled_nll
from deepspeed_tpu_torch.sequence.layer import DistributedAttention
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
    # ring hop/compute interleave depth (step_schedule.ring_interleave):
    # 1 = attend then rotate; 2 = each hop's rotation issued before its
    # attend (asynchronous, sequence/ring.py); the same bits either way
    ring_interleave: int = 1
    # ring rotation wire dtype (comm_quantization.ring_rotation; set by
    # the engine): "fp32" | "int8" | "fp8" — quantized payloads + fp32
    # per-row scales travel every ring hop; int8 hops run the hop kernels'
    # int8 lanes, fp8 hops decode first (sequence/ring.py)
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


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, in ``tree_map_with_path`` order."""
    out = []
    tree_map_with_path(lambda _p, x: out.append(x), tree)
    return out


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


# the MLP leaves the fused gather-matmul gathers itself
FUSED_MLP_LEAVES = (("mlp", "wi"), ("mlp", "wg"), ("mlp", "wo"), ("mlp", "bi"))


def _mlp_block(x, p, cfg: TransformerConfig):
    dt0 = x.dtype
    dt = _module_dtype(cfg, "mlp", dt0)
    x = x.to(dt)
    if cfg.fused_gather_matmul and cfg.fused_gather_axes:
        # ZeRO-3 fused gather-matmul (step_schedule.fused_gather_matmul;
        # ops/gather_matmul.py): p holds the MLP's shards (zero.Deferred),
        # gathered inside with the following matmul's gather issued ahead;
        # the engine verified the split pattern before setting the flag.
        # The output bias stays outside the fused region.
        y = fused_gather_mlp(x, p, cfg)
        if p.get("bo") is not None:
            y = y + p["bo"].to(dt)
        return y.to(dt0)
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


def _rope(q, k, positions, cfg: TransformerConfig):
    """Rotary embeddings (Llama). q,k: [B, S, H, D].  ``rotary_pct`` < 1
    rotates only the leading fraction of the head dim (Phi partial
    rotary); ``rope_interleaved`` pairs dims (2i, 2i+1) (GPT-J)."""
    d = cfg.dim_per_head
    rot_d = d if cfg.rotary_pct >= 1.0 else max(2, int(d * cfg.rotary_pct) // 2 * 2)
    freqs = 1.0 / (cfg.rope_theta ** (torch.arange(
        0, rot_d, 2, dtype=torch.float32, device=q.device) / rot_d))
    angles = positions[..., None].float() * freqs  # [B, S, rot_d/2]
    ct = torch.float32 if op_fp32(cfg, "rope") else q.dtype
    cos = torch.cos(angles)[:, :, None, :].to(ct)
    sin = torch.sin(angles)[:, :, None, :].to(ct)

    def rot(x):
        xf = x.to(ct)
        xr, x_pass = xf[..., :rot_d], xf[..., rot_d:]
        if cfg.rope_interleaved:
            x1, x2 = xr[..., 0::2], xr[..., 1::2]
            xr = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                             dim=-1).reshape(xr.shape)
        else:
            x1, x2 = torch.chunk(xr, 2, dim=-1)
            xr = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        return torch.cat([xr, x_pass], dim=-1)

    return rot(q).to(q.dtype), rot(k).to(k.dtype)


def _attention_scores(q, k, v, cfg: TransformerConfig, attention_mask=None,
                      slopes=None):
    """MHA/GQA over [B, S, H, D] through plain products — the path for a
    key-padding ``attention_mask`` ([B, S], 1 = attend) and the ALiBi
    score bias, which the flash kernels have no lane for.  ``slopes``
    ([H]) are the ALiBi slopes of the heads in ``q``: by default those of
    an H-head model, under Ulysses the slice of the global heads a rank
    holds."""
    b, s, nh, d = q.shape
    nkv = k.shape[2]
    if nkv != nh:  # GQA: repeat kv heads
        k = k.repeat_interleave(nh // nkv, dim=2)
        v = v.repeat_interleave(nh // nkv, dim=2)
    scale = cfg.attn_scale if cfg.attn_scale is not None else 1 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if cfg.use_alibi:
        if slopes is None:
            slopes = alibi_slopes(nh, device=q.device)
        if attention_mask is not None:
            # key positions within the real sequence (HF build_alibi_tensor)
            am = attention_mask.float()
            kpos = (torch.cumsum(am, dim=-1) - 1.0) * am      # [B, S]
            scores = scores + (slopes[None, :, None, None]
                               * kpos[:, None, None, :]).to(scores.dtype)
        else:
            kpos = torch.arange(s, dtype=torch.float32, device=q.device)
            scores = scores + (slopes[:, None, None]
                               * kpos[None, None, :]).to(scores.dtype)
    if cfg.causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
        if cfg.sliding_window:
            idx = torch.arange(s, device=q.device)
            mask = mask & (idx[:, None] - idx[None, :] < cfg.sliding_window)
        mask = mask[None, None]
    else:
        mask = torch.ones((1, 1, s, s), dtype=torch.bool, device=q.device)
    if attention_mask is not None:
        mask = mask & attention_mask[:, None, None, :].bool()
    # JAX's where against an fp32 minimum promotes the scores to fp32
    scores = torch.where(mask, scores.float(), torch.finfo(torch.float32).min)
    ct = torch.float32 if op_fp32(cfg, "softmax") else scores.dtype
    probs = torch.softmax(scores.to(ct), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


ATTN_IMPLS = ("auto", "pallas_flash", "xla", "sparse")
_SPARSITY_CONFIGS = {"fixed": sa.FixedSparsityConfig,
                     "bigbird": sa.BigBirdSparsityConfig,
                     "bslongformer": sa.BSLongformerSparsityConfig,
                     "variable": sa.VariableSparsityConfig,
                     "dense": sa.DenseSparsityConfig}
_SPARSITY_CACHE: Dict[Tuple[str, int], sa.SparsityConfig] = {}


def _sparse_attn(q, k, v, cfg: TransformerConfig):
    """Block-sparse attention path (ref ops/sparse_attention configs):
    ``cfg.sparse_attention`` = {"mode": ..., "block": ..., mode kwargs};
    causal composes with the layout.  As in the JAX model, the scale is
    ``d**-0.5`` (``attn_scale`` and ``sliding_window`` do not apply).  The
    config object is built once per (sparse config, heads) and its kernel
    layout once per sequence length (``sparse_attention.sparse_layout``)."""
    key = (repr(cfg.sparse_attention), q.shape[2])
    sparsity = _SPARSITY_CACHE.get(key)
    if sparsity is None:
        sc = dict(cfg.sparse_attention or {})
        mode = sc.pop("mode", "fixed")
        sparsity = _SPARSITY_CONFIGS[mode](num_heads=q.shape[2], **sc)
        _SPARSITY_CACHE[key] = sparsity
    return sa.sparse_attention(q, k, v, sparsity, causal=cfg.causal)


def _sp_size(topo) -> int:
    return topo.sp_size if topo is not None else 1


def _local_attention(q, k, v, cfg: TransformerConfig, attention_mask=None,
                     slopes=None):
    """The attention of the unsplit model over [B, S, H, D] (and of each
    rank's head shard under Ulysses, ``slopes`` then its heads' ALiBi
    slopes): the plain products for a key-padding mask or ALiBi, the
    block-sparse kernels, or the flash kernels."""
    if attention_mask is not None or cfg.use_alibi:
        if cfg.attn_impl == "sparse":
            raise NotImplementedError(
                "attention_mask/alibi + attn_impl='sparse' not supported")
        return _attention_scores(q, k, v, cfg, attention_mask=attention_mask,
                                 slopes=slopes)
    if cfg.attn_impl == "sparse":
        return _sparse_attn(q, k, v, cfg)
    if cfg.attn_impl in ("pallas_flash", "auto"):
        return flash_attention(q, k, v, causal=cfg.causal,
                               sm_scale=cfg.attn_scale,
                               window=cfg.sliding_window or None)
    if q.device.type != "cpu":
        # "xla" is the unfused reference path: on the card these inputs
        # (no mask, no alibi) go through the flash kernel, never the plain one
        raise NotImplementedError(
            "attn_impl='xla' runs only on the CPU in deepspeed_tpu_torch; "
            "use 'auto' on the card")
    return _attention_scores(q, k, v, cfg)


def _attn_block(x, p, positions, cfg: TransformerConfig, attention_mask=None,
                topo=None):
    b, s, _h = x.shape
    nh, nkv, d = cfg.num_heads, cfg.kv_heads, cfg.dim_per_head
    dt0 = x.dtype  # residual-stream dtype: restored at the block boundary
    dt = _module_dtype(cfg, "attn", dt0)
    x = x.to(dt)

    def proj(w, b_):
        y = x @ w.to(dt)
        if b_ is not None:
            y = y + b_.to(dt)
        return y

    q = proj(p["wq"], p.get("bq")).reshape(b, s, nh, d)
    k = proj(p["wk"], p.get("bk")).reshape(b, s, nkv, d)
    v = proj(p["wv"], p.get("bv")).reshape(b, s, nkv, d)
    if cfg.use_rope:
        q, k = _rope(q, k, positions, cfg)
    if cfg.seq_impl not in ("ulysses", "ring"):
        raise ValueError(f"seq_impl={cfg.seq_impl!r}: expected 'ulysses' "
                         "or 'ring'")
    if cfg.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl={cfg.attn_impl!r}: expected one of "
                         f"{ATTN_IMPLS}")
    if _sp_size(topo) > 1 and cfg.seq_impl == "ring":
        # Ring attention: K/V blocks rotate the seq ring (nearest-neighbour
        # point-to-point + online softmax)
        if attention_mask is not None:
            raise NotImplementedError(
                "attention_mask + ring sequence parallelism not supported")
        if cfg.use_alibi:
            raise NotImplementedError(
                "alibi + ring sequence parallelism not supported (the "
                "ring hop has no score-bias lane yet)")
        if cfg.attn_impl == "sparse":
            raise NotImplementedError(
                "attn_impl='sparse' + ring sequence parallelism not "
                "supported (dense ring hops would silently replace the "
                "block-sparse layout's semantics)")
        out = ring.ring_attention(q, k, v, topo, causal=cfg.causal,
                                  sm_scale=cfg.attn_scale,
                                  window=cfg.sliding_window or None,
                                  placement=cfg.ring_placement,
                                  interleave=cfg.ring_interleave,
                                  wire_dtype=cfg.ring_wire_dtype)
    elif _sp_size(topo) > 1:
        # Ulysses: the all-to-alls turn the sequence shards of q/k/v into
        # head shards of the whole sequence around the local attention
        # (ref sequence/layer.py:331); a key-padding mask is gathered whole
        mask = attention_mask
        if mask is not None:
            mask = comm.all_gather(mask, 1, topo.seq_group)
        sc = cfg.sparse_attention or {}
        if cfg.attn_impl == "sparse" and sc.get("different_layout_per_head"):
            raise NotImplementedError(
                "attn_impl='sparse' with per-head layouts + Ulysses: a "
                "rank's layout would be built for its own heads, not the "
                "global heads it holds")
        slopes = None
        if cfg.use_alibi:
            # rank r holds the global heads r·H/sp … (r+1)·H/sp - 1
            hl = nh // topo.sp_size
            slopes = alibi_slopes(nh, device=q.device)[
                topo.sp_rank * hl:(topo.sp_rank + 1) * hl]
        out = DistributedAttention(
            lambda q_, k_, v_: _local_attention(q_, k_, v_, cfg, mask,
                                                slopes),
            topo)(q, k, v)
    else:
        out = _local_attention(q, k, v, cfg, attention_mask)
    out = out.reshape(b, s, nh * d) @ p["wo"].to(dt)
    if p.get("bo") is not None:
        out = out + p["bo"].to(dt)
    return out.to(dt0)


def _fold(seed: int, i: int) -> int:
    """A child seed of ``seed`` for stream ``i`` (JAX's ``fold_in``
    role): dropout masks depend only on (step, micro-step, layer, branch),
    so a checkpointed layer draws the same masks when it reruns."""
    return (seed * 1_000_003 + i + 1) % (1 << 62)


def _dp(topo) -> Tuple[int, int]:
    return (topo.dp_size, topo.dp_rank) if topo is not None else (1, 0)


def _dropout(x, rate: float, seed: Optional[int], topo=None, pos=None):
    """Inverted dropout from a ``torch.Generator`` seeded with ``seed``;
    identity when no seed is threaded (eval/serve).  The uniforms are
    drawn over the global ``[B·dp, S·sp, ...]`` array and this rank keeps
    its rows (``topo``'s data rank) and its sequence positions (``pos``,
    the shard's global positions, when a seq axis is above one), so a mask
    does not depend on how the batch is split."""
    if seed is None or rate <= 0.0:
        return x
    gen = torch.Generator(device=x.device).manual_seed(seed)
    dp, rank = _dp(topo)
    sp = _sp_size(topo)
    b, s = x.shape[:2]
    u = torch.rand((b * dp, s * sp) + tuple(x.shape[2:]), generator=gen,
                   device=x.device)[rank * b:(rank + 1) * b]
    if sp > 1:
        u = u[:, pos]
    keep = u < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def transformer_layer(x, layer_params, positions, cfg: TransformerConfig,
                      dropout_seed: Optional[int] = None,
                      attention_mask=None, topo=None):
    """One transformer block: pre-norm, post-norm (BERT) or the parallel
    attention + MLP residual (Falcon/Phi).  ``dropout_seed``: this layer's
    seed for residual dropout (None → off); ``topo``: the mesh topology
    (a seq axis above one runs ring attention; the data and seq ranks pick
    the dropout masks' slice)."""
    pos = positions[0] if _sp_size(topo) > 1 else None

    def drop(y, i):
        seed = None if dropout_seed is None else _fold(dropout_seed, i)
        return _dropout(y, cfg.dropout, seed, topo, pos)

    if cfg.parallel_block:
        n = _norm(x, layer_params["ln1"], cfg)
        n_mlp = _norm(x, layer_params["ln2"], cfg) if cfg.parallel_norms else n
        attn_out = _attn_block(n, layer_params["attn"], positions, cfg,
                               attention_mask=attention_mask, topo=topo)
        y = _mlp_block(n_mlp, layer_params["mlp"], cfg)
        return x + drop(attn_out, 0) + drop(y, 1)
    if cfg.norm_position == "post":
        attn_out = _attn_block(x, layer_params["attn"], positions, cfg,
                               attention_mask=attention_mask, topo=topo)
        x = _norm(x + drop(attn_out, 0), layer_params["ln1"], cfg)
        y = _mlp_block(x, layer_params["mlp"], cfg)
        return _norm(x + drop(y, 1), layer_params["ln2"], cfg)
    attn_out = _attn_block(_norm(x, layer_params["ln1"], cfg),
                           layer_params["attn"], positions, cfg,
                           attention_mask=attention_mask, topo=topo)
    x = x + drop(attn_out, 0)
    y = _mlp_block(_norm(x, layer_params["ln2"], cfg), layer_params["mlp"],
                   cfg)
    return x + drop(y, 1)


def _maybe_remat(fn, cfg: TransformerConfig):
    """``"none"`` saves every activation; ``"full"`` and
    ``"nothing_saveable"`` checkpoint the layer (its forward, flash kernel
    included, reruns in the backward).  The named ``*_saveable`` and
    ``offload_dots`` policies of the JAX model have no port yet."""
    if cfg.remat_policy == "none":
        return fn
    if cfg.remat_policy in ("full", "nothing_saveable"):
        return lambda *args: torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False)
    raise NotImplementedError(
        f"remat policy {cfg.remat_policy!r} (selective activation "
        "checkpointing) is not ported yet (ROADMAP Queue A item 13)")


def _forward_unsupported(cfg: TransformerConfig, pld_theta) -> None:
    _unsupported(cfg)
    if cfg.param_stream:
        raise NotImplementedError(
            "parameter streaming is not ported yet (ROADMAP Queue A item 7)")
    if pld_theta is not None or cfg.ltd_kept:
        raise NotImplementedError(
            "progressive layer drop and random-LTD are not ported yet "
            "(ROADMAP Queue A item 11)")


def _embed(params: Params, input_ids, positions, cfg: TransformerConfig,
           token_embeds=None, token_type_ids=None):
    """Embedding prologue: token rows (or precomputed ``token_embeds``),
    learned positions, BERT segment rows and embedding norm."""
    et = _module_dtype(cfg, "embed", cfg.dtype)
    x = (params["embed"]["tokens"].to(et)[input_ids]
         if token_embeds is None else token_embeds.to(et))
    if cfg.has_learned_positions:
        x = x + params["embed"]["positions"].to(et)[positions]
    if cfg.type_vocab_size:
        tt = (token_type_ids if token_type_ids is not None
              else torch.zeros_like(input_ids))
        x = x + params["embed"]["token_types"].to(et)[tt]
    if cfg.embed_norm:
        x = _norm(x.to(cfg.dtype), params["embed"]["norm"], cfg)
    return x.to(cfg.dtype)


def _shard_positions(s: int, cfg: TransformerConfig, topo, device):
    """The global positions of this rank's ``s`` slots ([s] int64): the
    ring placement's under the ring, else the contiguous shard's
    (``sp_rank·s …``; all of them with no seq axis)."""
    if _sp_size(topo) > 1 and cfg.seq_impl == "ring":
        return ring.shard_positions(s, topo, cfg.ring_placement,
                                    device=device)
    first = topo.sp_rank * s if _sp_size(topo) > 1 else 0
    return torch.arange(first, first + s, dtype=torch.int64, device=device)


def forward(params: Params, input_ids, cfg: TransformerConfig,
            positions=None, pld_theta=None, return_hidden: bool = False,
            token_embeds=None, dropout_seed: Optional[int] = None,
            token_type_ids=None, attention_mask=None, topo=None, zero=None):
    """Token ids [B, S] → logits [B, S, V].  A Python loop over the
    stacked layers takes the place of the JAX ``lax.scan``: each stacked
    leaf is unbound once into per-layer views, so its gradient is stacked
    once per backward.  ``dropout_seed``: per-micro-step seed enabling
    ``cfg.dropout`` (None → off, the eval contract).  ``topo``: the mesh
    topology; with a seq axis above one, ``input_ids`` is this rank's
    shard of the sequence (in the placement's order) and its positions
    are the shard's global ones.  ``zero``: the ZeRO-3
    :class:`~deepspeed_tpu_torch.zero.ParamGather` when ``params`` are
    this rank's shards.  ``return_hidden``: the final norm's output
    [B, S, E] instead of the logits."""
    x, top = _hidden(params, input_ids, cfg, positions, pld_theta,
                     token_embeds, dropout_seed, token_type_ids,
                     attention_mask, topo, zero)
    if return_hidden:
        return x
    dt = cfg.dtype
    ht = _module_dtype(cfg, "lm_head", dt)
    if cfg.mlm_head:
        mh = top["mlm_head"]
        t = x.to(ht) @ mh["w"].to(ht) + mh["b"].to(ht)
        t = F.relu(t) if cfg.activation == "relu" else F.gelu(
            t, approximate="none" if cfg.activation == "gelu_exact" else "tanh")
        t = _norm(t, mh["ln"], cfg)
        logits = t.to(ht) @ top["embed"]["tokens"].to(ht).T \
            + mh["bias"].to(ht)
    elif cfg.tie_embeddings:
        logits = x.to(ht) @ top["embed"]["tokens"].to(ht).T
    else:
        logits = x.to(ht) @ top["lm_head"].to(ht)
    if not cfg.mlm_head and top.get("lm_head_bias") is not None:
        logits = logits + top["lm_head_bias"].to(ht)
    return logits


def _hidden(params: Params, input_ids, cfg: TransformerConfig, positions,
            pld_theta, token_embeds, dropout_seed, token_type_ids,
            attention_mask, topo, zero):
    """:func:`forward` up to the final norm: ``(hidden [B, S, E], the
    params whose top leaves the head reads)`` — under ZeRO-3 the gathered
    ones of this forward, so a head computed outside gathers nothing
    twice."""
    _forward_unsupported(cfg, pld_theta)
    b, s = input_ids.shape
    if positions is None:
        pos_row = _shard_positions(s, cfg, topo, input_ids.device)
        positions = pos_row[None, :].expand(b, s)
    per_layer = tree_map_with_path(lambda _p, leaf: leaf.unbind(0),
                                   params["layers"])
    window = None
    if zero is not None:   # the top leaves, then the layers ahead of use
        skip = FUSED_MLP_LEAVES if cfg.fused_gather_matmul else ()
        window = zero.window(params, per_layer, cfg.num_layers, skip)
        params = window.top()
    x = _embed(params, input_ids, positions, cfg, token_embeds,
               token_type_ids=token_type_ids)
    if dropout_seed is not None and cfg.dropout > 0:
        x = _dropout(x, cfg.dropout, _fold(dropout_seed, 10_000), topo,
                     positions[0] if _sp_size(topo) > 1 else None)

    for i in range(cfg.num_layers):
        lp = tree_map_with_path(lambda _p, views, i=i: views[i], per_layer)
        # GPT-Neo alternating attention: even layers attend globally
        lcfg = cfg.replace(sliding_window=None) \
            if cfg.alt_window and i % 2 == 0 else cfg
        seed = None if dropout_seed is None else _fold(dropout_seed, i)

        def layer(h, i=i, lp=lp, lcfg=lcfg, seed=seed):
            if window is not None:   # this layer's leaves, when it runs
                lp = window.layer(i)
            return transformer_layer(h, lp, positions, lcfg,
                                     dropout_seed=seed,
                                     attention_mask=attention_mask, topo=topo)

        x = _maybe_remat(layer, cfg)(x)

    if cfg.norm_position != "post":
        x = _norm(x, params["final_norm"], cfg)
    return x, params


def _nll_sum(logits32, labels_mb):
    """Summed token NLL with -100 = ignore (HF convention)."""
    m = labels_mb != -100
    safe = torch.where(m, labels_mb, torch.zeros_like(labels_mb))
    logz = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1, safe[..., None].long())[..., 0]
    return torch.sum((logz - gold) * m)


def loss_fn(params: Params, batch: Dict[str, Any], cfg: TransformerConfig,
            token_embeds=None, topo=None, sum_count: bool = False,
            zero=None):
    """Causal LM cross-entropy.  ``batch``: input_ids [B,S], labels [B,S]
    (-100 = ignore), optional loss_mask, token_type_ids, attention_mask
    and dropout_seed, all tensors on the params' device.  ``topo`` and
    ``zero``: as in :func:`forward`.  With ``cfg.loss_tiles`` dividing the
    global sequence (this rank's times the seq axis, the JAX gate), the
    loss runs over tiles of ``S_global / loss_tiles`` tokens of this
    rank's shard (``sequence/alst.py``; the shard must divide into them),
    against the head weight cast to the compute dtype (no logit bias, as
    in JAX).  ``sum_count``: return ``(token NLL
    sum, token count)`` of this batch instead of their ratio, for a caller
    that reduces both over the ranks of a data or sequence-parallel
    group."""
    labels = batch["labels"]
    mask = labels != -100
    if "loss_mask" in batch:
        mask = mask & (batch["loss_mask"] > 0)
    labels_eff = torch.where(mask, labels, torch.full_like(labels, -100))
    s = batch["input_ids"].shape[1]
    s_global = s * _sp_size(topo)
    tiled = cfg.loss_tiles and s_global % cfg.loss_tiles == 0
    if tiled and cfg.mlm_head:
        raise NotImplementedError(
            "loss_tiles + mlm_head not supported (the tiled loss computes "
            "logits directly against the embedding table, bypassing the "
            "MLM transform head); encoder sequences are short — drop "
            "loss_tiles")
    if tiled and s % (s_global // cfg.loss_tiles):
        raise ValueError(
            f"loss_tiles={cfg.loss_tiles}: this rank's {s} tokens do not "
            f"divide into tiles of {s_global // cfg.loss_tiles} (the "
            f"global sequence {s_global} over the tiles)")
    extra = dict(positions=None, pld_theta=batch.get("pld_theta"),
                 token_embeds=token_embeds,
                 dropout_seed=batch.get("dropout_seed"),
                 token_type_ids=batch.get("token_type_ids"),
                 attention_mask=batch.get("attention_mask"), topo=topo,
                 zero=zero)
    if tiled:
        # ALST: the head weight the forward used (under ZeRO-3 its
        # gathered embedding), tiles of the global sequence's tile size
        hidden, top = _hidden(params, batch["input_ids"], cfg, **extra)
        w = top["embed"]["tokens"] if cfg.tie_embeddings \
            else top["lm_head"].T
        nll, count = tiled_nll(hidden, w.to(cfg.dtype), labels_eff,
                               s_global // cfg.loss_tiles)
    else:
        out = forward(params, batch["input_ids"], cfg, **extra)
        lt = torch.float32 if op_fp32(cfg, "loss") else out.dtype
        nll, count = _nll_sum(out.to(lt), labels_eff), mask.sum()
    if sum_count:
        return nll, count
    return nll / torch.clamp(count, min=1)
