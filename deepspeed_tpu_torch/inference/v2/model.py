"""Ragged (paged-KV) transformer forward for continuous batching, PyTorch.

Port of ``deepspeed_tpu/inference/v2/model.py``: one forward processes an
arbitrary prefill/decode mix as a flat token list with per-token metadata.

* KV cache pages are rows of one array per layer, ``[L, nkv, P, d]``
  (P = num_blocks·block_size), or the int8 dict ``{"q": int8 [L, nkv, P,
  d], "s": fp32 [L, nkv, P]}``.  Token KV is scattered to its page slot
  **in place** (the JAX package returns new caches under donation; here
  the caches passed in are updated and returned for the same call shape).
* Attention resolves through the module registry: ``paged_kernel`` (the
  block-table kernel, ``ops/paged_attention.py``) or ``paged_gather``
  (the JAX package's gather path, ``_paged_attention_xla``, used for
  ALiBi models and on the CPU).
* The layer loop is a Python loop over the stacked per-layer parameters.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.inference.v2.modules import register_module, resolve
from deepspeed_tpu_torch.models.transformer import (TransformerConfig,
                                                    _mlp_block, _norm,
                                                    alibi_slopes)
from deepspeed_tpu_torch.ops.paged_attention import (paged_decode_attention,
                                                     supports)


def _rope_tok(x, positions, cfg: TransformerConfig):
    """Rotary embedding over per-token positions. x: [T, H, D], positions:
    [T].  Honors ``rotary_pct`` (Phi partial rotary) like models._rope."""
    d = cfg.dim_per_head
    rot_d = d if cfg.rotary_pct >= 1.0 else max(2, int(d * cfg.rotary_pct) // 2 * 2)
    freqs = 1.0 / (cfg.rope_theta ** (torch.arange(
        0, rot_d, 2, dtype=torch.float32, device=x.device) / rot_d))
    angles = positions[:, None].float() * freqs  # [T, rot_d/2]
    cos = torch.cos(angles)[:, None, :]
    sin = torch.sin(angles)[:, None, :]
    xf = x.float()
    xr, x_pass = xf[..., :rot_d], xf[..., rot_d:]
    if cfg.rope_interleaved:
        # GPT-J "rotate every two" pairing
        x1, x2 = xr[..., 0::2], xr[..., 1::2]
        xr = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                         dim=-1).reshape(xr.shape)
    else:
        x1, x2 = torch.chunk(xr, 2, dim=-1)
        xr = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([xr, x_pass], dim=-1).to(x.dtype)


def _is_quant_cache(pages) -> bool:
    """Int8 KV cache layout: {"q": int8 payload, "s": fp32 per-row scales}
    (quantization per (head, row) over head_dim)."""
    return isinstance(pages, dict)


def _kv_append(pages, x, token_dest):
    """Scatter this step's KV rows [T, nkv, d] into the page pool in place
    — quantizing on append when the cache is int8.

    Padding tokens all target row 0 of the garbage block 0, so several
    rows may land on one destination; which one wins is unspecified on
    CUDA.  That is harmless: garbage rows are only ever read fully masked
    (padding slots) — a real token's table never points at block 0."""
    xh = x.transpose(0, 1)                                # [nkv, T, d]
    if _is_quant_cache(pages):
        xf = xh.float()
        scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / 127.0
        q8 = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
        pages["q"][:, token_dest] = q8.to(torch.int8)
        pages["s"][:, token_dest] = scale
    else:
        pages[:, token_dest] = xh.to(pages.dtype)
    return pages


def paged_gather(q, k_pages, v_pages, gather_idx, token_pos, token_ctx_len,
                 cfg: TransformerConfig):
    """Gather-based attention (the JAX package's ``_paged_attention_xla``).

    q: [T, nh, d]; k_pages/v_pages: [nkv, P, d] (or int8 dict caches);
    gather_idx: [T, C] flat page-row indices of each token's context.
    GQA-native: queries are grouped by KV head instead of repeating KV.
    """
    t, nh, d = q.shape
    if _is_quant_cache(k_pages):
        nkv = k_pages["q"].shape[0]
        k_ctx = (k_pages["q"][:, gather_idx].to(q.dtype)
                 * k_pages["s"][:, gather_idx, None].to(q.dtype))
        v_ctx = (v_pages["q"][:, gather_idx].to(q.dtype)
                 * v_pages["s"][:, gather_idx, None].to(q.dtype))
    else:
        nkv = k_pages.shape[0]
        k_ctx = k_pages[:, gather_idx].to(q.dtype)   # [nkv, T, C, d]
        v_ctx = v_pages[:, gather_idx].to(q.dtype)
    g = nh // nkv
    qg = q.reshape(t, nkv, g, d)
    scale = (cfg.attn_scale if cfg.attn_scale is not None
             else 1.0 / math.sqrt(cfg.dim_per_head))
    scores = torch.einsum("tkgd,ktcd->tkgc", qg, k_ctx) * scale
    c_pos = torch.arange(scores.shape[-1], dtype=torch.int32, device=q.device)
    if cfg.use_alibi:
        # Bloom ALiBi (key-position form; softmax-shift equivalent)
        sl = alibi_slopes(nh, device=q.device).reshape(nkv, g)
        scores = scores + (sl[None, :, :, None]
                           * c_pos.float()[None, None, None, :]
                           ).to(scores.dtype)
    valid = (c_pos[None, :] <= token_pos[:, None]) & \
            (c_pos[None, :] < token_ctx_len[:, None])       # [T, C]
    if cfg.sliding_window:
        valid = valid & (token_pos[:, None] - c_pos[None, :]
                         < cfg.sliding_window)
    scores = torch.where(valid[:, None, None, :], scores.float(),
                         torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("tkgc,ktcd->tkgd", probs, v_ctx)
    return out.reshape(t, nh, d)


def _kernel_attn_default(block_size=0, head_dim=0, on_cuda=False,
                         has_tables=False, use_alibi=False, **_):
    if not (has_tables and on_cuda) or use_alibi:
        # alibi rides the gather path (the kernel has no score-bias lane)
        return False
    return supports(block_size, head_dim)


@register_module("attention", "paged_kernel",
                 default_for=_kernel_attn_default)
def _attn_impl_kernel(q, k_pages, v_pages, gather_idx, token_pos,
                      token_ctx_len, cfg, block_tables, token_slot,
                      block_size):
    """Block-table kernel (ops/paged_attention.py: page walk with online
    softmax — no [T, C, ...] gather materialisation)."""
    if block_tables is None:
        raise ValueError(
            "attention='paged_kernel' needs block tables — use 'auto' or "
            "'paged_gather'")
    if cfg.use_alibi:
        raise ValueError(
            "attention='paged_kernel' has no ALiBi score-bias lane — use "
            "'auto' or 'paged_gather' for bloom-class models")
    pages = block_tables[token_slot]  # [T, NB]
    scale = (cfg.attn_scale if cfg.attn_scale is not None
             else 1.0 / math.sqrt(cfg.dim_per_head))
    if _is_quant_cache(k_pages):
        return paged_decode_attention(
            q, k_pages["q"], v_pages["q"], pages, token_pos, token_ctx_len,
            block_size, scale, window=cfg.sliding_window or None,
            k_scales=k_pages["s"], v_scales=v_pages["s"])
    return paged_decode_attention(
        q, k_pages, v_pages, pages, token_pos, token_ctx_len,
        block_size, scale, window=cfg.sliding_window or None)


@register_module("attention", "paged_gather")
def _attn_impl_gather(q, k_pages, v_pages, gather_idx, token_pos,
                      token_ctx_len, cfg, block_tables, token_slot,
                      block_size):
    return paged_gather(q, k_pages, v_pages, gather_idx, token_pos,
                        token_ctx_len, cfg)


def _paged_attention(q, k_pages, v_pages, gather_idx, token_pos, token_ctx_len,
                     cfg: TransformerConfig, block_tables=None, token_slot=None,
                     block_size: int = 0):
    """Attention of T query tokens against their sequences' KV pages,
    resolved through the module registry: 'auto' picks the block-table
    kernel for CUDA tensors when the geometry is servable, the gather path
    elsewhere; ``cfg.v2_modules`` pins a name explicitly."""
    name = dict(cfg.v2_modules or ()).get("attention", "auto")
    impl = resolve("attention", name, block_size=block_size,
                   head_dim=cfg.dim_per_head, on_cuda=q.is_cuda,
                   has_tables=block_tables is not None,
                   use_alibi=cfg.use_alibi)
    return impl(q, k_pages, v_pages, gather_idx, token_pos, token_ctx_len,
                cfg, block_tables, token_slot, block_size)


def _ragged_layer(x, lp, k_pages, v_pages, meta, cfg: TransformerConfig):
    """One block over flat tokens [T, H]; scatters KV, attends via pages."""
    (token_pos, token_dest, gather_idx, token_ctx_len, token_slot,
     block_tables, block_size) = meta
    t = x.shape[0]
    nh, nkv, d = cfg.num_heads, cfg.kv_heads, cfg.dim_per_head
    dt = x.dtype

    h = _norm(x, lp["ln1"], cfg)

    def proj(w, b_):
        y = h @ w.to(dt)
        return y + b_.to(dt) if b_ is not None else y

    q = proj(lp["attn"]["wq"], lp["attn"].get("bq")).reshape(t, nh, d)
    k = proj(lp["attn"]["wk"], lp["attn"].get("bk")).reshape(t, nkv, d)
    v = proj(lp["attn"]["wv"], lp["attn"].get("bv")).reshape(t, nkv, d)
    if cfg.use_rope:
        q = _rope_tok(q, token_pos, cfg)
        k = _rope_tok(k, token_pos, cfg)

    # write this step's KV to its pages (padding tokens target page 0 =
    # garbage, so no mask is needed), quantized on append for int8
    _kv_append(k_pages, k, token_dest)
    _kv_append(v_pages, v, token_dest)

    attn = _paged_attention(q, k_pages, v_pages, gather_idx, token_pos,
                            token_ctx_len, cfg, block_tables=block_tables,
                            token_slot=token_slot, block_size=block_size)
    attn = attn.reshape(t, nh * d) @ lp["attn"]["wo"].to(dt)
    if lp["attn"].get("bo") is not None:
        attn = attn + lp["attn"]["bo"].to(dt)

    if cfg.parallel_block:
        # Falcon/Phi: attention and MLP read the shared input norm;
        # Falcon-40B/GPT-NeoX (parallel_norms): the MLP gets its own
        # ln2 on the same residual input (HF use_parallel_residual)
        h_mlp = _norm(x, lp["ln2"], cfg) if cfg.parallel_norms else h
        return x + attn + _mlp_block(h_mlp, lp["mlp"], cfg)

    x = x + attn
    h2 = _norm(x, lp["ln2"], cfg)
    return x + _mlp_block(h2, lp["mlp"], cfg)


def _layer_slice(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def _trunk(params, cache_k, cache_v, token_ids, token_slot, token_pos,
           token_dest, block_tables, ctx_lens, cfg: TransformerConfig,
           block_size: int):
    """Embedding + every layer + final norm over the flat tokens [T, H]."""
    if cfg.is_moe:
        raise NotImplementedError(
            "MoE layers are not ported yet (ROADMAP Queue A item 10)")
    dt = cfg.dtype
    x = params["embed"]["tokens"].to(dt)[token_ids]  # [T, H]
    if cfg.has_learned_positions and "positions" in params["embed"]:
        # gpt2/opt/gpt-neo learned positions
        x = x + params["embed"]["positions"].to(dt)[token_pos]
    if cfg.embed_norm:
        x = _norm(x, params["embed"]["norm"], cfg)  # Bloom embedding LN

    # context gather indices, shared by all layers (ref: atom_builder)
    nb = block_tables.shape[1]
    c = torch.arange(nb * block_size, device=x.device)
    ctx_idx = (block_tables[:, c // block_size].long() * block_size
               + c % block_size)                               # [S+1, C]
    gather_idx = ctx_idx[token_slot.long()]                    # [T, C]
    token_ctx_len = ctx_lens[token_slot.long()]                # [T]
    meta = (token_pos, token_dest.long(), gather_idx, token_ctx_len,
            token_slot.long(), block_tables, block_size)

    local_cfg = cfg.replace(sliding_window=None) if cfg.alt_window else cfg
    for i in range(cfg.num_layers):
        # GPT-Neo alternating global/local: even members attend globally
        lcfg = cfg if (not cfg.alt_window or i % 2) else local_cfg
        ck = _layer_slice(cache_k, i)
        cv = _layer_slice(cache_v, i)
        x = _ragged_layer(x, _layer_slice(params["layers"], i), ck, cv, meta,
                          lcfg)
    return _norm(x, params["final_norm"], cfg)


def _head(params, x, cfg: TransformerConfig):
    dt = cfg.dtype
    if cfg.tie_embeddings:
        return x @ params["embed"]["tokens"].to(dt).T
    return x @ params["lm_head"].to(dt)


def ragged_forward(params, cache_k, cache_v, token_ids, token_slot, token_pos,
                   token_dest, block_tables, ctx_lens, logits_idx,
                   cfg: TransformerConfig, block_size: int):
    """One ragged step.

    cache_k/cache_v: [L, nkv, P, d] (or int8 dicts), updated in place;
    block_tables: [S+1, NB] int32; returns (logits [S+1, V] fp32, cache_k,
    cache_v)."""
    x = _trunk(params, cache_k, cache_v, token_ids, token_slot, token_pos,
               token_dest, block_tables, ctx_lens, cfg, block_size)
    last = x[logits_idx.long()]  # [S+1, H]
    return _head(params, last, cfg).float(), cache_k, cache_v


def ragged_forward_verify(params, cache_k, cache_v, token_ids, token_slot,
                          token_pos, token_dest, block_tables, ctx_lens,
                          logits_idx, cfg: TransformerConfig,
                          block_size: int):
    """Speculative-decoding verify-k step: the same ragged trunk, but the
    greedy argmax is taken at EVERY token row — [T] int32 — instead of
    only at each sequence's final row (the acceptance oracle: proposal i
    is accepted iff it equals the argmax at the row of proposal i-1).
    ``logits_idx`` is accepted (unused) so the verify step shares the
    argument tuple of ``ragged_forward``."""
    del logits_idx
    if cfg.alt_window:
        raise NotImplementedError(
            "speculative verify step supports the plain ragged path only "
            "(no alt_window, no MoE)")
    x = _trunk(params, cache_k, cache_v, token_ids, token_slot, token_pos,
               token_dest, block_tables, ctx_lens, cfg, block_size)
    logits = _head(params, x, cfg)
    nxt = torch.argmax(logits.float(), dim=-1).to(torch.int32)
    return nxt, cache_k, cache_v


def check_sampling_params(top_k: int, top_p, vocab_size: int):
    """API-boundary validation + normalization: rejects degenerate values
    that would silently emit token 0 (top_p <= 0) or fail inside topk
    (top_k > vocab).  Returns ``(top_k, top_p)`` — top_k clamped to vocab,
    top_p None when disabled (>= 1.0) else a float."""
    if top_p is not None and not (0.0 < float(top_p) <= 1.0):
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")
    tp = None if top_p is None or float(top_p) >= 1.0 else float(top_p)
    return min(int(top_k), vocab_size), tp


def sample_tokens(logits, generator: Optional[torch.Generator],
                  temperature: float, greedy: bool, top_k: int = 0,
                  top_p=None) -> torch.Tensor:
    """On-device token sampling with FastGen-style logit processing:
    greedy argmax, or temperature categorical restricted to the top-k
    logits and/or the top-p nucleus.  Draws come from ``generator``
    (``torch.Generator`` gives other bits than ``jax.random``; sampled
    paths are checked by membership in the top-k/top-p set)."""
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / max(float(temperature), 1e-6)
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits >= kth, logits, neg_inf)
    if top_p is not None:
        # nucleus: keep the smallest prefix of desc-sorted tokens whose
        # cumulative probability reaches top_p (first always kept)
        order = torch.argsort(-logits, dim=-1)
        sorted_p = torch.softmax(torch.gather(logits, -1, order), dim=-1)
        keep_sorted = (torch.cumsum(sorted_p, dim=-1) - sorted_p) < top_p
        keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
        logits = torch.where(keep, logits, neg_inf)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0].to(
        torch.int32)


def ragged_forward_sampled(params, cache_k, cache_v, token_ids, token_slot,
                           token_pos, token_dest, block_tables, ctx_lens,
                           logits_idx, generator, temperature,
                           cfg: TransformerConfig, block_size: int,
                           greedy: bool, top_k: int = 0, top_p=None):
    """Ragged step + on-device sampling: the host receives [S+1] int32
    tokens instead of [S+1, V] logits."""
    logits, cache_k, cache_v = ragged_forward(
        params, cache_k, cache_v, token_ids, token_slot, token_pos,
        token_dest, block_tables, ctx_lens, logits_idx, cfg=cfg,
        block_size=block_size)
    nxt = sample_tokens(logits, generator, temperature, greedy, top_k, top_p)
    return nxt, cache_k, cache_v


def ragged_decode_loop(params, cache_k, cache_v, tokens0, ctx_lens0,
                       active, block_tables, generator, temperature,
                       cfg: TransformerConfig, block_size: int,
                       n_steps: int, greedy: bool, top_k: int = 0,
                       top_p=None):
    """Fused multi-step decode: ``n_steps`` single-token steps with
    on-device sampling; tokens stay on the device and the host fetches one
    ``[n_steps, S]`` int32 array at the end.

    tokens0 [S]: each slot's current last token; ctx_lens0 [S]: tokens
    already in cache; active [S] bool; block_tables [S, NB] preallocated
    for the full horizon.  Returns (sampled [n_steps, S], ctx_lens',
    cache_k, cache_v).  Slot s's column in ``sampled`` is garbage where
    ``active[s]`` is False."""
    s_rows = block_tables.shape[0]
    dev = tokens0.device
    slots = torch.arange(s_rows, dtype=torch.int32, device=dev)
    act_i = active.to(torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    tokens, ctx_lens = tokens0, ctx_lens0
    sampled = []
    for _ in range(n_steps):
        pos = ctx_lens  # 0-based position of the incoming token
        dest = block_tables[slots.long(), (pos // block_size).long()] \
            * block_size + pos % block_size
        dest = torch.where(active, dest, zero)  # inactive → garbage page 0
        ctx_after = ctx_lens + act_i
        logits, cache_k, cache_v = ragged_forward(
            params, cache_k, cache_v, tokens, slots, pos, dest, block_tables,
            ctx_after, slots, cfg=cfg, block_size=block_size)
        nxt = sample_tokens(logits, generator, temperature, greedy, top_k,
                            top_p)
        tokens = torch.where(active, nxt, zero)
        ctx_lens = ctx_after
        sampled.append(tokens)
    return torch.stack(sampled), ctx_lens, cache_k, cache_v
