"""ALST — Arctic Long Sequence Training building blocks.

Port of ``deepspeed_tpu/sequence/alst.py`` (the reference's Ulysses-SP HF
integration, ``deepspeed/runtime/sequence_parallel/ulysses_sp.py``:
``TiledMLP`` :838, tiled logits+loss :960, DataLoader shard adapter
:471).  The attention half is :mod:`deepspeed_tpu_torch.sequence.layer`;
this module holds the memory-capping tiled compute and the sequence
sharding of host batches.

The tiled loss never holds the ``[B, S, V]`` logits: a
``torch.autograd.Function`` walks sequence tiles, keeps each tile's
log-sum-exp and the scalar sums, and in the backward recomputes one
tile's logits at a time to form ``softmax − onehot`` and accumulate the
gradients of the hidden states and of the head weight.  The largest live
logits block is one tile's ``[B, tile, V]`` in fp32.  Every product that
adds into the fp32 ``[V, E]`` head gradient reads and writes all of it
(2.1 GB at llama3-8b's vocabulary and width), so the backward keeps the
logit gradients of a group of tiles, in the inputs' dtype, and adds the
group in one product (:data:`DW_GROUP_BYTES`).  (The JAX package
gets the same bound from ``jax.checkpoint`` per tile inside a
``lax.scan``; ``torch.utils.checkpoint`` would import ``torch._dynamo``
on a worker's first step, so the loss does its own recompute.)
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.utils.checkpoint


def tiled_mlp(fn: Callable, x, num_tiles: int, remat: bool = True):
    """Apply ``fn`` over sequence tiles in turn (ref TiledMLP,
    ulysses_sp.py:838).

    ``fn(x_tile) -> y_tile`` must be pointwise in the sequence dim (true for
    transformer MLPs and norms).  x: [B, S, ...] with S divisible by
    ``num_tiles``.  With ``remat`` each tile is checkpointed (its forward
    reruns in the backward, as the model's ``_maybe_remat`` does), so the
    live activation memory is one tile's."""
    b, s = x.shape[0], x.shape[1]
    if s % num_tiles != 0:
        raise ValueError(f"seq {s} not divisible by num_tiles {num_tiles}")
    tile = s // num_tiles
    outs = []
    for t0 in range(0, s, tile):
        xi = x[:, t0:t0 + tile]
        outs.append(torch.utils.checkpoint.checkpoint(
            fn, xi, use_reentrant=False) if remat else fn(xi))
    return torch.cat(outs, dim=1)


# The backward's buffer of tile logit gradients (inputs' dtype): the tiles
# it holds share one product into the fp32 head gradient.
DW_GROUP_BYTES = 1 << 29


def _mm32(a, b):
    """``a @ b`` with fp32 accumulation and an fp32 result, the products
    in the operands' dtype (``einsum(..., preferred_element_type=f32)``)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _addmm32_(acc, a, b):
    """``acc += a @ b`` in place, ``acc`` fp32, the products in the
    operands' dtype."""
    if a.dtype == torch.float32:
        return acc.addmm_(a, b)
    if a.is_cuda:
        return torch.addmm(acc, a, b, out_dtype=torch.float32, out=acc)
    return acc.addmm_(a.float(), b.float())


def _tile_logits(h, w, logit_cap):
    """One tile's fp32 logits ``h [T, E] @ w.T`` (and the cap's tanh)."""
    z = _mm32(h, w.t())
    if logit_cap is None:
        return z, None
    t = torch.tanh(z / logit_cap)
    return logit_cap * t, t


class _TiledNLL(torch.autograd.Function):
    """The token NLL sum over sequence tiles of ``tile`` tokens (module
    docstring); the token count is a plain function of the labels."""

    @staticmethod
    def forward(ctx, hidden, w, labels, tile, ignore_index, logit_cap,
                group):
        b, s, e = hidden.shape
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        lses = []
        for t0 in range(0, s, tile):
            h = hidden[:, t0:t0 + tile].reshape(-1, e)
            y = labels[:, t0:t0 + tile].reshape(-1)
            z, _ = _tile_logits(h, w, logit_cap)
            lse = torch.logsumexp(z, dim=-1)
            valid = y != ignore_index
            gold = z.gather(1, torch.where(valid, y, 0)[:, None].long())[:, 0]
            total += torch.where(valid, lse - gold, 0.0).sum()
            lses.append(lse)
            del z
        ctx.save_for_backward(hidden, w, labels, torch.stack(lses))
        ctx.tiling = (tile, ignore_index, logit_cap, group)
        return total

    @staticmethod
    def backward(ctx, grad):
        hidden, w, labels, lses = ctx.saved_tensors
        tile, ignore_index, logit_cap, group = ctx.tiling
        b, s, e = hidden.shape
        v = w.shape[0]
        dh = torch.empty_like(hidden)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        # the logit gradients of a group of tiles, added into dw together
        buf = torch.empty((b, group * tile, v), dtype=hidden.dtype,
                          device=hidden.device)
        for i, t0 in enumerate(range(0, s, tile)):
            h = hidden[:, t0:t0 + tile].reshape(-1, e)
            y = labels[:, t0:t0 + tile].reshape(-1)
            z, t = _tile_logits(h, w, logit_cap)
            valid = y != ignore_index
            # d(lse - gold)/dz = softmax - onehot, on the valid tokens; the
            # onehot goes in by scatter (no host sync), 0 on ignored rows
            p = torch.exp(z - lses[i][:, None])
            del z
            p.scatter_add_(1, torch.where(valid, y, 0)[:, None].long(),
                           -valid.float()[:, None])
            p *= (valid.float() * grad)[:, None]
            if t is not None:        # through the cap's tanh
                p *= 1.0 - t * t
            j = i % group
            dl = buf[:, j * tile:(j + 1) * tile]
            dl.copy_(p.view(b, tile, v))
            del p, t
            dh[:, t0:t0 + tile] = torch.matmul(dl, w)
            if j == group - 1 or t0 + tile == s:
                g0 = t0 + tile - (j + 1) * tile
                _addmm32_(dw, buf[:, :(j + 1) * tile].reshape(-1, v).t(),
                          hidden[:, g0:t0 + tile].reshape(-1, e))
        return dh, dw.to(w.dtype), None, None, None, None, None


def tiled_nll(hidden, w, labels, tile: int, ignore_index: int = -100,
              logit_cap: Optional[float] = None):
    """``(token NLL sum, valid token count)`` of ``hidden [B, S, E]``
    against ``w [V, E]`` over sequence tiles of ``tile`` tokens (S must
    divide by it), the logits ``hidden @ w.T`` in the inputs' dtype with
    fp32 accumulation; the sum is differentiable in ``hidden`` and ``w``.
    The backward adds the logit gradients of as many tiles as
    :data:`DW_GROUP_BYTES` holds (at least one) into the head gradient in
    one product."""
    b, s = hidden.shape[:2]
    if s % tile != 0:
        raise ValueError(f"seq {s} not divisible by the tile of {tile} "
                         "tokens")
    per_tile = b * tile * w.shape[0] * hidden.element_size()
    group = max(1, min(DW_GROUP_BYTES // per_tile, s // tile))
    nll = _TiledNLL.apply(hidden, w, labels, tile, ignore_index, logit_cap,
                          group)
    return nll, (labels != ignore_index).sum()


def tiled_logits_loss(hidden, w_embed, labels, num_tiles: int,
                      ignore_index: int = -100,
                      logit_cap: Optional[float] = None):
    """Sequence-tiled cross-entropy without materialising [B, S, V] logits
    (ref tiled logits+loss, ulysses_sp.py:960).

    hidden: [B, S, E]; w_embed: [V, E] (tied output embedding); labels:
    [B, S] with ``ignore_index`` masking.  Returns (mean_loss,
    valid_token_count)."""
    s = hidden.shape[1]
    if s % num_tiles != 0:
        raise ValueError(f"seq {s} not divisible by num_tiles {num_tiles}")
    nll, count = tiled_nll(hidden, w_embed, labels, s // num_tiles,
                           ignore_index, logit_cap)
    return nll / torch.clamp(count, min=1).float(), count


def sp_shard_batch(batch: Dict[str, np.ndarray], sp_rank: int, sp_size: int,
                   seq_keys=("input_ids", "labels", "attention_mask",
                             "position_ids")) -> Dict[str, np.ndarray]:
    """Slice a host batch's sequence dim for one SP rank (ref DataLoader
    shard adapter, ulysses_sp.py:471).

    Each SP rank sees the same samples but a disjoint 1/sp_size slice of the
    sequence; keys not in ``seq_keys`` pass through unsliced."""
    if sp_size == 1:
        return dict(batch)
    out = {}
    for key, val in batch.items():
        if key in seq_keys and val is not None and np.ndim(val) >= 2:
            s = val.shape[1]
            if s % sp_size != 0:
                raise ValueError(
                    f"batch['{key}'] seq len {s} not divisible by sp_size {sp_size}")
            shard = s // sp_size
            out[key] = val[:, sp_rank * shard:(sp_rank + 1) * shard]
        else:
            out[key] = val
    return out


class SPDataLoader:
    """Wrap an iterable of host batches, yielding this rank's sequence shard
    (ref UlyssesSPDataLoaderAdapter, ulysses_sp.py:471)."""

    def __init__(self, loader, sp_rank: int, sp_size: int, seq_keys=None):
        self.loader = loader
        self.sp_rank = sp_rank
        self.sp_size = sp_size
        self.seq_keys = tuple(seq_keys) if seq_keys else (
            "input_ids", "labels", "attention_mask", "position_ids")

    def __iter__(self):
        for batch in self.loader:
            yield sp_shard_batch(batch, self.sp_rank, self.sp_size, self.seq_keys)

    def __len__(self):
        return len(self.loader)
