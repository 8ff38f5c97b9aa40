"""Block-sparse attention with DeepSpeed-compatible sparsity configs.

Port of ``deepspeed_tpu/ops/sparse_attention.py`` (itself the analog of
``deepspeed/ops/sparse_attention/``: ``sparsity_config.py`` configs and
``sparse_self_attention.py``).  The configs build the same numpy block
layouts ``[H, S/block, S/block]``, bit for bit (BigBird's random blocks
included: the same ``np.random.default_rng(seed)`` draws).
:func:`sparse_attention` runs the block-sparse kernels of
``ops/block_sparse_mha.py`` on CUDA tensors and their plain versions on
CPU tensors.  The JAX function's dense-masked XLA lowering has no
counterpart: a CUDA call launches the kernels or raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops import block_sparse_mha as bsm
from deepspeed_tpu_torch.ops.block_sparse_mha import layout_to_token_mask  # noqa: F401


class SparsityConfig:
    """Base (ref sparsity_config.py SparsityConfig): block layout builder."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(f"seq len {seq_len} not divisible by block "
                             f"{self.block}")
        nb = seq_len // self.block
        return np.zeros((self.num_heads, nb, nb), dtype=np.int64)

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """All blocks attend (ref DenseSparsityConfig) — for testing parity."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Local windows + periodic global blocks (ref FixedSparsityConfig).

    Each query block attends its own ``num_local_blocks`` window plus the
    last ``num_global_blocks`` of every window (the "summary" blocks).
    """

    def __init__(self, num_heads: int, block: int = 16,
                 num_local_blocks: int = 4, num_global_blocks: int = 1,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False, **kw):
        super().__init__(num_heads, block, kw.get("different_layout_per_head", False))
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        for q in range(nb):
            w0 = (q // self.num_local_blocks) * self.num_local_blocks
            # local window
            for k in range(w0, min(w0 + self.num_local_blocks, nb)):
                layout[:, q, k] = 1
            # global (summary) blocks: last num_global_blocks of each
            # preceding window
            for wstart in range(0, nb, self.num_local_blocks):
                gstart = wstart + self.num_local_blocks - self.num_global_blocks
                for k in range(max(wstart, gstart), min(wstart + self.num_local_blocks, nb)):
                    if k <= q or self.attention == "bidirectional":
                        layout[:, q, k] = 1
                    if self.horizontal_global_attention:
                        layout[:, k, q] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout


class BSLongformerSparsityConfig(SparsityConfig):
    """Sliding window + explicit global blocks (ref
    BSLongformerSparsityConfig)."""

    def __init__(self, num_heads: int, block: int = 16,
                 num_sliding_window_blocks: int = 3,
                 global_block_indices=(0,), attention: str = "bidirectional",
                 **kw):
        super().__init__(num_heads, block, kw.get("different_layout_per_head", False))
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = list(global_block_indices)
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        half = self.num_sliding_window_blocks // 2
        for q in range(nb):
            for k in range(max(0, q - half), min(nb, q + half + 1)):
                layout[:, q, k] = 1
        for g in self.global_block_indices:
            if g < nb:
                layout[:, g, :] = 1  # global row
                layout[:, :, g] = 1  # global column
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout


class BigBirdSparsityConfig(SparsityConfig):
    """Random + sliding + global blocks (ref BigBirdSparsityConfig)."""

    def __init__(self, num_heads: int, block: int = 16,
                 num_random_blocks: int = 1, num_sliding_window_blocks: int = 3,
                 num_global_blocks: int = 1, attention: str = "bidirectional",
                 seed: int = 0, **kw):
        super().__init__(num_heads, block,
                         kw.get("different_layout_per_head", False))
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.seed = seed

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        half = self.num_sliding_window_blocks // 2
        rng = np.random.default_rng(self.seed)
        for h in range(self.num_heads if self.different_layout_per_head else 1):
            for q in range(nb):
                for k in range(max(0, q - half), min(nb, q + half + 1)):
                    layout[h, q, k] = 1
                ks = rng.choice(nb, size=min(self.num_random_blocks, nb),
                                replace=False)
                layout[h, q, ks] = 1
            g = self.num_global_blocks
            layout[h, :g, :] = 1
            layout[h, :, :g] = 1
        if not self.different_layout_per_head:
            layout[:] = layout[0]
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout


class VariableSparsityConfig(SparsityConfig):
    """Per-head variable local windows + globals (ref
    VariableSparsityConfig, simplified: explicit window list)."""

    def __init__(self, num_heads: int, block: int = 16,
                 local_window_blocks=(4,), global_block_indices=(0,),
                 attention: str = "bidirectional", **kw):
        super().__init__(num_heads, block, True)
        self.local_window_blocks = list(local_window_blocks)
        self.global_block_indices = list(global_block_indices)
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        for h in range(self.num_heads):
            w = self.local_window_blocks[min(h, len(self.local_window_blocks) - 1)]
            for q in range(nb):
                w0 = (q // w) * w
                layout[h, q, w0:min(w0 + w, nb)] = 1
        for g in self.global_block_indices:
            if g < nb:
                layout[:, g, :] = 1
                layout[:, :, g] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout


# ----------------------------------------------------------------------
def _config_key(cfg: SparsityConfig) -> Tuple:
    return (type(cfg).__name__,) + tuple(sorted(
        (k, tuple(v) if isinstance(v, list) else v)
        for k, v in vars(cfg).items()))


_LAYOUTS: Dict[Tuple, bsm.SparseLayout] = {}


def sparse_layout(cfg: SparsityConfig, seq_len: int, causal: bool,
                  device) -> bsm.SparseLayout:
    """The kernels' form of ``cfg``'s layout at ``seq_len``, built once per
    (config, length, causal, device): later calls do no host numpy and no
    host-to-device copy."""
    key = (_config_key(cfg), int(seq_len), bool(causal), str(device))
    plan = _LAYOUTS.get(key)
    if plan is None:
        plan = bsm.SparseLayout(cfg.make_layout(seq_len), cfg.block, causal,
                                device)
        _LAYOUTS[key] = plan
    return plan


def sparse_attention(q, k, v, sparsity_config: SparsityConfig,
                     causal: bool = False,
                     sm_scale: Optional[float] = None,
                     impl: str = "auto") -> torch.Tensor:
    """Block-sparse attention (ref SparseSelfAttention forward).

    q/k/v: [B, S, H, D] → [B, S, H, D] (GQA: k/v may carry fewer heads).
    The block layout masks the score matrix; causal composes a
    lower-triangular mask on top; a query row that sees no key gives
    zeros (the kernel's convention).  ``impl``: ``'auto'`` or ``'pallas'``
    (the JAX names; both take the block-sparse kernels); the JAX
    function's ``'xla'`` dense lowering is not ported.
    """
    if impl not in ("auto", "pallas"):
        raise ValueError(f"impl={impl!r}: deepspeed_tpu_torch runs the "
                         "block-sparse kernels ('auto'); the dense 'xla' "
                         "lowering is not ported")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    plan = sparse_layout(sparsity_config, q.shape[1], causal, q.device)
    out = bsm.block_sparse_mha(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), plan, plan.block,
                               causal=causal, sm_scale=sm_scale)
    return out.transpose(1, 2)
