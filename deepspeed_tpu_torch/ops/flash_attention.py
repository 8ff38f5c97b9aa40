"""Flash attention over the model's ``[batch, seq, heads, head_dim]`` layout.

Port of ``deepspeed_tpu/ops/flash_attention.py`` ``flash_attention``.  The
JAX function picks between its own Pallas kernel, JAX's bundled library
kernel (``_lib_flash``) and an XLA fallback; the port has one route for
every shape: :func:`deepspeed_tpu_torch.ops.flash_mha.flash_mha`, whose
kernels read the transposed ``[B, H, S, D]`` views in place.
"""

from __future__ import annotations

import math
from typing import Optional

from deepspeed_tpu_torch.ops.flash_mha import flash_mha


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None,
                    window: Optional[int] = None):
    """Multi-head attention over ``q [B, S, Hq, D]``, ``k/v [B, S, Hkv,
    D]``; returns ``[B, S, Hq, D]``."""
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive (got {window}); pass "
                         "None to disable sliding-window masking")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    out = flash_mha(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    causal, sm_scale, window)
    return out.transpose(1, 2)
