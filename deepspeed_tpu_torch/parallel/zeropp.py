"""qwZ: the ZeRO-3 weight gather on a quantized wire.

Port of ``deepspeed_tpu/parallel/zeropp.py`` ``qwz_weight_gather``.  The
JAX package encodes each master leaf with the wire codec (block-scaled
int8, or fp8 moved as uint8, with fp32 block scales; ``comm/quantized.py``)
while it is still sharded, lets GSPMD gather the payload and the scales,
decodes, and passes the gradient straight through to the master leaf
(``p + stop_gradient(w - p)``).  Here the stage-3 gather of ``zero.py``
packs each rank's payload and scales into the layer's flat all-gather and
decodes after it; the gradient goes to the shard as an fp32 gather's does.

Which leaves, and which blocks, are the JAX package's:

* a leaf is encoded when it has a dim and its stacked (global) size is at
  least the group size (:func:`quantized`), kept whole or split; a whole
  leaf takes the round trip on its own rank (:func:`round_trip`,
  :func:`straight_through`), as the JAX code runs it on every leaf;
* a block is ``group_size`` along the last dim, or the whole last dim
  when that does not divide by ``group_size`` (:func:`block_of`).

A leaf split on its last dim whose shards do not hold whole blocks (a
128-wide block over 4 ranks of 32 columns) has blocks that straddle
shards.  Its scales are those of the whole block: each rank reduces its
part of each block to a partial absolute maximum (:func:`partial_absmax`),
the ranks take their maximum in one all-reduce, and each rank quantizes
its columns with the block's scale (:func:`quantize_columns`), so its
payload is its slice of the whole leaf's encoding and every rank decodes
with the same scales.  The forward value of a gathered leaf is the
decoded ``w``; the JAX value ``p + (w - p)`` in fp32 can differ from it by
one ulp where ``w - p`` rounds, which the gather cannot reproduce without
moving ``p``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.comm import quantized as wire

# the group size when comm_quantization is off (the legacy flag)
DEFAULT_GROUP_SIZE = 256


def qwz_of(config) -> Optional[Tuple[str, int]]:
    """``(wire dtype, group size)`` of a config's ZeRO-3 gather, or None:
    ``comm_quantization.zero3_gather`` when the block is enabled and asks
    for int8 or fp8, else int8 under the legacy
    ``zero_optimization.zero_quantized_weights``; the group size is the
    block's ``group_size`` when it is enabled, else 256 (the JAX engine's
    rule, ``deepspeed_tpu/runtime/engine.py:1163-1173``).  Only ZeRO stage
    3 gathers weights."""
    if config.zero_config.stage < 3:
        return None
    cq = config.comm_quantization
    dtype = None
    if cq.enabled and cq.zero3_gather != "fp32":
        dtype = cq.zero3_gather
    elif config.zero_config.zero_quantized_weights:
        dtype = "int8"
    if dtype is None:
        return None
    wire.validate_wire_dtype(dtype)
    return dtype, cq.group_size if cq.enabled else DEFAULT_GROUP_SIZE


def quantized(full_shape, group_size: int) -> bool:
    """Whether the JAX gather encodes a leaf of (stacked, global)
    ``full_shape``: it has a dim and at least ``group_size`` elements."""
    return len(full_shape) > 0 and math.prod(full_shape) >= group_size


def block_of(m: int, group_size: int) -> int:
    """The block length along a last dim of ``m``."""
    return group_size if m % group_size == 0 else m


def round_trip(x: torch.Tensor, wire_dtype: str, group_size: int
               ) -> torch.Tensor:
    """The decoded fp32 values of the whole tensor ``x`` on the wire."""
    m = x.shape[-1]
    payload, scale = wire._wire_encode(x.float().reshape(-1, m), wire_dtype,
                                       block_of(m, group_size),
                                       backend="torch")
    return wire._wire_decode(payload, scale, wire_dtype,
                             backend="torch").reshape(x.shape)


def straight_through(p: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``p + stop_gradient(w - p)`` in ``p``'s dtype: forward ``w`` (as
    the JAX code rounds it), gradient to ``p`` unchanged."""
    return p + (w.to(p.dtype) - p).detach()


def qwz_weight_gather(params, wire_dtype: str, group_size: int):
    """The round trip with straight-through gradients on every leaf of a
    tree of whole leaves (a ZeRO-3 engine of one rank, where nothing is
    gathered): the JAX function's values on one device."""
    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if not quantized(tuple(x.shape), group_size):
            return x
        return straight_through(x, round_trip(x.detach(), wire_dtype,
                                              group_size))

    return one(params)


def straddles(shard_shape, dim: int, world: int, group_size: int) -> bool:
    """Whether a leaf split on ``dim`` has blocks that lie across shards:
    split on its last dim, whose shard width does not hold whole blocks."""
    if dim != len(shard_shape) - 1:
        return False
    m_l = shard_shape[-1]
    return m_l % block_of(m_l * world, group_size) != 0


def _column_blocks(m_l: int, rank: int, gs: int, device) -> torch.Tensor:
    return (rank * m_l + torch.arange(m_l, device=device)) // gs


def partial_absmax(x: torch.Tensor, rank: int, world: int,
                   group_size: int) -> torch.Tensor:
    """This rank's part of the absolute maximum of every block of a leaf
    split on its last dim: ``x`` is the rank's shard ``[..., m / world]``;
    returns fp32 ``[..., blocks]`` (0 for blocks the shard does not
    touch), whose maximum over the ranks is the whole leaf's."""
    m_l = x.shape[-1]
    gs = block_of(m_l * world, group_size)
    idx = _column_blocks(m_l, rank, gs, x.device).expand(x.shape)
    out = torch.zeros(tuple(x.shape[:-1]) + (m_l * world // gs,),
                      dtype=torch.float32, device=x.device)
    return out.scatter_reduce(-1, idx, torch.abs(x.float()), "amax")


def quantize_columns(x: torch.Tensor, scale: torch.Tensor, rank: int,
                     world: int, group_size: int, wire_dtype: str
                     ) -> torch.Tensor:
    """This rank's payload of a leaf split on its last dim, quantized with
    the whole blocks' ``scale`` ``[..., blocks]``: the rank's columns of the
    whole leaf's payload."""
    m_l = x.shape[-1]
    gs = block_of(m_l * world, group_size)
    cols = scale[..., _column_blocks(m_l, rank, gs, x.device)]
    return wire.wire_quantize(x.float(), cols, wire_dtype)


def decode(payload: torch.Tensor, scale: torch.Tensor, wire_dtype: str
           ) -> torch.Tensor:
    """fp32 values of a whole leaf's ``payload`` ``[..., m]`` and block
    ``scale`` ``[..., blocks]``."""
    m = payload.shape[-1]
    out = wire._wire_decode(payload.reshape(-1, m),
                            scale.reshape(-1, scale.shape[-1]), wire_dtype,
                            backend="torch")
    return out.reshape(payload.shape)


def encode_shard(x: torch.Tensor, m: int, group_size: int,
                 wire_dtype: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Payload and scales ``[..., blocks]`` of a shard whose blocks lie
    whole in it (split on another dim, or on the last dim at whole
    blocks), ``m`` the whole leaf's last dim; gathered along the split dim
    they are the whole leaf's."""
    m_l = x.shape[-1]
    payload, scale = wire._wire_encode(x.float().reshape(-1, m_l),
                                       wire_dtype, block_of(m, group_size),
                                       backend="torch")
    return (payload.reshape(x.shape),
            scale.reshape(tuple(x.shape[:-1]) + (scale.shape[-1],)))
