"""1-bit compressed all-reduce with error feedback (the 1-bit optimizers'
wire).

Port of ``deepspeed_tpu/comm/compressed.py``, plain PyTorch as the JAX
module is plain jnp (no kernel backs it).  With a worker error ``e`` and a
server error ``s`` over a flat buffer ``c = x + e``:

1. chunk ``c`` into ``world`` rows; each row's scale is mean|row|, its
   signs are packed 8 to a byte; the worker error becomes ``c`` less the
   decompressed send;
2. ``all_to_all`` the packed signs and scales: rank r receives chunk r of
   every rank;
3. each rank averages what it received, adds its server error and
   compresses again; the server error becomes the residual;
4. ``all_gather`` the compressed server chunks and decompress: every rank
   holds the same average.

The caller keeps the error state per rank (``worker_err`` [N],
``server_err`` [N / world]).  Where the JAX package names a mesh axis,
these functions take a process group (None: the default group).
"""

from __future__ import annotations

from typing import Tuple

import torch

from deepspeed_tpu_torch.comm import comm

_BIT_WEIGHTS = [1 << i for i in range(8)]


def pack_signs(sign01: torch.Tensor) -> torch.Tensor:
    """Pack {0, 1} sign bits 8 to a byte along the last dim, the first bit
    the lowest.  A length not divisible by 8 is zero-padded here; the
    caller keeps the true length (``_decompress`` slices back to it)."""
    n = sign01.shape[-1]
    pad = (-n) % 8
    if pad:
        sign01 = torch.nn.functional.pad(sign01, (0, pad))
        n += pad
    b = sign01.reshape(tuple(sign01.shape[:-1]) + (n // 8, 8)).to(torch.uint8)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8,
                           device=sign01.device)
    return torch.sum(b * weights, dim=-1, dtype=torch.uint8)


def unpack_signs(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_signs`; returns the padded length (whole
    bytes), which the caller slices back."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(tuple(packed.shape[:-1]) + (packed.shape[-1] * 8,))


def _compress(c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Signs and the L1 scale of each row: ``(packed bits, scale)``."""
    scale = torch.mean(torch.abs(c), dim=-1)
    return pack_signs((c >= 0).to(torch.uint8)), scale


def _decompress(bits: torch.Tensor, scale: torch.Tensor, n: int
                ) -> torch.Tensor:
    sign = unpack_signs(bits)[..., :n].float() * 2.0 - 1.0
    return sign * scale[..., None]


def compressed_allreduce(x: torch.Tensor, worker_err: torch.Tensor,
                         server_err: torch.Tensor, group=None,
                         world: int = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback 1-bit mean all-reduce of the flat ``x`` [N] (N
    divisible by the group's size; a chunk of any length compresses).
    ``worker_err`` [N], ``server_err`` [N / world].  Returns ``(average,
    new worker error, new server error)``."""
    world = comm.group_size(group, world)
    n = x.numel()
    if n % world:
        raise ValueError(f"buffer size {n} not divisible by world {world}")
    m = n // world
    c = x + worker_err
    bits, scales = _compress(c.reshape(world, m))
    new_worker_err = c - _decompress(bits, scales, m).reshape(-1)
    del c

    # rank r receives chunk r of every rank
    bits_t = comm.all_to_all(bits, group=group)
    scales_t = comm.all_to_all(scales, group=group)
    recv = _decompress(bits_t.reshape(world, -(-m // 8)),
                       scales_t.reshape(world), m)

    server_chunk = torch.mean(recv, dim=0) + server_err
    s_bits, s_scale = _compress(server_chunk[None, :])
    new_server_err = server_chunk - _decompress(s_bits, s_scale, m)[0]

    # every rank's compressed server chunk
    g_bits = comm.all_gather(s_bits, 0, group)
    g_scale = comm.all_gather(s_scale, 0, group)
    out = _decompress(g_bits, g_scale.reshape(world), m).reshape(-1)[:n]
    return out, new_worker_err, new_server_err


class CompressedBackend:
    """The reference's backend object: a group and its size, and
    ``compressed_allreduce`` bound to them."""

    def __init__(self, group=None, world: int = None):
        self.group = group
        self.world = comm.group_size(group, world)
        self.size = self.world

    def compressed_allreduce(self, x, worker_err, server_err):
        return compressed_allreduce(x, worker_err, server_err, self.group,
                                    self.world)
