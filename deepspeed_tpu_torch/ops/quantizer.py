"""Blockwise integer quantization: the routing façade over the kernels.

Port of ``deepspeed_tpu/ops/quantizer.py``.  Symmetric blockwise calls of
a shape that :func:`ops.quantize.supports` accepts go to the kernels of
``ops/quantize.py`` (a hand-written CUDA kernel on CUDA tensors, its plain
version on CPU tensors); asymmetric mode takes the torch arithmetic below,
which is the JAX package's jnp path, ported: the reference's own second
path, on a TPU as here.  A symmetric call on a CUDA tensor that the
kernels cannot serve (a group that is not a whole number of their
vectors) raises; on a CPU tensor it takes the torch arithmetic, whose
numbers are the plain versions'.

``backend`` (the JAX values in brackets):
  * ``"auto"`` (``"auto"`` and ``"pallas"``): the kernel when
    :func:`supports` accepts the call, else the torch arithmetic (or, on
    a symmetric CUDA call, an error).  JAX needs
    two values because its ``"auto"`` takes the Pallas kernel only on a
    TPU and ``"pallas"`` forces it elsewhere; here the kernel wrapper runs
    wherever the tensor lies (its plain version on the CPU).
  * ``"torch"`` (``"jnp"``): always the torch arithmetic.

All functions group the last axis into ``group_size`` blocks, each with
its own scale (and zero point when asymmetric).  int4 packs two nibbles
per byte.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops import quantize as qk

BACKENDS = ("auto", "torch")


def _kernel_ok(x: torch.Tensor, num_bits: int, group_size: int,
               symmetric: bool, backend: str) -> bool:
    """Route to the kernels when the backend allows and they serve the
    call; a symmetric CUDA call they cannot serve raises."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "torch":
        return False
    if qk.supports(tuple(x.shape), group_size, symmetric, num_bits, x.dtype):
        return True
    if x.device.type == "cuda" and symmetric and num_bits in (4, 8):
        raise ValueError(
            f"quantizer: shape {tuple(x.shape)}, {x.dtype}, group "
            f"{group_size} is not served by the quantize kernels (a group "
            "that divides the last dim and holds whole vectors of "
            f"{qk.vector_elems(x.dtype)} elements); backend='torch' takes "
            "the plain arithmetic")
    return False


def _whole(x: torch.Tensor, group_size: int) -> int:
    """``group_size``, or the last dim where it is <= 0 or longer (one
    group a row)."""
    n = x.shape[-1]
    return n if group_size <= 0 or group_size > n else group_size


def _group(x: torch.Tensor, group_size: int) -> Tuple[torch.Tensor, int]:
    n = x.shape[-1]
    group_size = _whole(x, group_size)
    if n % group_size != 0:
        raise ValueError(f"last dim {n} not divisible by group_size {group_size}")
    return x.reshape(tuple(x.shape[:-1]) + (n // group_size, group_size)), group_size


def _dev_scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim fp32 tensor on ``like``'s device: dividing by it is a true
    division (PyTorch may multiply by the reciprocal of a host scalar)."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def quantize_blockwise(x: torch.Tensor, num_bits: int = 8,
                       group_size: int = 256, symmetric: bool = True,
                       backend: str = "auto"
                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                  Optional[torch.Tensor]]:
    """Quantize to ``num_bits`` integers with per-group scales.

    Returns ``(q, scale, zero_point)``; ``zero_point`` is None when
    symmetric.  q is int8 (int4 values occupy the low nibble range)."""
    group_size = _whole(x, group_size)
    if _kernel_ok(x, num_bits, group_size, symmetric, backend):
        q, s = qk.quantize(x, num_bits, group_size)
        return q, s, None
    g, group_size = _group(x.float(), group_size)
    qmax = qk.qmax_of(num_bits)
    if symmetric:
        absmax = torch.amax(torch.abs(g), dim=-1, keepdim=True)
        scale = absmax / _dev_scalar(qmax, g)
        scale = torch.where(scale == 0, 1.0, scale)
        q = torch.clamp(torch.round(g / scale), -qmax - 1, qmax).to(torch.int8)
        return q.reshape(x.shape), scale.squeeze(-1), None
    lo = torch.amin(g, dim=-1, keepdim=True)
    hi = torch.amax(g, dim=-1, keepdim=True)
    scale = (hi - lo) / _dev_scalar(2 ** num_bits - 1, g)
    scale = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round((g - lo) / scale), 0, 2 ** num_bits - 1)
    # store centred so int8 holds the uint range for 8-bit too
    q = (q - 2 ** (num_bits - 1)).to(torch.int8)
    return q.reshape(x.shape), scale.squeeze(-1), lo.squeeze(-1)


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor,
                         zero_point: Optional[torch.Tensor] = None,
                         num_bits: int = 8, dtype=torch.float32,
                         backend: str = "auto") -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise`."""
    if zero_point is None and _kernel_ok(
            q, num_bits, q.shape[-1] // scale.shape[-1], True, backend):
        return qk.dequantize(q, scale, dtype=dtype)
    shape = tuple(q.shape)
    group_size = shape[-1] // scale.shape[-1]
    g = q.float().reshape(shape[:-1] + (scale.shape[-1], group_size))
    if zero_point is None:
        out = g * scale[..., None]
    else:
        out = (g + 2 ** (num_bits - 1)) * scale[..., None] + zero_point[..., None]
    return out.reshape(shape).to(dtype)


def fake_quantize(x: torch.Tensor, num_bits: int = 8, group_size: int = 256,
                  symmetric: bool = True, backend: str = "auto") -> torch.Tensor:
    """Quantize-dequantize round trip for QAT; the kernel does it in one
    pass without writing the payload."""
    group_size = _whole(x, group_size)
    if _kernel_ok(x, num_bits, group_size, symmetric, backend):
        return qk.fake_quantize(x, num_bits, group_size)
    q, s, z = quantize_blockwise(x, num_bits, group_size, symmetric,
                                 backend="torch")
    return dequantize_blockwise(q, s, z, num_bits, dtype=x.dtype,
                                backend="torch")


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 values (stored in int8) two to a byte, low nibble first."""
    if q.shape[-1] % 2 != 0:
        raise ValueError("last dim must be even to pack int4")
    lo = q[..., 0::2].to(torch.uint8) & 0xF
    hi = (q[..., 1::2].to(torch.uint8) & 0xF) << 4
    return lo | hi


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: sign-extended int8 nibbles."""
    lo = (packed & 0xF).to(torch.int8)
    hi = ((packed >> 4) & 0xF).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(tuple(packed.shape[:-1]) + (packed.shape[-1] * 2,))


def stochastic_round(x: torch.Tensor,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Round up with probability equal to the fractional part (the JAX
    version draws from a PRNG key; here from ``generator``)."""
    floor = torch.floor(x)
    frac = x - floor
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return floor + (u < frac).to(x.dtype)
