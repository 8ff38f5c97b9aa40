"""The quantized wire codec: block-scaled int8 or fp8 payloads with fp32
scales.

Port of the codec of ``deepspeed_tpu/comm/quantized.py``
(``wire_encode_rows``/``wire_decode_rows`` and the int8/fp8 branches of
``_wire_encode``/``_wire_decode``), which the ring's quantized wire
(``sequence/ring.py``, ``comm_quantization.ring_rotation``) uses to move
K/V and the traveling dk/dv.  The quantized reduce-scatter and all-reduce of
the same JAX module serve ``comm_quantization.grad_reduce``, which the port
does not run yet (ROADMAP Queue A item 8).

Wire dtypes:
  ``fp32``  no quantization: the buffer travels as it is.
  ``int8``  symmetric blockwise int8: scale = absmax / 127 (a zero scale
            becomes 1), payload = round-half-to-even(x / scale) clipped to
            [-128, 127] (the symmetric branch of ``ops/quantizer.py``
            ``quantize_blockwise``).
  ``fp8``   float8_e4m3fn of x / (absmax / 448), viewed as uint8 so that
            every backend (gloo too) moves plain bytes.

The scale's rounding is that of the JAX ring, which encodes under ``jit``:
XLA compiles ``absmax / qmax`` there as a multiply by the fp32 reciprocal
of ``qmax`` (one ulp off the true quotient in some rows), and this module
computes it so, bit for bit.  The eager JAX path divides;
``ops/quantizer.py`` matches that one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# wire dtypes a comm_quantization block may select per collective
WIRE_DTYPES = ("fp32", "int8", "fp8")

_FP8_DTYPE = getattr(torch, "float8_e4m3fn", None)
_FP8_MAX = 448.0   # e4m3fn's largest finite value
_INT8_MAX = 127.0


def wire_encode_rows(x: torch.Tensor, wire_dtype: str
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Encode a ``[..., d]`` buffer for the wire with ONE fp32 scale per
    trailing-dim row (the block is the trailing dim, the layout the ring's
    hop kernels read).  Returns ``(payload, scale)``: the payload has
    ``x``'s shape (int8, or fp8 viewed as uint8) and is contiguous,
    ``scale`` is fp32 ``x.shape[:-1] + (1,)``; ``(x, None)`` for fp32."""
    if wire_dtype == "fp32":
        return x, None
    d = x.shape[-1]
    payload, scale = _wire_encode(x.float().reshape(-1, d), wire_dtype, d)
    return (payload.reshape(x.shape),
            scale.reshape(tuple(x.shape[:-1]) + (1,)))


def wire_decode_rows(payload: torch.Tensor, scale: Optional[torch.Tensor],
                     wire_dtype: str) -> torch.Tensor:
    """Inverse of :func:`wire_encode_rows`; always fp32 (contiguous).  The
    int8 branch is one fp32 multiply an element after an exact int8 to fp32
    convert: the arithmetic of the JAX kernels' ``wire_dequant_rows`` and
    of the port's hop kernels on their fp32 route."""
    if wire_dtype == "fp32":
        return payload
    d = payload.shape[-1]
    out = _wire_decode(payload.reshape(-1, d), scale.reshape(-1, 1),
                       wire_dtype)
    return out.reshape(payload.shape)


def fp8_supported() -> bool:
    return _FP8_DTYPE is not None


def validate_wire_dtype(name: str) -> str:
    if name not in WIRE_DTYPES:
        raise ValueError(f"wire dtype {name!r} not in {WIRE_DTYPES}")
    if name == "fp8" and not fp8_supported():
        raise ValueError("wire dtype 'fp8' requires torch.float8_e4m3fn, "
                         "which this torch build lacks")
    return name


def _block(m: int, group_size: int) -> int:
    """The block length of an ``m``-wide row: ``group_size`` when it
    divides ``m``, else the whole row."""
    gs = min(group_size, m) if group_size > 0 else m
    if m % gs:
        gs = m
    return gs


def _recip(qmax: float, like: torch.Tensor) -> torch.Tensor:
    """fp32(1 / qmax) as a 0-dim tensor on ``like``'s device: the factor
    XLA multiplies by for ``absmax / qmax`` under jit."""
    return torch.tensor(1.0 / qmax, dtype=torch.float32, device=like.device)


def _wire_encode(x2d: torch.Tensor, wire_dtype: str, group_size: int
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Encode last-dim blocks of an fp32 ``[rows, m]`` buffer: returns
    ``(payload, scales [rows, m / block])``; scales None for fp32."""
    if wire_dtype == "fp32":
        return x2d, None
    validate_wire_dtype(wire_dtype)
    m = x2d.shape[-1]
    gs = _block(m, group_size)
    g = x2d.reshape(tuple(x2d.shape[:-1]) + (m // gs, gs))
    scale = wire_scale(torch.amax(torch.abs(g), dim=-1, keepdim=True),
                       wire_dtype)
    return wire_quantize(g, scale, wire_dtype).reshape(x2d.shape), \
        scale.squeeze(-1)


def wire_scale(absmax: torch.Tensor, wire_dtype: str) -> torch.Tensor:
    """The fp32 scale of blocks of absolute maximum ``absmax`` (int8 or
    fp8): ``absmax * fp32(1 / qmax)``, one where it is zero."""
    qmax = _INT8_MAX if wire_dtype == "int8" else _FP8_MAX
    scale = absmax * _recip(qmax, absmax)
    return torch.where(scale == 0, 1.0, scale)


def wire_quantize(x: torch.Tensor, scale: torch.Tensor, wire_dtype: str
                  ) -> torch.Tensor:
    """The payload of fp32 ``x`` over ``scale`` (broadcast to it): int8
    round-half-to-even of ``x / scale`` clipped to [-128, 127], or
    float8_e4m3fn of ``x / scale`` viewed as uint8."""
    if wire_dtype == "int8":
        return torch.clamp(torch.round(x / scale), -_INT8_MAX - 1,
                           _INT8_MAX).to(torch.int8)
    return (x / scale).to(_FP8_DTYPE).view(torch.uint8)


def _wire_decode(payload: torch.Tensor, scale: Optional[torch.Tensor],
                 wire_dtype: str) -> torch.Tensor:
    """Inverse of :func:`_wire_encode`; always fp32."""
    if wire_dtype == "fp32":
        return payload
    if wire_dtype == "int8":
        vals = payload
    else:
        vals = payload.contiguous().view(_FP8_DTYPE)
    m = vals.shape[-1]
    gs = m // scale.shape[-1]
    g = vals.float().reshape(tuple(vals.shape[:-1]) + (scale.shape[-1], gs))
    return (g * scale[..., None]).reshape(vals.shape)
