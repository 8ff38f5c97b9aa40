"""Quantized collectives: block-scaled int8 or fp8 payloads with fp32
scales, and the quantized gradient reduction over a data axis.

Port of ``deepspeed_tpu/comm/quantized.py``: the wire codec
(``wire_encode_rows``/``wire_decode_rows``, ``_wire_encode``/
``_wire_decode``) that the ring's quantized wire (``sequence/ring.py``,
``comm_quantization.ring_rotation``) and the qwZ gather
(``parallel/zeropp.py``) use, and the collectives of
``comm_quantization.grad_reduce``: :func:`quantized_reduce_scatter`
(quantize each rank's chunk, ``all_to_all``, dequantize and reduce in
fp32, with optional error feedback on the first send) and
:func:`quantized_all_reduce` (then requantize the reduced chunk and
``all_gather`` it: both phases move the payload).  Each wire movement is
recorded under one of :data:`QUANT_COMM_OPS` in ``comm.nbytes()``, payload
and scales.

Wire dtypes:
  ``fp32``  no quantization: the buffer travels as it is.
  ``int8``  symmetric blockwise int8: scale = absmax / 127 (a zero scale
            becomes 1), payload = round-half-to-even(x / scale) clipped to
            [-128, 127] (the symmetric branch of ``ops/quantizer.py``
            ``quantize_blockwise``).
  ``fp8``   float8_e4m3fn of x / (absmax / 448), viewed as uint8 so that
            every backend (gloo too) moves plain bytes.

``backend`` routes the int8 codec as the JAX argument does: ``"auto"``
(the gradient reduction) goes through ``ops/quantizer.py``, which launches
the ``quantize``/``dequantize`` kernels on CUDA tensors (their plain
versions on CPU tensors); ``"torch"`` (JAX's ``"jnp"``: the ring and qwZ)
keeps the plain arithmetic below.  The two round the scale differently.
The plain codec takes the rounding of the JAX ring, which encodes under
``jit``: XLA compiles ``absmax / qmax`` there as a multiply by the fp32
reciprocal of ``qmax`` (one ulp off the true quotient in some blocks), and
this module computes it so, bit for bit.  The kernels divide, as the eager
JAX path does; the JAX gradient reduction runs under ``jit`` and takes the
reciprocal, so there the two packages' scales may be one ulp apart in a
block (ROADMAP, reference divergences).  fp8 is plain arithmetic on every
backend, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.ops import quantizer

# wire dtypes a comm_quantization block may select per collective
WIRE_DTYPES = ("fp32", "int8", "fp8")

# every wire movement of the quantized collectives is recorded under one
# of these names in ``comm.nbytes()``, payload and scales both
QUANT_COMM_OPS = ("quant_reduce_scatter", "quant_all_gather")

_FP8_DTYPE = getattr(torch, "float8_e4m3fn", None)
_FP8_MAX = 448.0   # e4m3fn's largest finite value


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
    payload, scale = _wire_encode(x.float().reshape(-1, d), wire_dtype, d,
                                  backend="torch")
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
                       wire_dtype, backend="torch")
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


def _wire_encode(x2d: torch.Tensor, wire_dtype: str, group_size: int,
                 backend: str = "auto"
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Encode last-dim blocks of an fp32 ``[rows, m]`` buffer: returns
    ``(payload, scales [rows, m / block])``; scales None for fp32.
    ``backend`` routes the int8 codec (``"auto"``: ``ops/quantizer.py``,
    the kernel on CUDA tensors; ``"torch"``: the plain arithmetic).  The
    JAX function's ``num_bits`` (int4 values on the int8 wire) is left
    out: no caller sets it."""
    if wire_dtype == "fp32":
        return x2d, None
    validate_wire_dtype(wire_dtype)
    m = x2d.shape[-1]
    gs = _block(m, group_size)
    if wire_dtype == "int8" and backend != "torch":
        q, scale, _ = quantizer.quantize_blockwise(x2d, group_size=gs,
                                                   backend=backend)
        return q, scale
    g = x2d.reshape(tuple(x2d.shape[:-1]) + (m // gs, gs))
    scale = wire_scale(torch.amax(torch.abs(g), dim=-1, keepdim=True),
                       wire_dtype)
    return wire_quantize(g, scale, wire_dtype).reshape(x2d.shape), \
        scale.squeeze(-1)


def _qmax(wire_dtype: str) -> float:
    return _FP8_MAX if wire_dtype == "fp8" else 127.0


def wire_scale(absmax: torch.Tensor, wire_dtype: str) -> torch.Tensor:
    """The fp32 scale of blocks of absolute maximum ``absmax`` (int8 or
    fp8): ``absmax * fp32(1 / qmax)``, one where it is zero."""
    scale = absmax * _recip(_qmax(wire_dtype), absmax)
    return torch.where(scale == 0, 1.0, scale)


def wire_quantize(x: torch.Tensor, scale: torch.Tensor,
                  wire_dtype: str) -> torch.Tensor:
    """The payload of fp32 ``x`` over ``scale`` (broadcast to it): int8
    round-half-to-even of ``x / scale`` clipped to [-128, 127], or
    float8_e4m3fn of ``x / scale`` viewed as uint8."""
    if wire_dtype == "int8":
        return torch.clamp(torch.round(x / scale), -128, 127).to(torch.int8)
    return (x / scale).to(_FP8_DTYPE).view(torch.uint8)


def _wire_decode(payload: torch.Tensor, scale: Optional[torch.Tensor],
                 wire_dtype: str, backend: str = "auto") -> torch.Tensor:
    """Inverse of :func:`_wire_encode`; always fp32."""
    if wire_dtype == "fp32":
        return payload
    if wire_dtype == "int8":
        if backend != "torch":
            return quantizer.dequantize_blockwise(payload, scale,
                                                  backend=backend)
        vals = payload
    else:
        vals = payload.contiguous().view(_FP8_DTYPE)
    m = vals.shape[-1]
    gs = m // scale.shape[-1]
    g = vals.float().reshape(tuple(vals.shape[:-1]) + (scale.shape[-1], gs))
    return (g * scale[..., None]).reshape(vals.shape)


# ----------------------------------------------------------------------
# the quantized gradient reduction
# ----------------------------------------------------------------------
def _log_wire(op: str, payload: torch.Tensor,
              scale: Optional[torch.Tensor], group) -> None:
    """Record what travels the wire over ``group``: the payload and, for a
    quantized dtype, its fp32 scales."""
    comm.record_bytes(op, payload, scale, group=group)


def quantized_reduce_scatter(x: torch.Tensor, group=None,
                             world: Optional[int] = None,
                             wire_dtype: str = "int8", group_size: int = 256,
                             residual: Optional[torch.Tensor] = None,
                             mean: bool = True
                             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Block-scaled quantized reduce-scatter of the flat fp32 ``x`` [N]
    (N divisible by the group's size): quantize, ``all_to_all``, dequantize
    and reduce in fp32.  Rank r returns its [N / world] reduced chunk.
    ``residual`` (shaped as ``x``) turns error feedback on: it is added to
    the send and the new first-send residual is returned (None without
    one).  ``mean`` divides by ``world``; ``False`` keeps the sum."""
    world = comm.group_size(group, world)
    n = x.numel()
    if n % world:
        raise ValueError(f"buffer size {n} not divisible by world {world}")
    m = n // world
    c = x + residual if residual is not None else x
    chunks = c.reshape(world, m)
    payload, scale = _wire_encode(chunks, wire_dtype, group_size)
    _log_wire("quant_reduce_scatter", payload, scale, group)
    new_residual = None
    if residual is not None:
        sent = _wire_decode(payload, scale, wire_dtype).reshape(-1)
        new_residual = c - sent
        del sent
    del c, chunks
    # rank r receives chunk r of every rank: [world, m], a row a source
    p_t = comm.all_to_all(payload, group=group)
    s_t = comm.all_to_all(scale, group=group) if scale is not None else None
    del payload, scale
    deq = _wire_decode(p_t, s_t, wire_dtype)
    red = deq.mean(dim=0) if mean else deq.sum(dim=0)
    return red, new_residual


def quantized_all_reduce(x: torch.Tensor, group=None,
                         world: Optional[int] = None,
                         wire_dtype: str = "int8", group_size: int = 256,
                         residual: Optional[torch.Tensor] = None,
                         mean: bool = True
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Two-phase quantized all-reduce: :func:`quantized_reduce_scatter`,
    then the reduced chunk requantized and ``all_gather``-ed, so both
    phases move the payload; the reduction stays fp32.  Returns ``(out
    [N], new_residual or None)``.  Error feedback covers the reduce-scatter
    send only (the gather phase's requantization is not compensated)."""
    world = comm.group_size(group, world)
    shard, new_residual = quantized_reduce_scatter(
        x, group, world, wire_dtype=wire_dtype, group_size=group_size,
        residual=residual, mean=mean)
    m = shard.numel()
    payload, scale = _wire_encode(shard[None, :], wire_dtype, group_size)
    _log_wire("quant_all_gather", payload, scale, group)
    g = comm.all_gather(payload[0], 0, group)
    s = comm.all_gather(scale[0], 0, group).reshape(world, -1) \
        if scale is not None else None
    out = _wire_decode(g.reshape(world, m), s, wire_dtype)
    return out.reshape(-1), new_residual
