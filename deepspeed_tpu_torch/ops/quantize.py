"""Blockwise symmetric int8/int4 quantize, dequantize and fake-quantize.

Port of ``deepspeed_tpu/ops/pallas/quantize.py`` (``quantize``,
``dequantize`` and ``fake_quantize``; Pallas bodies ``_quant_kernel``,
``_dequant_kernel`` and ``_fake_quant_kernel``).  On CUDA tensors each
function launches its hand-written Hopper kernel in
``ops/csrc/quantize.cu``; on CPU tensors the plain PyTorch versions below
compute the same numbers.  A CUDA call never falls back: the kernel builds
and launches, or the call raises.

Layout (the JAX function's): the tensor is viewed as ``[M, N]`` rows
(``_view_2d``) whose last axis splits into ``group_size``-wide groups, one
fp32 scale each, returned as ``x.shape[:-1] + (N // group_size,)``.  The
kernels serve what :func:`supports` accepts: symmetric, 4 or 8 bits, a
group that divides the last dim and is a whole number of the vectors the
kernels read (16 bytes of input: 4 fp32 or 8 bf16/fp16 elements; 4 bytes
of payload for ``dequantize``).  That is wider than the JAX kernel's rule
(a multiple of 128), so the whole-chunk groups of qgZ and any
``grad_reduce`` block of such a length launch the kernels on the card.
The caller (``ops/quantizer.py``) routes asymmetric calls to the ported
jnp arithmetic, as the JAX package does.

Arithmetic, shared by kernel and plain version so the two agree bit for
bit: the input is turned into fp32 first; ``scale = absmax / qmax`` (true
division), 1.0 where 0; ``q = clip(round(x / scale), -qmax - 1, qmax)``
with round-half-even; the dequantized value is ``q * scale`` in fp32,
rounded once to the output dtype.  ``dequantize`` writes the output dtype
directly: the same values as dequantizing to fp32 and casting after.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# launches of each kernel on CUDA tensors (never the plain versions)
launches = {"quantize": 0, "dequantize": 0, "fake_quantize": 0}


def vector_elems(dtype: torch.dtype) -> int:
    """Elements of one vector the kernels read: 16 bytes of a 16-bit input
    (8), of an fp32 input (4), or 4 bytes of an int8 payload (dequantize's
    loads)."""
    return 8 if dtype in (torch.bfloat16, torch.float16) else 4


def supports(shape: Tuple[int, ...], group_size: int, symmetric: bool,
             num_bits: int, dtype: torch.dtype = torch.float32) -> bool:
    """Whether the kernels can serve this call on ``dtype`` input (the
    int8 payload for ``dequantize``)."""
    if not symmetric or num_bits not in (4, 8):
        return False
    if len(shape) == 0 or group_size <= 0:  # <=0 means whole-tensor group
        return False
    n = shape[-1]
    return (n >= group_size and n % group_size == 0
            and group_size % vector_elems(dtype) == 0)


def _view_2d(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    shape = tuple(x.shape)
    return x.reshape(math.prod(shape[:-1]), shape[-1]), shape


def qmax_of(num_bits: int) -> float:
    return float(2 ** (num_bits - 1) - 1)


# ----------------------------------------------------------------------
# plain versions (CPU tensors; the card's reference in chip_smoke.py)
# ----------------------------------------------------------------------
def _round_trip_ref(x2: torch.Tensor, num_bits: int, group_size: int):
    """``(q fp32 [M, G, g], scale fp32 [M, G, 1])`` of an ``[M, N]`` view.
    qmax is a tensor on x's device so that ``absmax / qmax`` is a true
    division (PyTorch may multiply by the reciprocal of a host scalar)."""
    m, n = x2.shape
    g = x2.float().reshape(m, n // group_size, group_size)
    qmax = qmax_of(num_bits)
    absmax = torch.amax(torch.abs(g), dim=-1, keepdim=True)
    scale = absmax / torch.tensor(qmax, dtype=torch.float32, device=x2.device)
    scale = torch.where(scale == 0.0, 1.0, scale)
    q = torch.div(g, scale).round_().clamp_(-qmax - 1.0, qmax)
    return q, scale


def quantize_ref(x: torch.Tensor, num_bits: int = 8, group_size: int = 256):
    """Plain version of :func:`quantize`."""
    x2, shape = _view_2d(x)
    q, scale = _round_trip_ref(x2, num_bits, group_size)
    ng = shape[-1] // group_size
    return (q.to(torch.int8).reshape(shape),
            scale.reshape(shape[:-1] + (ng,)))


def dequantize_ref(q: torch.Tensor, scales: torch.Tensor,
                   dtype=torch.float32) -> torch.Tensor:
    """Plain version of :func:`dequantize`."""
    q2, shape = _view_2d(q)
    m, n = q2.shape
    ng = scales.shape[-1]
    out = q2.to(torch.float32).reshape(m, ng, n // ng).mul_(
        scales.reshape(m, ng, 1))
    return out.reshape(shape).to(dtype)


def fake_quantize_ref(x: torch.Tensor, num_bits: int = 8,
                      group_size: int = 256) -> torch.Tensor:
    """Plain version of :func:`fake_quantize`."""
    x2, shape = _view_2d(x)
    q, scale = _round_trip_ref(x2, num_bits, group_size)
    return (q * scale).reshape(shape).to(x.dtype)


# ----------------------------------------------------------------------
# kernel wrappers (CUDA tensors)
# ----------------------------------------------------------------------
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


def _lib():
    from deepspeed_tpu_torch.ops import op_builder

    lib = op_builder.load("quantize")
    if not getattr(lib, "_bound", False):
        lib.quantize.argtypes = [_I, _P, _P, _P, _L, _I, _I, _F, _P]
        lib.fake_quantize.argtypes = [_I, _P, _P, _L, _I, _I, _F, _P]
        lib.dequantize.argtypes = [_I, _P, _P, _P, _L, _I, _I, _P]
        for fn in (lib.quantize, lib.fake_quantize, lib.dequantize):
            fn.restype = _I
        lib._bound = True
    return lib


def _operand(x: torch.Tensor) -> torch.Tensor:
    """A contiguous, 16-byte aligned copy-if-needed of a kernel operand
    (the kernels read 4 elements a load)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _check(name: str, x: torch.Tensor, group_size: int, num_bits: int) -> None:
    if not supports(tuple(x.shape), group_size, True, num_bits, x.dtype):
        raise ValueError(
            f"{name}: shape {tuple(x.shape)}, {x.dtype}, group {group_size}, "
            f"{num_bits} bits is not served by the kernel (symmetric 4 or "
            "8 bits, a group that divides the last dim and holds whole "
            f"vectors of {vector_elems(x.dtype)} elements)")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")


def _check_float(name: str, x: torch.Tensor) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: the kernel takes fp32, bf16 or fp16, got "
                        f"{x.dtype}")


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def quantize(x: torch.Tensor, num_bits: int = 8,
             group_size: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric blockwise quantize; returns ``(q_int8, scales)`` with
    ``scales.shape == x.shape[:-1] + (n // group_size,)``."""
    _check("quantize", x, group_size, num_bits)
    if x.device.type == "cpu":
        return quantize_ref(x, num_bits, group_size)
    _check_float("quantize", x)
    x2, shape = _view_2d(_operand(x))
    m, n = x2.shape
    ng = n // group_size
    q = torch.empty((m, n), dtype=torch.int8, device=x.device)
    s = torch.empty((m, ng), dtype=torch.float32, device=x.device)
    err = _lib().quantize(_DTYPE_CODE[x.dtype], x2.data_ptr(), q.data_ptr(),
                          s.data_ptr(), m, n, group_size, qmax_of(num_bits),
                          _stream(x))
    _raise_on(err, "quantize")
    launches["quantize"] += 1
    return q.reshape(shape), s.reshape(shape[:-1] + (ng,))


def dequantize(q: torch.Tensor, scales: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize`: ``q * scale`` in ``dtype``."""
    ng = scales.shape[-1]
    group_size = q.shape[-1] // ng if ng else 0
    _check("dequantize", q, group_size, 8)
    if tuple(scales.shape) != tuple(q.shape[:-1]) + (ng,):
        raise ValueError(f"dequantize: scales {tuple(scales.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if q.device.type == "cpu":
        return dequantize_ref(q, scales, dtype)
    if q.dtype != torch.int8 or scales.dtype != torch.float32 \
            or scales.device != q.device or dtype not in _DTYPE_CODE:
        raise TypeError("dequantize: the kernel takes an int8 payload and "
                        "fp32 scales on one device, and writes fp32, bf16 "
                        "or fp16")
    q2, shape = _view_2d(_operand(q))
    s2 = scales.reshape(q2.shape[0], ng).contiguous()
    out = torch.empty(q2.shape, dtype=dtype, device=q.device)
    err = _lib().dequantize(_DTYPE_CODE[dtype], q2.data_ptr(), s2.data_ptr(),
                            out.data_ptr(), q2.shape[0], q2.shape[1],
                            group_size, _stream(q))
    _raise_on(err, "dequantize")
    launches["dequantize"] += 1
    return out.reshape(shape)


def fake_quantize(x: torch.Tensor, num_bits: int = 8,
                  group_size: int = 256) -> torch.Tensor:
    """Quantize-dequantize round trip (QAT) in one pass: the int8 payload
    is never written."""
    _check("fake_quantize", x, group_size, num_bits)
    if x.device.type == "cpu":
        return fake_quantize_ref(x, num_bits, group_size)
    _check_float("fake_quantize", x)
    x2, shape = _view_2d(_operand(x))
    out = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    err = _lib().fake_quantize(_DTYPE_CODE[x.dtype], x2.data_ptr(),
                               out.data_ptr(), x2.shape[0], x2.shape[1],
                               group_size, qmax_of(num_bits), _stream(x))
    _raise_on(err, "fake_quantize")
    launches["fake_quantize"] += 1
    return out.reshape(shape)
