"""FP6 (e3m2) packed-weight linear: 6-bit storage and a GEMM that reads
only the packed bytes.

Port of ``deepspeed_tpu/ops/pallas/fp6_linear.py`` (``fp6_quantize``,
``fp6_dequantize``, ``fp6_matmul``; Pallas body ``_mm_kernel``).  A
``[K, N]`` weight is stored as three byte planes ``packed[3, K/4, N]``
(four 6-bit codes v0..v3 of K rows 4r..4r+3 in three bytes)::

    B0 = v0<<2 | v1>>4;  B1 = (v1&15)<<4 | v2>>2;  B2 = (v2&3)<<6 | v3

plus one fp32 scale per output column.  e3m2: 1 sign, 3 exponent bits
(bias 3, no inf/nan codes), 2 mantissa bits; largest value 28, subnormal
step 2^-4.

On CUDA tensors :func:`fp6_matmul` launches the hand-written Hopper kernel
of ``ops/csrc/fp6_linear.cu`` for any M and N (tails are masked in the
kernel); only ``K % 4 != 0`` raises, as packing does.  There is no
dequantize-then-dot path on the card: the JAX fallbacks exist for the
TPU's tiling and for running off the TPU.  On CPU tensors the plain
version :func:`fp6_matmul_ref` computes the kernel's function.

:func:`fp6_quantize` gives codes bit-equal to the JAX package's (the same
nearest-value search over the stably sorted table, ties to the lower
neighbour, the same plane packing) and runs in torch on the weight's
device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

_BIAS = 3
_MAX_VAL = 28.0  # (2 - 2^-2) * 2^(7-3): full exponent range, no inf/nan
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _decode_table() -> np.ndarray:
    """All 64 e3m2 code values (index = 6-bit code)."""
    codes = np.arange(64)
    s = codes >> 5
    e = (codes >> 2) & 7
    m = (codes & 3).astype(np.float64)
    mag = np.where(e == 0, m * 2.0 ** (1 - _BIAS - 2),
                   (1.0 + m * 0.25) * 2.0 ** (e - _BIAS))
    return np.where(s == 1, -mag, mag).astype(np.float32)


DECODE_TABLE = _decode_table()
# the table stably sorted: code 0 (+0) stays before code 32 (-0)
_ORDER = np.argsort(DECODE_TABLE, kind="stable")
_SORTED = DECODE_TABLE[_ORDER]


def fp6_quantize(w):
    """``[K, N]`` weight → ``(packed uint8 [3, K/4, N], scale fp32 [N])`` on
    the weight's device.

    Per-output-column absmax scaling, nearest-representable e3m2 encoding
    (ties to the lower neighbour), plane packing."""
    w = torch.as_tensor(w)
    dev = w.device
    w = w.float()
    if w.dim() != 2:
        raise ValueError(f"fp6_quantize takes a 2-D [K, N] weight, got "
                         f"shape {tuple(w.shape)}")
    k, n = w.shape
    if k % 4:
        raise ValueError(f"K={k} must be divisible by 4 for fp6 packing")
    # 0-dim device tensors: true divisions (a host scalar divisor may become
    # a multiplication by its reciprocal)
    max_val = torch.tensor(_MAX_VAL, dtype=torch.float32, device=dev)
    scale = torch.clamp(torch.amax(torch.abs(w), dim=0), min=1e-12) / max_val
    ws = w / scale[None, :]
    tbl = torch.from_numpy(_SORTED).to(dev)
    order = torch.from_numpy(_ORDER).to(dev)
    pos = torch.searchsorted(tbl, ws).clamp_(1, 63)
    hi_pos = torch.clamp(pos, max=63)
    lo, hi = tbl[pos - 1], tbl[hi_pos]
    pick_hi = (ws - lo) > (hi - ws)
    del ws, lo, hi
    codes = order[torch.where(pick_hi, hi_pos, pos - 1)].to(torch.uint8)
    del pos, hi_pos, pick_hi
    v = codes.reshape(k // 4, 4, n)
    v0, v1, v2, v3 = v[:, 0], v[:, 1], v[:, 2], v[:, 3]
    packed = torch.stack([
        (v0 << 2) | (v1 >> 4),
        ((v1 & 15) << 4) | (v2 >> 2),
        ((v2 & 3) << 6) | v3,
    ])                                                   # [3, K/4, N]
    return packed, scale


def _unpack_codes(packed: torch.Tensor):
    """``[3, K/4, N]`` planes → the 4 code planes v0..v3 (int32 [K/4, N])."""
    b0, b1, b2 = (packed[i].to(torch.int32) for i in range(3))
    v0 = b0 >> 2
    v1 = ((b0 & 3) << 4) | (b1 >> 4)
    v2 = ((b1 & 15) << 2) | (b2 >> 6)
    v3 = b2 & 63
    return v0, v1, v2, v3


def _decode(v: torch.Tensor) -> torch.Tensor:
    """e3m2 code plane → fp32 values (a gather from the exact table)."""
    return torch.from_numpy(DECODE_TABLE).to(v.device)[v.long()]


def _decoded(packed: torch.Tensor) -> torch.Tensor:
    """The unscaled ``[K, N]`` fp32 weight: row 4r + p holds plane p of
    packed row r."""
    k4, n = packed.shape[1], packed.shape[2]
    planes = [_decode(v) for v in _unpack_codes(packed)]
    return torch.stack(planes, dim=1).reshape(k4 * 4, n)


def fp6_dequantize(packed: torch.Tensor, scale: torch.Tensor,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """Full dequantized ``[K, N]`` weight."""
    return (_decoded(packed) * scale[None, :]).to(dtype)


# ----------------------------------------------------------------------
# the GEMM: plain version and kernel wrapper
# ----------------------------------------------------------------------
def _check(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> None:
    if packed.dim() != 3 or packed.shape[0] != 3 or packed.dtype != torch.uint8:
        raise ValueError(f"packed must be uint8 [3, K/4, N], got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    k = x.shape[-1]
    if k % 4:
        raise ValueError(f"K={k} must be divisible by 4 for fp6 packing")
    if packed.shape[1] * 4 != k:
        raise ValueError(f"packed K {packed.shape[1] * 4} != x K {k}")
    if tuple(scale.shape) != (packed.shape[2],):
        raise ValueError(f"scale {tuple(scale.shape)} does not match N "
                         f"{packed.shape[2]}")


def fp6_matmul_ref(x: torch.Tensor, packed: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`fp6_matmul`: ``cast_x(scale · (x @
    decode(codes)))`` with the products in fp32 (e3m2 values are exact in
    x's type, so this is the kernel's sum in another order)."""
    _check(x, packed, scale)
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, x.shape[-1]).float()
    out = (x2 @ _decoded(packed)) * scale.float()[None, :]
    return out.to(x.dtype).reshape(lead + (packed.shape[2],))


_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    from deepspeed_tpu_torch.ops import op_builder

    lib = op_builder.load("fp6_linear")
    if not getattr(lib, "_bound", False):
        lib.fp6_matmul.argtypes = [_I, _P, _P, _P, _P, _I, _I, _I, _P]
        lib.fp6_matmul.restype = _I
        lib._bound = True
    return lib


def fp6_matmul(x: torch.Tensor, packed: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ fp6_weight [K, N]`` reading only the packed bytes;
    the output has x's dtype and leading shape.  CPU tensors take the plain
    version, CUDA tensors the kernel (counted in ``fp6_matmul.launches``)."""
    if x.device.type == "cpu":
        return fp6_matmul_ref(x, packed, scale)
    _check(x, packed, scale)
    if x.device.type != "cuda":
        raise ValueError(f"fp6_matmul: no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fp6_matmul: the kernel takes fp32, bf16 or fp16 "
                        f"activations, got {x.dtype}")
    if packed.device != x.device or scale.device != x.device \
            or scale.dtype != torch.float32:
        raise TypeError("fp6_matmul: packed and fp32 scale must be on x's "
                        "device")
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    packed, scale = packed.contiguous(), scale.contiguous()
    m, k = x2.shape
    n = packed.shape[2]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = _lib().fp6_matmul(_DTYPE_CODE[x.dtype], x2.data_ptr(),
                            packed.data_ptr(), scale.data_ptr(),
                            out.data_ptr(), m, n, k,
                            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"fp6_matmul kernel launch failed: CUDA error {err}")
    fp6_matmul.launches["fp6_matmul"] += 1
    return out.reshape(lead + (n,))


fp6_matmul.launches = {"fp6_matmul": 0}
