"""QuantizedParameter — a frozen weight in quantized storage.

Port of ``deepspeed_tpu/linear/quantization.py`` (analog of
``deepspeed/linear/quantization.py`` ``QuantizedParameter``): the weight is
stored as int8, packed int4 or packed FP6 (e3m2) with its scales, as
buffers of a module (so ``.to(device)`` and ``state_dict`` carry them and
no optimizer ever sees them).  q_bits 8 and 4 quantize through the
blockwise kernels (``ops/quantizer.py``) and dequantize before the product;
q_bits 6 multiplies through the FP6 GEMM kernel (``ops/fp6_linear.py``),
which reads only the packed bytes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.fp6_linear import (fp6_dequantize, fp6_matmul,
                                                fp6_quantize)
from deepspeed_tpu_torch.ops.quantizer import (dequantize_blockwise,
                                               pack_int4, quantize_blockwise,
                                               unpack_int4)


class _FP6MatMul(torch.autograd.Function):
    """``x @ W`` through the FP6 GEMM kernel, the JAX custom VJP's torch
    form: the packed weight is frozen (no gradient), and dx = g @ Wᵀ flows
    to the layers below, the backward dequantizing with plain ops (LoRA
    training is not the bandwidth-bound serving case the packed read
    exists for)."""

    @staticmethod
    def forward(ctx, x, packed, scale):
        ctx.save_for_backward(packed, scale)
        return fp6_matmul(x, packed, scale)

    @staticmethod
    def backward(ctx, g):
        packed, scale = ctx.saved_tensors
        w = fp6_dequantize(packed, scale, g.dtype)
        return g @ w.T, None, None


class QuantizedParameter(torch.nn.Module):
    """Quantize once at construction; ``dequantized()`` per forward.

    q_bits 8 → int8 storage; 4 → two nibbles per byte; 6 → FP6 e3m2 plane
    packing (2-D weights, per-output-column scales; ``matmul`` runs the
    packed-read GEMM kernel).  Int grouping is along the last dim
    (``group_size`` shrunk to a divisor of it).  Buffers: ``data``,
    ``scale`` and, for asymmetric storage, ``zero``."""

    def __init__(self, weight: torch.Tensor, q_bits: int = 8,
                 group_size: int = 512):
        super().__init__()
        weight = weight.detach()
        self._describe(q_bits, tuple(weight.shape), weight.dtype)
        if q_bits == 6:
            if len(self.shape) != 2:
                raise ValueError("q_bits=6 (FP6 packed) needs a 2-D "
                                 f"weight, got shape {self.shape}")
            data, scale = fp6_quantize(weight)
            self._store(data, scale, None, self.shape[0])  # per-column scale
            return
        n = self.shape[-1]
        group_size = min(group_size, n)
        while n % group_size != 0:  # shrink to a divisor of the last dim
            group_size -= 1
        q, scale, zero = quantize_blockwise(weight, num_bits=q_bits,
                                            group_size=group_size)
        self._store(pack_int4(q) if q_bits == 4 else q, scale, zero,
                    group_size)

    def _describe(self, q_bits: int, shape: Tuple[int, ...],
                  dtype: torch.dtype) -> None:
        if q_bits not in (4, 6, 8):
            raise ValueError(f"q_bits must be 4, 6, or 8, got {q_bits}")
        self.q_bits, self.shape, self.dtype = q_bits, shape, dtype

    def _store(self, data, scale, zero, group_size: int) -> None:
        self.group_size = group_size
        self.register_buffer("data", data)
        self.register_buffer("scale", scale)
        self.register_buffer("zero", zero)

    @classmethod
    def from_fields(cls, data: torch.Tensor, scale: torch.Tensor,
                    zero: Optional[torch.Tensor], q_bits: int,
                    shape: Tuple[int, ...], dtype: torch.dtype,
                    group_size: int) -> "QuantizedParameter":
        """An already quantized weight (for example a JAX
        ``QuantizedParameter`` carried over by ``models.bridge``), kept as
        it is: nothing is quantized again."""
        qp = cls.__new__(cls)
        torch.nn.Module.__init__(qp)
        qp._describe(q_bits, tuple(shape), dtype)
        qp._store(data, scale, zero, group_size)
        return qp

    def dequantized(self) -> torch.Tensor:
        """The weight in its original dtype.  Int storage dequantizes
        straight to that dtype (the same values as through fp32)."""
        if self.q_bits == 6:
            return fp6_dequantize(self.data, self.scale, self.dtype)
        q = unpack_int4(self.data) if self.q_bits == 4 else self.data
        return dequantize_blockwise(q, self.scale, self.zero,
                                    num_bits=self.q_bits, dtype=self.dtype)

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ W``: the packed-read GEMM for FP6, dequantize-then-dot
        otherwise."""
        if self.q_bits != 6:
            return x @ self.dequantized()
        return _FP6MatMul.apply(x, self.data, self.scale)

    @property
    def nbytes(self) -> int:
        return (self.data.numel() * self.data.element_size()
                + self.scale.numel() * self.scale.element_size())
