"""OptimizedLinear — a quantized frozen base weight + a trainable LoRA adapter.

Port of ``deepspeed_tpu/linear/optimized_linear.py`` (analog of
``deepspeed/linear/optimized_linear.py`` ``OptimizedLinear`` and
``LoRAOptimizedLinear``).  The base weight is ``[in, out]`` (``x @ W``, the
JAX layout) and frozen: a buffer (or a :class:`QuantizedParameter` of
buffers), never a parameter.  :func:`lora_linear` is the forward, with the
JAX cast order; the adapter may be passed per call, as the JAX
``__call__(x, lora_A, lora_B)`` takes it, so a functional trainable can
keep its adapters in its own param tree.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from deepspeed_tpu_torch.linear.config import LoRAConfig, QuantizationConfig
from deepspeed_tpu_torch.linear.quantization import QuantizedParameter


def init_lora_params(generator: Optional[torch.Generator], in_dim: int,
                     out_dim: int, lora_config: Optional[LoRAConfig] = None,
                     dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """A ~ kaiming-uniform, B = 0 (the standard LoRA init; ref
    LoRAOptimizedLinear.init_lora), on the generator's device (the JAX
    version takes a PRNG key)."""
    lc = lora_config or LoRAConfig()
    device = generator.device if generator is not None else "cpu"
    bound = math.sqrt(6.0 / in_dim)
    a = torch.rand((in_dim, lc.lora_r), generator=generator, device=device,
                   dtype=torch.float32) * (2 * bound) - bound
    b = torch.zeros((lc.lora_r, out_dim), dtype=dtype, device=device)
    return {"lora_A": a.to(dtype), "lora_B": b}


def lora_linear(x, base, lora_A=None, lora_B=None,
                lora_alpha: float = 16.0, lora_r: Optional[int] = None,
                bias=None):
    """y = x @ W_base (frozen) + (alpha/r) * (x @ A) @ B.

    FP6 bases (q_bits 6) go through :meth:`QuantizedParameter.matmul`, the
    packed-read GEMM kernel, whose backward still passes dx to the layers
    below; int bases dequantize first (the dequantize kernel), then a
    plain product."""
    if isinstance(base, QuantizedParameter) and base.q_bits == 6:
        y = base.matmul(x)
    else:
        w = (base.dequantized() if isinstance(base, QuantizedParameter)
             else base)
        y = x @ w.detach().to(x.dtype)
    if lora_A is not None and lora_B is not None:
        r = lora_r or lora_A.shape[-1]
        scale = lora_alpha / r
        y = y + scale * ((x @ lora_A.to(x.dtype)) @ lora_B.to(x.dtype))
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


class OptimizedLinear(torch.nn.Module):
    """Quantizes the base when a :class:`QuantizationConfig` is given and
    attaches a LoRA adapter when a :class:`LoRAConfig` is given (unless
    ``delay_lora_init``), as the reference's ``OptimizedLinear.__new__``
    dispatch does."""

    def __init__(self, weight: torch.Tensor,
                 lora_config: Optional[LoRAConfig] = None,
                 quantization_config: Optional[QuantizationConfig] = None,
                 bias: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lora_config = lora_config
        weight = weight.detach()
        if quantization_config is not None:
            self.base = QuantizedParameter(
                weight, q_bits=quantization_config.q_bits,
                group_size=quantization_config.group_size)
        else:
            self.register_buffer("base", weight)
        self.register_buffer("bias", None if bias is None else bias.detach())
        self.lora_A = self.lora_B = None
        if lora_config is not None and not lora_config.delay_lora_init:
            if generator is None:
                generator = torch.Generator(device=weight.device).manual_seed(0)
            p = init_lora_params(generator, weight.shape[-2],
                                 weight.shape[-1], lora_config,
                                 dtype=weight.dtype)
            self.lora_A = torch.nn.Parameter(p["lora_A"])
            self.lora_B = torch.nn.Parameter(p["lora_B"])

    def trainable_params(self) -> Dict[str, torch.Tensor]:
        if self.lora_A is None:
            return {}
        return {"lora_A": self.lora_A, "lora_B": self.lora_B}

    def forward(self, x, lora_A=None, lora_B=None):
        lc = self.lora_config or LoRAConfig()
        return lora_linear(x, self.base,
                           lora_A if lora_A is not None else self.lora_A,
                           lora_B if lora_B is not None else self.lora_B,
                           lora_alpha=lc.lora_alpha, lora_r=lc.lora_r,
                           bias=self.bias)
