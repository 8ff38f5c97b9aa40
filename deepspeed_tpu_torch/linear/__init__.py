"""Optimized linear: quantized frozen base weights + LoRA adapters.

Port of ``deepspeed_tpu/linear/`` (analog of ``deepspeed/linear/``).

    from deepspeed_tpu_torch.linear import QuantizedParameter
    y = QuantizedParameter(w, q_bits=6).matmul(x)   # the FP6 GEMM kernel
"""

from deepspeed_tpu_torch.linear.config import LoRAConfig, QuantizationConfig
from deepspeed_tpu_torch.linear.quantization import QuantizedParameter
from deepspeed_tpu_torch.linear.optimized_linear import (OptimizedLinear,
                                                         init_lora_params,
                                                         lora_linear)

__all__ = ["LoRAConfig", "QuantizationConfig", "QuantizedParameter",
           "OptimizedLinear", "init_lora_params", "lora_linear"]
