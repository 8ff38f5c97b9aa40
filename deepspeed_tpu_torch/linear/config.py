"""LoRA and quantization configs (ref ``deepspeed/linear/config.py``).

From ``deepspeed_tpu/linear/config.py``, less the fields nothing reads."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class LoRAConfig:
    """Rank and alpha of the adapter.  ``delay_lora_init``: the layer makes
    no adapter of its own, the caller passes one per call.  The JAX
    config's ``base_weight_sharding``, ``offload`` and ``offload_ratio``
    are not here: nothing reads them there either, and the port's base
    weight lives whole on one device."""
    lora_r: int = 64
    lora_alpha: float = 16.0
    delay_lora_init: bool = False


@dataclass
class QuantizationConfig:
    """Quantized frozen base weights: ``q_bits`` 8 (int8), 4 (packed
    int4) or 6 (packed FP6 e3m2, whose 2 mantissa bits are fixed; the JAX
    config's unread ``mantissa_bits`` is not here)."""
    q_bits: int = 8
    group_size: int = 512
