"""Parameter bridge between the JAX package's param tree and the port's.

Both trees share key paths, the ``[in, out]`` kernel layout and the
stacked per-layer leaves, so the bridge is an identity copy through numpy:
``params_from_jax(jax.tree.map(np.asarray, jax_params), cfg)`` gives the
port's tree bit for bit.  A duck-typed trainable's tree (LoRA adapters,
say) goes through ``params_from_jax(tree, None)`` as it is.  A JAX
``linear.QuantizedParameter`` comes across by its fields
(:func:`quantized_from_jax`), without quantizing again.  The port never
imports JAX; the caller converts its arrays to numpy first.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.models.transformer import (Params,
                                                    TransformerConfig,
                                                    is_norm_path,
                                                    tree_map_with_path)
from deepspeed_tpu_torch.utils.device import resolve_device


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr, order="C")  # a writable copy: JAX's views are not
    if arr.dtype.name == "bfloat16":
        # numpy has no native bfloat16 (JAX hands out ml_dtypes arrays):
        # move the bit pattern and reinterpret it
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _check_shapes(tree: Params, cfg: TransformerConfig) -> None:
    tok = tree["embed"]["tokens"]
    if tuple(tok.shape) != (cfg.vocab_size, cfg.hidden_size):
        raise ValueError(f"embed/tokens shape {tuple(tok.shape)} does not "
                         f"match the config's ({cfg.vocab_size}, "
                         f"{cfg.hidden_size})")

    def layer_dim(path, leaf):
        if leaf.shape[0] != cfg.num_layers:
            raise ValueError(f"layers/{'/'.join(path)} has leading dim "
                             f"{leaf.shape[0]}, config has "
                             f"{cfg.num_layers} layers")

    tree_map_with_path(layer_dim, tree["layers"])


def params_from_jax(tree, cfg: Optional[TransformerConfig], device=None,
                    dtype: Optional[torch.dtype] = None) -> Params:
    """The JAX param tree (leaves as numpy arrays) as the port's tree on
    ``device`` (``None`` → CUDA).  ``dtype=None`` copies bit for bit;
    otherwise leaves are cast once to ``dtype`` as an engine does at load,
    norm leaves excepted (the forward casts those at use).  ``cfg=None``:
    a duck-typed trainable's tree, whose shapes are not checked."""
    if cfg is not None:
        _check_shapes(tree, cfg)
    dev = resolve_device(device)

    def conv(path, leaf):
        t = _to_tensor(np.asarray(leaf)).to(dev)
        if dtype is not None and not is_norm_path(path):
            t = t.to(dtype)
        return t

    return tree_map_with_path(conv, tree)


def params_to_numpy(params: Params):
    """The port's tree as numpy arrays (same paths).  bfloat16 leaves
    widen to float32, which holds every bfloat16 value exactly."""

    def conv(_path, t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return tree_map_with_path(conv, params)


_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def quantized_from_jax(data: np.ndarray, scale: np.ndarray,
                       zero: Optional[np.ndarray], q_bits: int,
                       shape: Sequence[int], dtype, group_size: int,
                       device=None):
    """A JAX ``linear.QuantizedParameter``'s fields (arrays as numpy;
    ``dtype`` a numpy dtype or its name) as the port's
    ``QuantizedParameter`` on ``device`` (``None`` → CUDA), with the same
    bytes: nothing is quantized again."""
    from deepspeed_tpu_torch.linear.quantization import QuantizedParameter

    dev = resolve_device(device)
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    return QuantizedParameter.from_fields(
        _to_tensor(data).to(dev), _to_tensor(scale).to(dev),
        None if zero is None else _to_tensor(zero).to(dev), int(q_bits),
        tuple(int(d) for d in shape), _TORCH_DTYPES[name], int(group_size))
