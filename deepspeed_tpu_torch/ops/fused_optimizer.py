"""Fused multi-tensor AdamW and Lion steps.

Port of ``deepspeed_tpu/ops/pallas/fused_optimizer.py`` (``fused_adamw_leaf``
and ``fused_lion_leaf``, Pallas bodies ``_adamw_kernel`` and
``_lion_kernel``).  On CUDA tensors one launch of the hand-written kernel
in ``ops/csrc/fused_adamw.cu`` or ``ops/csrc/fused_lion.cu`` steps every
fp32 leaf of the tree, reading a device table of leaf pointers and sizes
(the role of the reference's ``csrc/adam/multi_tensor_adam.cu`` and
``csrc/lion/``); on CPU tensors :func:`adamw_leaf_ref` and
:func:`lion_leaf_ref`, the plain PyTorch versions, step each leaf with the
same operations in the same order.  A CUDA call never falls back.

The JAX kernels serve only leaves whose last dim is a whole number of
128-lane vectors (``supports``); the multi-tensor kernels serve every fp32
leaf, with the same numbers.

Each step is rounded to fp32, with no fused multiply-add, so kernel and
plain version agree bit for bit on the card.  AdamW, in this order:
``m = b1·m + (1−b1)·g``; ``v = b2·v + (1−b2)·g·g``;
``u = (m/bc1)/(sqrt(v/bc2)+eps)``; ``u += wd·p``; ``p = p − lr·u``, with
``bc1 = 1 − b1**t`` and ``bc2 = 1 − b2**t`` in fp32 from ``t = count + 1``.
Lion: ``u = sign(b1·m + (1−b1)·g)``; ``u += wd·p``; ``p = p − lr·u``;
``m = b2·m + (1−b2)·g`` (sign as ``jnp.sign``: ±1, with 0 and NaN kept).
Updates are in place (p and the moments), where the JAX kernels alias
their outputs onto their inputs.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

# elements of one leaf stepped by one thread block
CHUNK = 1 << 16


def bias_corrections(count: int, b1: float, b2: float) -> Tuple[float, float]:
    """``(1 - b1**t, 1 - b2**t)`` in fp32 with ``t = count + 1`` (the step
    count before this step's increment), as ``fused_adamw_leaf`` forms
    them."""
    t = torch.tensor(float(count + 1), dtype=torch.float32)
    one = torch.tensor(1.0, dtype=torch.float32)
    bc1 = one - torch.tensor(b1, dtype=torch.float32) ** t
    bc2 = one - torch.tensor(b2, dtype=torch.float32) ** t
    return float(bc1), float(bc2)


def adamw_leaf_ref(p, g, m, v, lr: float, bc1: float, bc2: float, b1: float,
                   b2: float, eps: float, wd: float) -> None:
    """Plain version of the kernel on one fp32 leaf, in place.  The bias
    corrections are 0-dim tensors on the leaf's device so that the
    divisions are true divisions (a division by a host scalar may be turned
    into a multiplication by its reciprocal)."""
    dev = p.device
    bc1_t = torch.tensor(bc1, dtype=torch.float32, device=dev)
    bc2_t = torch.tensor(bc2, dtype=torch.float32, device=dev)
    gf = g.float()
    # each op rounds once, in the kernel's order; in place where a
    # temporary would only be copied back
    m.mul_(b1).add_(torch.mul(gf, 1.0 - b1))
    v.mul_(b2).add_(torch.mul(gf, 1.0 - b2).mul_(gf))
    u = torch.div(m, bc1_t).div_(torch.div(v, bc2_t).sqrt_().add_(eps))
    if wd:
        u.add_(torch.mul(p, wd))
    p.sub_(u.mul_(lr))


def lion_leaf_ref(p, g, m, lr: float, b1: float, b2: float, wd: float) -> None:
    """Plain version of the Lion kernel on one fp32 leaf, in place; the
    sign keeps 0 and NaN as ``jnp.sign`` does (``torch.sign`` maps NaN to
    0)."""
    gf = g.float()
    c = torch.add(torch.mul(m, b1), torch.mul(gf, 1.0 - b1))
    u = torch.where(c > 0, 1.0, torch.where(c < 0, -1.0, c))
    if wd:
        u = torch.add(u, torch.mul(p, wd))
    p.copy_(torch.sub(p, torch.mul(u, lr)))
    m.copy_(torch.add(torch.mul(m, b2), torch.mul(gf, 1.0 - b2)))


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {"fused_adamw": [_P, _P, _I] + [_F] * 9 + [_P],
             "fused_lion": [_P, _P, _I] + [_F] * 6 + [_P]}


def _kernel(name: str):
    """The entry point ``name`` of the library of the same name."""
    from deepspeed_tpu_torch.ops import op_builder

    fn = getattr(op_builder.load(name), name)
    if not getattr(fn, "_bound", False):
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _I
        fn._bound = True
    return fn


class LeafTable:
    """The device tables of one set of fp32 leaves: per leaf the pointers
    of its tensors (p, g, then the moments) and its size, and per thread
    block (leaf, first element).  Built once for a set of tensors and
    rebuilt only when a pointer moves (the engine updates its leaves and
    gradients in place)."""

    def __init__(self):
        self._key = None
        self.leaves = None
        self.chunks = None
        self.n_chunks = 0

    def update(self, *groups: Sequence[torch.Tensor]) -> None:
        key = tuple(t.data_ptr() for group in groups for t in group)
        if key == self._key:
            return
        dev = groups[0][0].device
        rows, chunks = [], []
        for i, leaf in enumerate(zip(*groups)):
            n = leaf[0].numel()
            rows.append([t.data_ptr() for t in leaf] + [n])
            chunks += [[i, start] for start in range(0, n, CHUNK)]
        self.leaves = torch.tensor(rows, dtype=torch.int64).to(dev)
        self.chunks = torch.tensor(chunks, dtype=torch.int64).to(dev)
        self.n_chunks = len(chunks)
        self._key = key


def _check(name: str, *groups: Sequence[torch.Tensor]) -> torch.device:
    """The groups' common device, after checking what the kernels take."""
    if len({len(group) for group in groups}) != 1 or not groups[0]:
        raise ValueError(f"{name}: the p, g and moment lists must match and "
                         "be non-empty")
    dev = groups[0][0].device
    for group in groups:
        for t in group:
            if t.dtype != torch.float32 or t.device != dev \
                    or not t.is_contiguous():
                raise TypeError(f"{name}: the kernel takes contiguous fp32 "
                                "tensors on one device")
    for leaf in zip(*groups):
        if len({t.shape for t in leaf}) != 1:
            raise ValueError(f"{name}: leaf shapes differ "
                             f"{[tuple(t.shape) for t in leaf]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev


def _launch(name: str, table: LeafTable, dev, *hyper: float) -> None:
    err = _kernel(name)(table.leaves.data_ptr(), table.chunks.data_ptr(),
                        table.n_chunks, *hyper,
                        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def fused_adamw(ps: List[torch.Tensor], gs: List[torch.Tensor],
                ms: List[torch.Tensor], vs: List[torch.Tensor], lr: float,
                count: int, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8, wd: float = 0.01,
                table: LeafTable = None) -> None:
    """One AdamW step over fp32 leaves, in place.  ``count`` is the step
    counter before this step (so ``t = count + 1``).  CPU tensors take the
    plain version leaf by leaf; CUDA tensors one launch of the multi-tensor
    kernel, counted in ``fused_adamw.launches``."""
    dev = _check("fused_adamw", ps, gs, ms, vs)
    bc1, bc2 = bias_corrections(count, b1, b2)
    if dev.type == "cpu":
        for p, g, m, v in zip(ps, gs, ms, vs):
            adamw_leaf_ref(p, g, m, v, lr, bc1, bc2, b1, b2, eps, wd)
        return
    table = table or LeafTable()
    table.update(ps, gs, ms, vs)
    _launch("fused_adamw", table, dev, float(lr), bc1, bc2, float(b1),
            1.0 - b1, float(b2), 1.0 - b2, float(eps), float(wd))
    fused_adamw.launches["fused_adamw"] += 1


fused_adamw.launches = {"fused_adamw": 0}


def fused_lion(ps: List[torch.Tensor], gs: List[torch.Tensor],
               ms: List[torch.Tensor], lr: float, b1: float = 0.9,
               b2: float = 0.99, wd: float = 0.0,
               table: LeafTable = None) -> None:
    """One Lion step over fp32 leaves, in place.  CPU tensors take the
    plain version leaf by leaf; CUDA tensors one launch of the multi-tensor
    kernel, counted in ``fused_lion.launches``."""
    dev = _check("fused_lion", ps, gs, ms)
    if dev.type == "cpu":
        for p, g, m in zip(ps, gs, ms):
            lion_leaf_ref(p, g, m, lr, b1, b2, wd)
        return
    table = table or LeafTable()
    table.update(ps, gs, ms)
    _launch("fused_lion", table, dev, float(lr), float(b1), 1.0 - b1,
            float(b2), 1.0 - b2, float(wd))
    fused_lion.launches["fused_lion"] += 1


fused_lion.launches = {"fused_lion": 0}
