"""Fused multi-tensor AdamW step.

Port of ``deepspeed_tpu/ops/pallas/fused_optimizer.py`` (``fused_adamw_leaf``,
Pallas body ``_adamw_kernel``).  On CUDA tensors one launch of the
hand-written kernel in ``ops/csrc/fused_adamw.cu`` steps every fp32 leaf
of the tree, reading a device table of leaf pointers and sizes (the role
of the reference's ``csrc/adam/multi_tensor_adam.cu``); on CPU tensors
:func:`adamw_leaf_ref`, the plain PyTorch version, steps each leaf with
the same operations in the same order.  A CUDA call never falls back.

The JAX kernel serves only leaves whose last dim is a whole number of
128-lane vectors (``supports``); the multi-tensor kernel serves every fp32
leaf, with the same numbers.

The update, in this order (each step rounded to fp32, no fused
multiply-add, so kernel and plain version agree bit for bit on the card):
``m = b1·m + (1−b1)·g``; ``v = b2·v + (1−b2)·g·g``;
``u = (m/bc1)/(sqrt(v/bc2)+eps)``; ``u += wd·p``; ``p = p − lr·u``, with
``bc1 = 1 − b1**t`` and ``bc2 = 1 − b2**t`` in fp32 from ``t = count + 1``.
Updates are in place (p, m, v), where the JAX kernel aliases its outputs
onto its inputs.
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
    m.copy_(torch.add(torch.mul(m, b1), torch.mul(gf, 1.0 - b1)))
    v.copy_(torch.add(torch.mul(v, b2), torch.mul(torch.mul(gf, 1.0 - b2), gf)))
    u = torch.div(torch.div(m, bc1_t),
                  torch.add(torch.sqrt(torch.div(v, bc2_t)), eps))
    if wd:
        u = torch.add(u, torch.mul(p, wd))
    p.copy_(torch.sub(p, torch.mul(u, lr)))


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib():
    from deepspeed_tpu_torch.ops import op_builder

    lib = op_builder.load("fused_adamw")
    if not getattr(lib, "_bound", False):
        lib.fused_adamw.argtypes = [_P, _P, _I] + [_F] * 9 + [_P]
        lib.fused_adamw.restype = _I
        lib._bound = True
    return lib


class AdamWTable:
    """The device tables of one set of fp32 leaves: per leaf the p, g, m,
    v pointers and its size, and per thread block (leaf, first element).
    Built once for a set of tensors and rebuilt only when a pointer moves
    (the engine updates its leaves and gradients in place)."""

    def __init__(self):
        self._key = None
        self.leaves = None
        self.chunks = None
        self.n_chunks = 0

    def update(self, ps, gs, ms, vs) -> None:
        key = tuple(t.data_ptr() for group in (ps, gs, ms, vs) for t in group)
        if key == self._key:
            return
        dev = ps[0].device
        rows, chunks = [], []
        for i, (p, g, m, v) in enumerate(zip(ps, gs, ms, vs)):
            n = p.numel()
            rows.append([p.data_ptr(), g.data_ptr(), m.data_ptr(),
                         v.data_ptr(), n])
            chunks += [[i, start] for start in range(0, n, CHUNK)]
        self.leaves = torch.tensor(rows, dtype=torch.int64).to(dev)
        self.chunks = torch.tensor(chunks, dtype=torch.int64).to(dev)
        self.n_chunks = len(chunks)
        self._key = key


def _check(ps: Sequence[torch.Tensor], gs, ms, vs) -> None:
    if not (len(ps) == len(gs) == len(ms) == len(vs)) or not ps:
        raise ValueError("fused_adamw: p, g, m, v lists must match and be "
                         "non-empty")
    dev = ps[0].device
    for group in (ps, gs, ms, vs):
        for t in group:
            if t.dtype != torch.float32 or t.device != dev \
                    or not t.is_contiguous():
                raise TypeError("fused_adamw: the kernel takes contiguous "
                                "fp32 tensors on one device")
    for p, g, m, v in zip(ps, gs, ms, vs):
        if not (p.shape == g.shape == m.shape == v.shape):
            raise ValueError(f"fused_adamw: leaf shapes differ {p.shape}, "
                             f"{g.shape}, {m.shape}, {v.shape}")


def fused_adamw(ps: List[torch.Tensor], gs: List[torch.Tensor],
                ms: List[torch.Tensor], vs: List[torch.Tensor], lr: float,
                count: int, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8, wd: float = 0.01,
                table: AdamWTable = None) -> None:
    """One AdamW step over fp32 leaves, in place.  ``count`` is the step
    counter before this step (so ``t = count + 1``).  CPU tensors take the
    plain version leaf by leaf; CUDA tensors one launch of the multi-tensor
    kernel, counted in ``fused_adamw.launches``."""
    _check(ps, gs, ms, vs)
    bc1, bc2 = bias_corrections(count, b1, b2)
    dev = ps[0].device
    if dev.type == "cpu":
        for p, g, m, v in zip(ps, gs, ms, vs):
            adamw_leaf_ref(p, g, m, v, lr, bc1, bc2, b1, b2, eps, wd)
        return
    if dev.type != "cuda":
        raise ValueError(f"fused_adamw: no kernel for device {dev}")
    table = table or AdamWTable()
    table.update(ps, gs, ms, vs)
    err = _lib().fused_adamw(
        table.leaves.data_ptr(), table.chunks.data_ptr(), table.n_chunks,
        float(lr), bc1, bc2, float(b1), 1.0 - b1, float(b2), 1.0 - b2,
        float(eps), float(wd), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"fused_adamw kernel launch failed: CUDA error {err}")
    fused_adamw.launches["fused_adamw"] += 1


fused_adamw.launches = {"fused_adamw": 0}
