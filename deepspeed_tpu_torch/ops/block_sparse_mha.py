"""Block-sparse attention for training: forward and backward, GQA-native.

Port of ``deepspeed_tpu/ops/pallas/block_sparse_mha.py`` (``block_sparse_mha``
and its custom VJP; Pallas bodies ``_fwd_kernel``, ``_dq_kernel`` and
``_dkv_kernel``).  A DeepSpeed block layout ``[Hq, S/block, S/block]``
gates which (query, key) pairs attend; causal composes on top.  On CUDA
tensors the three roles launch the hand-written Hopper kernels of
``ops/csrc/block_sparse_attention.cu`` (``bsa_fwd``, ``bsa_bwd_dq``,
``bsa_bwd_dkv``); on CPU tensors the plain versions run the flash plain
versions' tile walk (``ops/flash_mha.py``) with the layout's token mask.
A CUDA call never falls back: the kernel builds and launches, or the call
raises.

The kernels and the plain versions follow the TPU kernels' arithmetic: an
online softmax over 64-key tiles, the ``-1e30`` mask with p zeroed on
masked entries, ``safe_l``, and zeros (lse ``-1e30``) for a query row that
sees no key.  The TPU's host-side liveness (``_tile_live`` and the
``_kv_pick`` clamp tables) becomes :class:`SparseLayout`: per layout, the
live 64-row tiles as lists on the device, built once and reused by every
call.

Layout contract (the JAX function's): q is ``[B, Hq, S, D]``, k/v are
``[B, Hkv, S, D]`` with Hq a multiple of Hkv, any view whose last dim is
contiguous (the model hands in transposed ``[B, S, H, D]`` projections).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops import flash_mha as fm

# rows of a kernel tile on both sides (the flash kernels' tile)
TILE = fm.BLOCK_K


def tile_live(layout, block: int, causal: bool, tile: int = TILE) -> np.ndarray:
    """[H, n, n] bool, n = ceil(S / tile): whether the (query tile, key
    tile) pair holds a live layout block and, causal, a key at or before
    the tile's last query — the JAX ``_tile_live`` predicate, for any block
    that divides S (a tile may hold several blocks or lie inside one)."""
    live_blocks = np.asarray(layout) != 0
    h, nb, _ = live_blocks.shape
    s = nb * block
    n = -(-s // tile)
    first = np.arange(n) * tile // block                       # first block
    last = (np.minimum(np.arange(1, n + 1) * tile, s) - 1) // block
    csum = np.zeros((h, nb + 1, nb + 1), np.int64)
    csum[:, 1:, 1:] = live_blocks.cumsum(1).cumsum(2)
    r0, r1 = first[:, None], last[:, None] + 1
    c0, c1 = first[None, :], last[None, :] + 1
    live = (csum[:, r1, c1] - csum[:, r0, c1] - csum[:, r1, c0]
            + csum[:, r0, c0]) > 0
    if causal:
        live &= np.tril(np.ones((n, n), bool))[None]
    return live


def layout_to_token_mask(layout, block: int) -> torch.Tensor:
    """[H, nb, nb] block layout (numpy or tensor) → [H, S, S] boolean token
    mask, on the layout's device."""
    m = torch.as_tensor(layout).bool()
    return m.repeat_interleave(block, dim=1).repeat_interleave(block, dim=2)


def _lists(live: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """CSR form of ``live [H, outer, inner]``: ``ptr [H*outer+1]`` and the
    inner indices of each (h, outer) row at ``idx[ptr[i]:ptr[i+1]]``."""
    counts = live.reshape(-1, live.shape[-1]).sum(1)
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return ptr, np.nonzero(live)[2].astype(np.int32)


class SparseLayout:
    """A block layout prepared for the kernels on one device: the uint8
    layout, the live-tile lists per (query head, q tile) for fwd and dq and
    per (query head, k tile) for dk/dv.  Build it once per (layout, causal,
    device); every call then reads it."""

    def __init__(self, layout, block: int, causal: bool, device):
        layout = np.asarray(layout)
        if layout.ndim != 3 or layout.shape[1] != layout.shape[2]:
            raise ValueError(f"layout must be [H, nb, nb], got {layout.shape}")
        self.block, self.causal = int(block), bool(causal)
        self.heads, self.nb = layout.shape[0], layout.shape[1]
        self.seq = self.nb * self.block
        self.live = tile_live(layout, self.block, self.causal)
        dev = torch.device(device)
        self.layout = torch.from_numpy((layout != 0).astype(np.uint8)).to(dev)
        self.device = self.layout.device   # "cuda" → "cuda:0"
        self.k_ptr, self.k_idx = (torch.from_numpy(a).to(dev)
                                  for a in _lists(self.live))
        self.q_ptr, self.q_idx = (torch.from_numpy(a).to(dev)
                                  for a in _lists(self.live.transpose(0, 2, 1)))
        self._mask = None

    def token_mask(self) -> torch.Tensor:
        """[Hq, S, S] bool: the pairs the layout and causal keep (the plain
        versions' mask), built at first use on the layout's device."""
        if self._mask is None:
            m = layout_to_token_mask(self.layout, self.block)
            if self.causal:
                m = m & torch.ones((self.seq, self.seq), dtype=torch.bool,
                                   device=m.device).tril()
            self._mask = m
        return self._mask


# ----------------------------------------------------------------------
# plain versions (CPU tensors; the card's reference in chip_smoke.py)
# ----------------------------------------------------------------------
def bsa_fwd_ref(q, k, v, plan: SparseLayout, sm_scale: float):
    """Plain version of ``bsa_fwd``: ``(o, lse)`` as ``flash_fwd_ref``
    computes them, every tile masked by the layout."""
    return fm.flash_fwd_ref(q, k, v, False, sm_scale,
                            mask=plan.token_mask().to(q.device))


def bsa_bwd_dq_ref(q, k, v, do, lse, delta, plan: SparseLayout,
                   sm_scale: float):
    """Plain version of ``bsa_bwd_dq``."""
    return fm.flash_bwd_dq_ref(q, k, v, do, lse, delta, False, sm_scale,
                               mask=plan.token_mask().to(q.device))


def bsa_bwd_dkv_ref(q, k, v, do, lse, delta, plan: SparseLayout,
                    sm_scale: float):
    """Plain version of ``bsa_bwd_dkv``: ``(dk, dv)``."""
    return fm.flash_bwd_dkv_ref(q, k, v, do, lse, delta, False, sm_scale,
                                mask=plan.token_mask().to(q.device))


# ----------------------------------------------------------------------
# kernel wrappers (CUDA tensors)
# ----------------------------------------------------------------------
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib():
    from deepspeed_tpu_torch.ops import op_builder

    lib = op_builder.load("block_sparse_attention")
    if not getattr(lib, "_bound", False):
        tail = [fm._STRIDES] + [_P] * 5 + [_I] * 6 + [_F, _I, _P]
        lib.bsa_fwd.argtypes = [_I] + [_P] * 5 + tail
        lib.bsa_bwd_dq.argtypes = [_I] + [_P] * 7 + tail
        lib.bsa_bwd_dkv.argtypes = [_I] + [_P] * 8 + tail
        for fn in (lib.bsa_fwd, lib.bsa_bwd_dq, lib.bsa_bwd_dkv):
            fn.restype = _I
        lib._bound = True
    return lib


def _check_plan(q, plan: SparseLayout) -> None:
    if plan.heads != q.shape[1]:
        raise ValueError(f"layout has {plan.heads} heads but q has "
                         f"{q.shape[1]}")
    if plan.seq != q.shape[2]:
        raise ValueError(f"layout covers {plan.seq} tokens "
                         f"({plan.nb} blocks of {plan.block}) but S is "
                         f"{q.shape[2]}")
    if plan.device != q.device and q.device.type == "cuda":
        raise ValueError(f"layout lives on {plan.device}, q on {q.device}")


def _layout_args(q, k, plan: SparseLayout, sm_scale: float):
    b, hq, s, d = q.shape
    return (plan.layout.data_ptr(), plan.k_ptr.data_ptr(),
            plan.k_idx.data_ptr(), plan.q_ptr.data_ptr(),
            plan.q_idx.data_ptr(), b, hq, k.shape[1], s, d, plan.block,
            float(sm_scale), int(plan.causal),
            torch.cuda.current_stream(q.device).cuda_stream)


def bsa_fwd(q, k, v, plan: SparseLayout, sm_scale: float):
    """``(o, lse)`` of one block-sparse forward; CPU tensors take the plain
    version, CUDA tensors the ``bsa_fwd`` kernel."""
    _check_plan(q, plan)
    if q.device.type == "cpu":
        return bsa_fwd_ref(q, k, v, plan, sm_scale)
    fm._check_cuda(q, k, v)
    b, hq, s, _ = q.shape
    o = fm._empty_bshd(q, hq)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    err = _lib().bsa_fwd(fm._DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                         v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                         fm._strides(q, k, v, o),
                         *_layout_args(q, k, plan, sm_scale))
    fm._raise_on(err, "bsa_fwd")
    block_sparse_mha.launches["bsa_fwd"] += 1
    return o, lse


def bsa_bwd_dq(q, k, v, do, lse, delta, plan: SparseLayout, sm_scale: float):
    """dq from the saved lse and ``delta = attn_delta(o, do)``; CPU tensors
    take the plain version, CUDA tensors the ``bsa_bwd_dq`` kernel."""
    _check_plan(q, plan)
    if q.device.type == "cpu":
        return bsa_bwd_dq_ref(q, k, v, do, lse, delta, plan, sm_scale)
    fm._check_cuda(q, k, v, do, lse, delta)
    dq = fm._empty_bshd(q, q.shape[1])
    err = _lib().bsa_bwd_dq(
        fm._DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        fm._strides(q, k, v, do, dq), *_layout_args(q, k, plan, sm_scale))
    fm._raise_on(err, "bsa_bwd_dq")
    block_sparse_mha.launches["bsa_bwd_dq"] += 1
    return dq


def bsa_bwd_dkv(q, k, v, do, lse, delta, plan: SparseLayout, sm_scale: float):
    """(dk, dv) from the saved lse and delta; CPU tensors take the plain
    version, CUDA tensors the ``bsa_bwd_dkv`` kernel."""
    _check_plan(q, plan)
    if q.device.type == "cpu":
        return bsa_bwd_dkv_ref(q, k, v, do, lse, delta, plan, sm_scale)
    fm._check_cuda(q, k, v, do, lse, delta)
    dk, dv = fm._empty_bshd(k, k.shape[1]), fm._empty_bshd(v, k.shape[1])
    err = _lib().bsa_bwd_dkv(
        fm._DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), fm._strides(q, k, v, do, dk, dv),
        *_layout_args(q, k, plan, sm_scale))
    fm._raise_on(err, "bsa_bwd_dkv")
    block_sparse_mha.launches["bsa_bwd_dkv"] += 1
    return dk, dv


class _BlockSparseAttention(torch.autograd.Function):
    """The custom VJP of the JAX function: the forward saves
    ``(q, k, v, o, lse)`` and the backward never reruns the forward."""

    @staticmethod
    def forward(ctx, q, k, v, plan, sm_scale):
        o, lse = bsa_fwd(q, k, v, plan, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.attn = (plan, sm_scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.device.type == "cuda" and not fm._kernel_layout_ok(do):
            do = do.contiguous()
        delta = fm.attn_delta(o, do).contiguous()
        dq = bsa_bwd_dq(q, k, v, do, lse, delta, *ctx.attn)
        dk, dv = bsa_bwd_dkv(q, k, v, do, lse, delta, *ctx.attn)
        return dq, dk, dv, None, None


def block_sparse_mha(q, k, v, layout, block: int, causal: bool = False,
                     sm_scale: Optional[float] = None):
    """Block-sparse attention over ``q [B, Hq, S, D]``, ``k/v [B, Hkv, S,
    D]`` with a DeepSpeed block ``layout [Hq, S/block, S/block]`` (a numpy
    array, or a :class:`SparseLayout` built for this block and causal flag
    to skip the host work).  Returns ``o [B, Hq, S, D]``, differentiable in
    q, k and v; dead tiles cost nothing.  Kernel launches are counted in
    ``block_sparse_mha.launches`` by kernel name."""
    if isinstance(layout, SparseLayout):
        if (layout.block, layout.causal) != (int(block), bool(causal)):
            raise ValueError(f"the SparseLayout was built for block "
                             f"{layout.block}, causal {layout.causal}")
        plan = layout
    else:
        plan = SparseLayout(layout, block, causal, q.device)
    scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale
    return _BlockSparseAttention.apply(q, k, v, plan, scale)


block_sparse_mha.launches = {"bsa_fwd": 0, "bsa_bwd_dq": 0, "bsa_bwd_dkv": 0}
