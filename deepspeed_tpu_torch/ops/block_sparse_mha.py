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

Routes (counted in ``block_sparse_mha.routes`` as ``"bsa_fwd.wgmma"``,
...): ``bsa_fwd`` takes :func:`fwd_route`'s route, the backward pair
:func:`bwd_route`'s: ``flash_mha``'s rule (bf16 views TMA reads at D 64 or
128 take ``wgmma``) and, for ``wgmma``, layout blocks of at least 16
tokens.  On ``wgmma`` the forward runs the persistent forward of
``attention_wgmma.cuh`` (128-row items over 128-key tiles) and dq and
dk/dv the persistent store-mode walks of ``attention_wgmma_bwd.cuh`` (dq:
128-row items over 64-key tiles; dk/dv: 128-key items over 64-row query
tiles), all under the layout; other bf16 runs the 64 x 64 walk of
``attention_tiles.cuh`` (``mma``), fp32 ``fma``.  :func:`block_sparse_mha` hands
the kernels a ``do`` they read on ``wgmma`` (``flash_mha.readable_do``)
and zero-pads a head_dim off the kernels' lanes (``flash_mha.head_dim_padded``).

The kernels and the plain versions follow the TPU kernels' arithmetic: an
online softmax over 64-key tiles, the ``-1e30`` mask with p zeroed on
masked entries, ``safe_l``, and zeros (lse ``-1e30``) for a query row that
sees no key.  The TPU's host-side liveness (``_tile_live`` and the
``_kv_pick`` clamp tables) becomes :class:`SparseLayout`: per layout, the
live tiles of each walk as lists on the device (and, for the ``wgmma``
walks, each entry's layout words and each 64 x 64 tile's full flag), built
once and reused by every call.

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
# the wgmma walks' items: 128 query rows (forward, dq) or 128 keys (dk/dv),
# walking 128-key (forward) or TILE-row tiles of the other side
WG_ITEM = 128
# layout blocks a wgmma list entry holds words for (the blocks a 128-row
# item spans at blocks of at least WG_MIN_BLOCK), one word per 64 rows or
# columns of the walked tile each, as in ops/csrc/block_sparse_attention.cu
WG_SLOTS, WG_MIN_BLOCK = 9, 16
# every kernel's routes, by C route code
ROUTES = fm.FWD_ROUTES


def _tile_blocks(layout, block: int, tq: int, tk: int):
    """Live layout blocks in each tq x tk tile ([H, nq, nk]), and the
    blocks each tile spans ([nq, nk]): tiles may hold several blocks or lie
    inside one."""
    live_blocks = np.asarray(layout) != 0
    h, nb, _ = live_blocks.shape
    s = nb * block

    def spans(t):     # first block, one past the last, of each tile
        n = -(-s // t)
        return (np.arange(n) * t // block,
                (np.minimum(np.arange(1, n + 1) * t, s) - 1) // block + 1)

    (r0, r1), (c0, c1) = spans(tq), spans(tk)
    csum = np.zeros((h, nb + 1, nb + 1), np.int64)
    csum[:, 1:, 1:] = live_blocks.cumsum(1).cumsum(2)
    r0, r1, c0, c1 = r0[:, None], r1[:, None], c0[None, :], c1[None, :]
    count = (csum[:, r1, c1] - csum[:, r0, c1] - csum[:, r1, c0]
             + csum[:, r0, c0])
    return count, (r1 - r0) * (c1 - c0)


def tile_live(layout, block: int, causal: bool, tq: int = TILE,
              tk: Optional[int] = None) -> np.ndarray:
    """[H, nq, nk] bool over tq x tk tiles (tk defaults to tq), nq =
    ceil(S / tq): whether the (query tile, key tile) pair holds a live
    layout block and, causal, a key at or before the tile's last query —
    the JAX ``_tile_live`` predicate, for any block that divides S.  It
    keeps every tile in which the token mask keeps a pair, and no other
    when the layout is causal itself (lower triangular) or ``causal`` is
    off."""
    tk = tq if tk is None else tk
    count, _ = _tile_blocks(layout, block, tq, tk)
    live = count > 0
    if causal:
        s = np.asarray(layout).shape[1] * block
        last_q = np.minimum(np.arange(1, live.shape[1] + 1) * tq, s) - 1
        live &= (np.arange(live.shape[2]) * tk)[None, :] <= last_q[:, None]
    return live


def tile_full(layout, block: int, causal: bool) -> np.ndarray:
    """[H, n, n] bool over TILE x TILE tiles: every (row, col) pair of the
    tile is kept — inside S, every layout block live, and, causal, the
    tile's last key at or before its first query.  Such tiles take the
    wgmma walks' maskless body."""
    count, area = _tile_blocks(layout, block, TILE, TILE)
    s = np.asarray(layout).shape[1] * block
    ends = np.arange(1, count.shape[1] + 1) * TILE
    full = (count == area[None]) & (ends <= s)[None, :, None] \
        & (ends <= s)[None, None, :]
    if causal:
        full &= np.tril(np.ones(area.shape, bool), -1)[None]
    return full


def tile_words(layout, block: int, live: np.ndarray, rows_fixed: bool,
               walked_rows: int = TILE) -> np.ndarray:
    """The layout words of each entry of the wgmma lists ``live`` ([H,
    items, walked tiles], in list order): [entries, WG_SLOTS · walked_rows
    / 64] uint64, for layout block ``item·WG_ITEM // block + j`` of the
    item's fixed side (rows for the forward and dq, ``rows_fixed``; keys for
    dk/dv) the words ``j·n .. j·n + n - 1`` (n = walked_rows / 64), bit c of
    word w set where row or column 64·w + c of the walked tile lies inside
    S in a live block."""
    lb = np.asarray(layout) != 0
    nb = lb.shape[1]
    s = nb * block
    h, item, walked = np.nonzero(live)
    n_words = walked_rows // 64
    out = np.zeros((len(h), WG_SLOTS, n_words), np.uint64)
    for a in range(0, len(h), 1 << 14):       # bounded temporaries
        hh, ii, jj = h[a:a + (1 << 14)], item[a:a + (1 << 14)], walked[a:a + (1 << 14)]
        fixed = ii[:, None] * WG_ITEM // block + np.arange(WG_SLOTS)[None]
        other = jj[:, None] * walked_rows + np.arange(walked_rows)[None]
        ok = (fixed < nb)[:, :, None] & (other < s)[:, None, :]
        fixed, other = np.minimum(fixed, nb - 1), np.minimum(other // block, nb - 1)
        hi = hh[:, None, None]
        bits = (lb[hi, fixed[:, :, None], other[:, None, :]] if rows_fixed
                else lb[hi, other[:, None, :], fixed[:, :, None]]) & ok
        out[a:a + len(hh)] = np.packbits(bits, axis=-1, bitorder="little") \
            .view("<u8")
    return out.reshape(len(h), WG_SLOTS * n_words)


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
    layout; the live 64 x 64 tile lists per (query head, q tile) for the
    64 x 64 walk's forward and dq, and per (query head, k tile) for its
    dk/dv; and, at blocks of at least WG_MIN_BLOCK (``wgmma``), the wgmma
    walks' lists with their layout words (:func:`tile_words`) — the
    forward's per (query head, 128-row item) over 128-key tiles, dq's per
    (query head, 128-row item) over 64-key tiles, dk/dv's per (query head,
    128-key item) over 64-row query tiles — and the 64 x 64 full flags
    (:func:`tile_full`).  Build it once per (layout, causal, device); every
    call then reads it."""

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
        self.wgmma = self.block >= WG_MIN_BLOCK
        self.fwd_walk = self.dq_walk = self.dkv_walk = self.full = None
        if self.wgmma:
            # (live tiles [H, items, walked], rows fixed, walked tile rows)
            walks = ((tile_live(layout, self.block, self.causal, WG_ITEM,
                                WG_ITEM), True, WG_ITEM),
                     (tile_live(layout, self.block, self.causal, WG_ITEM,
                                TILE), True, TILE),
                     (tile_live(layout, self.block, self.causal, TILE,
                                WG_ITEM).transpose(0, 2, 1), False, TILE))
            self.fwd_walk, self.dq_walk, self.dkv_walk = (
                tuple(torch.from_numpy(a).to(dev) for a in (
                    *_lists(live), tile_words(layout, self.block, live,
                                              rows_fixed, walked)
                    .view(np.int64)))
                for live, rows_fixed, walked in walks)
            # C order: the kernels index [H, n, n] flat (numpy's mixed
            # advanced indexing may hand back another memory order)
            self.full = torch.from_numpy(np.ascontiguousarray(
                tile_full(layout, self.block, self.causal), np.uint8)).to(dev)
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
        shape = [_I] * 6 + [_F, _I, _P]
        # strides, the 64 x 64 walk's layout and lists, the wgmma walk's
        # lists, words and flags, then the shape
        tail = [fm._STRIDES] + [_P] * 9 + shape
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


def _layout_args(q, k, plan: SparseLayout, sm_scale: float, walk: str):
    """The C entries' layout and shape arguments.  ``walk``: which wgmma
    lists follow the 64 x 64 ones ("fwd", "dq" or "dkv"; null pointers
    where the plan has none, read on route 2 only)."""
    b, hq, s, d = q.shape
    ptrs = [x.data_ptr() for x in (plan.layout, plan.k_ptr, plan.k_idx,
                                   plan.q_ptr, plan.q_idx)]
    lists = getattr(plan, f"{walk}_walk")
    ptrs += ([x.data_ptr() for x in (*lists, plan.full)] if plan.wgmma
             else [None] * 4)
    return (*ptrs, b, hq, k.shape[1], s, d, plan.block, float(sm_scale),
            int(plan.causal), torch.cuda.current_stream(q.device).cuda_stream)


def fwd_route(q, k, v, plan: SparseLayout) -> str:
    """``bsa_fwd``'s route, before the launch: ``flash_mha.fwd_route``
    (fp32 ``fma``; bf16 views TMA reads at D 64 or 128 ``wgmma``, other
    bf16 ``mma``), with ``wgmma`` kept for layouts whose blocks the wgmma
    walks' words cover (``plan.wgmma``, blocks of at least 16)."""
    route = fm.fwd_route(q, k, v)
    return "mma" if route == "wgmma" and not plan.wgmma else route


def bwd_route(q, k, v, do, plan: SparseLayout) -> str:
    """The backward pair's route, before the launch: :func:`fwd_route`'s
    rule over ``do`` as well (``flash_mha.bwd_route``)."""
    route = fm.bwd_route(q, k, v, do)
    return "mma" if route == "wgmma" and not plan.wgmma else route


def bsa_fwd(q, k, v, plan: SparseLayout, sm_scale: float):
    """``(o, lse)`` of one block-sparse forward; CPU tensors take the plain
    version, CUDA tensors the ``bsa_fwd`` kernel on :func:`fwd_route`'s
    route."""
    _check_plan(q, plan)
    if q.device.type == "cpu":
        return bsa_fwd_ref(q, k, v, plan, sm_scale)
    fm._check_cuda(q, k, v)
    b, hq, s, _ = q.shape
    o = fm._empty_bshd(q, hq)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    path = fwd_route(q, k, v, plan)
    err = _lib().bsa_fwd(ROUTES.index(path), q.data_ptr(), k.data_ptr(),
                         v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                         fm._strides(q, k, v, o),
                         *_layout_args(q, k, plan, sm_scale, walk="fwd"))
    fm._raise_on(err, f"bsa_fwd ({path} route)")
    block_sparse_mha.launches["bsa_fwd"] += 1
    block_sparse_mha.routes[f"bsa_fwd.{path}"] += 1
    return o, lse


def bsa_bwd_dq(q, k, v, do, lse, delta, plan: SparseLayout, sm_scale: float):
    """dq from the saved lse and ``delta = attn_delta(o, do)``; CPU tensors
    take the plain version, CUDA tensors the ``bsa_bwd_dq`` kernel on
    :func:`bwd_route`'s route."""
    _check_plan(q, plan)
    if q.device.type == "cpu":
        return bsa_bwd_dq_ref(q, k, v, do, lse, delta, plan, sm_scale)
    fm._check_cuda(q, k, v, do, lse, delta)
    dq = fm._empty_bshd(q, q.shape[1])
    path = bwd_route(q, k, v, do, plan)
    err = _lib().bsa_bwd_dq(
        ROUTES.index(path), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        fm._strides(q, k, v, do, dq),
        *_layout_args(q, k, plan, sm_scale, walk="dq"))
    fm._raise_on(err, f"bsa_bwd_dq ({path} route)")
    block_sparse_mha.launches["bsa_bwd_dq"] += 1
    block_sparse_mha.routes[f"bsa_bwd_dq.{path}"] += 1
    return dq


def bsa_bwd_dkv(q, k, v, do, lse, delta, plan: SparseLayout, sm_scale: float):
    """(dk, dv) from the saved lse and delta; CPU tensors take the plain
    version, CUDA tensors the ``bsa_bwd_dkv`` kernel on :func:`bwd_route`'s
    route."""
    _check_plan(q, plan)
    if q.device.type == "cpu":
        return bsa_bwd_dkv_ref(q, k, v, do, lse, delta, plan, sm_scale)
    fm._check_cuda(q, k, v, do, lse, delta)
    dk, dv = fm._empty_bshd(k, k.shape[1]), fm._empty_bshd(v, k.shape[1])
    path = bwd_route(q, k, v, do, plan)
    err = _lib().bsa_bwd_dkv(
        ROUTES.index(path), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), fm._strides(q, k, v, do, dk, dv),
        *_layout_args(q, k, plan, sm_scale, walk="dkv"))
    fm._raise_on(err, f"bsa_bwd_dkv ({path} route)")
    block_sparse_mha.launches["bsa_bwd_dkv"] += 1
    block_sparse_mha.routes[f"bsa_bwd_dkv.{path}"] += 1
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
        do = fm.readable_do(do)
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
    q, k and v; dead tiles cost nothing.  On CUDA tensors a head_dim off
    the kernels' lanes is zero-padded to its lane
    (``flash_mha.head_dim_padded``).  Kernel launches are counted in
    ``block_sparse_mha.launches`` by kernel name and in
    ``block_sparse_mha.routes`` by route."""
    if isinstance(layout, SparseLayout):
        if (layout.block, layout.causal) != (int(block), bool(causal)):
            raise ValueError(f"the SparseLayout was built for block "
                             f"{layout.block}, causal {layout.causal}")
        plan = layout
    else:
        plan = SparseLayout(layout, block, causal, q.device)
    scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale

    def attn(q_, k_, v_):
        return _BlockSparseAttention.apply(q_, k_, v_, plan, scale)

    if q.device.type == "cuda":
        return fm.head_dim_padded(attn, q, k, v)
    return attn(q, k, v)


block_sparse_mha.launches = {"bsa_fwd": 0, "bsa_bwd_dq": 0, "bsa_bwd_dkv": 0}
# each kernel's launches by route (codes in ops/csrc/block_sparse_attention.cu)
block_sparse_mha.routes = {f"{n}.{r}": 0 for n in block_sparse_mha.launches
                           for r in ROUTES}
