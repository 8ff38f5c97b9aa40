"""Flash attention for training: forward and backward, GQA-native.

Port of ``deepspeed_tpu/ops/pallas/flash_mha.py`` (``flash_mha`` and its
custom VJP ``_flash_fwd_rule``/``_flash_bwd_rule``; Pallas bodies
``_fwd_kernel``/``_fwd_kernel_blocked``, ``_dq_kernel``/``_dq_kernel_blocked``
and ``_dkv_kernel``/``_dkv_kernel_blocked``).  On CUDA tensors the three
roles launch the hand-written Hopper kernels of ``ops/csrc/flash_attention.cu``
(``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``); on CPU tensors the
plain PyTorch versions below run the same tile walk.  A CUDA call never
falls back: the kernel builds and launches, or the call raises.  Each
role has routes, picked before the launch from dtype and strides
(:func:`fwd_route` for the forward, :func:`bwd_route`, which adds ``do``,
for the backward; counted in ``flash_mha.routes`` as
``"flash_fwd.wgmma"``, ``"flash_bwd_dq.mma"``, ...): bf16 views that TMA
can read take the ``wgmma`` walks (the forward of
``ops/csrc/attention_wgmma.cuh`` on 128-key tiles; dq and dk/dv of
``ops/csrc/attention_wgmma_bwd.cuh``, their sums from zero and written once
in bf16), other bf16 views (``mma``) and fp32 (``fma``) the 64 x 64 tile
walk of ``ops/csrc/attention_tiles.cuh``.  :func:`flash_bwd` makes a ``do``
that TMA cannot read (an expanded gradient) contiguous first, so the bf16
backward of the autograd function always takes ``wgmma``.

The TPU file has a VMEM-resident variant and a KV-blocked variant of each
kernel; the split exists for VMEM budgets, which Hopper does not share.
One kernel per role serves every sequence length and follows the
**blocked** kernels' arithmetic: an online softmax over ``BLOCK_K``-key
tiles, fp32 scores, ``p`` rounded to v's dtype before ``p·v`` (to do's
before ``pᵀ·do``), ``ds`` rounded to k's dtype for dq and to q's for dk,
the ``-1e30`` mask with ``p`` zeroed on masked entries, and
``safe_l = l if l > 0 else 1``.  The plain versions walk the same key
tiles, so kernel and plain version differ in summation order only.  The
JAX **resident** kernel rounds ``p`` against the global row max instead of
the running one, so against it bf16 results differ by p's rounding.

The ring-attention hop kernels of the same TPU file (``_carry_kernel``,
``_ring_dq_kernel``, ``_ring_dkv_kernel`` behind ``flash_carry_block``,
``flash_ring_dq_block`` and ``flash_ring_dkv_block``) are the same tile
walk in accumulate mode, under a mask on global positions ``off + stride
· i``: their wrappers below launch ``ring_carry``, ``ring_bwd_dq`` and
``ring_bwd_dkv`` of ``ops/csrc/ring_attention.cu`` on CUDA tensors, and
their plain versions run the per-hop math of the JAX ring's XLA path
(``sequence/ring.py`` ``_ring_fwd_xla``/``_ring_bwd_xla``) over the same
key tiles on CPU tensors.  Each updates its fp32 state in place.  The
carry takes :func:`fwd_route`'s route and the backward :func:`bwd_route`'s,
which adds ``do`` to the operands (counted in ``ring_routes``): bf16 views
TMA can read run the ``wgmma`` walks (``attention_wgmma.cuh``, the
forward in accumulate mode; ``attention_wgmma_bwd.cuh``, dq and dk/dv).
The hop wrappers also take the quantized ring wire's int8 K/V with per-row
fp32 scales (``k_scale``/``v_scale``, the JAX kernels' quantized operands):
:func:`ring_route` sends them, kernel by kernel, to the int8 lanes of
``ops/csrc/ring_attention_int8.cu``: ``wgmma_s8`` (the ``wgmma`` walks
with the int8 tiles widened to bf16 on the card) for bf16 q and do that
TMA can read at D 64 and 128, ``mma_s8`` (the 64 x 64 tile walk) for other
bf16 calls, ``fma_s8`` for fp32; the plain versions
decode the rows as the Pallas bodies do (:func:`wire_dequant_rows`) and
compute in fp32.

Layout contract (the JAX function's): q is ``[B, Hq, S, D]``, k/v are
``[B, Hkv, S, D]`` with Hq a multiple of Hkv; the kernels read any such
view whose last dim is contiguous (the model hands them transposed
``[B, S, H, D]`` projections, read in place).  The residual lse is plain
``[B, Hq, S]`` fp32 (the TPU's 128-lane replication, ``_lanes``, has no
reason to exist here).

Head dims (the JAX kernels take the whole D as one block, any D): the
kernels have lanes for D 64 and 128 on every route and D 256 on the 64 x 64
tile walk (``mma`` for bf16, ``fma`` for fp32; a bf16 call at D 256 takes
``mma``).  The differentiable entries (:func:`flash_mha`, the block-sparse
``block_sparse_mha`` and the ring's ``ring_attention``) zero-pad any other
D up to its lane (:func:`head_dim_lane`: 64, 128 or 256) on CUDA tensors
with :func:`head_dim_padded`, ``sm_scale`` taken from the real D, and slice
the output back: zero columns add nothing to q·kᵀ or p·v, and their
gradients come out zero.  D above 256 raises.  The kernel wrappers take a
lane's D only; the plain versions take any D.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

NEG_INF = -1e30
# key rows per step of the online softmax (kernel and plain version alike)
BLOCK_K = 64
# the kernels' head_dim lanes: every route takes 64 and 128, the 64 x 64
# tile walk (mma, fma) 256 too; the entries pad any D up to the next lane
LANES = (64, 128, 256)
WGMMA_LANES = (64, 128)
# the kernels' operand dtypes (the routes' codes carry them: fma fp32, mma and
# wgmma bf16)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# the attention kernels' routes by their code in ops/csrc/*_attention.cu
FWD_ROUTES = ("fma", "mma", "wgmma")


# ----------------------------------------------------------------------
# plain versions (CPU tensors; the card's reference in chip_smoke.py)
# ----------------------------------------------------------------------
# global positions of (query rows, key cols): (q_off, q_stride, k_off,
# k_stride), row r at q_off + q_stride·r; one sequence: rows and cols alike
SAME_BLOCK = (0, 1, 0, 1)


def _valid(s_real: int, k0: int, k1: int, causal: bool,
           window: Optional[int], device, mask=None,
           pos=SAME_BLOCK) -> torch.Tensor:
    """[S, k1-k0] validity of (query row, key col) pairs of one key tile,
    causal and window tested on the positions ``pos`` gives; ``mask``: a
    [Hkv, group, S, S] token mask (a block-sparse layout's) to compose on
    top, making the result [Hkv, group, S, k1-k0]."""
    q_off, q_stride, k_off, k_stride = pos
    rows = q_off + q_stride * torch.arange(s_real, device=device)[:, None]
    cols = torch.arange(k0, k1, device=device)[None, :]
    valid = cols < s_real
    cols = k_off + k_stride * cols
    if causal:
        valid = valid & (cols <= rows)
    if window is not None:
        valid = valid & (rows - cols < window)
    if mask is not None:
        valid = valid & mask[..., k0:k1]
    return valid


def _group_mask(mask, hkv: int):
    """A [Hq, S, S] token mask folded as [Hkv, group, S, S] (or None)."""
    return None if mask is None else mask.reshape(hkv, -1, *mask.shape[1:])


def attn_delta(o, do):
    """``delta = sum(do·o)`` per query row in fp32 — the softmax-backward
    correction term, computed outside the kernels as JAX does."""
    return torch.sum(do.float() * o.float(), dim=-1)


def flash_fwd_ref(q, k, v, causal: bool, sm_scale: float,
                  window: Optional[int] = None, mask=None):
    """Plain version of ``flash_fwd``: ``(o [B,Hq,S,D] in q's dtype,
    lse [B,Hq,S] fp32)`` by an online softmax over ``BLOCK_K``-key tiles,
    the query heads of a group folded onto their KV head.  ``mask``: an
    optional [Hq, S, S] bool token mask ANDed into every tile's validity
    (the block-sparse kernels' plain versions pass their layout's).  A row
    that sees no key gets o = 0 and lse = -1e30."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    dev = q.device
    m = torch.full((b, hkv, g, s, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, s, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, s, d), dtype=torch.float32, device=dev)
    m, l, acc = _fwd_walk(q, k, v, m, l, acc, causal, sm_scale, window,
                          _group_mask(mask, hkv))
    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    o = (acc / safe_l).to(q.dtype).reshape(b, hq, s, d)
    return o, (m + torch.log(safe_l)).reshape(b, hq, s)


def _fwd_walk(q, k, v, m, l, acc, causal, sm_scale, window, mask=None,
              pos=SAME_BLOCK):
    """The forward's online softmax over ``BLOCK_K``-key tiles from the
    running ``(m, l, acc)`` ([B, Hkv, group, S, 1|D] fp32); returns them
    updated, unnormalised."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    qf = q.float().reshape(b, hkv, hq // hkv, s, d)
    for k0 in range(0, s, BLOCK_K):
        k1 = min(k0 + BLOCK_K, s)
        valid = _valid(s, k0, k1, causal, window, q.device, mask, pos)
        sc = torch.einsum("bhgsd,bhkd->bhgsk", qf, k[:, :, k0:k1].float())
        sc = torch.where(valid, sc * sm_scale, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(sc - m_new), 0.0)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bhgsk,bhkd->bhgsd", p.to(v.dtype).float(),
                          v[:, :, k0:k1].float())
        acc = acc * alpha + pv
        m = m_new
    return m, l, acc


def _bwd_tiles(q, k, v, do, lse, delta, causal, sm_scale, window, mask,
               pos=SAME_BLOCK):
    """The backward's key-tile walk shared by the plain versions: yields
    ``(k0, k1, kt, p, ds)`` per tile, p and ds fp32
    [B, Hkv, group, S, tile] with masked entries zero."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    mask = _group_mask(mask, hkv)
    qf = q.float().reshape(b, hkv, g, s, d)
    dof = do.float().reshape(b, hkv, g, s, d)
    lse_ = lse.float().reshape(b, hkv, g, s, 1)
    delta_ = delta.float().reshape(b, hkv, g, s, 1)
    for k0 in range(0, s, BLOCK_K):
        k1 = min(k0 + BLOCK_K, s)
        kt, vt = k[:, :, k0:k1].float(), v[:, :, k0:k1].float()
        valid = _valid(s, k0, k1, causal, window, q.device, mask, pos)
        sc = torch.einsum("bhgsd,bhkd->bhgsk", qf, kt)
        sc = torch.where(valid, sc * sm_scale, NEG_INF)
        p = torch.where(valid, torch.exp(sc - lse_), 0.0)
        dp = torch.einsum("bhgsd,bhkd->bhgsk", dof, vt)
        yield k0, k1, kt, p, p * (dp - delta_) * sm_scale


def flash_bwd_dq_ref(q, k, v, do, lse, delta, causal: bool, sm_scale: float,
                     window: Optional[int] = None, mask=None):
    """Plain version of ``flash_bwd_dq``: dq = sum over key tiles of
    (p·(dp−delta)·scale rounded to k's dtype)·k."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    dq = torch.zeros((b, hkv, hq // hkv, s, d), dtype=torch.float32,
                     device=q.device)
    for _k0, _k1, kt, _p, ds in _bwd_tiles(q, k, v, do, lse, delta, causal,
                                           sm_scale, window, mask):
        dq += torch.einsum("bhgsk,bhkd->bhgsd", ds.to(k.dtype).float(), kt)
    return dq.to(q.dtype).reshape(b, hq, s, d)


def flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal: bool, sm_scale: float,
                      window: Optional[int] = None, mask=None):
    """Plain version of ``flash_bwd_dkv``: per key tile, dv = pᵀ·do (p
    rounded to do's dtype) and dk = dsᵀ·q (ds rounded to q's dtype), summed
    over the query heads of each KV head's group."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    qf = q.float().reshape(b, hkv, hq // hkv, s, d)
    dof = do.float().reshape(b, hkv, hq // hkv, s, d)
    dk = torch.empty((b, hkv, s, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, hkv, s, d), dtype=v.dtype, device=q.device)
    for k0, k1, _kt, p, ds in _bwd_tiles(q, k, v, do, lse, delta, causal,
                                         sm_scale, window, mask):
        dv[:, :, k0:k1] = torch.einsum(
            "bhgsk,bhgsd->bhkd", p.to(do.dtype).float(), dof).to(v.dtype)
        dk[:, :, k0:k1] = torch.einsum(
            "bhgsk,bhgsd->bhkd", ds.to(q.dtype).float(), qf).to(k.dtype)
    return dk, dv


def flash_bwd_ref(q, k, v, o, lse, do, causal: bool, sm_scale: float,
                  window: Optional[int] = None):
    """Plain version of the whole backward: ``(dq, dk, dv)`` from the saved
    ``(q, k, v, o, lse)``."""
    delta = attn_delta(o, do)
    dq = flash_bwd_dq_ref(q, k, v, do, lse, delta, causal, sm_scale, window)
    return (dq, *flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal, sm_scale,
                                   window))


# ----------------------------------------------------------------------
# kernel wrappers (CUDA tensors)
# ----------------------------------------------------------------------
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)


def _lib():
    from deepspeed_tpu_torch.ops import op_builder

    lib = op_builder.load("flash_attention")
    if not getattr(lib, "_bound", False):
        tail = [_STRIDES] + [_I] * 5 + [_F, _I, _I, _P]
        lib.flash_fwd.argtypes = [_I] + [_P] * 5 + tail
        lib.flash_bwd_dq.argtypes = [_I] + [_P] * 7 + tail
        lib.flash_bwd_dkv.argtypes = [_I] + [_P] * 8 + tail
        for fn in (lib.flash_fwd, lib.flash_bwd_dq, lib.flash_bwd_dkv):
            fn.restype = _I
        lib._bound = True
    return lib


def _kernel_layout_ok(x: torch.Tensor) -> bool:
    """The kernels read rows of D contiguous elements with 16-byte vector
    loads: last stride 1, every other stride and the base 16-byte aligned."""
    step = 16 // x.element_size()
    return (x.stride(-1) == 1 and all(st % step == 0 for st in x.stride()[:-1])
            and x.data_ptr() % 16 == 0)


def head_dim_lane(d: int) -> int:
    """The kernel lane a head_dim ``d`` runs in: ``d`` itself when it is a
    lane (64, 128, 256), else the next lane up, which the entries zero-pad
    ``d`` to.  D above 256 raises (the reference's kernels take any D that
    fits their S·D bound)."""
    for lane in LANES:
        if 0 < d <= lane:
            return lane
    raise ValueError(f"head_dim {d}: the attention kernels take D from 1 to "
                     f"{LANES[-1]} (zero-padded to a lane of {LANES})")


def head_dim_padded(attn, q, k, v):
    """``attn(q, k, v)`` over the last dim zero-padded to its lane
    (:func:`head_dim_lane`), the output sliced back to the real D: exact,
    since zero columns add nothing to q·kᵀ or p·v, and differentiable, the
    pad's and the slice's gradients slicing and padding.  ``attn`` must take
    its ``sm_scale`` from the real D, not from the padded operands.  The
    entries call it on CUDA tensors; on the CPU it runs the padded path
    through the plain versions."""
    d = q.shape[-1]
    lane = head_dim_lane(d)
    if lane == d:
        return attn(q, k, v)
    q, k, v = (torch.nn.functional.pad(x, (0, lane - d)) for x in (q, k, v))
    return attn(q, k, v)[..., :d]


def _check_cuda(q, k, v, do=None, lse=None, delta=None, kv_dtype=None):
    """What the kernels take: CUDA tensors, fp32 or bf16, head_dim a lane
    (64, 128 or 256), Hq a multiple of Hkv, rows readable in place;
    lse/delta contiguous fp32 [B, Hq, S].  K/V are of q's dtype, or of
    ``kv_dtype`` when given (the ring's int8 lanes)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: no kernel for device {q.device}")
    b, hq, s, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[2] != s or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if hq % k.shape[1]:
        raise ValueError(f"{hq} query heads do not group over {k.shape[1]} "
                         "KV heads")
    if d not in LANES:
        raise ValueError(f"head_dim {d}: the kernels take {LANES}; "
                         "flash_mha, block_sparse_mha and ring_attention "
                         f"zero-pad any D up to {LANES[-1]} to its lane")
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"dtype {q.dtype}: the kernels take fp32 and bf16")
    ops = [x for x in (k, v, do) if x is not None]
    for x in ops:
        want = q.dtype if x is do or kv_dtype is None else kv_dtype
        if x.dtype != want or x.device != q.device:
            raise TypeError("q, k, v (and do) must share dtype and device")
    if do is not None and do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} does not match q")
    for x in [q] + ops:
        if not _kernel_layout_ok(x):
            raise ValueError(f"a [B,H,S,D] operand with strides {x.stride()} "
                             "is not readable by the kernels (last dim "
                             "contiguous, rows 16-byte aligned)")
    for x in (lse, delta):
        if x is not None and (x.dtype != torch.float32 or x.shape != (b, hq, s)
                              or not x.is_contiguous() or x.device != q.device):
            raise ValueError("lse/delta must be contiguous fp32 [B, Hq, S] on "
                             "q's device")


def _strides(*tensors):
    vals = [st for x in tensors for st in x.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _common(q, k, causal, sm_scale, window):
    b, hq, s, d = q.shape
    return (b, hq, k.shape[1], s, d, float(sm_scale), int(bool(causal)),
            int(window or 0), torch.cuda.current_stream(q.device).cuda_stream)


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _empty_bshd(q: torch.Tensor, heads: int) -> torch.Tensor:
    """A [B, heads, S, D] output laid out as contiguous [B, S, heads, D],
    the model's layout, so the caller's transpose back is free."""
    b, _, s, d = q.shape
    return torch.empty((b, s, heads, d), dtype=q.dtype,
                       device=q.device).transpose(1, 2)


def _tma_readable(x: torch.Tensor) -> bool:
    """A [B, H, S, D] view a TMA tensor map can describe (beyond
    :func:`_kernel_layout_ok`): no zero stride on a dim longer than one."""
    return all(st > 0 for st, n in zip(x.stride()[:3], x.shape[:3]) if n > 1)


def fwd_route(q, k, v) -> str:
    """The ``flash_fwd`` kernel's route, from dtype, head_dim and strides
    alone: ``"wgmma"`` (the wgmma/TMA forward) for bf16 views TMA can read
    at D 64 or 128; ``"mma"`` (the 64 x 64 tile walk on wmma) for other
    bf16 views (an expanded K/V with a zero stride) and for D 256; ``"fma"``
    for fp32 (the card-vs-CPU reference).  The operands are views the
    kernels take (:func:`_check_cuda`)."""
    if q.dtype == torch.float32:
        return "fma"
    if q.shape[-1] not in WGMMA_LANES:
        return "mma"
    return "wgmma" if all(_tma_readable(x) for x in (q, k, v)) else "mma"


def bwd_route(q, k, v, do) -> str:
    """The backward kernels' route (``flash_bwd_dq``, ``flash_bwd_dkv``,
    ``ring_bwd_dq``, ``ring_bwd_dkv``): :func:`fwd_route`'s rule over
    ``do`` as well, whose view (an expanded gradient) TMA must read too."""
    route = fwd_route(q, k, v)
    return "mma" if route == "wgmma" and not _tma_readable(do) else route


def flash_fwd(q, k, v, causal: bool, sm_scale: float,
              window: Optional[int] = None):
    """``(o, lse)`` of one attention forward; CPU tensors take the plain
    version, CUDA tensors the ``flash_fwd`` kernel on :func:`fwd_route`'s
    route."""
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, causal, sm_scale, window)
    _check_cuda(q, k, v)
    b, hq, s, _ = q.shape
    o = _empty_bshd(q, hq)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    path = fwd_route(q, k, v)
    err = _lib().flash_fwd(FWD_ROUTES.index(path), q.data_ptr(), k.data_ptr(),
                           v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                           _strides(q, k, v, o),
                           *_common(q, k, causal, sm_scale, window))
    _raise_on(err, f"flash_fwd ({path} route)")
    flash_mha.launches["flash_fwd"] += 1
    flash_mha.routes[f"flash_fwd.{path}"] += 1
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool, sm_scale: float,
                 window: Optional[int] = None):
    """dq from the saved lse and ``delta = attn_delta(o, do)``; CPU tensors
    take the plain version, CUDA tensors the ``flash_bwd_dq`` kernel on
    :func:`bwd_route`'s route."""
    if q.device.type == "cpu":
        return flash_bwd_dq_ref(q, k, v, do, lse, delta, causal, sm_scale,
                                window)
    _check_cuda(q, k, v, do, lse, delta)
    dq = _empty_bshd(q, q.shape[1])
    path = bwd_route(q, k, v, do)
    err = _lib().flash_bwd_dq(
        FWD_ROUTES.index(path), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        _strides(q, k, v, do, dq), *_common(q, k, causal, sm_scale, window))
    _raise_on(err, f"flash_bwd_dq ({path} route)")
    flash_mha.launches["flash_bwd_dq"] += 1
    flash_mha.routes[f"flash_bwd_dq.{path}"] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, sm_scale: float,
                  window: Optional[int] = None):
    """(dk, dv) from the saved lse and delta; CPU tensors take the plain
    version, CUDA tensors the ``flash_bwd_dkv`` kernel on
    :func:`bwd_route`'s route."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal, sm_scale,
                                 window)
    _check_cuda(q, k, v, do, lse, delta)
    dk, dv = _empty_bshd(k, k.shape[1]), _empty_bshd(v, k.shape[1])
    path = bwd_route(q, k, v, do)
    err = _lib().flash_bwd_dkv(
        FWD_ROUTES.index(path), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _strides(q, k, v, do, dk, dv),
        *_common(q, k, causal, sm_scale, window))
    _raise_on(err, f"flash_bwd_dkv ({path} route)")
    flash_mha.launches["flash_bwd_dkv"] += 1
    flash_mha.routes[f"flash_bwd_dkv.{path}"] += 1
    return dk, dv


def readable_do(do: torch.Tensor) -> torch.Tensor:
    """``do`` as :func:`flash_bwd` hands it to the kernels: autograd's
    gradient may come in any layout (an expanded one has zero strides), and
    one that the kernels cannot read in place, or a TMA tensor map cannot
    describe, is made contiguous.  One copy of ``do`` costs far less than
    the bf16 backward on the ``mma`` walk."""
    if _kernel_layout_ok(do) and _tma_readable(do):
        return do
    return do.contiguous()


def flash_bwd(q, k, v, o, lse, do, causal: bool, sm_scale: float,
              window: Optional[int] = None):
    """``(dq, dk, dv)`` from the saved residuals, ``do`` through
    :func:`readable_do`."""
    do = readable_do(do)
    # the row sum over [B, S, H, D]-laid views comes out [B, S, H]-strided
    delta = attn_delta(o, do).contiguous()
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, sm_scale, window)
    return (dq, *flash_bwd_dkv(q, k, v, do, lse, delta, causal, sm_scale,
                               window))


def wire_dequant_rows(payload, scale):
    """The quantized wire's int8 payload rows times their fp32 row scales
    (``scale`` [..., S], one a row): the JAX kernels' ``wire_dequant_rows``
    and ``comm/quantized.wire_decode_rows``' int8 branch, one fp32 multiply
    an element after an exact int8 to fp32 convert."""
    return payload.float() * scale[..., None]


def _wire_operands(q, k, v, do, k_scale, v_scale):
    """The operands as the Pallas bodies' quantized lane sees them: int8
    K/V decoded to fp32 and q, do promoted to fp32 (so p and ds stay fp32
    in the products); as they are without scales."""
    if k_scale is None:
        return q, k, v, do
    return (q.float(), wire_dequant_rows(k, k_scale),
            wire_dequant_rows(v, v_scale), None if do is None else do.float())


def ring_carry_ref(q, k, v, m, l, acc, pos, causal: bool, sm_scale: float,
                   window: Optional[int] = None, k_scale=None, v_scale=None):
    """Plain version of ``ring_carry``: one ring hop's online-softmax update
    of the running ``m, l`` ([B, Hq, S] fp32) and ``acc`` ([B, Hq, S, D]
    fp32) against the visiting K/V block, in place, unnormalised; ``pos``:
    the hop's ``(q_off, q_stride, k_off, k_stride)``.  ``k_scale``,
    ``v_scale`` ([B, Hkv, S] fp32): K/V are int8 payloads
    (:func:`_wire_operands`)."""
    q, k, v, _ = _wire_operands(q, k, v, None, k_scale, v_scale)
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    m5, l5, acc5 = _fwd_walk(q, k, v, m.reshape(b, hkv, g, s, 1),
                             l.reshape(b, hkv, g, s, 1),
                             acc.reshape(b, hkv, g, s, d), causal, sm_scale,
                             window, pos=pos)
    m.copy_(m5.reshape(m.shape))
    l.copy_(l5.reshape(l.shape))
    acc.copy_(acc5.reshape(acc.shape))
    return m, l, acc


def ring_bwd_dq_ref(q, k, v, do, lse, delta, dq, pos, causal: bool,
                    sm_scale: float, window: Optional[int] = None,
                    k_scale=None, v_scale=None):
    """Plain version of ``ring_bwd_dq``: adds one hop's dq, key tile by key
    tile, into the fp32 ``dq`` [B, Hq, S, D] in place (int8 K/V with
    ``k_scale``/``v_scale`` as in :func:`ring_carry_ref`)."""
    q, k, v, do = _wire_operands(q, k, v, do, k_scale, v_scale)
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    dq5 = dq.view(b, hkv, hq // hkv, s, d)
    for _k0, _k1, kt, _p, ds in _bwd_tiles(q, k, v, do, lse, delta, causal,
                                           sm_scale, window, None, pos):
        dq5 += torch.einsum("bhgsk,bhkd->bhgsd", ds.to(k.dtype).float(), kt)
    return dq


def ring_bwd_dkv_ref(q, k, v, do, lse, delta, dk, dv, pos, causal: bool,
                     sm_scale: float, window: Optional[int] = None,
                     k_scale=None, v_scale=None):
    """Plain version of ``ring_bwd_dkv``: adds the visiting block's dk and
    dv, summed over each KV head's group, into the fp32 ``dk``/``dv``
    [B, Hkv, S, D] in place (int8 K/V with ``k_scale``/``v_scale`` as in
    :func:`ring_carry_ref`)."""
    q, k, v, do = _wire_operands(q, k, v, do, k_scale, v_scale)
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    qf = q.float().reshape(b, hkv, hq // hkv, s, d)
    dof = do.float().reshape(b, hkv, hq // hkv, s, d)
    for k0, k1, _kt, p, ds in _bwd_tiles(q, k, v, do, lse, delta, causal,
                                         sm_scale, window, None, pos):
        dv[:, :, k0:k1] += torch.einsum("bhgsk,bhgsd->bhkd",
                                        p.to(do.dtype).float(), dof)
        dk[:, :, k0:k1] += torch.einsum("bhgsk,bhgsd->bhkd",
                                        ds.to(q.dtype).float(), qf)
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """The custom VJP of the JAX function: the forward saves
    ``(q, k, v, o, lse)`` and the backward never reruns the forward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, window):
        o, lse = flash_fwd(q, k, v, causal, sm_scale, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.attn = (causal, sm_scale, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, *ctx.attn)
        return dq, dk, dv, None, None, None


def flash_mha(q, k, v, causal: bool = True, sm_scale: Optional[float] = None,
              window: Optional[int] = None):
    """Flash attention over ``q [B, Hq, S, D]``, ``k/v [B, Hkv, S, D]``
    (GQA folded in the kernels, KV never repeated); ``window``: sliding
    window (key visible iff ``qpos - kpos < window``).  Returns
    ``o [B, Hq, S, D]``, differentiable in q, k and v.  On CUDA tensors a
    D off the kernels' lanes is zero-padded to its lane
    (:func:`head_dim_padded`).  Kernel launches are counted in
    ``flash_mha.launches`` by kernel name."""
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive (got {window}); pass "
                         "None to disable sliding-window masking")
    scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale

    def attn(q_, k_, v_):
        return _FlashAttention.apply(q_, k_, v_, causal, scale, window)

    if q.device.type == "cuda":
        return head_dim_padded(attn, q, k, v)
    return attn(q, k, v)


flash_mha.launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
# each kernel's launches by route (codes in ops/csrc/flash_attention.cu)
flash_mha.routes = {f"{n}.{r}": 0 for n in flash_mha.launches
                    for r in FWD_ROUTES}


# ----------------------------------------------------------------------
# ring-attention hop wrappers (the JAX flash_carry_block /
# flash_ring_dq_block / flash_ring_dkv_block)
# ----------------------------------------------------------------------
ring_launches = {"ring_carry": 0, "ring_bwd_dq": 0, "ring_bwd_dkv": 0}
# the ring kernels' routes: the attention routes of ops/csrc/ring_attention.cu
# and the int8 K/V lanes of ops/csrc/ring_attention_int8.cu (the quantized
# wire), each lane's code that of the route it extends
S8_ROUTES = tuple(f"{r}_s8" for r in FWD_ROUTES)
RING_ROUTES = FWD_ROUTES + S8_ROUTES
# each ring kernel's launches by route
ring_routes = {f"{n}.{r}": 0 for n in ring_launches for r in RING_ROUTES}


def _ring_lib():
    from deepspeed_tpu_torch.ops import op_builder

    lib = op_builder.load("ring_attention")
    if not getattr(lib, "_bound", False):
        tail = [_STRIDES] + [_I] * 5 + [_F] + [_I] * 6 + [_P]
        lib.ring_carry.argtypes = [_I] + [_P] * 6 + tail
        lib.ring_bwd_dq.argtypes = [_I] + [_P] * 7 + tail
        lib.ring_bwd_dkv.argtypes = [_I] + [_P] * 8 + tail
        for fn in (lib.ring_carry, lib.ring_bwd_dq, lib.ring_bwd_dkv):
            fn.restype = _I
        lib._bound = True
    return lib


def _ring_int8_lib():
    """The int8 K/V lanes (``ops/csrc/ring_attention_int8.cu``): the entries
    of :func:`_ring_lib`, the lane's route code first, with the two scale
    pointers after ``v``."""
    from deepspeed_tpu_torch.ops import op_builder

    lib = op_builder.load("ring_attention_int8")
    if not getattr(lib, "_bound", False):
        tail = [_STRIDES] + [_I] * 5 + [_F] + [_I] * 6 + [_P]
        lib.ring_carry_s8.argtypes = [_I] + [_P] * 8 + tail
        lib.ring_bwd_dq_s8.argtypes = [_I] + [_P] * 9 + tail
        lib.ring_bwd_dkv_s8.argtypes = [_I] + [_P] * 10 + tail
        for fn in (lib.ring_carry_s8, lib.ring_bwd_dq_s8, lib.ring_bwd_dkv_s8):
            fn.restype = _I
        lib._bound = True
    return lib


def _ring_entry(name: str, path: str, k_scale, v_scale):
    """A hop kernel's C entry and its leading arguments for ``path``: the
    route code (``ring_attention.cu``), or for an int8 lane its code
    (``ring_attention_int8.cu``) with the scale pointers to pass after
    ``v``."""
    if path in S8_ROUTES:
        return (getattr(_ring_int8_lib(), f"{name}_s8"), S8_ROUTES.index(path),
                (k_scale.data_ptr(), v_scale.data_ptr()))
    return getattr(_ring_lib(), name), FWD_ROUTES.index(path), ()


def _check_state(q, heads: int, *tensors, rows_only=False):
    """The ring kernels' fp32 state: contiguous fp32 on q's device,
    [B, heads, S] (``rows_only``) or [B, heads, S, D]."""
    b, _, s, d = q.shape
    want = (b, heads, s) if rows_only else (b, heads, s, d)
    for x in tensors:
        if (x.dtype != torch.float32 or tuple(x.shape) != want
                or not x.is_contiguous() or x.device != q.device):
            raise ValueError(f"ring state {tuple(x.shape)} {x.dtype}: "
                             f"expected contiguous fp32 {want} on {q.device}")


# the ring kernels with a wgmma walk over int8 K/V (all three)
WGMMA_S8_KERNELS = ("ring_carry", "ring_bwd_dq", "ring_bwd_dkv")


def ring_route(kernel: str, q, k, v, do=None) -> str:
    """The route of ring kernel ``kernel`` (a key of ``ring_launches``):
    other K/V than int8 take :func:`fwd_route`'s rule (the carry, no
    ``do``) or :func:`bwd_route`'s; int8 K/V (the quantized wire's payloads)
    take the int8 lanes: ``"fma_s8"`` for an fp32 q, ``"wgmma_s8"`` where
    the bf16 rule says ``wgmma`` (D 64 or 128, every operand a view TMA can
    read), else ``"mma_s8"`` (D 256, an expanded view)."""
    if kernel not in ring_launches:
        raise ValueError(f"no ring kernel {kernel!r}: {sorted(ring_launches)}")
    route = fwd_route(q, k, v) if do is None else bwd_route(q, k, v, do)
    if k.dtype != torch.int8:
        return route
    if route == "wgmma" and kernel in WGMMA_S8_KERNELS:
        return "wgmma_s8"
    return "fma_s8" if route == "fma" else "mma_s8"


def _check_wire_pair(k_scale, v_scale) -> None:
    """The JAX wrappers' rule for the quantized wire's row scales: both or
    neither."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")


def _check_ring(q, k, v, do, lse, delta, k_scale, v_scale):
    """:func:`_check_cuda` for a hop; with scales, K/V are int8 payloads
    and the scales contiguous fp32 [B, Hkv, S] on q's device."""
    if k_scale is None:
        return _check_cuda(q, k, v, do, lse, delta)
    b, hkv, s = k.shape[:3]
    for x in (k_scale, v_scale):
        if (x.dtype != torch.float32 or tuple(x.shape) != (b, hkv, s)
                or not x.is_contiguous() or x.device != q.device):
            raise ValueError(f"row scales {tuple(x.shape)} {x.dtype}: "
                             f"expected contiguous fp32 {(b, hkv, s)} on "
                             f"{q.device}")
    _check_cuda(q, k, v, do, lse, delta, kv_dtype=torch.int8)


def _ring_args(q, k, pos, causal, sm_scale, window):
    b, hq, s, d = q.shape
    q_off, q_stride, k_off, k_stride = (int(x) for x in pos)
    if q_stride <= 0 or k_stride <= 0:
        raise ValueError(f"position strides must be positive, got {pos}")
    last = max(q_off + q_stride * s, k_off + k_stride * s)
    if min(q_off, k_off) < 0 or last >= 2 ** 31:
        raise ValueError(f"positions {pos} over {s} rows leave the kernels' "
                         "32-bit range")
    return (b, hq, k.shape[1], s, d, float(sm_scale), int(bool(causal)),
            int(window or 0), q_off, k_off, q_stride, k_stride,
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_carry_block(q, k, v, m, l, acc, pos, causal: bool = True,
                      sm_scale: Optional[float] = None,
                      window: Optional[int] = None, k_scale=None, v_scale=None):
    """One ring hop, forward: update the running ``m, l`` ([B, Hq, S]
    fp32) and ``acc`` ([B, Hq, S, D] fp32) against the visiting block
    ``k/v [B, Hkv, S, D]`` in place, unnormalised.  ``pos = (q_off,
    q_stride, k_off, k_stride)``: the global position of query row r is
    ``q_off + q_stride·r``, of key col c ``k_off + k_stride·c``.  CPU
    tensors take the plain version, CUDA tensors the ``ring_carry``
    kernel on :func:`ring_route`'s route (counted in ``ring_launches`` and
    ``ring_routes``).  ``k_scale``/``v_scale`` (both or neither, contiguous
    fp32 [B, Hkv, S]): ``k``/``v`` are the quantized wire's int8 payloads
    with one scale a row.  Returns ``(m, l, acc)``."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale
    _check_wire_pair(k_scale, v_scale)
    if q.device.type == "cpu":
        return ring_carry_ref(q, k, v, m, l, acc, pos, causal, scale, window,
                              k_scale, v_scale)
    _check_ring(q, k, v, None, None, None, k_scale, v_scale)
    _check_state(q, q.shape[1], m, l, rows_only=True)
    _check_state(q, q.shape[1], acc)
    path = ring_route("ring_carry", q, k, v)
    fn, code, scales = _ring_entry("ring_carry", path, k_scale, v_scale)
    err = fn(code, q.data_ptr(), k.data_ptr(), v.data_ptr(), *scales,
             m.data_ptr(), l.data_ptr(), acc.data_ptr(), _strides(q, k, v, acc),
             *_ring_args(q, k, pos, causal, scale, window))
    _raise_on(err, f"ring_carry ({path} route)")
    ring_launches["ring_carry"] += 1
    ring_routes[f"ring_carry.{path}"] += 1
    return m, l, acc


def flash_ring_dq_block(q, k, v, do, lse, delta, dq, pos, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        window: Optional[int] = None, k_scale=None,
                        v_scale=None):
    """One ring hop, backward dq side: add the hop's dq against the
    visiting block into the fp32 ``dq`` [B, Hq, S, D] in place, from the
    shard's final ``lse`` and ``delta`` ([B, Hq, S] fp32).  ``pos`` as in
    :func:`flash_carry_block`, and so are ``k_scale``/``v_scale``.  CPU
    tensors take the plain version, CUDA tensors the ``ring_bwd_dq`` kernel
    on :func:`ring_route`'s route (counted in ``ring_launches`` and
    ``ring_routes``).  Returns ``dq``."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale
    _check_wire_pair(k_scale, v_scale)
    if q.device.type == "cpu":
        return ring_bwd_dq_ref(q, k, v, do, lse, delta, dq, pos, causal,
                               scale, window, k_scale, v_scale)
    _check_ring(q, k, v, do, lse, delta, k_scale, v_scale)
    _check_state(q, q.shape[1], dq)
    path = ring_route("ring_bwd_dq", q, k, v, do)
    fn, code, scales = _ring_entry("ring_bwd_dq", path, k_scale, v_scale)
    err = fn(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), *scales,
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        _strides(q, k, v, do, dq), *_ring_args(q, k, pos, causal, scale,
                                               window))
    _raise_on(err, f"ring_bwd_dq ({path} route)")
    ring_launches["ring_bwd_dq"] += 1
    ring_routes[f"ring_bwd_dq.{path}"] += 1
    return dq


def flash_ring_dkv_block(q, k, v, do, lse, delta, dk, dv, pos,
                         causal: bool = True, sm_scale: Optional[float] = None,
                         window: Optional[int] = None, k_scale=None,
                         v_scale=None):
    """One ring hop, backward dk/dv side: add the visiting block's dk and
    dv into the traveling fp32 ``dk/dv`` [B, Hkv, S, D] in place.  ``pos``
    and ``k_scale``/``v_scale`` as in :func:`flash_carry_block`.  CPU
    tensors take the plain version, CUDA tensors the ``ring_bwd_dkv``
    kernel on :func:`ring_route`'s route (counted in ``ring_launches`` and
    ``ring_routes``).  Returns ``(dk, dv)``."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale
    _check_wire_pair(k_scale, v_scale)
    if q.device.type == "cpu":
        return ring_bwd_dkv_ref(q, k, v, do, lse, delta, dk, dv, pos, causal,
                                scale, window, k_scale, v_scale)
    _check_ring(q, k, v, do, lse, delta, k_scale, v_scale)
    _check_state(q, k.shape[1], dk, dv)
    path = ring_route("ring_bwd_dkv", q, k, v, do)
    fn, code, scales = _ring_entry("ring_bwd_dkv", path, k_scale, v_scale)
    err = fn(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), *scales,
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _strides(q, k, v, do, dk, dv),
        *_ring_args(q, k, pos, causal, scale, window))
    _raise_on(err, f"ring_bwd_dkv ({path} route)")
    ring_launches["ring_bwd_dkv"] += 1
    ring_routes[f"ring_bwd_dkv.{path}"] += 1
    return dk, dv
