"""Flash attention for training: forward and backward, GQA-native.

Port of ``deepspeed_tpu/ops/pallas/flash_mha.py`` (``flash_mha`` and its
custom VJP ``_flash_fwd_rule``/``_flash_bwd_rule``; Pallas bodies
``_fwd_kernel``/``_fwd_kernel_blocked``, ``_dq_kernel``/``_dq_kernel_blocked``
and ``_dkv_kernel``/``_dkv_kernel_blocked``).  On CUDA tensors the three
roles launch the hand-written Hopper kernels of ``ops/csrc/flash_attention.cu``
(``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``); on CPU tensors the
plain PyTorch versions below run the same tile walk.  A CUDA call never
falls back: the kernel builds and launches, or the call raises.  The
forward has routes, picked before the launch from dtype and strides
(:func:`fwd_route`, counted in ``flash_mha.routes``): bf16 views that TMA
can read take the wgmma/TMA forward (``ops/csrc/attention_wgmma.cuh``,
128-key tiles), other bf16 views and fp32 the 64 x 64 tile walk of
``ops/csrc/attention_tiles.cuh``.

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
key tiles on CPU tensors.  Each updates its fp32 state in place.

Layout contract (the JAX function's): q is ``[B, Hq, S, D]``, k/v are
``[B, Hkv, S, D]`` with Hq a multiple of Hkv; the kernels read any such
view whose last dim is contiguous (the model hands them transposed
``[B, S, H, D]`` projections, read in place).  The residual lse is plain
``[B, Hq, S]`` fp32 (the TPU's 128-lane replication, ``_lanes``, has no
reason to exist here).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

NEG_INF = -1e30
# key rows per step of the online softmax (kernel and plain version alike)
BLOCK_K = 64
HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# flash_fwd's routes by their code in ops/csrc/flash_attention.cu
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


def _check_cuda(q, k, v, do=None, lse=None, delta=None):
    """What the kernels take: CUDA tensors, fp32 or bf16, head_dim 64 or
    128, Hq a multiple of Hkv, rows readable in place; lse/delta
    contiguous fp32 [B, Hq, S]."""
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
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d}: the kernels take {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"dtype {q.dtype}: the kernels take fp32 and bf16")
    ops = [x for x in (k, v, do) if x is not None]
    for x in ops:
        if x.dtype != q.dtype or x.device != q.device:
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
    """The ``flash_fwd`` kernel's route, from dtype and strides alone:
    ``"wgmma"`` (the wgmma/TMA forward) for bf16 views TMA can read;
    ``"mma"`` (the 64 x 64 tile walk on wmma) for other bf16 views (an
    expanded K/V with a zero stride); ``"fma"`` for fp32 (the card-vs-CPU
    reference).  The operands are views the kernels take
    (:func:`_check_cuda`)."""
    if q.dtype == torch.float32:
        return "fma"
    return "wgmma" if all(_tma_readable(x) for x in (q, k, v)) else "mma"


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
    take the plain version, CUDA tensors the ``flash_bwd_dq`` kernel."""
    if q.device.type == "cpu":
        return flash_bwd_dq_ref(q, k, v, do, lse, delta, causal, sm_scale,
                                window)
    _check_cuda(q, k, v, do, lse, delta)
    dq = _empty_bshd(q, q.shape[1])
    err = _lib().flash_bwd_dq(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        _strides(q, k, v, do, dq), *_common(q, k, causal, sm_scale, window))
    _raise_on(err, "flash_bwd_dq")
    flash_mha.launches["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, sm_scale: float,
                  window: Optional[int] = None):
    """(dk, dv) from the saved lse and delta; CPU tensors take the plain
    version, CUDA tensors the ``flash_bwd_dkv`` kernel."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal, sm_scale,
                                 window)
    _check_cuda(q, k, v, do, lse, delta)
    dk, dv = _empty_bshd(k, k.shape[1]), _empty_bshd(v, k.shape[1])
    err = _lib().flash_bwd_dkv(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _strides(q, k, v, do, dk, dv),
        *_common(q, k, causal, sm_scale, window))
    _raise_on(err, "flash_bwd_dkv")
    flash_mha.launches["flash_bwd_dkv"] += 1
    return dk, dv


def flash_bwd(q, k, v, o, lse, do, causal: bool, sm_scale: float,
              window: Optional[int] = None):
    """``(dq, dk, dv)`` from the saved residuals.  ``do`` from autograd
    may come in any layout (an expanded gradient has zero strides): on the
    card it is made contiguous when the kernels cannot read it in place."""
    if do.device.type == "cuda" and not _kernel_layout_ok(do):
        do = do.contiguous()
    # the row sum over [B, S, H, D]-laid views comes out [B, S, H]-strided
    delta = attn_delta(o, do).contiguous()
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, sm_scale, window)
    return (dq, *flash_bwd_dkv(q, k, v, do, lse, delta, causal, sm_scale,
                               window))


def ring_carry_ref(q, k, v, m, l, acc, pos, causal: bool, sm_scale: float,
                   window: Optional[int] = None):
    """Plain version of ``ring_carry``: one ring hop's online-softmax update
    of the running ``m, l`` ([B, Hq, S] fp32) and ``acc`` ([B, Hq, S, D]
    fp32) against the visiting K/V block, in place, unnormalised; ``pos``:
    the hop's ``(q_off, q_stride, k_off, k_stride)``."""
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
                    sm_scale: float, window: Optional[int] = None):
    """Plain version of ``ring_bwd_dq``: adds one hop's dq, key tile by key
    tile, into the fp32 ``dq`` [B, Hq, S, D] in place."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    dq5 = dq.view(b, hkv, hq // hkv, s, d)
    for _k0, _k1, kt, _p, ds in _bwd_tiles(q, k, v, do, lse, delta, causal,
                                           sm_scale, window, None, pos):
        dq5 += torch.einsum("bhgsk,bhkd->bhgsd", ds.to(k.dtype).float(), kt)
    return dq


def ring_bwd_dkv_ref(q, k, v, do, lse, delta, dk, dv, pos, causal: bool,
                     sm_scale: float, window: Optional[int] = None):
    """Plain version of ``ring_bwd_dkv``: adds the visiting block's dk and
    dv, summed over each KV head's group, into the fp32 ``dk``/``dv``
    [B, Hkv, S, D] in place."""
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
    ``o [B, Hq, S, D]``, differentiable in q, k and v.  Kernel launches
    are counted in ``flash_mha.launches`` by kernel name."""
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive (got {window}); pass "
                         "None to disable sliding-window masking")
    scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale
    return _FlashAttention.apply(q, k, v, causal, scale, window)


flash_mha.launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
flash_mha.routes = {f"flash_fwd.{r}": 0 for r in FWD_ROUTES}


# ----------------------------------------------------------------------
# ring-attention hop wrappers (the JAX flash_carry_block /
# flash_ring_dq_block / flash_ring_dkv_block)
# ----------------------------------------------------------------------
ring_launches = {"ring_carry": 0, "ring_bwd_dq": 0, "ring_bwd_dkv": 0}


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
                      window: Optional[int] = None):
    """One ring hop, forward: update the running ``m, l`` ([B, Hq, S]
    fp32) and ``acc`` ([B, Hq, S, D] fp32) against the visiting block
    ``k/v [B, Hkv, S, D]`` in place, unnormalised.  ``pos = (q_off,
    q_stride, k_off, k_stride)``: the global position of query row r is
    ``q_off + q_stride·r``, of key col c ``k_off + k_stride·c``.  CPU
    tensors take the plain version, CUDA tensors the ``ring_carry``
    kernel.  Returns ``(m, l, acc)``."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale
    if q.device.type == "cpu":
        return ring_carry_ref(q, k, v, m, l, acc, pos, causal, scale, window)
    _check_cuda(q, k, v)
    _check_state(q, q.shape[1], m, l, rows_only=True)
    _check_state(q, q.shape[1], acc)
    err = _ring_lib().ring_carry(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        m.data_ptr(), l.data_ptr(), acc.data_ptr(), _strides(q, k, v, acc),
        *_ring_args(q, k, pos, causal, scale, window))
    _raise_on(err, "ring_carry")
    ring_launches["ring_carry"] += 1
    return m, l, acc


def flash_ring_dq_block(q, k, v, do, lse, delta, dq, pos, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        window: Optional[int] = None):
    """One ring hop, backward dq side: add the hop's dq against the
    visiting block into the fp32 ``dq`` [B, Hq, S, D] in place, from the
    shard's final ``lse`` and ``delta`` ([B, Hq, S] fp32).  ``pos`` as in
    :func:`flash_carry_block`.  CPU tensors take the plain version, CUDA
    tensors the ``ring_bwd_dq`` kernel.  Returns ``dq``."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale
    if q.device.type == "cpu":
        return ring_bwd_dq_ref(q, k, v, do, lse, delta, dq, pos, causal,
                               scale, window)
    _check_cuda(q, k, v, do, lse, delta)
    _check_state(q, q.shape[1], dq)
    err = _ring_lib().ring_bwd_dq(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        _strides(q, k, v, do, dq), *_ring_args(q, k, pos, causal, scale,
                                               window))
    _raise_on(err, "ring_bwd_dq")
    ring_launches["ring_bwd_dq"] += 1
    return dq


def flash_ring_dkv_block(q, k, v, do, lse, delta, dk, dv, pos,
                         causal: bool = True, sm_scale: Optional[float] = None,
                         window: Optional[int] = None):
    """One ring hop, backward dk/dv side: add the visiting block's dk and
    dv into the traveling fp32 ``dk/dv`` [B, Hkv, S, D] in place.  ``pos``
    as in :func:`flash_carry_block`.  CPU tensors take the plain version,
    CUDA tensors the ``ring_bwd_dkv`` kernel.  Returns ``(dk, dv)``."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale
    if q.device.type == "cpu":
        return ring_bwd_dkv_ref(q, k, v, do, lse, delta, dk, dv, pos, causal,
                                scale, window)
    _check_cuda(q, k, v, do, lse, delta)
    _check_state(q, k.shape[1], dk, dv)
    err = _ring_lib().ring_bwd_dkv(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _strides(q, k, v, do, dk, dv),
        *_ring_args(q, k, pos, causal, scale, window))
    _raise_on(err, "ring_bwd_dkv")
    ring_launches["ring_bwd_dkv"] += 1
    return dk, dv
