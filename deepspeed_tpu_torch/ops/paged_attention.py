"""Paged (block-table) attention for the ragged serving forward.

Port of ``deepspeed_tpu/ops/pallas/paged_attention.py``
(``paged_decode_attention``; Pallas bodies ``_kernel`` and
``_kernel_quant``).  On a CUDA tensor the wrapper launches the hand-written
Hopper kernel in ``ops/csrc/paged_attention.cu``; on a CPU tensor it runs
:func:`paged_decode_attention_ref`, the plain PyTorch version of the same
function with the same rounding points.  A CUDA call never falls back:
the kernel builds and launches, or the call raises.

Cache layout contract: ``k_pages``/``v_pages`` are ``[nkv, P, d]`` where P
is the number of pages × ``block_size`` rows; ``pages[t, j]`` gives page
ids; positions ``c = j*block_size + r`` are masked against the token's
causal position and its sequence's context length.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

NEG_INF = -1e30
_THREADS = 128
_MAX_ACC_PER_THREAD = 8
_MAX_SMEM = 232448
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def supports(block_size: int, d: int) -> bool:
    """Kernel applicability: page rows must be sublane-aligned (the JAX
    package's rule, kept so the registry picks the same path)."""
    return block_size >= 8 and block_size % 8 == 0


def _window_lo(token_pos, block_size: int, window: Optional[int]):
    if window is None:
        return torch.zeros_like(token_pos)
    return torch.clamp(torch.div(token_pos - (window - 1), block_size,
                                 rounding_mode="floor"), min=0)


def paged_decode_attention_ref(q, k_pages, v_pages, pages, token_pos,
                               token_ctx_len, block_size: int,
                               sm_scale: float, window: Optional[int] = None,
                               k_scales=None, v_scales=None):
    """Plain PyTorch version: the TPU kernel's page walk with online
    softmax, vectorised over tokens and heads.  Page ``j`` of token ``t``
    is live for ``j_lo[t] <= j <= pos[t] // block_size``; the (m, l, acc)
    state of a token only advances on its live pages."""
    t, nh, d = q.shape
    nkv = k_pages.shape[0]
    g = nh // nkv
    bs = block_size
    quant = k_scales is not None
    dev = q.device
    qg = q.reshape(t, nkv, g, d).float()
    pos = token_pos.long()
    clen = token_ctx_len.long()
    j_lo = _window_lo(pos, bs, window)
    j_hi = pos // bs + 1
    r = torch.arange(bs, device=dev)
    m = torch.full((t, nkv, g, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((t, nkv, g, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((t, nkv, g, d), dtype=torch.float32, device=dev)
    for j in range(pages.shape[1]):
        live = ((j >= j_lo) & (j < j_hi))[:, None, None, None]
        rows = pages[:, j].long()[:, None] * bs + r           # [T, bs]
        k = k_pages[:, rows].float()                           # [nkv, T, bs, d]
        v = v_pages[:, rows].float()
        s = torch.einsum("tkgd,ktbd->tkgb", qg, k)
        if quant:
            col = sm_scale * k_scales[:, rows].float()         # [nkv, T, bs]
            s = s * col.permute(1, 0, 2)[:, :, None, :]
        else:
            s = s * sm_scale
        c = j * bs + r
        valid = (c[None, :] <= pos[:, None]) & (c[None, :] < clen[:, None])
        if window is not None:
            valid &= pos[:, None] - c[None, :] < window
        s = torch.where(valid[:, None, None, :], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l_new = l * alpha + p.sum(dim=-1, keepdim=True)
        if quant:
            p = p * v_scales[:, rows].float().permute(1, 0, 2)[:, :, None, :]
        else:
            p = p.to(v_pages.dtype).float()   # TPU kernel: p.astype(v.dtype)
        acc_new = acc * alpha + torch.einsum("tkgb,ktbd->tkgd", p, v)
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live, acc_new, acc)
    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    return (acc / safe_l).to(q.dtype).reshape(t, nh, d)


def _check(q, k_pages, v_pages, pages, token_pos, token_ctx_len, bs,
           k_scales, v_scales):
    t, nh, d = q.shape
    nkv = k_pages.shape[0]
    quant = k_scales is not None
    if (v_scales is None) != (k_scales is None):
        raise ValueError("k_scales and v_scales come together")
    if nh % nkv:
        raise ValueError(f"{nh} query heads do not group over {nkv} KV heads")
    if (nh // nkv) * d > _THREADS * _MAX_ACC_PER_THREAD:
        raise ValueError(f"group*d = {(nh // nkv) * d} exceeds the kernel's "
                         f"{_THREADS * _MAX_ACC_PER_THREAD}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} (kernel takes fp32/bf16)")
    if quant:
        if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
            raise TypeError("scaled pages must be int8")
        for s in (k_scales, v_scales):
            if s.dtype != torch.float32 or s.shape != k_pages.shape[:2]:
                raise TypeError("scales must be fp32 [nkv, P]")
    elif (k_pages.dtype not in _DTYPE_CODE or v_pages.dtype != k_pages.dtype
          or (q.dtype == torch.bfloat16 and k_pages.dtype != torch.bfloat16)):
        raise TypeError(f"unsupported q/page dtypes {q.dtype}/"
                        f"{k_pages.dtype} (fp32/fp32, fp32/bf16, bf16/bf16)")
    if k_pages.shape != v_pages.shape or k_pages.shape[2] != d \
            or k_pages.shape[1] % bs:
        raise ValueError(f"pages {tuple(k_pages.shape)} do not match "
                         f"q {tuple(q.shape)} and block_size {bs}")
    if pages.dtype != torch.int32 or pages.dim() != 2 or pages.shape[0] != t:
        raise TypeError("pages must be int32 [T, NB]")
    for a in (token_pos, token_ctx_len):
        if a.dtype != torch.int32 or a.shape != (t,):
            raise TypeError("token_pos/token_ctx_len must be int32 [T]")
    page_bytes = bs * d * k_pages.element_size()
    if page_bytes % 16:
        raise ValueError(f"a page of {page_bytes} bytes is not a whole "
                         "number of 16-byte vectors")
    smem = 2 * page_bytes + 4 * ((nh // nkv) * (d + bs + 3) + 2 * bs)
    if smem > _MAX_SMEM:
        raise ValueError(f"{smem} bytes of shared memory exceed the card's")
    tensors = [q, k_pages, v_pages, pages, token_pos, token_ctx_len]
    if quant:
        tensors += [k_scales, v_scales]
    for a in tensors:
        if a.device != q.device:
            raise ValueError("all inputs must be on one device")
        if not a.is_contiguous():
            raise ValueError("all inputs must be contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("page pools must be 16-byte aligned")


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib():
    from deepspeed_tpu_torch.ops import op_builder

    lib = op_builder.load("paged_attention")
    if not getattr(lib, "_bound", False):
        lib.paged_attention_fwd.argtypes = [_I, _I] + [_P] * 7 + [_I] * 7 \
            + [_F, _I, _P]
        lib.paged_attention_fwd.restype = _I
        lib.paged_attention_int8_fwd.argtypes = [_I] + [_P] * 9 \
            + [_I] * 7 + [_F, _I, _P]
        lib.paged_attention_int8_fwd.restype = _I
        lib._bound = True
    return lib


def paged_decode_attention(q, k_pages, v_pages, pages, token_pos,
                           token_ctx_len, block_size: int, sm_scale: float,
                           window: Optional[int] = None,
                           k_scales=None, v_scales=None):
    """q: [T, nh, d]; k_pages/v_pages: [nkv, P, d]; pages: [T, NB] int32
    page ids per token; token_pos/token_ctx_len: [T] int32; ``window``:
    sliding window (key visible iff qpos - kpos < window).  With
    ``k_scales``/``v_scales`` [nkv, P] fp32 the pages are int8 rows scaled
    per (head, row).  Returns [T, nh, d] in q's dtype.

    CPU tensors take the plain version; CUDA tensors the kernel, counted
    in ``paged_decode_attention.launches`` by kernel name."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(
            q, k_pages, v_pages, pages, token_pos, token_ctx_len, block_size,
            sm_scale, window, k_scales, v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for device "
                         f"{q.device}")
    _check(q, k_pages, v_pages, pages, token_pos, token_ctx_len, block_size,
           k_scales, v_scales)
    t, nh, d = q.shape
    nkv, p_rows = k_pages.shape[0], k_pages.shape[1]
    out = torch.empty_like(q)
    if t == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    common = (pages.data_ptr(), token_pos.data_ptr(),
              token_ctx_len.data_ptr(), out.data_ptr(), t, nh, nkv, p_rows,
              pages.shape[1], d, block_size, float(sm_scale),
              int(window or 0), stream)
    if k_scales is not None:
        name = "paged_attention_int8"
        err = lib.paged_attention_int8_fwd(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), k_scales.data_ptr(), v_scales.data_ptr(),
            *common)
    else:
        name = "paged_attention"
        err = lib.paged_attention_fwd(
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pages.dtype], q.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), *common)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    paged_decode_attention.launches[name] += 1
    return out


paged_decode_attention.launches = {"paged_attention": 0,
                                   "paged_attention_int8": 0}
