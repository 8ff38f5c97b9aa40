"""Paged (block-table) attention for the ragged serving forward.

Port of ``deepspeed_tpu/ops/pallas/paged_attention.py``
(``paged_decode_attention``; Pallas bodies ``_kernel`` and
``_kernel_quant``).  On a CUDA tensor the wrapper launches the hand-written
Hopper kernel in ``ops/csrc/paged_attention.cu``; on a CPU tensor it runs
:func:`paged_decode_attention_ref`, the plain PyTorch version of the same
function with the same rounding points.  A CUDA call never falls back:
the kernel builds and launches, or the call raises.

The kernel splits each token's pages over ``splits`` blocks
(:func:`split_plan`) and merges their partial states
(:func:`merge_partials`); :func:`paged_decode_attention_split_ref` is
that split-then-merge computation in plain PyTorch.  Its route is chosen
before the launch (:func:`route`, on the kernel's own :func:`plan`):
``mma`` (tensor cores) for bf16 queries over bf16 or int8 pages, ``fma``
(CUDA cores) for fp32 queries or pages and other geometries;
``paged_decode_attention.routes`` counts the launches by route.

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
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# the kernel's routes, by C route code
ROUTES = ("fma", "mma")
# split_plan: blocks an SM a call aims at, by kernel and route (the fma
# walk is issue-bound and gains from blocks in flight up to ~16 an SM; the
# bf16 mma walk keeps two pages in flight a warp and gains nothing from
# splitting once every SM has a block; the int8 mma walk, at 255 registers
# two blocks an SM, gains up to ~4; chip_smoke.py's paged kernel phase
# times them), pages a split at least, and splits at most
SPLIT_BLOCKS_PER_SM = {"paged_attention.fma": 16, "paged_attention.mma": 1,
                       "paged_attention_int8.fma": 16,
                       "paged_attention_int8.mma": 4}
SPLIT_MIN_PAGES = 4
MAX_SPLITS = 64


def supports(block_size: int, d: int) -> bool:
    """Kernel applicability: page rows must be sublane-aligned (the JAX
    package's rule, kept so the registry picks the same path)."""
    return block_size >= 8 and block_size % 8 == 0


def _window_lo(token_pos, block_size: int, window: Optional[int]):
    if window is None:
        return torch.zeros_like(token_pos)
    return torch.clamp(torch.div(token_pos - (window - 1), block_size,
                                 rounding_mode="floor"), min=0)


def _walk(q, k_pages, v_pages, pages, token_pos, token_ctx_len, bs: int,
          sm_scale: float, window, k_scales, v_scales, j_from, j_to):
    """The TPU kernel's page walk with online softmax, vectorised over
    tokens and heads, over pages ``j_from[t] <= j < j_to[t]`` of each
    token: the unnormalised state ``(m, l, acc)``, ``[T, nkv, g, 1]``
    twice and ``[T, nkv, g, d]``, fp32 (``-1e30``, 0, 0 where no page is
    walked)."""
    t, nh, d = q.shape
    nkv = k_pages.shape[0]
    g = nh // nkv
    quant = k_scales is not None
    dev = q.device
    qg = q.reshape(t, nkv, g, d).float()
    pos = token_pos.long()
    clen = token_ctx_len.long()
    r = torch.arange(bs, device=dev)
    m = torch.full((t, nkv, g, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((t, nkv, g, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((t, nkv, g, d), dtype=torch.float32, device=dev)
    for j in range(pages.shape[1]):
        live = ((j >= j_from) & (j < j_to))[:, None, None, None]
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
    return m, l, acc


def _span(token_pos, block_size: int, window: Optional[int], nb: int):
    """Each token's live pages ``[j_lo, j_hi)``, as the kernel computes
    them (``j_hi`` at most the table's width)."""
    pos = token_pos.long()
    return (_window_lo(pos, block_size, window),
            torch.clamp(pos // block_size + 1, max=nb))


def paged_decode_attention_ref(q, k_pages, v_pages, pages, token_pos,
                               token_ctx_len, block_size: int,
                               sm_scale: float, window: Optional[int] = None,
                               k_scales=None, v_scales=None):
    """Plain PyTorch version: the TPU kernel's page walk with online
    softmax, vectorised over tokens and heads.  Page ``j`` of token ``t``
    is live for ``j_lo[t] <= j <= pos[t] // block_size``; the (m, l, acc)
    state of a token only advances on its live pages."""
    t, nh, d = q.shape
    j_lo, j_hi = _span(token_pos, block_size, window, pages.shape[1])
    _, l, acc = _walk(q, k_pages, v_pages, pages, token_pos, token_ctx_len,
                      block_size, sm_scale, window, k_scales, v_scales,
                      j_lo, j_hi)
    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    return (acc / safe_l).to(q.dtype).reshape(t, nh, d)


def split_ranges(token_pos, block_size: int, window: Optional[int], nb: int,
                 splits: int):
    """The pages split ``s`` of each token walks, as the kernel's grid
    assigns them: ``[j_lo + s·c, min(j_lo + (s+1)·c, j_hi))`` with ``c =
    ceil(span / splits)``, empty where the span is shorter.  A list of
    ``(j_from, j_to)`` [T] pairs, one a split."""
    j_lo, j_hi = _span(token_pos, block_size, window, nb)
    span = torch.clamp(j_hi - j_lo, min=0)
    chunk = torch.div(span + splits - 1, splits, rounding_mode="floor")
    out = []
    for s in range(splits):
        lo = j_lo + s * chunk
        out.append((lo, torch.minimum(lo + chunk, j_hi)))
    return out


def merge_partials(m, l, acc):
    """Merges split states ``m, l`` [S, ...,  1] and ``acc`` [S, ..., d]
    (unnormalised) into the attention output, as
    ``paged_attention_merge_kernel`` does: ``M = max m_s``, ``w_s =
    exp(m_s - M)``, ``sum w_s acc_s / safe(sum w_s l_s)`` with safe(0) = 1.
    A split whose every score was masked holds ``m = -1e30``: beside a live
    split it weighs 0, beside only masked ones 1 (their average, as the
    sequential walk gives); an empty split holds ``l = 0``, ``acc = 0``."""
    big = m.amax(dim=0, keepdim=True)
    w = torch.exp(m - big)
    den = (w * l).sum(dim=0)
    safe = torch.where(den > 0, den, torch.ones_like(den))
    return (w * acc).sum(dim=0) / safe


def paged_decode_attention_split_ref(q, k_pages, v_pages, pages, token_pos,
                                     token_ctx_len, block_size: int,
                                     sm_scale: float, splits: int,
                                     window: Optional[int] = None,
                                     k_scales=None, v_scales=None):
    """Plain split-then-merge version of the kernel: the page walk over
    each split's pages (:func:`split_ranges`), then :func:`merge_partials`.
    Equals :func:`paged_decode_attention_ref` up to where p is rounded (the
    split's running max instead of the whole walk's) and summation order."""
    t, nh, d = q.shape
    parts = [_walk(q, k_pages, v_pages, pages, token_pos, token_ctx_len,
                   block_size, sm_scale, window, k_scales, v_scales, lo, hi)
             for lo, hi in split_ranges(token_pos, block_size, window,
                                        pages.shape[1], splits)]
    m, l, acc = (torch.stack(x) for x in zip(*parts))
    return merge_partials(m, l, acc).to(q.dtype).reshape(t, nh, d)


def plan(path: str, q_dtype, kv_dtype, d: int, group: int, block_size: int,
         nb: int, splits: int = 1):
    """The kernel's launch plan on route ``path`` for a call of these dtypes
    and shapes (a table ``nb`` pages wide over ``splits`` blocks), from
    ``paged_attention_plan`` in ops/csrc/paged_attention.cu, where the
    routes' rules and shared-memory layouts live: ``(sub, el, smem)``, the
    fma walk's lanes a query head and elements a lane (0 on ``mma``) and
    the dynamic shared memory; None if the route cannot take the call."""
    sub, el, smem = _I(), _I(), _I()
    err = _lib().paged_attention_plan(
        ROUTES.index(path), _DTYPE_CODE[q_dtype], _KV_CODE[kv_dtype], d, group,
        block_size, nb, splits, ctypes.byref(sub), ctypes.byref(el),
        ctypes.byref(smem))
    return None if err else (sub.value, el.value, smem.value)


def route(q, k_pages, block_size: int, nb: int) -> str:
    """The kernel's route, before the launch: ``"mma"`` (mma.sync over
    pages TMA loads) where :func:`plan` says it takes the call (bf16
    queries over bf16 pages at head_dim 64 or 128 or over int8 pages at
    head_dim 128, a group of at most 16 query heads, pages of a multiple
    of 16 rows whose ring fits shared memory at one split, the most a
    split can need), ``"fma"`` (the lane walk on CUDA cores) otherwise:
    fp32 queries or pages, other geometries."""
    fits = plan("mma", q.dtype, k_pages.dtype, q.shape[2],
                q.shape[1] // k_pages.shape[0], block_size, nb)
    return "mma" if fits else "fma"


def split_plan(t: int, nkv: int, nb: int, sms: int, kernel: str) -> int:
    """Blocks a (token, KV head) pair for ``kernel`` (a
    ``paged_decode_attention.routes`` key: kernel name and route): enough
    for SPLIT_BLOCKS_PER_SM[kernel] blocks an SM over the call's ``t·nkv``
    pairs, at most one a SPLIT_MIN_PAGES pages of the table (``nb`` pages
    wide) and MAX_SPLITS; at least 1.  A call whose pairs already reach
    the aim takes 1."""
    want = -(-SPLIT_BLOCKS_PER_SM[kernel] * sms // max(t * nkv, 1))
    return max(1, min(want, -(-nb // SPLIT_MIN_PAGES), MAX_SPLITS))


def _check(q, k_pages, v_pages, pages, token_pos, token_ctx_len, bs,
           k_scales, v_scales):
    t, nh, d = q.shape
    nkv = k_pages.shape[0]
    quant = k_scales is not None
    if (v_scales is None) != (k_scales is None):
        raise ValueError("k_scales and v_scales come together")
    if nh % nkv:
        raise ValueError(f"{nh} query heads do not group over {nkv} KV heads")
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
            or k_pages.shape[1] % bs or not supports(bs, d):
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
    tensors = [q, k_pages, v_pages, pages, token_pos, token_ctx_len]
    if quant:
        tensors += [k_scales, v_scales]
    for a in tensors:
        if a.device != q.device:
            raise ValueError("all inputs must be on one device")
        if not a.is_contiguous():
            raise ValueError("all inputs must be contiguous")
    if any(a.data_ptr() % 16 for a in tensors[1:3] + tensors[6:]):
        raise ValueError("page pools and scales must be 16-byte aligned")


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib():
    from deepspeed_tpu_torch.ops import op_builder

    lib = op_builder.load("paged_attention")
    if not getattr(lib, "_bound", False):
        # ..., t, nh, nkv, p_rows, nb, d, bs, scale, window, splits, stream
        shape = [_I] * 7 + [_F] + [_I] * 2 + [_P]
        lib.paged_attention_fwd.argtypes = [_I, _I, _I] + [_P] * 9 + shape
        lib.paged_attention_fwd.restype = _I
        lib.paged_attention_int8_fwd.argtypes = [_I, _I] + [_P] * 11 + shape
        lib.paged_attention_int8_fwd.restype = _I
        lib.paged_attention_plan.argtypes = [_I] * 8 + [ctypes.POINTER(_I)] * 3
        lib.paged_attention_plan.restype = _I
        lib._bound = True
    return lib


_SMS = {}


def _sm_count(device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


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
    in ``paged_decode_attention.launches`` by kernel name and in
    ``paged_decode_attention.routes`` by route (:func:`route`), its pages
    split over :func:`split_plan`'s blocks a (token, KV head); a call of
    more than one split also launches the merge kernel, counted in
    ``paged_decode_attention.merges``."""
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
    nb = pages.shape[1]
    out = torch.empty_like(q)
    if t == 0:
        return out
    path = route(q, k_pages, block_size, nb)
    name = "paged_attention" if k_scales is None else "paged_attention_int8"
    splits = split_plan(t, nkv, nb, _sm_count(q.device), f"{name}.{path}")
    if plan(path, q.dtype, k_pages.dtype, d, nh // nkv, block_size, nb,
            splits) is None:
        raise ValueError(f"{name}: no route of the kernel takes group "
                         f"{nh // nkv}, head_dim {d}, block_size "
                         f"{block_size} over {k_pages.dtype} pages")
    part_ml = part_acc = None
    if splits > 1:     # the splits' partial states, merged by the kernel
        part_ml = torch.empty((t, nh, splits, 2), dtype=torch.float32,
                              device=q.device)
        part_acc = torch.empty((t, nh, splits, d), dtype=torch.float32,
                               device=q.device)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    common = (pages.data_ptr(), token_pos.data_ptr(),
              token_ctx_len.data_ptr(), out.data_ptr(),
              *(None if x is None else x.data_ptr()
                for x in (part_ml, part_acc)),
              t, nh, nkv, p_rows, nb, d, block_size, float(sm_scale),
              int(window or 0), splits, stream)
    if k_scales is not None:
        err = lib.paged_attention_int8_fwd(
            ROUTES.index(path), _DTYPE_CODE[q.dtype], q.data_ptr(),
            k_pages.data_ptr(),
            v_pages.data_ptr(), k_scales.data_ptr(), v_scales.data_ptr(),
            *common)
    else:
        err = lib.paged_attention_fwd(
            ROUTES.index(path), _DTYPE_CODE[q.dtype],
            _DTYPE_CODE[k_pages.dtype], q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), *common)
    if err:
        raise RuntimeError(f"{name} kernel launch failed ({path} route): "
                           f"CUDA error {err}")
    paged_decode_attention.launches[name] += 1
    paged_decode_attention.routes[f"{name}.{path}"] += 1
    if splits > 1:
        paged_decode_attention.merges[name] += 1
    return out


paged_decode_attention.launches = {"paged_attention": 0,
                                   "paged_attention_int8": 0}
# launches by route (codes in ops/csrc/paged_attention.cu)
paged_decode_attention.routes = {f"{n}.{r}": 0
                                 for n in paged_decode_attention.launches
                                 for r in ROUTES}
# merge kernel launches (calls of more than one split), by kernel name
paged_decode_attention.merges = dict.fromkeys(paged_decode_attention.launches,
                                              0)
