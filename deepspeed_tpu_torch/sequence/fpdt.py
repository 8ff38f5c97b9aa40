"""FPDT — fully pipelined distributed transformer for multi-million-token
contexts.

Port of ``deepspeed_tpu/sequence/fpdt.py`` (the reference's
Ulysses-Offload stack, ``deepspeed/sequence/fpdt_layer.py``:
``FPDT_Attention`` :971, chunk offloading :510, chunked FFN :1056).
Attention streams over sequence chunks, so its live memory is one
(query chunk, K/V chunk) pair's instead of the whole sequence's.

* :func:`chunked_attention` on CPU tensors is the JAX function's plain
  version: an online softmax over K/V chunks for each query chunk, GQA
  native, rows with no visible key guarded, differentiated by autograd.
* On CUDA tensors each live (query chunk, K/V chunk) pair is one launch
  of the ring's carry kernel (``flash_mha.flash_carry_block``, with the
  pair's global offsets in place of a hop's), and the backward — a
  ``torch.autograd.Function`` that saves (q, o, lse) — launches
  ``flash_ring_dq_block`` and ``flash_ring_dkv_block`` once per live
  pair: the ring's contract with the hop replaced by a chunk.  A pair
  wholly in the causal future launches nothing, so ``n`` causal chunks
  launch ``n·(n+1)/2`` of each kernel.
* ``offload_kv`` parks the K/V chunks in pinned host memory (FPDT's host
  parking, the role of the JAX ``_park_on_host``/``_fetch_from_host``):
  each pair's chunks are copied back on a side stream one pair ahead of
  their use, and each copy is handed to the compute stream through an
  event and ``record_stream``, so no chunk is freed while a kernel reads
  it.
* :class:`FPDTAttention` is Ulysses' all-to-all around
  :func:`chunked_attention`.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch

from deepspeed_tpu_torch.ops import flash_mha as fm
from deepspeed_tpu_torch.parallel.topology import get_topology
from deepspeed_tpu_torch.sequence.alst import tiled_mlp
from deepspeed_tpu_torch.sequence.layer import DistributedAttention


def _n_chunks(s: int, chunk: int) -> int:
    if s % chunk != 0:
        raise ValueError(f"sequence length {s} not divisible by chunk {chunk}")
    return s // chunk


def _plain_chunked_attention(q, k, v, chunk: int, causal: bool,
                             sm_scale: float):
    """The JAX ``chunked_attention`` over [B, S, H, D] tensors: for each
    query chunk, an online softmax over every K/V chunk (masked, not
    skipped), in fp32."""
    b, s, nh, d = q.shape
    nkv = k.shape[2]
    grp = nh // nkv
    n = _n_chunks(s, chunk)
    neg_inf = torch.finfo(torch.float32).min
    kf, vf = k.float(), v.float()
    outs = []
    for i in range(n):
        q_i = (q[:, i * chunk:(i + 1) * chunk].float() * sm_scale).reshape(
            b, chunk, nkv, grp, d)
        m = torch.full((b, nkv, grp, chunk), neg_inf, device=q.device)
        l = torch.zeros((b, nkv, grp, chunk), device=q.device)
        acc = torch.zeros((b, nkv, grp, chunk, d), device=q.device)
        for j in range(n):
            k_j = kf[:, j * chunk:(j + 1) * chunk]
            v_j = vf[:, j * chunk:(j + 1) * chunk]
            sc = torch.einsum("bqhgd,bkhd->bhgqk", q_i, k_j)
            if causal:
                qpos = i * chunk + torch.arange(chunk, device=q.device)
                kpos = j * chunk + torch.arange(chunk, device=q.device)
                sc = torch.where(qpos[:, None] >= kpos[None, :], sc, neg_inf)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            # guard fully-masked rows against exp(-inf - -inf)
            p = torch.exp(sc - m_new[..., None])
            p = torch.where(torch.isfinite(m_new)[..., None], p, 0.0)
            alpha = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd",
                                                        p, v_j)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, chunk, nh, d))
    return torch.cat(outs, dim=1).to(q.dtype)


def _live_pairs(n: int, causal: bool):
    """The (query chunk, K/V chunk) pairs that attend, query-major."""
    return [(i, j) for i in range(n) for j in range(n)
            if not (causal and j > i)]


class _KVChunks:
    """The K/V chunks ``[B, Hkv, C, D]`` of one call, as the pairs read
    them: views of the device K/V, or with ``offload`` copies parked in
    host memory (pinned for CUDA tensors) and fetched back one pair ahead
    on a side stream."""

    def __init__(self, parts, device, offload: bool):
        self.parts, self.device, self.offload = parts, device, offload
        self.cuda = device.type == "cuda"

    @classmethod
    def of(cls, k, v, chunk: int, offload: bool) -> "_KVChunks":
        """The chunks of ``k``/``v`` ([B, Hkv, S, D] views), parked in host
        memory with ``offload``."""
        cuda = k.is_cuda

        def park(x):
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=cuda)
            host.copy_(x, non_blocking=cuda)
            return host

        parts = [(k[:, :, j * chunk:(j + 1) * chunk],
                  v[:, :, j * chunk:(j + 1) * chunk])
                 for j in range(k.shape[2] // chunk)]
        if offload:
            parts = [(park(kc), park(vc)) for kc, vc in parts]
        return cls(parts, k.device, offload)

    def host_tensors(self):
        return [x for kv in self.parts for x in kv] if self.offload else []

    def walk(self, pairs):
        """Yield ``(i, j, k_j, v_j)`` for each pair, the chunks on the
        device and safe to read on the current stream."""
        if not (self.offload and self.cuda):
            for i, j in pairs:
                yield (i, j) + self.parts[j]
            return
        side = torch.cuda.Stream(self.device)
        main = torch.cuda.current_stream(self.device)
        side.wait_stream(main)        # the parking copies are queued there

        def fetch(j):
            with torch.cuda.stream(side):
                kv = tuple(x.to(self.device, non_blocking=True)
                           for x in self.parts[j])
                ready = torch.cuda.Event()
                ready.record(side)
            return kv, ready

        ahead = fetch(pairs[0][1]) if pairs else None
        for n_, (i, j) in enumerate(pairs):
            (k_j, v_j), ready = ahead
            if n_ + 1 < len(pairs):
                ahead = fetch(pairs[n_ + 1][1])
            main.wait_event(ready)
            for x in (k_j, v_j):
                x.record_stream(main)
            yield i, j, k_j, v_j


def _sliced(x, n: int, chunk: int):
    """[B, H, S, D] (or [B, H, S]) -> chunk views along S."""
    return [x[:, :, i * chunk:(i + 1) * chunk] for i in range(n)]


def _rows(x, n: int, chunk: int):
    """[B, H, S] fp32 -> contiguous [n, B, H, chunk] (each chunk's rows
    as the kernels take them)."""
    b, h, _ = x.shape
    return x.reshape(b, h, n, chunk).permute(2, 0, 1, 3).contiguous()


def _chunk_fwd(qk, kv: _KVChunks, n: int, chunk: int, causal: bool,
               scale: float):
    """o [B, Hq, S, D] (as a view of [B, S, Hq, D]) and lse [n, B, Hq, C]
    over the live pairs."""
    b, hq, s, d = qk.shape
    dev = qk.device
    o = torch.empty((b, s, hq, d), dtype=qk.dtype, device=dev).transpose(1, 2)
    lse = torch.empty((n, b, hq, chunk), dtype=torch.float32, device=dev)
    q_chunks = _sliced(qk, n, chunk)
    state = None
    for i, j, k_j, v_j in kv.walk(_live_pairs(n, causal)):
        if state is None or state[0] != i:
            state = (i, torch.full((b, hq, chunk), fm.NEG_INF,
                                   dtype=torch.float32, device=dev),
                     torch.zeros((b, hq, chunk), dtype=torch.float32,
                                 device=dev),
                     torch.zeros((b, hq, chunk, d), dtype=torch.float32,
                                 device=dev))
        _, m, l, acc = state
        fm.flash_carry_block(q_chunks[i], k_j, v_j, m, l, acc,
                             (i * chunk, 1, j * chunk, 1), causal=causal,
                             sm_scale=scale)
        if j == (i if causal else n - 1):    # the query chunk's last pair
            safe = torch.clamp(l, min=1e-20)
            o[:, :, i * chunk:(i + 1) * chunk] = acc / safe[..., None]
            lse[i] = m + torch.log(safe)
    return o, lse


def _chunk_bwd(qk, kv: _KVChunks, ok, lse, dok, n: int, chunk: int,
               causal: bool, scale: float, hkv: int):
    """fp32 (dq, dk, dv) as [n, B, H, C, D] chunk stacks."""
    b, hq, s, d = qk.shape
    dev = qk.device
    delta = _rows(fm.attn_delta(ok, dok), n, chunk)
    dq = torch.zeros((n, b, hq, chunk, d), dtype=torch.float32, device=dev)
    dk = torch.zeros((n, b, hkv, chunk, d), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    q_chunks, do_chunks = _sliced(qk, n, chunk), _sliced(dok, n, chunk)
    for i, j, k_j, v_j in kv.walk(_live_pairs(n, causal)):
        pos = (i * chunk, 1, j * chunk, 1)
        fm.flash_ring_dq_block(q_chunks[i], k_j, v_j, do_chunks[i], lse[i],
                               delta[i], dq[i], pos, causal=causal,
                               sm_scale=scale)
        fm.flash_ring_dkv_block(q_chunks[i], k_j, v_j, do_chunks[i], lse[i],
                                delta[i], dk[j], dv[j], pos, causal=causal,
                                sm_scale=scale)
    return dq, dk, dv


def _unchunk(x):
    """[n, B, H, C, D] -> [B, n·C, H, D]."""
    n, b, h, c, d = x.shape
    return x.permute(1, 0, 3, 2, 4).reshape(b, n * c, h, d)


class _ChunkedAttention(torch.autograd.Function):
    """Chunked attention on the ring's hop kernels (module docstring): the
    forward saves (q, o, lse) and the K/V chunks (host copies under
    ``offload_kv``); the backward walks the live pairs again."""

    @staticmethod
    def forward(ctx, q, k, v, chunk, causal, scale, offload_kv):
        n = _n_chunks(q.shape[1], chunk)
        qk, kk, vk = (x.transpose(1, 2) for x in (q, k, v))
        kv = _KVChunks.of(kk, vk, chunk, offload_kv)
        ok, lse = _chunk_fwd(qk, kv, n, chunk, causal, scale)
        if offload_kv:
            ctx.save_for_backward(q, ok, lse, *kv.host_tensors())
        else:
            ctx.save_for_backward(q, ok, lse, k, v)
        ctx.attn = (n, chunk, causal, scale, offload_kv, k.shape[2])
        return ok.transpose(1, 2)

    @staticmethod
    def backward(ctx, do):
        n, chunk, causal, scale, offload_kv, hkv = ctx.attn
        q, ok, lse, *rest = ctx.saved_tensors
        if offload_kv:
            kv = _KVChunks([tuple(rest[2 * j:2 * j + 2]) for j in range(n)],
                           q.device, True)
        else:
            k, v = rest
            kv = _KVChunks.of(k.transpose(1, 2), v.transpose(1, 2), chunk,
                              False)
        dtype = rest[0].dtype
        dok = do.transpose(1, 2)
        if dok.is_cuda and not fm._kernel_layout_ok(dok):
            dok = dok.contiguous()
        dq, dk, dv = _chunk_bwd(q.transpose(1, 2), kv, ok, lse, dok, n,
                                chunk, causal, scale, hkv)
        return (_unchunk(dq).to(q.dtype), _unchunk(dk).to(dtype),
                _unchunk(dv).to(dtype), None, None, None, None)


def _hop_chunked_attention(q, k, v, chunk: int, causal: bool, scale: float,
                           offload_kv: bool):
    """The kernel path over [B, S, H, D] (on CPU tensors the hop wrappers
    run their plain versions)."""
    return _ChunkedAttention.apply(q, k, v, chunk, causal, scale, offload_kv)


def chunked_attention(q, k, v, chunk_size: int, causal: bool = True,
                      sm_scale: Optional[float] = None,
                      offload_kv: bool = False):
    """Streaming attention over sequence chunks (ref FPDT_Attention,
    fpdt_layer.py:971).

    q/k/v: [B, S, H, D] (KV heads may divide query heads: GQA-native, K/V
    never repeated); S divisible by ``chunk_size``.  Returns [B, S, H, D],
    differentiable in q, k and v.  CPU tensors take the plain version
    (``offload_kv`` a no-op there, as on the JAX package's CPU backend),
    CUDA tensors the hop kernels (module docstring); a head dim off the
    kernels' lanes is zero-padded to its lane."""
    d = q.shape[-1]
    scale = d ** -0.5 if sm_scale is None else sm_scale
    nh, nkv = q.shape[2], k.shape[2]
    if nh % nkv != 0:
        raise ValueError(f"query heads {nh} not a multiple of kv heads {nkv}")
    _n_chunks(q.shape[1], chunk_size)
    if not q.is_cuda:
        return _plain_chunked_attention(q, k, v, chunk_size, causal, scale)
    attn = partial(_hop_chunked_attention, chunk=chunk_size, causal=causal,
                   scale=float(scale), offload_kv=offload_kv)
    return fm.head_dim_padded(attn, q, k, v)


def chunked_ffn(fn, x, num_chunks: int, remat: bool = True):
    """Apply a feed-forward callable over sequence chunks in turn (ref
    chunked FFN, fpdt_layer.py:1056): :func:`~deepspeed_tpu_torch.sequence.
    alst.tiled_mlp` under FPDT's name, ``num_chunks`` its tiles."""
    if x.shape[1] % num_chunks != 0:
        raise ValueError(f"seq {x.shape[1]} not divisible by {num_chunks} "
                         "chunks")
    return tiled_mlp(fn, x, num_chunks, remat)


class FPDTAttention:
    """Ulysses all-to-all + chunked streaming attention (ref
    FPDT_Attention, fpdt_layer.py:971).

    This rank's sequence shard of q/k/v [B, S_local, H, D] is
    head-scattered over the ``seq`` group (Ulysses), each rank runs
    chunked attention over the whole gathered sequence with O(chunk) live
    memory, and the inverse all-to-all restores the sequence shard.
    ``offload_kv`` parks the gathered K/V in pinned host memory between
    chunk fetches."""

    def __init__(self, chunk_size: int, causal: bool = True,
                 offload_kv: bool = False, topology=None):
        self.chunk_size = chunk_size
        self.causal = causal
        self.offload_kv = offload_kv
        local = partial(chunked_attention, chunk_size=chunk_size,
                        causal=causal, offload_kv=offload_kv)
        self._dist = DistributedAttention(local, topology=topology)

    def __call__(self, q, k, v):
        topo = self._dist.topo or get_topology()
        if topo is None or topo.sp_size == 1:
            return chunked_attention(q, k, v, self.chunk_size, self.causal,
                                     offload_kv=self.offload_kv)
        return self._dist(q, k, v)
