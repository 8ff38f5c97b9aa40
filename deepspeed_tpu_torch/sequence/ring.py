"""Ring attention: sequence parallelism by rotating K/V blocks around the
ranks of the ``seq`` group.

Port of ``deepspeed_tpu/sequence/ring.py``.  Each rank keeps its shard of
the queries while the K/V blocks travel the ring one neighbour a hop
(``comm.ring_rotate``, the JAX ``_rotate_together``), and an online softmax
accumulates each visiting block.  GQA K/V travel unrepeated.

Every hop is one launch of a hand-written kernel on CUDA tensors (the JAX
package's flash path, ``_ring_fwd_flash``/``_ring_bwd_flash``): the
forward carries ``(m, l, acc)`` through ``flash_carry_block``; the
backward reuses the saved ``(o, lse)``, computes ``delta = rowsum(do·o)``
once per shard, accumulates dq locally (``flash_ring_dq_block``) while
dk/dv travel with their K/V block (``flash_ring_dkv_block``), and one last
rotation delivers dk/dv to their owner.  On CPU tensors the same wrappers
run their plain versions.  A hop whose source block lies wholly in the
causal future (or older than the window) launches nothing but still
rotates, or the ranks would deadlock.

Placements: ``contiguous`` (rank r owns positions r·S_l …) and ``striped``
(rank r owns r, r+sp, …: Striped Attention's causal load balance, every
hop about half live on every rank).  Callers feed striped data
(:func:`stripe_sequence`), and positions follow :func:`ring_position_map`.

The gradient is a ``torch.autograd.Function`` that saves (q, k, v, o, lse)
and never reruns the forward.  ``interleave=2`` is the JAX rotate-ahead
order: each hop issues the next rotation of its K/V block (or payloads)
asynchronously (``ring_rotate(..., async_op=True)``), attends the block it
holds while the transfer is in flight, then waits.  In the backward the
K/V depart before the hop's grads and the traveling dk/dv take a second,
blocking rotation once the hop has added into them.  The kernels read the
same blocks in the same order either way, so interleave 2 gives the bits
of interleave 1.

The quantized wire (``wire_dtype`` "int8" or "fp8",
``comm_quantization.ring_rotation``; the codec of ``comm/quantized.py``):
the rank's own block attends exactly at hop 0; its K/V are then encoded
once, int8 (or fp8 viewed as uint8) payloads with one fp32 scale a row,
and the payloads and scales travel all sp - 1 hops (one payload message
and one scale message a hop, in one ``ring_rotate``).  The backward's
traveling dk/dv are encoded for every hop and for the delivery hop, and
decoded to fp32 on arrival.  With int8 a visiting hop runs the hop
kernels' int8 lanes on the payloads (``flash_mha.ring_route``); fp8 hops
decode K/V with the codec to q's dtype and run the kernels' own routes,
as the JAX package does.  Encoding happens after the head-dim padding:
zero columns change neither a row's absmax nor its payload.

Head dims off the kernels' lanes (``flash_mha.head_dim_lane``) are
zero-padded once, before the hop loop, on CUDA tensors: K/V rotate padded,
so the wire carries lane / D times the bytes (D 80 and 96 pad to 128, 1.6x
and 1.33x; D 32 pads to 64, 2x), and ``sm_scale`` comes from the real D.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from deepspeed_tpu_torch.comm.comm import Pending, ring_rotate
from deepspeed_tpu_torch.comm.quantized import (validate_wire_dtype,
                                                wire_decode_rows,
                                                wire_encode_rows)
from deepspeed_tpu_torch.ops import flash_mha as fm
from deepspeed_tpu_torch.ops.flash_attention import flash_attention

PLACEMENTS = ("contiguous", "striped")


class _RingSpec(NamedTuple):
    """Static per-call configuration."""
    sp: int
    idx: int          # this rank's place in the ring
    scale: float
    causal: bool
    window: Optional[int]
    placement: str
    wire: str = "fp32"   # the ring's wire dtype: "fp32", "int8" or "fp8"
    interleave: int = 1  # 2: each hop's rotation issued before its attend


# ----------------------------------------------------------------------
# Placement helpers
# ----------------------------------------------------------------------
def ring_position_map(s: int, sp: int, placement: str = "contiguous",
                      device=None) -> torch.Tensor:
    """Global token position held by each slot of the seq-sharded
    sequence ([S] int64): under ``striped`` placement shard r's slot j holds
    token ``r + sp*j``; rank r's positions are slots ``r*S/sp`` on."""
    i = torch.arange(s, dtype=torch.int64, device=device)
    if placement == "striped" and sp > 1:
        s_l = s // sp
        return (i // s_l) + sp * (i % s_l)
    return i


def stripe_sequence(x, sp: int, axis: int = 1):
    """Reorder a GLOBAL sequence-axis array from natural token order to
    striped placement (shard r gets tokens r, r+sp, …).  A reshape and a
    transpose; works on numpy arrays and tensors."""
    if sp <= 1:
        return x
    s = x.shape[axis]
    if s % sp:
        raise ValueError(f"sequence length {s} not divisible by sp={sp}")
    shape = tuple(x.shape)
    y = x.reshape(shape[:axis] + (s // sp, sp) + shape[axis + 1:])
    return y.swapaxes(axis, axis + 1).reshape(shape)


def unstripe_sequence(x, sp: int, axis: int = 1):
    """Inverse of :func:`stripe_sequence`."""
    if sp <= 1:
        return x
    s = x.shape[axis]
    if s % sp:
        raise ValueError(f"sequence length {s} not divisible by sp={sp}")
    shape = tuple(x.shape)
    y = x.reshape(shape[:axis] + (sp, s // sp) + shape[axis + 1:])
    return y.swapaxes(axis, axis + 1).reshape(shape)


def _block_offset(block_idx: int, s_l: int, spec: _RingSpec):
    """(offset, stride) of the global positions of block ``block_idx``."""
    if spec.placement == "striped":
        return block_idx, spec.sp
    return block_idx * s_l, 1


def _block_bounds(block_idx: int, s_l: int, sp: int, placement: str):
    """(lo, hi) global position range of a block."""
    if placement == "striped":
        return block_idx, block_idx + sp * (s_l - 1)
    return block_idx * s_l, block_idx * s_l + s_l - 1


def _hop_dead(idx: int, src: int, s_l: int, spec: _RingSpec) -> bool:
    """Whether the (query block idx, key block src) hop contributes
    nothing: the source block lies wholly in the causal future, or wholly
    older than the sliding window."""
    q_lo, q_hi = _block_bounds(idx, s_l, spec.sp, spec.placement)
    k_lo, k_hi = _block_bounds(src, s_l, spec.sp, spec.placement)
    dead = False
    if spec.causal:
        dead |= k_lo > q_hi
    if spec.window is not None:
        dead |= q_lo - k_hi >= spec.window
    return dead


def _pos(src: int, s_l: int, spec: _RingSpec):
    """The hop's (q_off, q_stride, k_off, k_stride)."""
    return (*_block_offset(spec.idx, s_l, spec),
            *_block_offset(src, s_l, spec))


# ----------------------------------------------------------------------
# the quantized wire (JAX _rotate_quantized and its callers)
# ----------------------------------------------------------------------
class _Wire(NamedTuple):
    """A block that travels the quantized wire: int8 (or fp8 as uint8)
    payloads [B, Hkv, S_l, D] and fp32 row scales [B, Hkv, S_l, 1]."""
    kp: torch.Tensor
    vp: torch.Tensor
    ks: torch.Tensor
    vs: torch.Tensor


def _then(pending: Pending, fn) -> Pending:
    """A :class:`Pending` of ``fn(pending's result)``."""
    def finish():
        pending._complete()
        return fn(pending._out)
    return Pending(None, finish, "comm.ring_rotate")


def _rotate_quantized(payloads, scales, group, async_op: bool = False):
    """One hop of the quantized wire: every payload flattened into ONE
    int8/uint8 message and every scale into one fp32 message, both moved
    by one ``ring_rotate``; returns ``(payloads', scales')``, or with
    ``async_op`` a :class:`Pending` of them."""
    def cat(xs):
        return torch.cat([x.reshape(-1) for x in xs])

    def split(flat, like):
        out, i = [], 0
        for x in like:
            out.append(flat[i:i + x.numel()].view(x.shape))
            i += x.numel()
        return out

    def unpack(got):
        return split(got[0], payloads), split(got[1], scales)

    moved = ring_rotate([cat(payloads), cat(scales)], group,
                        async_op=async_op)
    return _then(moved, unpack) if async_op else unpack(moved)


def _wire_of(got) -> _Wire:
    (kp, vp), (ks, vs) = got
    return _Wire(kp, vp, ks, vs)


def _rotate_wire(w: _Wire, group, async_op: bool = False):
    """The block's payloads and scales one hop on (a :class:`Pending` of
    the :class:`_Wire` with ``async_op``)."""
    moved = _rotate_quantized((w.kp, w.vp), (w.ks, w.vs), group, async_op)
    return _then(moved, _wire_of) if async_op else _wire_of(moved)


def _rotate_grads_quant(dk, dv, wire, group, w: Optional[_Wire] = None):
    """The traveling fp32 dk/dv encoded for the wire and decoded on arrival
    (with ``w``: the block's K/V payloads and scales in the same two
    messages, the JAX ``_rotate_kv_grads_quant``).  Returns ``(dk', dv',
    w')``."""
    (dkp, dks), (dvp, dvs) = (wire_encode_rows(x, wire) for x in (dk, dv))
    pays, scs = [dkp, dvp], [dks, dvs]
    if w is not None:
        pays, scs = [w.kp, w.vp] + pays, [w.ks, w.vs] + scs
    pays, scs = _rotate_quantized(pays, scs, group)
    dk_t = wire_decode_rows(pays[-2], scs[-2], wire)
    dv_t = wire_decode_rows(pays[-1], scs[-1], wire)
    return dk_t, dv_t, (None if w is None else _Wire(pays[0], pays[1],
                                                    scs[0], scs[1]))


def _visiting(w: _Wire, dtype, wire):
    """A visiting block's K/V and row-scale keywords as the hop kernels
    take them: int8 payloads with compact [B, Hkv, S_l] scales (the int8
    lanes), or, for fp8, K/V decoded by the codec to q's dtype."""
    if wire == "int8":
        return w.kp, w.vp, dict(k_scale=w.ks[..., 0], v_scale=w.vs[..., 0])
    return (wire_decode_rows(w.kp, w.ks, wire).to(dtype),
            wire_decode_rows(w.vp, w.vs, wire).to(dtype), {})


# ----------------------------------------------------------------------
# forward and backward rings
# ----------------------------------------------------------------------
def _ring_fwd(qk, kk, vk, spec: _RingSpec, group):
    """Forward ring over [B, H, S_l, D] views: returns (o [B, Hq, S_l, D]
    in q's dtype, lse [B, Hq, S_l] fp32)."""
    b, hq, s_l, d = qk.shape
    dev = qk.device
    m = torch.full((b, hq, s_l), fm.NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hq, s_l), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hq, s_l, d), dtype=torch.float32, device=dev)
    kw = dict(causal=spec.causal, sm_scale=spec.scale, window=spec.window)

    def attend(kc, vc, src, **scales):
        if not _hop_dead(spec.idx, src, s_l, spec):
            fm.flash_carry_block(qk, kc, vc, m, l, acc, _pos(src, s_l, spec),
                                 **kw, **scales)

    def attend_wire(w, src):
        if not _hop_dead(spec.idx, src, s_l, spec):
            kc, vc, scales = _visiting(w, qk.dtype, spec.wire)
            attend(kc, vc, src, **scales)

    def hop(send, rotate, run):
        """``run()`` this hop's attend and move ``send`` one rank on:
        rotate-ahead at interleave 2, attend-then-rotate at 1."""
        if spec.interleave > 1:
            pending = rotate(send, group, async_op=True)
            run()
            return pending.wait()
        run()
        return rotate(send, group)

    srcs = [(spec.idx - t - 1) % spec.sp for t in range(spec.sp - 1)]
    # hop 0: the rank's own block (the diagonal is never dead), exact
    if spec.wire == "fp32":
        kc, vc = hop([kk, vk], ring_rotate, lambda: attend(kk, vk, spec.idx))
        for src in srcs[:-1]:
            kc, vc = hop([kc, vc], ring_rotate,
                         lambda kc=kc, vc=vc, src=src: attend(kc, vc, src))
        attend(kc, vc, srcs[-1])
    else:
        # K/V encoded once; the payloads and scales travel every hop
        (kp, ks), (vp, vs) = (wire_encode_rows(x, spec.wire) for x in (kk, vk))
        w = hop(_Wire(kp, vp, ks, vs), _rotate_wire,
                lambda: attend(kk, vk, spec.idx))
        for src in srcs[:-1]:
            w = hop(w, _rotate_wire, lambda w=w, src=src: attend_wire(w, src))
        attend_wire(w, srcs[-1])
    safe = torch.clamp(l, min=1e-20)
    o = (acc / safe[..., None]).to(qk.dtype)
    return o, m + torch.log(safe)


def _ring_bwd(qk, kk, vk, ok, lse, dok, spec: _RingSpec, group):
    """Backward ring over [B, H, S_l, D] views: returns fp32 (dq, dk, dv)."""
    b, hq, s_l, d = qk.shape
    hkv = kk.shape[1]
    dev = qk.device
    delta = fm.attn_delta(ok, dok).contiguous()
    dq = torch.zeros((b, hq, s_l, d), dtype=torch.float32, device=dev)
    dk = torch.zeros((b, hkv, s_l, d), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    kw = dict(causal=spec.causal, sm_scale=spec.scale, window=spec.window)

    def grads(kc, vc, dk_t, dv_t, src, **scales):
        if not _hop_dead(spec.idx, src, s_l, spec):
            pos = _pos(src, s_l, spec)
            fm.flash_ring_dq_block(qk, kc, vc, dok, lse, delta, dq, pos, **kw,
                                   **scales)
            fm.flash_ring_dkv_block(qk, kc, vc, dok, lse, delta, dk_t, dv_t,
                                    pos, **kw, **scales)

    def grads_wire(w, dk_t, dv_t, src):
        if not _hop_dead(spec.idx, src, s_l, spec):
            kc, vc, scales = _visiting(w, qk.dtype, spec.wire)
            grads(kc, vc, dk_t, dv_t, src, **scales)

    if spec.wire == "fp32":
        # K/V and their accumulated grads travel as tensors
        block = [kk, vk]

        def attend(block, dk_t, dv_t, src):
            grads(*block, dk_t, dv_t, src)

        def rotate(block, async_op=False):
            return ring_rotate(block, group, async_op=async_op)

        def rotate_grads(dk_t, dv_t):
            return ring_rotate([dk_t, dv_t], group)

        def rotate_all(block, dk_t, dv_t):
            kc, vc, dk_t, dv_t = ring_rotate([*block, dk_t, dv_t], group)
            return [kc, vc], dk_t, dv_t
    else:
        # K/V encoded once; the traveling grads re-encode every hop
        (kp, ks), (vp, vs) = (wire_encode_rows(x, spec.wire) for x in (kk, vk))
        block = _Wire(kp, vp, ks, vs)
        attend = grads_wire

        def rotate(block, async_op=False):
            return _rotate_wire(block, group, async_op)

        def rotate_grads(dk_t, dv_t):
            return _rotate_grads_quant(dk_t, dv_t, spec.wire, group)[:2]

        def rotate_all(block, dk_t, dv_t):
            dk_t, dv_t, w = _rotate_grads_quant(dk_t, dv_t, spec.wire, group,
                                                block)
            return w, dk_t, dv_t

    def hop(block, dk_t, dv_t, run):
        """``run()`` this hop's grads into ``dk_t``/``dv_t`` and move the
        block and the grads one rank on: at interleave 2 the block departs
        before ``run()`` and the grads after it (the JAX order), at 1 all
        travel together after it."""
        if spec.interleave > 1:
            pending = rotate(block, async_op=True)
            run()
            dk_t, dv_t = rotate_grads(dk_t, dv_t)
            return pending.wait(), dk_t, dv_t
        run()
        return rotate_all(block, dk_t, dv_t)

    srcs = [(spec.idx - t - 1) % spec.sp for t in range(spec.sp - 1)]
    # hop 0: the own block, exact
    block, dk_t, dv_t = hop(block, dk, dv,
                            lambda: grads(kk, vk, dk, dv, spec.idx))
    for src in srcs[:-1]:
        block, dk_t, dv_t = hop(
            block, dk_t, dv_t,
            lambda b_=block, dk_=dk_t, dv_=dv_t, src=src:
                attend(b_, dk_, dv_, src))
    attend(block, dk_t, dv_t, srcs[-1])
    # the delivery hop: the traveling grads sit one rank behind their owner
    dk_t, dv_t = rotate_grads(dk_t, dv_t)
    return dq, dk_t, dv_t


class _RingAttention(torch.autograd.Function):
    """The JAX ``_ring_local`` custom VJP: the forward saves
    ``(q, k, v, o, lse)`` and the backward is the second ring."""

    @staticmethod
    def forward(ctx, q, k, v, spec, group):
        qk, kk, vk = (x.transpose(1, 2) for x in (q, k, v))
        o, lse = _ring_fwd(qk, kk, vk, spec, group)
        ctx.save_for_backward(qk, kk, vk, o, lse)
        ctx.ring = (spec, group)
        return o.transpose(1, 2)

    @staticmethod
    def backward(ctx, do):
        qk, kk, vk, o, lse = ctx.saved_tensors
        dok = do.transpose(1, 2)
        if dok.device.type == "cuda" and not fm._kernel_layout_ok(dok):
            dok = dok.contiguous()
        dq, dk, dv = _ring_bwd(qk, kk, vk, o, lse, dok, *ctx.ring)
        return (dq.to(qk.dtype).transpose(1, 2), dk.to(kk.dtype).transpose(1, 2),
                dv.to(vk.dtype).transpose(1, 2), None, None)


# ----------------------------------------------------------------------
# Public entry
# ----------------------------------------------------------------------
def ring_attention(q, k, v, topo=None, causal: bool = True,
                   sm_scale: Optional[float] = None,
                   window: Optional[int] = None,
                   placement: str = "contiguous",
                   interleave: int = 1,
                   wire_dtype: str = "fp32"):
    """q ``[B, S_l, Hq, D]``, k/v ``[B, S_l, Hkv, D]``: THIS rank's shard
    of the sequence (the JAX function takes the global arrays and shards
    them under ``shard_map``; here each rank calls it on its own).
    ``topo``: the :class:`~deepspeed_tpu_torch.parallel.topology.MeshTopology`
    whose ``seq`` group is the ring (None or ``sp_size`` 1: plain flash
    attention on the shard).  Returns ``[B, S_l, Hq, D]``, differentiable
    in q, k and v.  ``placement``: "contiguous" or "striped" (the caller
    feeds striped data, cf. :func:`stripe_sequence`); ``interleave``: 1
    or 2, the JAX option: 2 issues each hop's rotation before its attend
    (the module docstring).  ``wire_dtype``: "fp32", or "int8"/"fp8" for
    the quantized wire (module docstring); ignored at sp 1."""
    sp = topo.sp_size if topo is not None else 1
    nh, nkv = q.shape[2], k.shape[2]
    if nh % nkv:
        raise ValueError(
            f"ring_attention: num_heads={nh} not divisible by "
            f"kv_heads={nkv} — GQA requires an integer group size")
    if window is not None:
        if window <= 0:
            raise ValueError(f"window must be positive, got {window}")
        if not causal:
            raise ValueError(
                "window without causal would be a ONE-SIDED band "
                "(key ∈ (qpos-window, qpos+∞)), which is almost never "
                "intended; pass causal=True for Mistral-style sliding "
                "windows")
    if placement not in PLACEMENTS:
        raise ValueError(f"placement={placement!r}: expected one of "
                         f"{PLACEMENTS}")
    if interleave not in (1, 2):
        raise ValueError(f"interleave={interleave!r}: expected 1 or 2")
    validate_wire_dtype(wire_dtype)
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    if sp == 1:
        return flash_attention(q, k, v, causal=causal, sm_scale=scale,
                               window=window)
    spec = _RingSpec(sp=sp, idx=topo.sp_rank, scale=float(scale),
                     causal=causal, window=window, placement=placement,
                     wire=wire_dtype, interleave=interleave)

    def attn(q_, k_, v_):
        return _RingAttention.apply(q_, k_, v_, spec, topo.seq_group)

    if q.device.type == "cuda":
        return fm.head_dim_padded(attn, q, k, v)
    return attn(q, k, v)


def shard_positions(s_l: int, topo, placement: str, device=None):
    """The global positions of this rank's ``s_l`` slots ([s_l] int64)."""
    full = ring_position_map(s_l * topo.sp_size, topo.sp_size, placement,
                             device=device)
    return full[topo.sp_rank * s_l:(topo.sp_rank + 1) * s_l]
