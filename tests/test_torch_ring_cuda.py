"""The port's ring-attention hop kernels against their plain PyTorch
versions on the card: ``ring_carry``, ``ring_bwd_dq`` and ``ring_bwd_dkv``
(``ops/csrc/ring_attention.cu``) over hops of both placements (the own
block on the diagonal, a striped neighbour, a fully live contiguous
source), MHA and GQA, head_dim 64 and 128, a sliding window, non-causal
hops and shard lengths that are not a multiple of 64 (200, 1000), in
bf16 and fp32.  Every kernel's route is asserted: bf16 views take the
wgmma walks (the forward in accumulate mode, the dq and dk/dv backward),
an expanded K/V or do (stride 0) the 64 x 64 tile walk (mma), fp32 the
FMA body.  Two hops of the backward on the wgmma route compose as the
plain version's do.  Head dims off the 64/128 lanes (D 32, 80, 96 zero-
padded to 64 or 128; D 256 on the 64 x 64 walk) hop against the plain
versions at the real D.

No JAX here: the machine with the card has none.  Run there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ring_cuda.py -m cuda

Without a card every test skips.  Tolerances, by the operands' dtype:
bf16 2^-7 and fp32 1e-4, as |kernel - plain| <= rtol * (1 + |plain|) on
the normalised carry ``acc / l``, on ``l`` and on the fp32 accumulators
dq, dk and dv (the two sum in other orders before p and ds round to
bf16), and 1e-4 on ``m`` (a max of fp32 scores).  A dead hop, and on the
wgmma route every item with no live tile (a 128-row query tile of the
carry or dq, a 128-key tile of dk/dv), leaves the state bit for bit as it
was.

The int8 K/V lanes of the quantized wire, routed kernel by kernel
(``ring_route``): ``wgmma_s8`` for all three with bf16 q and do at D 64
and 128 (the wgmma walks with the int8 tiles widened to bf16 on the card),
``mma_s8`` for D 256 and an expanded K/V (the 64 x 64 tile walk),
``fma_s8`` for fp32: int8 payloads with per-row fp32 scales against the
plain versions, which decode the rows and compute in fp32, at S 130, 1000
and 50, causal and window, GQA 32/8, 8/2 and MQA, striped and contiguous
positions, D 64/128/256, hops with dead tiles and items (in walks of many
rounds of items too), a bf16 hop followed by an int8 hop, and the route
counts.  Tolerance: bf16 q
2^-10 (the kernels' products are exact or fp32 up to summation order; p
and ds enter them as two bf16 parts, about 16 bits), fp32 q 1e-4
(summation order), on the same quantities as above.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import flash_mha as fm

# b, hq, hkv, s_l, d, causal, window, pos (q_off, q_stride, k_off, k_stride)
CASES = [
    (1, 8, 2, 320, 128, True, None, (0, 2, 0, 2)),      # striped, own block
    (1, 8, 2, 320, 128, True, None, (1, 2, 0, 2)),      # striped, rank 1 <- 0
    (1, 8, 2, 320, 128, True, None, (0, 2, 1, 2)),      # striped, rank 0 <- 1
    (1, 8, 2, 256, 128, True, None, (256, 1, 256, 1)),  # contiguous, own block
    (1, 8, 2, 256, 128, True, None, (256, 1, 0, 1)),    # contiguous, fully live
    (2, 4, 4, 192, 64, True, None, (1, 2, 0, 2)),       # MHA, d = 64
    (1, 4, 4, 256, 64, True, 100, (256, 1, 0, 1)),      # sliding window
    (1, 4, 2, 192, 64, False, None, (192, 1, 0, 1)),    # non-causal
    (1, 4, 2, 200, 128, True, None, (1, 2, 0, 2)),      # tail: S_l % 64 != 0
    (1, 4, 2, 1000, 128, True, None, (1, 2, 0, 2)),     # tail: S_l % 128 != 0
    (1, 8, 2, 384, 64, True, None, (384, 1, 0, 1)),     # GQA d = 64, fully live
    (1, 8, 2, 320, 64, True, 90, (1, 2, 0, 2)),         # striped, window, d = 64
    (2, 8, 4, 256, 128, False, None, (0, 2, 1, 2)),     # striped, non-causal
    (1, 4, 2, 130, 128, True, None, (1, 2, 0, 2)),      # S_l % 4 != 0: lse rows
    (2, 4, 4, 50, 64, False, None, (50, 1, 0, 1)),      # off 16-byte boundaries
]
IDS = ["striped-own", "striped-1from0", "striped-0from1", "contig-own",
       "contig-live", "mha-d64", "window", "noncausal", "tail",
       "tail-1000", "gqa-d64-live", "striped-window-d64",
       "striped-noncausal", "tail-130", "short-noncausal"]
RTOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-4}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref, rtol):
    diff = (got.float() - ref.float()).abs()
    return bool((diff <= rtol * (1 + ref.float().abs())).all()), float(diff.max())


def _rand(rng, dev, dtype, *shape, scale=1.0):
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            * scale).to(dev, dtype)


def _case(case, dtype, dev, seed=0):
    b, hq, hkv, s, d = case[:5]
    rng = np.random.default_rng(seed)
    q, do = _rand(rng, dev, dtype, b, hq, s, d), _rand(rng, dev, dtype, b, hq, s, d)
    k, v = _rand(rng, dev, dtype, b, hkv, s, d), _rand(rng, dev, dtype, b, hkv, s, d)
    return rng, q, k, v, do


def _fresh_state(b, hq, s, d, dev):
    return (torch.full((b, hq, s), fm.NEG_INF, device=dev),
            torch.zeros((b, hq, s), device=dev),
            torch.zeros((b, hq, s, d), device=dev))


def _route_delta(before):
    return {r: n - before[r] for r, n in fm.ring_routes.items() if n != before[r]}


def _check_carry(state, ref, rtol):
    (m, l, acc), (m_r, l_r, acc_r) = state, ref
    ok_m, e_m = _close(m, m_r, 1e-4)
    ok_l, e_l = _close(l, l_r, rtol)
    ok_o, e_o = _close(acc / l.clamp(min=1e-20)[..., None],
                       acc_r / l_r.clamp(min=1e-20)[..., None], rtol)
    assert ok_m and ok_l and ok_o, (e_m, e_l, e_o)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_cuda_ring_kernels_match_plain_version(case, dtype, cuda_device):
    """The case's hop from a fresh carry, then the own block of the query
    shard (q_off, q_stride on both sides) from the carried state; then dq
    and dk/dv of the case's hop into seeded fp32 accumulators, from the
    lse of those two hops."""
    b, hq, hkv, s, d, causal, window, pos = case
    rng, q, k, v, do = _case(case, dtype, cuda_device)
    scale = d ** -0.5
    kw = dict(causal=causal, sm_scale=scale, window=window)
    own = (pos[0], pos[1], pos[0], pos[1])
    state = _fresh_state(b, hq, s, d, cuda_device)
    ref = tuple(t.clone() for t in state)
    before = dict(fm.ring_launches)
    routes = dict(fm.ring_routes)
    want = "wgmma" if dtype == torch.bfloat16 else "fma"
    assert fm.fwd_route(q, k, v) == want
    assert fm.bwd_route(q, k, v, do) == want
    for hop in (pos, own):
        fm.flash_carry_block(q, k, v, *state, hop, **kw)
        fm.ring_carry_ref(q, k, v, *ref, hop, causal, scale, window)
        torch.cuda.synchronize()
        _check_carry(state, ref, RTOL[dtype])
    m, l, _ = ref
    lse = (m + torch.log(l.clamp(min=1e-20))).contiguous()
    delta = _rand(rng, cuda_device, torch.float32, b, hq, s, scale=0.1)
    dq = _rand(rng, cuda_device, torch.float32, b, hq, s, d, scale=0.1)
    dk = _rand(rng, cuda_device, torch.float32, b, hkv, s, d, scale=0.1)
    dv = _rand(rng, cuda_device, torch.float32, b, hkv, s, d, scale=0.1)
    grads = [t.clone() for t in (dq, dk, dv)]
    fm.flash_ring_dq_block(q, k, v, do, lse, delta, dq, pos, **kw)
    fm.flash_ring_dkv_block(q, k, v, do, lse, delta, dk, dv, pos, **kw)
    fm.ring_bwd_dq_ref(q, k, v, do, lse, delta, grads[0], pos, causal, scale,
                       window)
    fm.ring_bwd_dkv_ref(q, k, v, do, lse, delta, grads[1], grads[2], pos,
                        causal, scale, window)
    torch.cuda.synchronize()
    assert {n: fm.ring_launches[n] - before[n] for n in before} == \
        {"ring_carry": 2, "ring_bwd_dq": 1, "ring_bwd_dkv": 1}
    assert _route_delta(routes) == {f"ring_carry.{want}": 2,
                                    f"ring_bwd_dq.{want}": 1,
                                    f"ring_bwd_dkv.{want}": 1}
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), grads):
        ok, err = _close(got, want, RTOL[dtype])
        assert ok, f"{name}: max abs err {err}"


# b, hq, hkv, s_l, d, causal, window, pos: the head-dim lanes
D_CASES = [
    (1, 4, 4, 192, 32, True, None, (1, 2, 0, 2)),
    (1, 4, 2, 200, 80, True, None, (200, 1, 0, 1)),
    (1, 4, 2, 256, 96, True, 100, (1, 2, 0, 2)),
    (1, 4, 2, 192, 256, True, None, (1, 2, 0, 2)),
]
D_IDS = ["d32-striped", "d80-contig-tail", "d96-window", "d256-gqa"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", D_CASES, ids=D_IDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_cuda_ring_head_dim_lanes_match_plain_version(case, dtype,
                                                      cuda_device):
    """One hop (carry, dq, dk/dv) on q, k, v, do and the fp32 state
    zero-padded to the head_dim's lane, as ring_attention pads before its
    hop loop, against the plain versions at the real D: the padded columns
    of acc, dq, dk, dv stay 0, and the lane's route is taken (bf16: wgmma
    at lanes 64/128, mma at 256; fp32: fma)."""
    b, hq, hkv, s, d, causal, window, pos = case
    lane = fm.head_dim_lane(d)
    rng, q, k, v, do = _case(case, dtype, cuda_device, seed=3)
    scale = d ** -0.5
    kw = dict(causal=causal, sm_scale=scale, window=window)
    pad = lambda x: torch.nn.functional.pad(x, (0, lane - d))  # noqa: E731
    qp, kp, vp, dop = (pad(x) for x in (q, k, v, do))
    state = _fresh_state(b, hq, s, lane, cuda_device)
    ref = _fresh_state(b, hq, s, d, cuda_device)
    routes = dict(fm.ring_routes)
    fm.flash_carry_block(qp, kp, vp, *state, pos, **kw)
    fm.ring_carry_ref(q, k, v, *ref, pos, causal, scale, window)
    torch.cuda.synchronize()
    _check_carry((state[0], state[1], state[2][..., :d]), ref, RTOL[dtype])
    m, l, _ = ref
    lse = (m + torch.log(l.clamp(min=1e-20))).contiguous()
    delta = _rand(rng, cuda_device, torch.float32, b, hq, s, scale=0.1)
    grads = [_rand(rng, cuda_device, torch.float32, b, h, s, d, scale=0.1)
             for h in (hq, hkv, hkv)]
    got = [pad(g) for g in grads]
    fm.flash_ring_dq_block(qp, kp, vp, dop, lse, delta, got[0], pos, **kw)
    fm.flash_ring_dkv_block(qp, kp, vp, dop, lse, delta, got[1], got[2], pos,
                            **kw)
    fm.ring_bwd_dq_ref(q, k, v, do, lse, delta, grads[0], pos, causal, scale,
                       window)
    fm.ring_bwd_dkv_ref(q, k, v, do, lse, delta, grads[1], grads[2], pos,
                        causal, scale, window)
    torch.cuda.synchronize()
    want = ("fma" if dtype == torch.float32
            else "mma" if lane == 256 else "wgmma")
    assert _route_delta(routes) == {f"{n}.{want}": 1 for n in fm.ring_launches}
    for name, g, r in zip(("dq", "dk", "dv"), got, grads):
        ok, err = _close(g[..., :d], r, RTOL[dtype])
        assert ok, f"{name}: max abs err {err}"
    for name, x in (("acc", state[2]), ("dq", got[0]), ("dk", got[1]),
                    ("dv", got[2])):
        assert bool((x[..., d:] == 0).all()), f"{name}: padded columns not 0"
    if lane != d:
        with pytest.raises(ValueError, match="zero-pad"):
            fm.flash_carry_block(q, k, v, *ref, pos, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_cuda_ring_dead_hop_leaves_state_unchanged(dtype, cuda_device):
    """A source block wholly in the causal future (contiguous, rank 0 <-
    block 1): every tile is dead, so no tile is visited and the carry and
    the accumulators come back bit for bit."""
    case = (1, 4, 2, 200, 64, True, None, (0, 1, 200, 1))
    b, hq, hkv, s, d, causal, window, pos = case
    rng, q, k, v, do = _case(case, dtype, cuda_device, seed=1)
    m = _rand(rng, cuda_device, torch.float32, b, hq, s)
    l = _rand(rng, cuda_device, torch.float32, b, hq, s).abs() + 1
    acc = _rand(rng, cuda_device, torch.float32, b, hq, s, d)
    dk = _rand(rng, cuda_device, torch.float32, b, hkv, s, d)
    dv, dq = dk.clone() * 2, _rand(rng, cuda_device, torch.float32, b, hq, s, d)
    before = [t.clone() for t in (m, l, acc, dq, dk, dv)]
    lse, delta = m.clone(), torch.zeros_like(m)
    routes = dict(fm.ring_routes)
    fm.flash_carry_block(q, k, v, m, l, acc, pos, causal=causal)
    fm.flash_ring_dq_block(q, k, v, do, lse, delta, dq, pos, causal=causal)
    fm.flash_ring_dkv_block(q, k, v, do, lse, delta, dk, dv, pos, causal=causal)
    torch.cuda.synchronize()
    want_route = "wgmma" if dtype == torch.bfloat16 else "fma"
    assert _route_delta(routes) == {f"{n}.{want_route}": 1 for n in
                                    ("ring_carry", "ring_bwd_dq", "ring_bwd_dkv")}
    for got, want in zip((m, l, acc, dq, dk, dv), before):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_ring_carry_expanded_kv_takes_the_mma_route(cuda_device):
    """An expanded K/V (stride 0 over the KV heads) is no view a TMA tensor
    map takes: the carry runs the 64 x 64 tile walk and matches its plain
    version, from a fresh carry and from the carried state."""
    b, hq, hkv, s, d = 1, 8, 2, 256, 128
    rng = np.random.default_rng(3)
    q = _rand(rng, cuda_device, torch.bfloat16, b, hq, s, d)
    k = _rand(rng, cuda_device, torch.bfloat16, b, 1, s, d).expand(b, hkv, s, d)
    v = _rand(rng, cuda_device, torch.bfloat16, b, 1, s, d).expand(b, hkv, s, d)
    assert fm.fwd_route(q, k, v) == "mma"
    state = _fresh_state(b, hq, s, d, cuda_device)
    ref = tuple(t.clone() for t in state)
    routes = dict(fm.ring_routes)
    for hop in ((1, 2, 0, 2), (1, 2, 1, 2)):
        fm.flash_carry_block(q, k, v, *state, hop, sm_scale=d ** -0.5)
        fm.ring_carry_ref(q, k, v, *ref, hop, True, d ** -0.5)
        torch.cuda.synchronize()
        _check_carry(state, ref, RTOL[torch.bfloat16])
    assert _route_delta(routes) == {"ring_carry.mma": 2}


@pytest.mark.cuda
def test_cuda_ring_carry_dead_items_keep_their_rows(cuda_device):
    """A windowed contiguous hop (rank 1 <- block 0, window 100) from a
    seeded state: on the wgmma route each 128-row item past the window's
    reach has no live key tile, and its rows' m, l and acc come back bit
    for bit; the live rows match the plain version."""
    b, hq, hkv, s, d, window = 1, 4, 2, 512, 128, 100
    pos = (s, 1, 0, 1)
    rng = np.random.default_rng(4)
    q = _rand(rng, cuda_device, torch.bfloat16, b, hq, s, d)
    k = _rand(rng, cuda_device, torch.bfloat16, b, hkv, s, d)
    v = _rand(rng, cuda_device, torch.bfloat16, b, hkv, s, d)
    m = _rand(rng, cuda_device, torch.float32, b, hq, s)
    l = _rand(rng, cuda_device, torch.float32, b, hq, s).abs() + 1
    acc = _rand(rng, cuda_device, torch.float32, b, hq, s, d)
    before = [t.clone() for t in (m, l, acc)]
    ref = [t.clone() for t in (m, l, acc)]
    routes = dict(fm.ring_routes)
    fm.flash_carry_block(q, k, v, m, l, acc, pos, window=window)
    fm.ring_carry_ref(q, k, v, *ref, pos, True, d ** -0.5, window)
    torch.cuda.synchronize()
    assert _route_delta(routes) == {"ring_carry.wgmma": 1}
    # row r sees block 0 only while s + r - (s - 1) < window: rows < 99;
    # items (128 rows) from row 128 on have no live tile
    dead = slice(128, None)
    for got, was in zip((m, l, acc), before):
        assert torch.equal(got[:, :, dead], was[:, :, dead])
    _check_carry((m, l, acc), ref, RTOL[torch.bfloat16])


def _bwd_state(rng, dev, b, hq, hkv, s, d):
    """Seeded fp32 dq, dk, dv and [B, Hq, S] delta of a backward hop."""
    return (_rand(rng, dev, torch.float32, b, hq, s, d, scale=0.1),
            _rand(rng, dev, torch.float32, b, hkv, s, d, scale=0.1),
            _rand(rng, dev, torch.float32, b, hkv, s, d, scale=0.1),
            _rand(rng, dev, torch.float32, b, hq, s, scale=0.1))


def _lse_of(q, k, v, pos, causal, window, wire=None):
    """The lse a hop's rows end the forward with, by the plain carry
    (``wire``: the int8 K/V's row scales)."""
    b, hq, s, d = q.shape
    m, l, acc = _fresh_state(b, hq, s, d, q.device)
    fm.ring_carry_ref(q, k, v, m, l, acc, pos, causal, d ** -0.5, window,
                      **(wire or {}))
    return (m + torch.log(l.clamp(min=1e-20))).contiguous()


def _check_grads(got, want, rtol):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        ok, err = _close(g, w, rtol)
        assert ok, f"{name}: max abs err {err}"


@pytest.mark.cuda
def test_cuda_ring_bwd_dead_items_keep_their_rows(cuda_device):
    """A windowed contiguous hop (rank 1 <- block 0, window 100) into
    seeded accumulators: query row r sees keys 413 + r .. 511, so on the
    wgmma route each 128-row dq item from row 128 on and each 128-key
    dk/dv item below key 384 has no live tile, and their rows come back
    bit for bit; the live rows match the plain version."""
    b, hq, hkv, s, d, window = 1, 4, 2, 512, 128, 100
    pos = (s, 1, 0, 1)
    rng = np.random.default_rng(5)
    q, k, v, do = (_rand(rng, cuda_device, torch.bfloat16, b, h, s, d)
                   for h in (hq, hkv, hkv, hq))
    lse = _lse_of(q, k, v, pos, True, window)
    dq, dk, dv, delta = _bwd_state(rng, cuda_device, b, hq, hkv, s, d)
    before = [t.clone() for t in (dq, dk, dv)]
    want = [t.clone() for t in (dq, dk, dv)]
    routes = dict(fm.ring_routes)
    fm.flash_ring_dq_block(q, k, v, do, lse, delta, dq, pos, window=window)
    fm.flash_ring_dkv_block(q, k, v, do, lse, delta, dk, dv, pos,
                            window=window)
    fm.ring_bwd_dq_ref(q, k, v, do, lse, delta, want[0], pos, True,
                       d ** -0.5, window)
    fm.ring_bwd_dkv_ref(q, k, v, do, lse, delta, want[1], want[2], pos,
                        True, d ** -0.5, window)
    torch.cuda.synchronize()
    assert _route_delta(routes) == {"ring_bwd_dq.wgmma": 1,
                                    "ring_bwd_dkv.wgmma": 1}
    assert torch.equal(dq[:, :, 128:], before[0][:, :, 128:])
    for got, was in zip((dk, dv), before[1:]):
        assert torch.equal(got[:, :, :384], was[:, :, :384])
    _check_grads((dq, dk, dv), want, RTOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("expanded", ["kv", "do"])
def test_cuda_ring_bwd_expanded_operand_takes_the_mma_route(expanded,
                                                             cuda_device):
    """An expanded K/V, or an expanded do (the gradient of a sum), is no
    view a TMA tensor map takes: the backward runs the 64 x 64 tile walk
    and matches its plain version."""
    b, hq, hkv, s, d = 1, 8, 2, 256, 128
    pos = (1, 2, 0, 2)
    rng = np.random.default_rng(6)
    q = _rand(rng, cuda_device, torch.bfloat16, b, hq, s, d)
    if expanded == "kv":
        k, v = (_rand(rng, cuda_device, torch.bfloat16, b, 1, s, d)
                .expand(b, hkv, s, d) for _ in range(2))
        do = _rand(rng, cuda_device, torch.bfloat16, b, hq, s, d)
    else:
        k, v = (_rand(rng, cuda_device, torch.bfloat16, b, hkv, s, d)
                for _ in range(2))
        do = _rand(rng, cuda_device, torch.bfloat16, 1, 1, 1, d).expand(
            b, hq, s, d)
    assert fm.bwd_route(q, k, v, do) == "mma"
    lse = _lse_of(q, k, v, pos, True, None)
    dq, dk, dv, delta = _bwd_state(rng, cuda_device, b, hq, hkv, s, d)
    want = [t.clone() for t in (dq, dk, dv)]
    routes = dict(fm.ring_routes)
    fm.flash_ring_dq_block(q, k, v, do, lse, delta, dq, pos)
    fm.flash_ring_dkv_block(q, k, v, do, lse, delta, dk, dv, pos)
    fm.ring_bwd_dq_ref(q, k, v, do, lse, delta, want[0], pos, True, d ** -0.5)
    fm.ring_bwd_dkv_ref(q, k, v, do, lse, delta, want[1], want[2], pos, True,
                        d ** -0.5)
    torch.cuda.synchronize()
    assert _route_delta(routes) == {"ring_bwd_dq.mma": 1,
                                    "ring_bwd_dkv.mma": 1}
    _check_grads((dq, dk, dv), want, RTOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_ring_bwd_hops_compose(d, cuda_device):
    """Two striped ranks' backward around block 1 (bf16, wgmma route):
    rank 1's dq takes its own block's hop and then block 0's; block 1's
    traveling dk/dv take rank 1's hop (its owner) and then rank 0's.  The
    sums after both hops equal the same two hops through the plain
    version."""
    b, hq, hkv, s = 1, 8, 2, 320
    rng = np.random.default_rng(7)
    q0, q1, do0, do1 = (_rand(rng, cuda_device, torch.bfloat16, b, hq, s, d)
                        for _ in range(4))
    k0, v0, k1, v1 = (_rand(rng, cuda_device, torch.bfloat16, b, hkv, s, d)
                      for _ in range(4))
    lse1 = _lse_of(q1, k1, v1, (1, 2, 1, 2), True, None)
    lse0 = _lse_of(q0, k1, v1, (0, 2, 1, 2), True, None)
    dq, dk, dv, delta1 = _bwd_state(rng, cuda_device, b, hq, hkv, s, d)
    delta0 = _rand(rng, cuda_device, torch.float32, b, hq, s, scale=0.1)
    want = [t.clone() for t in (dq, dk, dv)]
    routes = dict(fm.ring_routes)

    def two_hops(run_dq, run_dkv, sums, *plain):
        for kk, vv, pos in ((k1, v1, (1, 2, 1, 2)), (k0, v0, (1, 2, 0, 2))):
            run_dq(q1, kk, vv, do1, lse1, delta1, sums[0], pos, *plain)
        for qq, dd, ll, de, pos in ((q1, do1, lse1, delta1, (1, 2, 1, 2)),
                                    (q0, do0, lse0, delta0, (0, 2, 1, 2))):
            run_dkv(qq, k1, v1, dd, ll, de, sums[1], sums[2], pos, *plain)

    two_hops(fm.flash_ring_dq_block, fm.flash_ring_dkv_block, (dq, dk, dv))
    two_hops(fm.ring_bwd_dq_ref, fm.ring_bwd_dkv_ref, want, True, d ** -0.5)
    torch.cuda.synchronize()
    assert _route_delta(routes) == {"ring_bwd_dq.wgmma": 2,
                                    "ring_bwd_dkv.wgmma": 2}
    _check_grads((dq, dk, dv), want, RTOL[torch.bfloat16])


@pytest.mark.cuda
def test_cuda_ring_kernels_reject_bad_state(cuda_device):
    """The fp32 state must be contiguous fp32 of the right shape, the
    position strides positive and the positions within 32 bits: each
    raises before any launch."""
    b, hq, hkv, s, d = 1, 4, 2, 64, 64
    q = torch.zeros((b, hq, s, d), device=cuda_device, dtype=torch.bfloat16)
    k = torch.zeros((b, hkv, s, d), device=cuda_device, dtype=torch.bfloat16)
    m, l, acc = _fresh_state(b, hq, s, d, cuda_device)
    with pytest.raises(ValueError, match="ring state"):
        fm.flash_carry_block(q, k, k, m, l, acc.bfloat16(), (0, 1, 0, 1))
    with pytest.raises(ValueError, match="strides"):
        fm.flash_carry_block(q, k, k, m, l, acc, (0, 0, 0, 1))
    with pytest.raises(ValueError, match="32-bit"):
        fm.flash_carry_block(q, k, k, m, l, acc, (2 ** 31 - 10, 1, 0, 1))


# b, hq, hkv, s_l, d, causal, window, pos: the int8 K/V lanes
INT8_CASES = [
    (1, 8, 2, 130, 128, True, None, (1, 2, 0, 2)),      # tail, striped 1 <- 0
    (1, 8, 2, 130, 128, True, None, (0, 2, 1, 2)),      # striped 0 <- 1
    (2, 4, 4, 50, 64, False, None, (50, 1, 0, 1)),      # short, non-causal MHA
    (1, 8, 2, 320, 64, True, 90, (1, 2, 0, 2)),         # window: dead tiles
    (1, 4, 2, 256, 128, True, 100, (256, 1, 0, 1)),     # contiguous, window
    (1, 4, 1, 192, 256, True, None, (1, 2, 0, 2)),      # D 256, MQA
    (1, 32, 8, 256, 128, True, None, (1, 2, 0, 2)),     # llama3-8b heads, striped
    (1, 8, 2, 256, 64, True, None, (256, 1, 0, 1)),     # contiguous, fully live
    (1, 8, 2, 50, 128, True, None, (50, 1, 0, 1)),      # S % 4 != 0: scale boxes
    (1, 8, 2, 1000, 128, True, None, (1, 2, 0, 2)),     # S % 128 != 0, many items
    (2, 32, 8, 1024, 128, True, 200, (1024, 1, 0, 1)),  # rounds of items, dead ones among them
]
INT8_IDS = ["tail-130-1from0", "tail-130-0from1", "short-50-noncausal",
            "window-d64", "contig-window", "d256-mqa", "gqa-32-8-striped",
            "contig-live-d64", "s50-d128-live", "tail-1000",
            "rounds-window-dead-items"]
INT8_RTOL = {torch.bfloat16: 2.0 ** -10, torch.float32: 1e-4}
RING_KERNELS = ("ring_carry", "ring_bwd_dq", "ring_bwd_dkv")


def _int8_routes(dtype, d):
    """The route each ring kernel takes over int8 K/V that TMA can read."""
    if dtype == torch.float32:
        return dict.fromkeys(RING_KERNELS, "fma_s8")
    if d not in (64, 128):
        return dict.fromkeys(RING_KERNELS, "mma_s8")
    return dict.fromkeys(RING_KERNELS, "wgmma_s8")


def _int8_kv(rng, dev, b, hkv, s, d):
    """int8 payloads and compact fp32 row scales of K and V."""
    def rows():
        return (torch.from_numpy(rng.integers(-127, 128, (b, hkv, s, d))
                                 .astype(np.int8)).to(dev),
                torch.from_numpy(rng.uniform(0.005, 0.03, (b, hkv, s))
                                 .astype(np.float32)).to(dev))
    (kp, ks), (vp, vs) = rows(), rows()
    return kp, vp, dict(k_scale=ks, v_scale=vs)


@pytest.mark.cuda
@pytest.mark.parametrize("case", INT8_CASES, ids=INT8_IDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_cuda_ring_int8_lanes_match_plain_version(case, dtype, cuda_device):
    """A visiting hop over int8 K/V from the state of the exact own block,
    then dq and dk/dv of that hop into seeded fp32 accumulators: each int8
    lane against its plain version, and one launch a kernel on the lane
    ``ring_route`` picks for it (bf16 at D 64/128: all three on
    wgmma_s8)."""
    b, hq, hkv, s, d, causal, window, pos = case
    rng, q, k, v, do = _case(case, dtype, cuda_device, seed=3)
    kp, vp, wire = _int8_kv(rng, cuda_device, b, hkv, s, d)
    scale = d ** -0.5
    kw = dict(causal=causal, sm_scale=scale, window=window)
    own = (pos[0], pos[1], pos[0], pos[1])
    want = _int8_routes(dtype, d)
    assert fm.ring_route("ring_carry", q, kp, vp) == want["ring_carry"]
    for n in RING_KERNELS[1:]:
        assert fm.ring_route(n, q, kp, vp, do) == want[n]
    state = _fresh_state(b, hq, s, d, cuda_device)
    fm.ring_carry_ref(q, k, v, *state, own, causal, scale, window)
    ref = tuple(t.clone() for t in state)
    routes = dict(fm.ring_routes)
    fm.flash_carry_block(q, kp, vp, *state, pos, **kw, **wire)
    fm.ring_carry_ref(q, kp, vp, *ref, pos, causal, scale, window, **wire)
    torch.cuda.synchronize()
    _check_carry(state, ref, INT8_RTOL[dtype])
    m, l, _ = ref
    lse = (m + torch.log(l.clamp(min=1e-20))).contiguous()
    *got, delta = _bwd_state(rng, cuda_device, b, hq, hkv, s, d)
    grads = [t.clone() for t in got]
    bwd = (q, kp, vp, do, lse, delta)
    fm.flash_ring_dq_block(*bwd, got[0], pos, **kw, **wire)
    fm.flash_ring_dkv_block(*bwd, got[1], got[2], pos, **kw, **wire)
    fm.ring_bwd_dq_ref(*bwd, grads[0], pos, causal, scale, window, **wire)
    fm.ring_bwd_dkv_ref(*bwd, grads[1], grads[2], pos, causal, scale, window,
                        **wire)
    torch.cuda.synchronize()
    assert _route_delta(routes) == {f"{n}.{r}": 1 for n, r in want.items()}
    _check_grads(got, grads, INT8_RTOL[dtype])


@pytest.mark.cuda
def test_cuda_ring_int8_dead_hop_and_bad_scales(cuda_device):
    """A hop whose tiles are all dead leaves the state bit for bit, the
    three kernels' on wgmma_s8; scales of the wrong
    shape or dtype, one scale alone, or int8 K/V without scales raise
    before any launch."""
    b, hq, hkv, s, d = 1, 4, 2, 128, 128
    rng, q, _, _, do = _case((b, hq, hkv, s, d), torch.bfloat16, cuda_device)
    kp, vp, wire = _int8_kv(rng, cuda_device, b, hkv, s, d)
    state = _fresh_state(b, hq, s, d, cuda_device)
    state[2].normal_()
    dq, dk, dv, delta = _bwd_state(rng, cuda_device, b, hq, hkv, s, d)
    lse = state[0].clone()
    before = tuple(t.clone() for t in (*state, dq, dk, dv))
    routes = dict(fm.ring_routes)
    future = (0, 1, s, 1)
    fm.flash_carry_block(q, kp, vp, *state, future, **wire)
    fm.flash_ring_dq_block(q, kp, vp, do, lse, delta, dq, future, **wire)
    fm.flash_ring_dkv_block(q, kp, vp, do, lse, delta, dk, dv, future, **wire)
    torch.cuda.synchronize()
    assert _route_delta(routes) == {
        f"{n}.{r}": 1 for n, r in _int8_routes(torch.bfloat16, d).items()}
    assert all(torch.equal(a, b_) for a, b_ in zip((*state, dq, dk, dv), before))
    with pytest.raises(ValueError, match="row scales"):
        fm.flash_carry_block(q, kp, vp, *state, (0, 1, 0, 1),
                             k_scale=wire["k_scale"][..., :-1],
                             v_scale=wire["v_scale"])
    with pytest.raises(ValueError, match="row scales"):
        fm.flash_carry_block(q, kp, vp, *state, (0, 1, 0, 1),
                             k_scale=wire["k_scale"].double(),
                             v_scale=wire["v_scale"])
    with pytest.raises(ValueError, match="together"):
        fm.flash_carry_block(q, kp, vp, *state, (0, 1, 0, 1),
                             k_scale=wire["k_scale"])
    with pytest.raises(TypeError, match="dtype"):
        fm.flash_carry_block(q, kp, vp, *state, (0, 1, 0, 1))


@pytest.mark.cuda
def test_cuda_ring_int8_wgmma_dead_items_keep_their_rows(cuda_device):
    """A windowed contiguous hop over int8 K/V (rank 1 <- block 0, window
    100) into a seeded state: on wgmma_s8 each 128-row carry and dq item
    from row 128 on and each 128-key dk/dv item below key 384 has no live
    tile, and their rows come back bit for bit; the live rows match the
    plain versions."""
    b, hq, hkv, s, d, window = 1, 8, 2, 512, 128, 100
    pos = (s, 1, 0, 1)
    rng, q, _, _, do = _case((b, hq, hkv, s, d), torch.bfloat16, cuda_device,
                             seed=8)
    kp, vp, wire = _int8_kv(rng, cuda_device, b, hkv, s, d)
    m = _rand(rng, cuda_device, torch.float32, b, hq, s)
    l = _rand(rng, cuda_device, torch.float32, b, hq, s).abs() + 1
    acc = _rand(rng, cuda_device, torch.float32, b, hq, s, d)
    dq, dk, dv, delta = _bwd_state(rng, cuda_device, b, hq, hkv, s, d)
    lse = _lse_of(q, kp, vp, pos, True, window, wire)
    before = [t.clone() for t in (m, l, acc, dq, dk, dv)]
    want = [t.clone() for t in (m, l, acc, dq, dk, dv)]
    routes = dict(fm.ring_routes)
    fm.flash_carry_block(q, kp, vp, m, l, acc, pos, window=window, **wire)
    fm.flash_ring_dq_block(q, kp, vp, do, lse, delta, dq, pos, window=window,
                           **wire)
    fm.flash_ring_dkv_block(q, kp, vp, do, lse, delta, dk, dv, pos,
                            window=window, **wire)
    fm.ring_carry_ref(q, kp, vp, *want[:3], pos, True, d ** -0.5, window,
                      **wire)
    fm.ring_bwd_dq_ref(q, kp, vp, do, lse, delta, want[3], pos, True,
                       d ** -0.5, window, **wire)
    fm.ring_bwd_dkv_ref(q, kp, vp, do, lse, delta, want[4], want[5], pos,
                        True, d ** -0.5, window, **wire)
    torch.cuda.synchronize()
    assert _route_delta(routes) == {
        f"{n}.{r}": 1 for n, r in _int8_routes(torch.bfloat16, d).items()}
    for got, was in zip((m, l, acc, dq), before[:4]):
        assert torch.equal(got[:, :, 128:], was[:, :, 128:])
    for got, was in zip((dk, dv), before[4:]):
        assert torch.equal(got[:, :, :384], was[:, :, :384])
    _check_carry((m, l, acc), want[:3], INT8_RTOL[torch.bfloat16])
    _check_grads((dq, dk, dv), want[3:], INT8_RTOL[torch.bfloat16])


@pytest.mark.cuda
def test_cuda_ring_int8_expanded_kv_takes_mma_s8(cuda_device):
    """An expanded int8 K/V (stride 0 over the KV heads) is no view a TMA
    tensor map takes: all three kernels run the 64 x 64 walk's int8 lane
    (mma_s8) and match their plain versions."""
    b, hq, hkv, s, d = 1, 8, 2, 256, 128
    pos = (1, 2, 0, 2)
    rng, q, _, _, do = _case((b, hq, hkv, s, d), torch.bfloat16, cuda_device,
                             seed=9)
    kp, vp, wire = _int8_kv(rng, cuda_device, b, 1, s, d)
    kp, vp = (x.expand(b, hkv, s, d) for x in (kp, vp))
    wire = {n: x.expand(b, hkv, s).contiguous() for n, x in wire.items()}
    assert {n: fm.ring_route(n, q, kp, vp, None if n == "ring_carry" else do)
            for n in RING_KERNELS} == dict.fromkeys(RING_KERNELS, "mma_s8")
    state = _fresh_state(b, hq, s, d, cuda_device)
    ref = tuple(t.clone() for t in state)
    lse = _lse_of(q, kp, vp, pos, True, None, wire)
    dq, dk, dv, delta = _bwd_state(rng, cuda_device, b, hq, hkv, s, d)
    want = [t.clone() for t in (dq, dk, dv)]
    routes = dict(fm.ring_routes)
    fm.flash_carry_block(q, kp, vp, *state, pos, **wire)
    fm.flash_ring_dq_block(q, kp, vp, do, lse, delta, dq, pos, **wire)
    fm.flash_ring_dkv_block(q, kp, vp, do, lse, delta, dk, dv, pos, **wire)
    fm.ring_carry_ref(q, kp, vp, *ref, pos, True, d ** -0.5, **wire)
    fm.ring_bwd_dq_ref(q, kp, vp, do, lse, delta, want[0], pos, True,
                       d ** -0.5, **wire)
    fm.ring_bwd_dkv_ref(q, kp, vp, do, lse, delta, want[1], want[2], pos,
                        True, d ** -0.5, **wire)
    torch.cuda.synchronize()
    assert _route_delta(routes) == {f"{n}.mma_s8": 1 for n in RING_KERNELS}
    _check_carry(state, ref, INT8_RTOL[torch.bfloat16])
    _check_grads((dq, dk, dv), want, INT8_RTOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_ring_int8_hop_composes_with_bf16_hop(d, cuda_device):
    """Rank 1 of two striped ranks: its own block's hop in bf16 (wgmma),
    then block 0's visiting hop over int8 K/V (all three on wgmma_s8), into
    the same fp32 state: m, l, acc, dq and block 0's
    traveling dk/dv after both hops equal the same two hops through the
    plain versions."""
    b, hq, hkv, s = 1, 8, 2, 320
    own, visit = (1, 2, 1, 2), (1, 2, 0, 2)
    rng = np.random.default_rng(10)
    q, do = (_rand(rng, cuda_device, torch.bfloat16, b, hq, s, d)
             for _ in range(2))
    k1, v1 = (_rand(rng, cuda_device, torch.bfloat16, b, hkv, s, d)
              for _ in range(2))
    kp, vp, wire = _int8_kv(rng, cuda_device, b, hkv, s, d)
    scale = d ** -0.5
    state = _fresh_state(b, hq, s, d, cuda_device)
    ref = tuple(t.clone() for t in state)
    routes = dict(fm.ring_routes)
    fm.flash_carry_block(q, k1, v1, *state, own)
    fm.flash_carry_block(q, kp, vp, *state, visit, **wire)
    fm.ring_carry_ref(q, k1, v1, *ref, own, True, scale)
    fm.ring_carry_ref(q, kp, vp, *ref, visit, True, scale, **wire)
    m, l, _ = ref
    lse = (m + torch.log(l.clamp(min=1e-20))).contiguous()
    dq, dk, dv, delta = _bwd_state(rng, cuda_device, b, hq, hkv, s, d)
    want = [t.clone() for t in (dq, dk, dv)]
    # dq takes both hops; block 0's dk/dv meet rank 1's queries on the
    # visiting hop, after a bf16 dk/dv hop of rank 1's own block into them
    fm.flash_ring_dq_block(q, k1, v1, do, lse, delta, dq, own)
    fm.flash_ring_dq_block(q, kp, vp, do, lse, delta, dq, visit, **wire)
    fm.flash_ring_dkv_block(q, k1, v1, do, lse, delta, dk, dv, own)
    fm.flash_ring_dkv_block(q, kp, vp, do, lse, delta, dk, dv, visit, **wire)
    fm.ring_bwd_dq_ref(q, k1, v1, do, lse, delta, want[0], own, True, scale)
    fm.ring_bwd_dq_ref(q, kp, vp, do, lse, delta, want[0], visit, True, scale,
                       **wire)
    fm.ring_bwd_dkv_ref(q, k1, v1, do, lse, delta, want[1], want[2], own,
                        True, scale)
    fm.ring_bwd_dkv_ref(q, kp, vp, do, lse, delta, want[1], want[2], visit,
                        True, scale, **wire)
    torch.cuda.synchronize()
    assert _route_delta(routes) == {
        "ring_carry.wgmma": 1, "ring_carry.wgmma_s8": 1,
        "ring_bwd_dq.wgmma": 1, "ring_bwd_dq.wgmma_s8": 1,
        "ring_bwd_dkv.wgmma": 1, "ring_bwd_dkv.wgmma_s8": 1}
    _check_carry(state, ref, INT8_RTOL[torch.bfloat16])
    _check_grads((dq, dk, dv), want, INT8_RTOL[torch.bfloat16])

