"""The port's ring-attention hop kernels against their plain PyTorch
versions on the card: ``ring_carry``, ``ring_bwd_dq`` and ``ring_bwd_dkv``
(``ops/csrc/ring_attention.cu``) over hops of both placements (the own
block on the diagonal, a striped neighbour, a fully live contiguous
source), MHA and GQA, head_dim 64 and 128, a sliding window, non-causal
hops and a shard length that is not a multiple of 64, in bf16 and fp32.

No JAX here: the machine with the card has none.  Run there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ring_cuda.py -m cuda

Without a card every test skips.  Tolerances, by the operands' dtype:
bf16 2^-7 and fp32 1e-4, as |kernel - plain| <= rtol * (1 + |plain|) on
the normalised carry ``acc / l``, on ``l`` and on the fp32 accumulators
dq, dk and dv (the two sum in other orders before p and ds round to
bf16), and 1e-4 on ``m`` (a max of fp32 scores).  A dead hop leaves the
state bit for bit as it was.
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
]
IDS = ["striped-own", "striped-1from0", "striped-0from1", "contig-own",
       "contig-live", "mha-d64", "window", "noncausal", "tail"]
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
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), grads):
        ok, err = _close(got, want, RTOL[dtype])
        assert ok, f"{name}: max abs err {err}"


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
    fm.flash_carry_block(q, k, v, m, l, acc, pos, causal=causal)
    fm.flash_ring_dq_block(q, k, v, do, lse, delta, dq, pos, causal=causal)
    fm.flash_ring_dkv_block(q, k, v, do, lse, delta, dk, dv, pos, causal=causal)
    torch.cuda.synchronize()
    for got, want in zip((m, l, acc, dq, dk, dv), before):
        assert torch.equal(got, want)


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
