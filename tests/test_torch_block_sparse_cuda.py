"""The port's CUDA block-sparse attention and Lion kernels against their
plain PyTorch versions on the card: ``bsa_fwd``, ``bsa_bwd_dq`` and
``bsa_bwd_dkv`` (``ops/csrc/block_sparse_attention.cu``) over every
sparsity mode, per-head layouts, GQA, head_dim 64 and 128, causal and not,
layout blocks from 16 to 256 tokens and sequence tails, in bf16 and fp32;
and ``fused_lion`` (``ops/csrc/fused_lion.cu``) bit for bit.

No JAX here: the machine with the card has none.  Run there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_block_sparse_cuda.py -m cuda

Without a card every test skips.  Tolerance: |kernel - plain| <= rtol *
(1 + |plain|), by the output's dtype: rtol = 2^-7 for bf16 outputs (about
two bf16 ulps: the two sum in other orders before rounding p, ds and the
outputs to bf16) and 1e-4 for fp32 outputs, lse in every case.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import block_sparse_mha as bsm
from deepspeed_tpu_torch.ops import fused_optimizer as fo
from deepspeed_tpu_torch.ops import sparse_attention as sa


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# b, hq, hkv, s, d, causal, config class, kwargs
CASES = [
    (2, 4, 4, 512, 64, True, "BSLongformerSparsityConfig",
     dict(block=16, attention="unidirectional")),
    (1, 4, 2, 384, 64, False, "FixedSparsityConfig",
     dict(block=16, num_local_blocks=4, num_global_blocks=1)),
    (1, 8, 2, 512, 128, True, "BigBirdSparsityConfig",
     dict(block=32, num_random_blocks=2, different_layout_per_head=True,
          seed=3)),
    (1, 4, 1, 200, 64, False, "VariableSparsityConfig",
     dict(block=40, local_window_blocks=[1, 2, 3])),      # tail, block 40
    (1, 2, 2, 512, 64, True, "BSLongformerSparsityConfig",
     dict(block=256, num_sliding_window_blocks=1)),     # block > tile
    (1, 4, 4, 256, 128, True, "DenseSparsityConfig", dict(block=128)),
]
IDS = ["bslongformer", "fixed-gqa-bidir", "bigbird-per-head-gqa-d128",
       "variable-tail-b40", "block256", "dense-b128"]
RTOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-4}


def _close(got, ref, rtol):
    diff = (got.float() - ref.float()).abs()
    return bool((diff <= rtol * (1 + ref.float().abs())).all()), float(diff.max())


def _inputs(case, dtype, dev, seed=0):
    b, hq, hkv, s, d = case[:5]
    rng = np.random.default_rng(seed)

    def t(*shape):   # the model's layout: [B, S, H, D] read as [B, H, S, D]
        x = rng.standard_normal((shape[0], shape[2], shape[1], shape[3]))
        return torch.from_numpy(x.astype(np.float32)).to(dev, dtype).transpose(1, 2)

    return t(b, hq, s, d), t(b, hkv, s, d), t(b, hkv, s, d), t(b, hq, s, d)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_cuda_block_sparse_kernels_match_plain_version(case, dtype,
                                                       cuda_device):
    b, hq, hkv, s, d, causal, name, kw = case
    layout = getattr(sa, name)(num_heads=hq, **kw).make_layout(s)
    plan = bsm.SparseLayout(layout, kw["block"], causal, cuda_device)
    q, k, v, do = _inputs(case, dtype, cuda_device)
    scale = d ** -0.5
    before = dict(bsm.block_sparse_mha.launches)
    o, lse = bsm.bsa_fwd(q, k, v, plan, scale)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    dq = bsm.bsa_bwd_dq(q, k, v, do.contiguous(), lse, delta, plan, scale)
    dk, dv = bsm.bsa_bwd_dkv(q, k, v, do.contiguous(), lse, delta, plan,
                             scale)
    torch.cuda.synchronize()
    assert {n: bsm.block_sparse_mha.launches[n] - before[n] for n in before} \
        == {"bsa_fwd": 1, "bsa_bwd_dq": 1, "bsa_bwd_dkv": 1}
    o_r, lse_r = bsm.bsa_fwd_ref(q, k, v, plan, scale)
    dq_r = bsm.bsa_bwd_dq_ref(q, k, v, do, lse, delta, plan, scale)
    dk_r, dv_r = bsm.bsa_bwd_dkv_ref(q, k, v, do, lse, delta, plan, scale)
    for what, got, ref in (("o", o, o_r), ("lse", lse, lse_r), ("dq", dq, dq_r),
                           ("dk", dk, dk_r), ("dv", dv, dv_r)):
        assert got.shape == ref.shape and got.dtype == ref.dtype, what
        ok, err = _close(got, ref, RTOL[got.dtype])
        assert ok, f"{what}: max abs err {err}"


@pytest.mark.cuda
def test_cuda_empty_rows_and_autograd_through_sparse_attention(cuda_device):
    """A layout whose query block 2 sees no key: zeros and lse -1e30 there,
    and sparse_attention's autograd over [B, S, H, D] equals the plain
    versions' (bf16)."""
    b, s, hq, hkv, d, block = 2, 256, 4, 2, 64, 32
    layout = np.tril(np.ones((hq, s // block, s // block), np.int64))
    layout[:, 2, :] = 0

    class _Given(sa.SparsityConfig):
        def make_layout(self, seq_len):
            return layout

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((b, s, (hq + 2 * hkv) * d))
                         .astype(np.float32)).to(cuda_device, torch.bfloat16)

    def run():
        xx = x.clone().requires_grad_(True)
        q, k, v = torch.split(xx, [hq * d, hkv * d, hkv * d], dim=-1)
        out = sa.sparse_attention(q.reshape(b, s, hq, d), k.reshape(b, s, hkv, d),
                                  v.reshape(b, s, hkv, d),
                                  _Given(num_heads=hq, block=block), causal=True)
        out.float().square().sum().backward()
        return out.detach(), xx.grad

    before = bsm.block_sparse_mha.launches["bsa_bwd_dkv"]
    out_k, g_k = run()
    assert bsm.block_sparse_mha.launches["bsa_bwd_dkv"] == before + 1
    assert torch.all(out_k[:, 2 * block:3 * block] == 0)
    saved = bsm.bsa_fwd, bsm.bsa_bwd_dq, bsm.bsa_bwd_dkv
    try:
        bsm.bsa_fwd, bsm.bsa_bwd_dq, bsm.bsa_bwd_dkv = (
            bsm.bsa_fwd_ref, bsm.bsa_bwd_dq_ref, bsm.bsa_bwd_dkv_ref)
        out_r, g_r = run()
    finally:
        bsm.bsa_fwd, bsm.bsa_bwd_dq, bsm.bsa_bwd_dkv = saved
    for got, ref in ((out_k, out_r), (g_k, g_r)):
        ok, err = _close(got, ref, RTOL[torch.bfloat16])
        assert ok, err


@pytest.mark.cuda
@pytest.mark.parametrize("wd", [0.0, 0.1], ids=["no-decay", "decay"])
def test_cuda_fused_lion_bitwise(wd, cuda_device):
    """One launch over leaves of awkward sizes and one leaf that is not
    16-byte aligned (the scalar path), three steps: bit for bit equal to
    the plain version."""
    rng = np.random.default_rng(6)
    sizes = [1, 3, 127, fo.CHUNK + 5, 2 * fo.CHUNK]

    def leaves(n, offset=0):
        buf = torch.from_numpy(rng.standard_normal(n + offset).astype(np.float32))
        return buf.to(cuda_device)[offset:]

    ps = [leaves(n) for n in sizes] + [leaves(1001, offset=1)]
    ms = [leaves(p.numel()) * 1e-3 for p in ps]
    ref = [[t.clone() for t in group] for group in (ps, ms)]
    table = fo.LeafTable()
    for _ in range(3):
        gs = [torch.from_numpy(rng.standard_normal(p.numel()).astype(np.float32))
              .to(cuda_device) for p in ps]
        before = fo.fused_lion.launches["fused_lion"]
        fo.fused_lion(ps, gs, ms, lr=1e-3, wd=wd, table=table)
        assert fo.fused_lion.launches["fused_lion"] == before + 1
        for p, g, m in zip(ref[0], gs, ref[1]):
            fo.lion_leaf_ref(p, g, m, 1e-3, 0.9, 0.99, wd)
    torch.cuda.synchronize()
    for got_group, ref_group in zip((ps, ms), ref):
        for got, want in zip(got_group, ref_group):
            assert torch.equal(got, want)
