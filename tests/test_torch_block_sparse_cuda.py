"""The port's CUDA block-sparse attention and Lion kernels against their
plain PyTorch versions on the card: ``bsa_fwd``, ``bsa_bwd_dq`` and
``bsa_bwd_dkv`` (``ops/csrc/block_sparse_attention.cu``) over every
sparsity mode, per-head layouts, GQA, head_dim 64 and 128, causal and not,
layout blocks from 16 to 256 tokens and sequence tails, in bf16 (every
role on its ``wgmma`` route) and fp32 (``fma``); the forward's ``mma``
route where the rule keeps it (blocks under 16, an expanded K/V); the
wgmma walks' store mode on outputs full of NaN under a layout with dead
items and a row that sees no key; the head_dim lanes (D 32, 80, 96
zero-padded, D 256 on the 64 x 64 walk) against the plain versions at the
real D; and ``fused_lion`` (``ops/csrc/fused_lion.cu``) bit for bit.

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
from deepspeed_tpu_torch.ops import flash_mha as fm
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


def _route_delta(before):
    return {r: n - before[r] for r, n in bsm.block_sparse_mha.routes.items()
            if n != before[r]}


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
    routes = dict(bsm.block_sparse_mha.routes)
    o, lse = bsm.bsa_fwd(q, k, v, plan, scale)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    dq = bsm.bsa_bwd_dq(q, k, v, do.contiguous(), lse, delta, plan, scale)
    dk, dv = bsm.bsa_bwd_dkv(q, k, v, do.contiguous(), lse, delta, plan,
                             scale)
    torch.cuda.synchronize()
    assert {n: bsm.block_sparse_mha.launches[n] - before[n] for n in before} \
        == {"bsa_fwd": 1, "bsa_bwd_dq": 1, "bsa_bwd_dkv": 1}
    route = "wgmma" if dtype == torch.bfloat16 else "fma"
    assert _route_delta(routes) == {f"bsa_fwd.{route}": 1,
                                    f"bsa_bwd_dq.{route}": 1,
                                    f"bsa_bwd_dkv.{route}": 1}
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
def test_cuda_block_sparse_wgmma_store_mode_writes_every_row(cuda_device,
                                                             monkeypatch):
    """The wgmma forward's and backward's store mode under a hand-built
    causal layout (block 32, S 384, GQA): keys 128-255 dead in every head
    (a whole dk/dv item with no live tile), query block 2 sees no key (a
    dead row inside a live forward and dq item), and head 1's rows 256-383
    see nothing (a dead forward and dq item).  Outputs allocated full of
    NaN come back finite, zero on the dead rows and keys (lse -1e30 there),
    and equal to the plain versions."""
    b, hq, hkv, s, d, block = 1, 4, 2, 384, 64, 32
    nb = s // block
    layout = np.tril(np.ones((hq, nb, nb), np.int64))
    layout[:, :, 4:8] = 0
    layout[:, 2, :] = 0
    layout[1, 8:12, :] = 0
    plan = bsm.SparseLayout(layout, block, True, cuda_device)
    case = (b, hq, hkv, s, d)
    q, k, v, do = _inputs(case, torch.bfloat16, cuda_device, seed=2)
    do = do.contiguous()
    scale = d ** -0.5
    empty = fm._empty_bshd
    monkeypatch.setattr(fm, "_empty_bshd",
                        lambda x, heads: empty(x, heads).fill_(float("nan")))
    assert bsm.fwd_route(q, k, v, plan) == "wgmma"
    o, lse = bsm.bsa_fwd(q, k, v, plan, scale)
    torch.cuda.synchronize()
    o_r, lse_r = bsm.bsa_fwd_ref(q, k, v, plan, scale)
    for name, g, r in (("o", o, o_r), ("lse", lse, lse_r)):
        assert bool(torch.isfinite(g).all()), name
        ok, err = _close(g, r, RTOL[g.dtype])
        assert ok, f"{name}: max abs err {err}"
    assert bool((o[:, :, 2 * block:3 * block] == 0).all())
    assert bool((o[:, 1, 8 * block:] == 0).all())
    assert bool((lse[:, 1, 8 * block:] == -1e30).all())
    delta = fm.attn_delta(o, do).contiguous()
    assert bsm.bwd_route(q, k, v, do, plan) == "wgmma"
    got = (bsm.bsa_bwd_dq(q, k, v, do, lse, delta, plan, scale),
           *bsm.bsa_bwd_dkv(q, k, v, do, lse, delta, plan, scale))
    torch.cuda.synchronize()
    ref = (bsm.bsa_bwd_dq_ref(q, k, v, do, lse, delta, plan, scale),
           *bsm.bsa_bwd_dkv_ref(q, k, v, do, lse, delta, plan, scale))
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert bool(torch.isfinite(g).all()), name
        ok, err = _close(g, r, RTOL[g.dtype])
        assert ok, f"{name}: max abs err {err}"
    dq, dk, dv = got
    assert bool((dq[:, :, 2 * block:3 * block] == 0).all())
    assert bool((dq[:, 1, 8 * block:] == 0).all())
    assert bool((dk[:, :, 4 * block:8 * block] == 0).all())
    assert bool((dv[:, :, 4 * block:8 * block] == 0).all())


# b, hq, hkv, s, d, causal, config class, kwargs: the head-dim lanes
D_CASES = [
    (1, 4, 4, 256, 32, True, "BSLongformerSparsityConfig",
     dict(block=16, attention="unidirectional")),
    (1, 4, 2, 256, 80, False, "FixedSparsityConfig",
     dict(block=16, num_local_blocks=4, num_global_blocks=1)),
    (1, 4, 4, 384, 96, True, "BigBirdSparsityConfig",
     dict(block=32, num_random_blocks=1, different_layout_per_head=True,
          seed=5)),
    (1, 4, 2, 256, 256, True, "BSLongformerSparsityConfig",
     dict(block=16, attention="unidirectional")),
]
D_IDS = ["d32", "d80-gqa-bidir", "d96-per-head", "d256-gqa"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", D_CASES, ids=D_IDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_cuda_block_sparse_head_dim_lanes_match_plain_version(case, dtype,
                                                              cuda_device):
    """Each kernel on q, k, v, do zero-padded to the head_dim's lane,
    sliced back, against the plain versions at the real D, on the lane's
    routes (bf16: the backward on wgmma at lanes 64/128, mma at 256; fp32:
    fma); and block_sparse_mha's autograd, which pads itself, against the
    same function on the plain versions."""
    b, hq, hkv, s, d, causal, name, kw = case
    lane = fm.head_dim_lane(d)
    layout = getattr(sa, name)(num_heads=hq, **kw).make_layout(s)
    plan = bsm.SparseLayout(layout, kw["block"], causal, cuda_device)
    q, k, v, do = _inputs(case, dtype, cuda_device, seed=7)
    scale = d ** -0.5
    pad = lambda x: torch.nn.functional.pad(x, (0, lane - d))  # noqa: E731
    qp, kp, vp, dop = (pad(x) for x in (q, k, v, do))
    routes = dict(bsm.block_sparse_mha.routes)
    o, lse = bsm.bsa_fwd(qp, kp, vp, plan, scale)
    delta = fm.attn_delta(o, dop).contiguous()
    dq = bsm.bsa_bwd_dq(qp, kp, vp, dop, lse, delta, plan, scale)
    dk, dv = bsm.bsa_bwd_dkv(qp, kp, vp, dop, lse, delta, plan, scale)
    torch.cuda.synchronize()
    route = "fma" if dtype == torch.float32 else "mma" if lane == 256 else "wgmma"
    assert _route_delta(routes) == {f"bsa_fwd.{route}": 1,
                                    f"bsa_bwd_dq.{route}": 1,
                                    f"bsa_bwd_dkv.{route}": 1}
    o_r, lse_r = bsm.bsa_fwd_ref(q, k, v, plan, scale)
    dq_r = bsm.bsa_bwd_dq_ref(q, k, v, do, lse, delta, plan, scale)
    dk_r, dv_r = bsm.bsa_bwd_dkv_ref(q, k, v, do, lse, delta, plan, scale)
    for what, got, ref in (("o", o[..., :d], o_r), ("lse", lse, lse_r),
                           ("dq", dq[..., :d], dq_r), ("dk", dk[..., :d], dk_r),
                           ("dv", dv[..., :d], dv_r)):
        ok, err = _close(got, ref, RTOL[got.dtype])
        assert ok, f"{what}: max abs err {err}"

    def run():
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = bsm.block_sparse_mha(*xs, plan, kw["block"], causal)
        out.backward(do)
        return [out.detach()] + [x.grad for x in xs]

    got = run()
    saved = bsm.bsa_fwd, bsm.bsa_bwd_dq, bsm.bsa_bwd_dkv
    try:
        bsm.bsa_fwd, bsm.bsa_bwd_dq, bsm.bsa_bwd_dkv = (
            bsm.bsa_fwd_ref, bsm.bsa_bwd_dq_ref, bsm.bsa_bwd_dkv_ref)
        ref = run()
    finally:
        bsm.bsa_fwd, bsm.bsa_bwd_dq, bsm.bsa_bwd_dkv = saved
    for what, g, r in zip(("o", "dq", "dk", "dv"), got, ref):
        assert g.shape == r.shape, what
        ok, err = _close(g, r, RTOL[dtype])
        assert ok, f"autograd {what}: max abs err {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["block8", "expanded-kv"])
def test_cuda_block_sparse_forward_mma_route_that_remains(case, cuda_device):
    """bf16 forwards the wgmma route does not take run the 64 x 64 walk
    (``mma``): layout blocks of 8 (more words than a thread keeps), and a
    K/V expanded over the heads (stride 0, no tensor map); each against
    the plain version."""
    b, hq, hkv, s, d = 1, 4, 2, 256, 64
    block = 8 if case == "block8" else 16
    layout = sa.BSLongformerSparsityConfig(
        num_heads=hq, block=block, attention="unidirectional").make_layout(s)
    plan = bsm.SparseLayout(layout, block, True, cuda_device)
    q, k, v, _ = _inputs((b, hq, hkv, s, d), torch.bfloat16, cuda_device,
                         seed=5)
    if case == "expanded-kv":
        k, v = (x[:, :1].expand(b, hkv, s, d) for x in (k, v))
    routes = dict(bsm.block_sparse_mha.routes)
    o, lse = bsm.bsa_fwd(q, k, v, plan, d ** -0.5)
    torch.cuda.synchronize()
    assert _route_delta(routes) == {"bsa_fwd.mma": 1}
    o_r, lse_r = bsm.bsa_fwd_ref(q, k, v, plan, d ** -0.5)
    for what, got, ref in (("o", o, o_r), ("lse", lse, lse_r)):
        ok, err = _close(got, ref, RTOL[got.dtype])
        assert ok, f"{what}: max abs err {err}"


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
