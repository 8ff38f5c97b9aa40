"""The port's CUDA training kernels against their plain PyTorch versions on
the card: ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv``
(``ops/csrc/flash_attention.cu``) over MHA and GQA, head_dim 64 and 128,
causal and not, sliding windows and sequence tails, in bf16 and fp32; and
``fused_adamw`` (``ops/csrc/fused_adamw.cu``) bit for bit.

No JAX here: the machine with the card has none.  Run there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_flash_attention_cuda.py -m cuda

Without a card every test skips.  Tolerance: |kernel - plain| <= rtol *
(1 + |plain|), by the output's dtype: rtol = 2^-7 for bf16 outputs (about
two bf16 ulps: the two sum in other orders before rounding p, ds and the
outputs to bf16) and 1e-4 for fp32 outputs, lse in every case (summation
order over up to S keys, no TF32 on either side).
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import flash_mha as fm
from deepspeed_tpu_torch.ops import fused_optimizer as fo
from deepspeed_tpu_torch.ops.flash_attention import flash_attention


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# b, hq, hkv, s, d, causal, window
CASES = [
    (2, 4, 4, 256, 64, True, None),      # MHA causal
    (2, 4, 4, 192, 64, False, None),     # bidirectional
    (1, 8, 2, 320, 128, True, None),     # GQA 4x, d=128
    (1, 4, 2, 200, 64, True, None),      # tail: S % 64 != 0
    (1, 4, 4, 384, 64, True, 100),       # sliding window
    (1, 4, 1, 130, 128, False, 48),      # window without causal, tail, MQA
    (1, 4, 2, 1000, 64, True, None),     # tail: S % 128 != 0 over many tiles
    (2, 4, 4, 50, 64, True, None),       # S below one tile
    (1, 8, 2, 700, 128, True, 300),      # GQA, d=128, window over tile edges
]
IDS = ["mha-causal", "mha-full", "gqa-d128", "tail", "window", "window-full-mqa",
       "tail-1000", "short", "gqa-d128-window"]
RTOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-4}


def _close(got, ref, rtol):
    diff = (got.float() - ref.float()).abs()
    return bool((diff <= rtol * (1 + ref.float().abs())).all()), float(diff.max())


def _inputs(case, dtype, dev, seed=0):
    b, hq, hkv, s, d, _causal, _window = case
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)

    return t(b, hq, s, d), t(b, hkv, s, d), t(b, hkv, s, d), t(b, hq, s, d)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_cuda_flash_kernels_match_plain_version(case, dtype, cuda_device):
    causal, window = case[5], case[6]
    q, k, v, do = _inputs(case, dtype, cuda_device)
    scale = 1.0 / np.sqrt(case[4])
    before = dict(fm.flash_mha.launches)
    routes = dict(fm.flash_mha.routes)
    o, lse = fm.flash_fwd(q, k, v, causal, scale, window)
    dq, dk, dv = fm.flash_bwd(q, k, v, o, lse, do, causal, scale, window)
    torch.cuda.synchronize()
    assert {n: fm.flash_mha.launches[n] - before[n] for n in before} == \
        {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    want = "wgmma" if dtype == torch.bfloat16 else "fma"
    assert {r: n - routes[r] for r, n in fm.flash_mha.routes.items()
            if n != routes[r]} == {f"flash_fwd.{want}": 1}
    o_r, lse_r = fm.flash_fwd_ref(q, k, v, causal, scale, window)
    grads_r = fm.flash_bwd_ref(q, k, v, o_r, lse_r, do, causal, scale, window)
    for name, got, ref in [("o", o, o_r), ("lse", lse, lse_r)] + list(
            zip(("dq", "dk", "dv"), (dq, dk, dv), grads_r)):
        assert got.shape == ref.shape and got.dtype == ref.dtype, name
        ok, err = _close(got, ref, RTOL[got.dtype])
        assert ok, f"{name}: max abs err {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES[2:4], ids=IDS[2:4])
def test_cuda_flash_fwd_expanded_kv_takes_the_mma_route(case, cuda_device):
    """K/V expanded over their heads (a zero head stride) are more than a
    TMA tensor map takes: the bf16 forward runs the 64 x 64 tile walk,
    against the same plain version."""
    b, hq, hkv, s, d, causal, window = case
    q, k, v, _ = _inputs(case, torch.bfloat16, cuda_device)
    k, v = k[:, :1].expand(b, hkv, s, d), v[:, :1].expand(b, hkv, s, d)
    assert fm.fwd_route(q, k, v) == "mma"
    before = fm.flash_mha.routes["flash_fwd.mma"]
    o, lse = fm.flash_fwd(q, k, v, causal, 1.0 / np.sqrt(d), window)
    torch.cuda.synchronize()
    assert fm.flash_mha.routes["flash_fwd.mma"] == before + 1
    o_r, lse_r = fm.flash_fwd_ref(q, k, v, causal, 1.0 / np.sqrt(d), window)
    for name, got, ref in (("o", o, o_r), ("lse", lse, lse_r)):
        ok, err = _close(got, ref, RTOL[got.dtype])
        assert ok, f"{name}: max abs err {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [0.3, -0.125], ids=["0.3", "negative"])
@pytest.mark.parametrize("case", [CASES[0], CASES[8]], ids=[IDS[0], IDS[8]])
def test_cuda_flash_fwd_wgmma_takes_any_scale(case, scale, cuda_device):
    """The wgmma forward at a softmax scale other than 1/sqrt(d), negative
    too (where a row's largest raw score is not its largest scaled one),
    against the plain version."""
    b, hq, hkv, s, d, causal, window = case
    q, k, v, _ = _inputs(case, torch.bfloat16, cuda_device, seed=4)
    before = fm.flash_mha.routes["flash_fwd.wgmma"]
    o, lse = fm.flash_fwd(q, k, v, causal, scale, window)
    torch.cuda.synchronize()
    assert fm.flash_mha.routes["flash_fwd.wgmma"] == before + 1
    o_r, lse_r = fm.flash_fwd_ref(q, k, v, causal, scale, window)
    for name, got, ref in (("o", o, o_r), ("lse", lse, lse_r)):
        ok, err = _close(got, ref, RTOL[got.dtype])
        assert ok, f"{name}: max abs err {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_cuda_flash_attention_autograd_in_model_layout(dtype, cuda_device,
                                                      monkeypatch):
    """flash_attention over [B, S, H, D] projections (read in place
    through strides) and autograd's gradient: the kernels against the same
    function on the plain versions."""
    b, s, hq, hkv, d = 2, 136, 8, 2, 64
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((b, s, (hq + 2 * hkv) * d))
                           .astype(np.float32)).to(cuda_device, dtype)
    w = torch.from_numpy(rng.standard_normal((b, s, hq, d)).astype(np.float32)
                         ).to(cuda_device, dtype)

    def run():
        x = qkv.clone().requires_grad_(True)
        q, k, v = torch.split(x, [hq * d, hkv * d, hkv * d], dim=-1)
        out = flash_attention(q.reshape(b, s, hq, d), k.reshape(b, s, hkv, d),
                              v.reshape(b, s, hkv, d), causal=True)
        (out.float() * w.float()).sum().backward()
        return out.detach(), x.grad

    before = fm.flash_mha.launches["flash_bwd_dkv"]
    out_k, g_k = run()
    assert fm.flash_mha.launches["flash_bwd_dkv"] == before + 1
    monkeypatch.setattr(fm, "flash_fwd", fm.flash_fwd_ref)
    monkeypatch.setattr(fm, "flash_bwd", fm.flash_bwd_ref)
    out_r, g_r = run()
    for got, ref in ((out_k, out_r), (g_k, g_r)):
        ok, err = _close(got, ref, RTOL[dtype])
        assert ok, err


@pytest.mark.cuda
@pytest.mark.parametrize("wd", [0.0, 0.01], ids=["no-decay", "decay"])
def test_cuda_fused_adamw_bitwise(wd, cuda_device):
    """One launch over leaves of awkward sizes (1, 3, 127, a chunk and a
    bit, two chunks) and one leaf that is not 16-byte aligned (the scalar
    path), three steps: bit for bit equal to the plain version."""
    rng = np.random.default_rng(5)
    sizes = [1, 3, 127, fo.CHUNK + 5, 2 * fo.CHUNK]

    def leaves(n, offset=0):
        buf = torch.from_numpy(rng.standard_normal(n + offset).astype(np.float32))
        return buf.to(cuda_device)[offset:]

    ps = [leaves(n) for n in sizes] + [leaves(1001, offset=1)]
    ms = [torch.zeros_like(p) for p in ps]
    vs = [torch.zeros_like(p) for p in ps]
    ref = [[t.clone() for t in group] for group in (ps, ms, vs)]
    table = fo.LeafTable()
    for count in range(3):
        gs = [torch.from_numpy(rng.standard_normal(p.numel()).astype(np.float32))
              .to(cuda_device) for p in ps]
        before = fo.fused_adamw.launches["fused_adamw"]
        fo.fused_adamw(ps, gs, ms, vs, lr=1e-3, count=count, wd=wd, table=table)
        assert fo.fused_adamw.launches["fused_adamw"] == before + 1
        bc1, bc2 = fo.bias_corrections(count, 0.9, 0.999)
        for p, g, m, v in zip(*ref[:1], gs, *ref[1:]):
            fo.adamw_leaf_ref(p, g, m, v, 1e-3, bc1, bc2, 0.9, 0.999, 1e-8, wd)
    torch.cuda.synchronize()
    for got_group, ref_group in zip((ps, ms, vs), ref):
        for got, want in zip(got_group, ref_group):
            assert torch.equal(got, want)
