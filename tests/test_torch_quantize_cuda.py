"""The port's CUDA quantize, dequantize, fake-quantize and FP6 GEMM kernels
against their plain PyTorch versions on the card.

``quantize``, ``dequantize`` and ``fake_quantize``
(``ops/csrc/quantize.cu``) bit for bit, over int8 and int4, bf16, fp16 and
fp32 inputs, groups from 24 to 4096 (any whole number of 16-byte vectors;
above 8 16-byte vectors a lane the
kernel's second pass reads the group again; where such groups are fewer
than 4 a streaming multiprocessor, quantize spreads each over blocks,
the wide-group route), group counts that leave half
a warp or part of a grid step idle, exact .5 ties of x / scale (the
kernel's reciprocal multiply against the IEEE quotient) and a 1-D tensor; ``fp6_matmul`` (``ops/csrc/fp6_linear.cu``) over tails in M, N
and K, decode-sized and large M, bf16, fp16 and fp32 activations, each
call held to the route ``fp6_linear.route`` picks (wgmma for bf16 rows TMA
can read, mma for fp16 and other bf16, fma for fp32), and every e3m2 code
through the wgmma route's decode, value for value; and the ``linear``
layers on CUDA tensors, which must launch the kernels.

No JAX here: the machine with the card has none.  Run there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_quantize_cuda.py -m cuda

Without a card every test skips.  Tolerance for ``fp6_matmul``:
|kernel - plain| <= rtol * (1 + |plain|), rtol 2^-7 for 16-bit outputs
(one rounding of the output after sums in another order) and 1e-4 for
fp32 (summation order over K).
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch import linear as tlin
from deepspeed_tpu_torch.ops import fp6_linear as t6
from deepspeed_tpu_torch.ops import quantize as tqk
from deepspeed_tpu_torch.ops import quantizer as tqz


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _x(shape, dtype, dev, seed=0, scale=3.0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(dev, dtype)


# shape, group.  The kernels' walk: 16-bit groups of 128 are half a warp
# (two a step, an odd count leaving half a warp idle: 33 x 11, 131 x 5,
# 20001 x 3 groups); a lane keeps up to 8 16-byte vectors of a group (384:
# 1.5 a lane in 16 bits, 3 in fp32; 2048 in fp32 and 4096 are read twice);
# 2048 x 4096 and 20001 x 384 take several steps a warp.  64 x 4096 and
# 5 x 8192 quantize on the wide-group route (128 and 10 groups read twice);
# 600 x 4096 in groups of 2048 (1200 groups) keeps the one-warp walk.
# Groups off the multiples of 128: 96 and 24 (24 and 6 fp32 vectors, 12
# and 3 16-bit ones: not a power of two under 32, a whole warp a group),
# 40 (10 and 5), 64 (16 and 8: half and a quarter of a warp) and 200 (50
# fp32 vectors: two a lane, most lanes' second idle).
QUANT_CASES = [((512, 1024), 512), ((300, 384), 128), ((1024,), 256),
               ((4, 8, 256), 256), ((64, 4096), 2048), ((33, 1408), 128),
               ((7, 3072), 384), ((5, 8192), 4096), ((131, 640), 128),
               ((2048, 4096), 512), ((20001, 384), 128),
               ((600, 4096), 2048), ((40, 960), 96), ((17, 72), 24),
               ((9, 120), 40), ((33, 320), 64), ((6, 1000), 200)]
DTYPES = [torch.bfloat16, torch.float16, torch.float32]


def _with_ties(x, gs, bits):
    """x with its second group (flat order) set to exact ties of x / scale:
    (k + 0.5) * s for k over [-qmax, qmax - 1] beside qmax * s (its
    absmax, so scale = s exactly), s = 3 (2 in bf16, whose 8 bits hold no
    odd multiple of 3 as large); in fp32 also the ties one ulp off, up and
    down.  The kernel's reciprocal multiply must round each as the IEEE
    quotient does (half to even, or the nudge's way)."""
    flat = x.view(-1)
    if flat.numel() < 2 * gs:
        return x
    qmax = 2 ** (bits - 1) - 1
    s = 2.0 if x.dtype == torch.bfloat16 else 3.0
    ks = torch.arange(-qmax, qmax, dtype=torch.float32)
    ties = (ks + 0.5) * s
    if x.dtype == torch.float32:
        inf = torch.tensor(float("inf"))
        ties = torch.cat([ties, torch.nextafter(ties, inf), torch.nextafter(ties, -inf)])
    vals = ties.repeat(gs // ties.numel() + 1)[:gs]
    vals[0] = qmax * s
    flat[gs:2 * gs] = vals.to(x.device, x.dtype)
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("shape,gs", QUANT_CASES)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp16", "fp32"])
def test_cuda_quantize_family_bit_equal(shape, gs, bits, dtype, cuda_device):
    x = _with_ties(_x(shape, dtype, cuda_device), gs, bits)
    x[..., :gs] = 0.0   # an all-zero group: scale 1.0
    before = dict(tqk.launches)
    q, s = tqk.quantize(x, bits, gs)
    q_r, s_r = tqk.quantize_ref(x, bits, gs)
    torch.cuda.synchronize()
    assert torch.equal(q, q_r) and torch.equal(s, s_r)
    for out in DTYPES:
        assert torch.equal(tqk.dequantize(q, s, out), tqk.dequantize_ref(q, s, out))
    f = tqk.fake_quantize(x, bits, gs)
    assert f.dtype == dtype and torch.equal(f, tqk.fake_quantize_ref(x, bits, gs))
    assert tqk.launches["quantize"] == before["quantize"] + 1
    assert tqk.launches["dequantize"] == before["dequantize"] + 3
    assert tqk.launches["fake_quantize"] == before["fake_quantize"] + 1


@pytest.mark.cuda
def test_cuda_quantize_unaligned_view_and_facade(cuda_device):
    x = _x((4097,), torch.bfloat16, cuda_device)[1:]   # 2-byte offset view
    assert x.data_ptr() % 16
    q, s = tqk.quantize(x, 8, 512)
    assert torch.equal(q, tqk.quantize_ref(x, 8, 512)[0])
    assert torch.equal(tqk.fake_quantize(x, 4, 512), tqk.fake_quantize_ref(x, 4, 512))
    # the façade: the kernel for every group of whole vectors (96 too),
    # the torch arithmetic for asymmetric mode, an error for a symmetric
    # group the kernel cannot serve
    before = dict(tqk.launches)
    tqz.quantize_blockwise(_x((32, 256), torch.float32, cuda_device), 8, 128)
    tqz.quantize_blockwise(_x((32, 96), torch.float32, cuda_device), 8, 96)
    tqz.quantize_blockwise(_x((32, 256), torch.float32, cuda_device), 8, 128,
                           symmetric=False)
    assert tqk.launches["quantize"] == before["quantize"] + 2
    with pytest.raises(ValueError, match="not served"):
        tqz.quantize_blockwise(_x((32, 90), torch.float32, cuda_device), 8, 90)
    with pytest.raises(ValueError, match="not served"):
        tqz.quantize_blockwise(_x((32, 36), torch.bfloat16, cuda_device), 8, 36)


# m, k, n, the bf16 route: K % 8 == 0 and N % 16 == 0 take wgmma (K 4104:
# a K tail inside a 64-deep chunk; M 300: an M tail), other shapes mma
# (K 4100 and K 12: rows off 16 bytes; N 260, 130, 4104: packed rows off
# 16 bytes)
FP6_CASES = [(16, 512, 1024, "wgmma"), (7, 256, 384, "wgmma"),
             (300, 1000, 260, "mma"), (514, 64, 130, "mma"), (5, 12, 40, "mma"),
             (1, 4096, 512, "wgmma"), (256, 1024, 4096, "wgmma"),
             (64, 4100, 256, "mma"), (48, 4104, 512, "wgmma"),
             (32, 256, 4104, "mma"), (300, 4096, 14336, "wgmma")]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,bf16_route", FP6_CASES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp16", "fp32"])
def test_cuda_fp6_matmul_matches_plain_version(m, k, n, bf16_route, dtype,
                                               cuda_device):
    w = _x((k, n), torch.float32, cuda_device, seed=1, scale=0.02)
    packed, scale = t6.fp6_quantize(w)
    x = _x((m, k), dtype, cuda_device, seed=2, scale=1.0)
    want = {torch.bfloat16: bf16_route, torch.float16: "mma",
            torch.float32: "fma"}[dtype]
    assert t6.route(x, packed) == want
    before = t6.fp6_matmul.launches["fp6_matmul"]
    routes = dict(t6.fp6_matmul.routes)
    out = t6.fp6_matmul(x, packed, scale)
    ref = t6.fp6_matmul_ref(x, packed, scale)
    torch.cuda.synchronize()
    assert t6.fp6_matmul.launches["fp6_matmul"] == before + 1
    assert {r: c - routes[r] for r, c in t6.fp6_matmul.routes.items()
            if c != routes[r]} == {f"fp6_matmul.{want}": 1}
    assert out.dtype == dtype and out.shape == (m, n)
    rtol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    diff = (out.float() - ref.float()).abs()
    assert torch.isfinite(out.float()).all()
    assert bool((diff <= rtol * (1 + ref.float().abs())).all()), float(diff.max())


def _pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """[K, N] e3m2 codes -> the planes [3, K/4, N] (fp6_quantize's packing)."""
    v = codes.to(torch.uint8).reshape(codes.shape[0] // 4, 4, codes.shape[1])
    v0, v1, v2, v3 = v[:, 0], v[:, 1], v[:, 2], v[:, 3]
    return torch.stack([(v0 << 2) | (v1 >> 4), ((v1 & 15) << 4) | (v2 >> 2),
                        ((v2 & 3) << 6) | v3]).contiguous()


@pytest.mark.cuda
def test_cuda_fp6_wgmma_decodes_every_code_exactly(cuda_device):
    """x = I (bf16), scale 1 and every code 0-63 in every column and in
    every 8-row band: the wgmma route's output is the decode table itself,
    value for value (the subnormal codes 1-3 and 33-35 included), across
    both consumer warpgroups' rows and both 64-column boxes."""
    k, n = 256, 128
    kk = torch.arange(k, device=cuda_device)[:, None]
    nn = torch.arange(n, device=cuda_device)[None, :]
    codes = (3 * kk + nn) % 64
    packed = _pack_codes(codes)
    scale = torch.ones(n, device=cuda_device)
    x = torch.eye(k, device=cuda_device, dtype=torch.bfloat16)
    assert t6.route(x, packed) == "wgmma"
    before = t6.fp6_matmul.routes["fp6_matmul.wgmma"]
    out = t6.fp6_matmul(x, packed, scale)
    torch.cuda.synchronize()
    assert t6.fp6_matmul.routes["fp6_matmul.wgmma"] == before + 1
    table = torch.from_numpy(t6.DECODE_TABLE).to(cuda_device)
    want = table[codes]
    assert torch.equal(out.float(), want), \
        sorted(set(codes[out.float() != want].tolist()))


@pytest.mark.cuda
def test_cuda_fp6_quantize_matches_cpu(cuda_device):
    w = _x((256, 384), torch.float32, cuda_device, seed=3, scale=0.02)
    w[:, 7] = 0.0
    p, s = t6.fp6_quantize(w)
    p_c, s_c = t6.fp6_quantize(w.cpu())
    assert torch.equal(p.cpu(), p_c) and torch.equal(s.cpu(), s_c)


@pytest.mark.cuda
@pytest.mark.parametrize("q_bits", [4, 6, 8])
def test_cuda_optimized_linear_launches_kernels(q_bits, cuda_device):
    """The layer on the card goes through the kernels (quantize at
    construction for int bases; dequantize or the FP6 GEMM per forward)
    and its gradients match the same layer on the CPU."""
    w = _x((256, 512), torch.bfloat16, cuda_device, seed=4, scale=0.02)
    qc = tlin.QuantizationConfig(q_bits=q_bits, group_size=128)
    lc = tlin.LoRAConfig(lora_r=8)
    q0, f0 = dict(tqk.launches), t6.fp6_matmul.launches["fp6_matmul"]
    lin = tlin.OptimizedLinear(w, lora_config=lc, quantization_config=qc)
    host = tlin.OptimizedLinear(w.cpu(), lora_config=lc, quantization_config=qc)
    assert torch.equal(lin.base.data.cpu(), host.base.data)
    assert tqk.launches["quantize"] == q0["quantize"] + (q_bits != 6)
    with torch.no_grad():
        lin.lora_B.normal_(0.0, 0.05)
        host.lora_A.copy_(lin.lora_A.cpu())
        host.lora_B.copy_(lin.lora_B.cpu())
    x = _x((2, 16, 256), torch.bfloat16, cuda_device, seed=5, scale=1.0).requires_grad_(True)
    xh = x.detach().cpu().requires_grad_(True)
    y, yh = lin(x), host(xh)
    y.float().square().sum().backward()
    yh.float().square().sum().backward()
    assert t6.fp6_matmul.launches["fp6_matmul"] == f0 + (q_bits == 6)
    assert tqk.launches["dequantize"] == q0["dequantize"] + (q_bits != 6)
    for got, ref in ((y, yh), (x.grad, xh.grad), (lin.lora_A.grad, host.lora_A.grad),
                     (lin.lora_B.grad, host.lora_B.grad)):
        got, ref = got.float().cpu(), ref.float()
        assert float((got - ref).abs().max()) <= 2.0 ** -6 * float(ref.abs().max())
