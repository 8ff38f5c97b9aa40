"""The port's CUDA quantize, dequantize, fake-quantize and FP6 GEMM kernels
against their plain PyTorch versions on the card.

``quantize``, ``dequantize`` and ``fake_quantize``
(``ops/csrc/quantize.cu``) bit for bit, over int8 and int4, bf16, fp16 and
fp32 inputs, groups from 128 to 2048 (above 1024 the kernel's second pass
reads the group again), row counts that are not a multiple of a block and a
1-D tensor; ``fp6_matmul`` (``ops/csrc/fp6_linear.cu``) over tails in M, N
and K, decode-sized and large M, bf16, fp16 and fp32 activations; and the
``linear`` layers on CUDA tensors, which must launch the kernels.

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


QUANT_CASES = [((512, 1024), 512), ((300, 384), 128), ((1024,), 256),
               ((4, 8, 256), 256), ((64, 4096), 2048), ((33, 1408), 128)]
DTYPES = [torch.bfloat16, torch.float16, torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,gs", QUANT_CASES)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp16", "fp32"])
def test_cuda_quantize_family_bit_equal(shape, gs, bits, dtype, cuda_device):
    x = _x(shape, dtype, cuda_device)
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
    # the façade: kernel for a supported shape, torch arithmetic otherwise
    before = dict(tqk.launches)
    tqz.quantize_blockwise(_x((32, 256), torch.float32, cuda_device), 8, 128)
    tqz.quantize_blockwise(_x((32, 96), torch.float32, cuda_device), 8, 96)
    tqz.quantize_blockwise(_x((32, 256), torch.float32, cuda_device), 8, 128,
                           symmetric=False)
    assert tqk.launches["quantize"] == before["quantize"] + 1


FP6_CASES = [(16, 512, 1024), (7, 256, 384), (300, 1000, 260), (514, 64, 130),
             (5, 12, 40), (1, 4096, 512), (256, 1024, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", FP6_CASES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp16", "fp32"])
def test_cuda_fp6_matmul_matches_plain_version(m, k, n, dtype, cuda_device):
    w = _x((k, n), torch.float32, cuda_device, seed=1, scale=0.02)
    packed, scale = t6.fp6_quantize(w)
    x = _x((m, k), dtype, cuda_device, seed=2, scale=1.0)
    before = t6.fp6_matmul.launches["fp6_matmul"]
    out = t6.fp6_matmul(x, packed, scale)
    ref = t6.fp6_matmul_ref(x, packed, scale)
    torch.cuda.synchronize()
    assert t6.fp6_matmul.launches["fp6_matmul"] == before + 1
    assert out.dtype == dtype and out.shape == (m, n)
    rtol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    diff = (out.float() - ref.float()).abs()
    assert torch.isfinite(out.float()).all()
    assert bool((diff <= rtol * (1 + ref.float().abs())).all()), float(diff.max())


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
