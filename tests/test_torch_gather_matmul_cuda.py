"""The port's gather-matmul kernel (``ops/csrc/gather_matmul.cu``) against
its plain PyTorch version on the card: the gpt2-350m MLP GEMMs at a cut M
(forward wi/wo, the backward's dx = g·wᵀ and dw = xᵀ·g through transposed
views), the JAX package's ragged shapes, a K tail, misaligned and
expanded operands, in bf16 and fp32; then the autograd Function's
gradients against the plain version's.  Each call is held to the route
``gather_matmul.route`` picks (wgmma for bf16 operands TMA can read, mma
for other bf16, fma for fp32) and counted under it.

No JAX here: the machine with the card has none.  Run there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gather_matmul_cuda.py -m cuda

Without a card every test skips.  Tolerances: bf16 outputs
|kernel - plain| <= 2^-7 · (1 + |plain|) elementwise (about two bf16 ulps:
the two sum in other orders before the one rounding); fp32 outputs
max |kernel - plain| <= 1e-5 · max |plain| (summation order only, the
kernel's fp32 body is FMA in fp32, never TF32: the error of an element
follows the partial sums over K, not the element, so an element that
cancels to near zero is held to the output's scale).
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import gather_matmul as tgm

RTOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}
# (name, M, K, N, transpose a, transpose b)
CASES = [
    ("wi-fwd", 1024, 1024, 4096, False, False),
    ("wo-fwd", 1024, 4096, 1024, False, False),
    ("wi-dx", 1024, 4096, 1024, False, True),
    ("wi-dw", 1024, 1024, 4096, True, False),
    ("ragged-64x64x256", 64, 64, 256, False, False),
    ("ragged-130x96x72", 130, 96, 72, False, False),
    ("ragged-8x300x128", 8, 300, 128, False, False),
    ("tails-both-t", 77, 131, 45, True, True),
    ("tails-both-t-aligned", 200, 136, 264, True, True),
    ("narrow-a-t", 192, 64, 120, True, False),
    ("narrow-b-t", 256, 128, 96, False, True),
    ("short-m", 8, 64, 520, False, False),
]
# the bf16 route of each case: a row pitch off 8 elements (K 300, a
# transposed [131, 77]) is more than TMA takes
MMA_CASES = {"ragged-8x300x128", "tails-both-t"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operand(rng, rows, cols, transpose, dtype, dev):
    """A [rows, cols] operand, as a transposed view when asked."""
    shape = (cols, rows) if transpose else (rows, cols)
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    t = t.to(dev, dtype)
    return t.T if transpose else t


def _close(got, ref, rtol):
    diff = (got.float() - ref.float()).abs()
    if got.dtype == torch.float32:
        return bool(diff.max() <= rtol * ref.abs().max()), float(diff.max())
    return bool((diff <= rtol * (1 + ref.float().abs())).all()), float(diff.max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_cuda_gemm_matches_plain_version(case, dtype, cuda_device):
    _, m, k, n, ta, tb = case
    rng = np.random.default_rng(m * 7 + n)
    a = _operand(rng, m, k, ta, dtype, cuda_device)
    b = _operand(rng, k, n, tb, dtype, cuda_device)
    want = ("fma" if dtype == torch.float32 else
            "mma" if case[0] in MMA_CASES else "wgmma")
    assert tgm.route(a, b) == want
    before = tgm.gemm.launches["gather_matmul"]
    routes = dict(tgm.gemm.routes)
    got = tgm.gemm(a, b)
    torch.cuda.synchronize()
    assert tgm.gemm.launches["gather_matmul"] == before + 1
    assert {r: n - routes[r] for r, n in tgm.gemm.routes.items() if n != routes[r]} \
        == {f"gather_matmul.{want}": 1}
    assert got.dtype == dtype and got.is_contiguous()
    ok, err = _close(got, tgm.matmul_ref(a, b), RTOL[dtype])
    assert ok, err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_cuda_gemm_misaligned_and_expanded_operands(dtype, cuda_device):
    """Views whose rows start off a 16-byte boundary take the masked
    scalar loads; an expanded gradient (stride 0) loads element by
    element."""
    rng = np.random.default_rng(3)
    base = _operand(rng, 200, 129, False, dtype, cuda_device)
    a = base[:, 1:]                                  # K 128, rows misaligned
    b = _operand(rng, 128, 72, False, dtype, cuda_device)
    bf16_route = "fma" if dtype == torch.float32 else "mma"
    assert tgm.route(a, b) == bf16_route
    ok, err = _close(tgm.gemm(a, b), tgm.matmul_ref(a, b), RTOL[dtype])
    assert ok, err
    g = torch.ones((), dtype=dtype, device=cuda_device).expand(200, 72)
    assert tgm.route(g, b.T) == bf16_route
    ok, err = _close(tgm.gemm(g, b.T), tgm.matmul_ref(g, b.T), RTOL[dtype])
    assert ok, err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_cuda_matmul_grads_match_plain_version(dtype, cuda_device):
    rng = np.random.default_rng(5)
    x = _operand(rng, 300, 256, False, dtype, cuda_device).requires_grad_()
    w = _operand(rng, 256, 520, False, dtype, cuda_device).requires_grad_()
    cot = _operand(rng, 300, 520, False, dtype, cuda_device)
    before = tgm.gemm.launches["gather_matmul"]
    (tgm.matmul(x, w) * cot).sum().backward()
    assert tgm.gemm.launches["gather_matmul"] == before + 3
    g = (cot.float()).to(dtype)
    for got, ref in ((x.grad, tgm.matmul_ref(g, w.detach().T)),
                     (w.grad, tgm.matmul_ref(x.detach().T, g))):
        ok, err = _close(got, ref, RTOL[dtype])
        assert ok, err
