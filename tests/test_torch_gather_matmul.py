"""The port's gather-matmul GEMM (``ops/gather_matmul.py``) against the JAX
package's ``pallas_matmul`` on the CPU.

The JAX kernel runs interpreted (``gather_matmul.INTERPRET = True``), its
gradients through its hand-written VJP; the port's ``matmul`` runs its
plain version (CPU tensors), its gradients through its autograd Function.
Same numpy inputs, fp32, at the shapes of the JAX package's own test
(``tests/test_fused_collectives.py::test_pallas_matmul_parity``): outputs
and both gradients within 1e-4 absolute, as that test holds the kernel to
``x @ w``.  Also the plain version's blocked sum and transposed views
against a float64 product, and the wrapper's checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.ops.pallas.gather_matmul as gm
from deepspeed_tpu_torch.ops import gather_matmul as tgm

SHAPES = [(64, 64, 256), (130, 96, 72), (8, 300, 128)]


@pytest.fixture
def interpret():
    old = gm.INTERPRET
    gm.INTERPRET = True
    yield
    gm.INTERPRET = old


@pytest.mark.parametrize("m,k,n", SHAPES, ids=[f"{m}x{k}x{n}" for m, k, n in SHAPES])
def test_matmul_and_grads_match_pallas_matmul(m, k, n, interpret):
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    cot = rng.standard_normal((m, n)).astype(np.float32)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    y_j = gm.pallas_matmul(jx, jw)
    gx_j, gw_j = jax.grad(lambda a, b: jnp.sum(gm.pallas_matmul(a, b) * cot),
                          argnums=(0, 1))(jx, jw)

    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    y_t = tgm.matmul(tx, tw)
    (y_t * torch.tensor(cot)).sum().backward()
    assert y_t.dtype == torch.float32 and tuple(y_t.shape) == (m, n)
    for got, want in ((y_t, y_j), (tx.grad, gx_j), (tw.grad, gw_j)):
        assert np.abs(got.detach().numpy() - np.asarray(want)).max() < 1e-4


def test_plain_version_sums_in_k_blocks_and_reads_views():
    """A K that spans several 256-deep blocks and a tail, transposed and
    expanded operands (the backward's views): against float64."""
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.standard_normal((600, 40)).astype(np.float32))
    b = torch.tensor(rng.standard_normal((600, 24)).astype(np.float32))
    got = tgm.gemm(a.T, b)                      # [40, 600] @ [600, 24]
    want = a.double().T @ b.double()
    assert got.is_contiguous() and got.dtype == torch.float32
    assert (got.double() - want).abs().max() < 1e-4
    g = torch.ones(()).expand(40, 24)          # d(sum)/dy, strides (0, 0)
    assert torch.equal(tgm.gemm(g, b.T), torch.ones(40, 24) @ b.T)
    xb, wb = a[:8].to(torch.bfloat16), b[:40].to(torch.bfloat16)
    yb = tgm.gemm(xb, wb)
    assert yb.dtype == torch.bfloat16
    assert torch.equal(yb, (xb.float() @ wb.float()).to(torch.bfloat16))


def test_gemm_rejects_what_the_kernel_does_not_take():
    a = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="K"):
        tgm.gemm(a, torch.zeros(4, 8))
    with pytest.raises(TypeError, match="dtype"):
        tgm.gemm(a, torch.zeros(8, 2, dtype=torch.bfloat16))
    before = dict(tgm.gemm.launches)
    tgm.matmul(a.requires_grad_(), torch.zeros(8, 3)).sum().backward()
    assert tgm.gemm.launches == before      # CPU tensors launch nothing


def _bf16(*shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype)


# name, a, b, the bf16 route: operands a TMA tensor map can describe (one
# unit stride, the other a positive multiple of 8 elements, a 16-byte
# aligned base, K > 0) take wgmma, any other bf16 operands mma
ROUTE_CASES = [
    ("plain", lambda: (_bf16(64, 128), _bf16(128, 256)), "wgmma"),
    ("a-transposed", lambda: (_bf16(128, 64).T, _bf16(128, 256)), "wgmma"),
    ("b-transposed", lambda: (_bf16(64, 128), _bf16(256, 128).T), "wgmma"),
    ("both-transposed", lambda: (_bf16(136, 200).T, _bf16(264, 136).T), "wgmma"),
    ("ragged-n72", lambda: (_bf16(130, 96), _bf16(96, 72)), "wgmma"),
    ("aligned-column-slice", lambda: (_bf16(200, 136)[:, 8:], _bf16(128, 64)), "wgmma"),
    ("k300-row-pitch", lambda: (_bf16(8, 300), _bf16(300, 128)), "mma"),
    ("a-t-pitch-77", lambda: (_bf16(131, 77).T, _bf16(131, 45)), "mma"),
    ("misaligned-base", lambda: (_bf16(200, 129)[:, 1:], _bf16(128, 72)), "mma"),
    ("expanded-gradient", lambda: (_bf16().add(1).expand(40, 24), _bf16(24, 16)), "mma"),
    ("b-column-vector", lambda: (_bf16(64, 128), _bf16(128, 1)), "mma"),
    ("k-zero", lambda: (_bf16(4, 0), _bf16(0, 8)), "mma"),
]


@pytest.mark.parametrize("case", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_route_is_chosen_from_dtype_strides_shape_and_alignment(case):
    """The GEMM's route is a pure function of the operands: bf16 takes
    wgmma or mma, never fma; the same views in fp32 always take fma."""
    _, make, want = case
    a, b = make()
    assert tgm.route(a, b) == want
    assert tgm.route(a.float(), b.float()) == "fma"


def test_route_counts_stay_untouched_on_cpu():
    """CPU tensors take the plain version: no launch and no route count."""
    before = (dict(tgm.gemm.launches), dict(tgm.gemm.routes))
    tgm.gemm(_bf16(64, 128), _bf16(128, 256))
    assert (tgm.gemm.launches, tgm.gemm.routes) == before
    assert set(tgm.gemm.routes) == {f"gather_matmul.{r}" for r in tgm.ROUTES}
