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
