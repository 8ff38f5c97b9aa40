"""The port's FP6 (e3m2) packed-weight linear against the JAX package's,
on the CPU.

``deepspeed_tpu_torch/ops/fp6_linear.py`` against
``deepspeed_tpu/ops/pallas/fp6_linear.py``: the decode table, the packed
codes of ``fp6_quantize`` bit for bit (random weights, exact zeros, exact
midpoints between neighbouring values, where ties go to the lower one),
``fp6_dequantize``, and the plain version of the ``fp6_matmul`` kernel
against the interpreted Pallas ``_mm_kernel`` (``fp6_matmul.__wrapped__``
with ``INTERPRET``): fp32 to 1e-5 (summation order), bf16 to 2^-7 (one
rounding of the output, after sums in another order).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import fp6_linear as t6

f6 = importlib.import_module("deepspeed_tpu.ops.pallas.fp6_linear")


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = f6.INTERPRET
    f6.INTERPRET = True
    yield
    f6.INTERPRET = old


def _weights(kind: str, k=64, n=256, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32)
    if kind == "zeros":
        w[rng.random((k, n)) < 0.3] = 0.0
        w[:, 5] = 0.0                         # a whole zero column
    elif kind == "midpoints":
        # column max 28 (scale 1): values exactly between table neighbours
        tbl = np.unique(f6.DECODE_TABLE)
        mids = (tbl[:-1] + tbl[1:]) / 2
        w = rng.choice(np.concatenate([mids, tbl]), size=(k, n)).astype(np.float32)
        w[0] = 28.0
    elif kind == "bf16":
        w = np.array(jnp.asarray(w * 0.02).astype(jnp.bfloat16)
                     .astype(jnp.float32))
    return w


def test_decode_table_equals_jax():
    np.testing.assert_array_equal(t6.DECODE_TABLE, f6.DECODE_TABLE)
    np.testing.assert_array_equal(np.signbit(t6.DECODE_TABLE),
                                  np.signbit(f6.DECODE_TABLE))


@pytest.mark.parametrize("kind", ["random", "zeros", "midpoints", "bf16"])
def test_quantize_codes_bit_equal(kind):
    w = _weights(kind)
    p_j, s_j = f6.fp6_quantize(w)
    p_t, s_t = t6.fp6_quantize(torch.from_numpy(w))
    assert p_t.dtype == torch.uint8 and tuple(p_t.shape) == (3, 16, 256)
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    codes = [v.numpy() for v in t6._unpack_codes(p_t)]
    if kind == "midpoints":
        # a midpoint takes the lower neighbour (strict > picks the upper)
        scaled = w / s_t.numpy()[None, :]
        deq = t6._decoded(p_t).numpy()
        tbl = np.unique(f6.DECODE_TABLE)
        on_mid = np.isin(scaled, (tbl[:-1] + tbl[1:]) / 2)
        assert on_mid.any()
        assert np.all(deq[on_mid] < scaled[on_mid])
    if kind == "zeros":
        # exact zeros take code 0 (+0), the first of the two zero codes in
        # the stable sort
        planes = np.stack(codes, axis=1).reshape(64, 256)
        assert np.all(planes[w == 0] == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_equals_jax(dtype):
    w = _weights("random", k=128, n=96, seed=1)
    p_j, s_j = f6.fp6_quantize(w)
    p_t, s_t = t6.fp6_quantize(torch.from_numpy(w))
    d_j = f6.fp6_dequantize(p_j, s_j, getattr(jnp, dtype))
    d_t = t6.fp6_dequantize(p_t, s_t, getattr(torch, dtype))
    np.testing.assert_array_equal(d_t.float().numpy(),
                                  np.asarray(d_j.astype(jnp.float32)))


@pytest.mark.parametrize("m", [7, 16, 514])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_plain_version_matches_interpreted_kernel(m, dtype):
    rng = np.random.default_rng(2)
    k, n = 64, 256
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.1
    x = rng.standard_normal((m, k)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    p_j, s_j = f6.fp6_quantize(w)
    p_t, s_t = t6.fp6_quantize(torch.from_numpy(w))
    jx = jnp.asarray(x).astype(jdt)
    out_j = f6.fp6_matmul.__wrapped__(jx, p_j, s_j)
    out_t = t6.fp6_matmul(torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt),
                          p_t, s_t)
    assert out_t.dtype == tdt and tuple(out_t.shape) == (m, n)
    ref = np.asarray(out_j.astype(jnp.float32))
    got = out_t.float().numpy()
    rtol = 1e-5 if dtype == "float32" else 2.0 ** -7
    assert np.all(np.abs(got - ref) <= rtol * (1 + np.abs(ref)))


def test_matmul_batched_activations():
    """[B, S, K] activations flatten to rows and keep their leading shape."""
    rng = np.random.default_rng(4)
    w = rng.standard_normal((64, 256)).astype(np.float32) * 0.1
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    p_j, s_j = f6.fp6_quantize(w)
    out_j = f6.fp6_matmul.__wrapped__(jnp.asarray(x), p_j, s_j)
    p_t, s_t = t6.fp6_quantize(torch.from_numpy(w))
    out_t = t6.fp6_matmul(torch.from_numpy(x), p_t, s_t)
    assert tuple(out_t.shape) == (2, 5, 256)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-5,
                               atol=1e-5)


def test_bad_shapes_raise():
    with pytest.raises(ValueError, match="divisible by 4"):
        t6.fp6_quantize(torch.zeros((6, 8)))
    with pytest.raises(ValueError, match="2-D"):
        t6.fp6_quantize(torch.zeros((4, 4, 4)))
    p, s = t6.fp6_quantize(torch.randn(64, 32))
    with pytest.raises(ValueError, match="divisible by 4"):
        t6.fp6_matmul(torch.randn(3, 62), p, s)
    with pytest.raises(ValueError, match="packed K"):
        t6.fp6_matmul(torch.randn(3, 60), p, s)


def test_cpu_call_launches_no_kernel():
    before = dict(t6.fp6_matmul.launches)
    p, s = t6.fp6_quantize(torch.randn(64, 32))
    t6.fp6_matmul(torch.randn(3, 64), p, s)
    assert t6.fp6_matmul.launches == before
