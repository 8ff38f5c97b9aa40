"""The port's blockwise quantization against the JAX package's, on the CPU.

``deepspeed_tpu_torch/ops/quantize.py`` (the plain versions of the
``quantize``, ``dequantize`` and ``fake_quantize`` kernels) against the jnp
path of ``deepspeed_tpu/ops/quantizer.py`` bit for bit, and against the
interpreted Pallas kernels of ``deepspeed_tpu/ops/pallas/quantize.py``, on
the shapes of ``tests/test_pallas_quantize.py`` in int8 and int4, fp32 and
bf16; the ``ops/quantizer.py`` façade (asymmetric mode, groups that are not
a multiple of 128, int4 packing) against the jnp path; and the routing:
the kernel count moves only for CUDA tensors, never here.

The port divides ``absmax / qmax`` exactly, as the eager jnp path does,
and matches that path bit for bit.  XLA's CPU compiler turns the division
into a multiplication by the reciprocal of qmax when it compiles the
interpreted kernel, so some of the kernel's scales are one fp32 ulp off
(the JAX test holds them to ``rtol 1e-6`` for that reason).  Against the
interpreted kernel the port is therefore held to: scales within 1e-6
relative; payloads and round trips equal in every group whose scales are
equal, and in the other groups payloads within one step and round trips
within one scale (plus the output dtype's rounding).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import quantizer as jqz
from deepspeed_tpu_torch.ops import quantize as tqk
from deepspeed_tpu_torch.ops import quantizer as tqz

pq = importlib.import_module("deepspeed_tpu.ops.pallas.quantize")


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = pq.INTERPRET
    pq.INTERPRET = True
    yield
    pq.INTERPRET = old


SHAPES = [((64, 512), 128), ((4, 8, 256), 256), ((300, 384), 128),
          ((1024,), 256)]
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, dtype, seed=0, scale=3.0):
    """The same values in both frameworks (bf16 rounded once, in JAX)."""
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    jx = jnp.asarray(x, jnp.float32).astype(jdt)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    return jx, tx


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp_np(a):
    return np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16 else np.asarray(a)


@pytest.mark.parametrize("shape,gs", SHAPES)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_kernel_plain_versions_match_jax(shape, gs, bits, dtype):
    jx, tx = _inputs(shape, dtype)
    assert tqk.supports(shape, gs, True, bits) == pq.supports(shape, gs, True, bits)
    q_p, s_p = pq.quantize(jx, bits, gs)
    q_j, s_j, _ = jqz.quantize_blockwise(jx, bits, gs, backend="jnp")
    q_t, s_t = tqk.quantize(tx, bits, gs)
    assert q_t.dtype == torch.int8 and tuple(q_t.shape) == shape
    assert tuple(s_t.shape) == tuple(s_p.shape)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_p), rtol=1e-6,
                               atol=1e-8)
    same = np.repeat(s_t.numpy() == np.asarray(s_p), gs, axis=-1)
    step = np.repeat(s_t.numpy(), gs, axis=-1)
    _near_interpreted(q_t.numpy(), np.asarray(q_p), same, 1)
    for out_t, out_j in ((torch.float32, jnp.float32),
                         (torch.bfloat16, jnp.bfloat16)):
        d_t = tqk.dequantize(q_t, s_t, dtype=out_t)
        d_j = jqz.dequantize_blockwise(q_j, s_j, dtype=out_j, backend="jnp")
        d_p = pq.dequantize(q_p, s_p, dtype=out_j)
        assert d_t.dtype == out_t
        np.testing.assert_array_equal(_np(d_t), _jnp_np(d_j))
        _near_interpreted(_np(d_t), _jnp_np(d_p), same, step)
    f_t = tqk.fake_quantize(tx, bits, gs)
    f_j = jqz.fake_quantize(jx, bits, gs, backend="jnp")
    f_p = pq.fake_quantize(jx, bits, gs)
    assert f_t.dtype == tx.dtype
    np.testing.assert_array_equal(_np(f_t), _jnp_np(f_j))
    _near_interpreted(_np(f_t), _jnp_np(f_p), same, step)


def _near_interpreted(got, ref, same, step):
    """Equal where the two scales are; elsewhere within ``step`` (one
    payload step, or one scale) plus the two values' bf16 rounding."""
    got, ref = got.astype(np.float64), ref.astype(np.float64)
    np.testing.assert_array_equal(got[same], ref[same])
    assert np.all(np.abs(got - ref)
                  <= step * (1 + 1e-6) + 2.0 ** -8 * (np.abs(got) + np.abs(ref)))


def test_zero_groups_and_ties():
    """A group of zeros takes scale 1.0; exact .5 quotients round to even."""
    x = np.zeros((2, 256), np.float32)
    x[1, :128] = np.arange(128) * 0.5 - 32.0      # absmax 32 → scale 32/127
    x[1, 128:] = np.linspace(-7.0, 7.0, 128)      # int4: scale 1, halves
    x[1, 130] = 2.5
    x[1, 131] = -3.5
    for bits in (8, 4):
        q_t, s_t = tqk.quantize(torch.from_numpy(x), bits, 128)
        q_j, s_j, _ = jqz.quantize_blockwise(jnp.asarray(x), bits, 128,
                                             backend="jnp")
        np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
        assert s_t[0, 0] == 1.0
    q4, _ = tqk.quantize(torch.from_numpy(x), 4, 128)
    assert q4[1, 130] == 2 and q4[1, 131] == -4


@pytest.mark.parametrize("shape,gs,bits,symmetric", [
    ((32, 96), 96, 8, True),        # group not a multiple of 128
    ((16, 64), 64, 4, True),
    ((64, 512), 128, 8, False),     # asymmetric
    ((8, 200), 50, 4, False),
    ((12, 100), 0, 8, True),        # whole-row group
])
def test_facade_torch_path_matches_jnp(shape, gs, bits, symmetric):
    jx, tx = _inputs(shape, "fp32", seed=1)
    q_j, s_j, z_j = jqz.quantize_blockwise(jx, bits, gs, symmetric,
                                           backend="jnp")
    q_t, s_t, z_t = tqz.quantize_blockwise(tx, bits, gs, symmetric)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert (z_t is None) == (z_j is None)
    if z_t is not None:
        np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))
    d_j = jqz.dequantize_blockwise(q_j, s_j, z_j, bits, backend="jnp")
    d_t = tqz.dequantize_blockwise(q_t, s_t, z_t, bits)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    f_j = jqz.fake_quantize(jx, bits, gs, symmetric, backend="jnp")
    f_t = tqz.fake_quantize(tx, bits, gs, symmetric)
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_facade_backends_match_jnp_path(backend):
    """Both backends give the jnp path's numbers (the interpreted kernel
    that JAX's "pallas" would take rounds the scale differently: module
    docstring); JAX's "pallas" has no counterpart to select."""
    jx, tx = _inputs((32, 256), "bf16", seed=2)
    q_j, s_j, _ = jqz.quantize_blockwise(jx, 8, 128, backend="jnp")
    q_t, s_t, _ = tqz.quantize_blockwise(tx, 8, 128, backend=backend)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    d = tqz.dequantize_blockwise(q_t, s_t, dtype=torch.bfloat16, backend=backend)
    d_j = jqz.dequantize_blockwise(q_j, s_j, dtype=jnp.bfloat16, backend="jnp")
    np.testing.assert_array_equal(_np(d), _jnp_np(d_j))
    with pytest.raises(ValueError, match="backend"):
        tqz.quantize_blockwise(tx, 8, 128, backend="pallas")


def test_pack_unpack_int4_match_jax():
    q = np.random.default_rng(3).integers(-8, 8, size=(6, 64)).astype(np.int8)
    p_j = jqz.pack_int4(jnp.asarray(q))
    p_t = tqz.pack_int4(torch.from_numpy(q))
    assert p_t.dtype == torch.uint8
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    u_t = tqz.unpack_int4(p_t)
    np.testing.assert_array_equal(u_t.numpy(), np.asarray(jqz.unpack_int4(p_j)))
    np.testing.assert_array_equal(u_t.numpy(), q)
    with pytest.raises(ValueError, match="even"):
        tqz.pack_int4(torch.zeros((2, 3), dtype=torch.int8))


def test_routing_and_counts_on_cpu():
    """CPU tensors take the plain versions (no kernel count moves, with or
    without ``supports``); the kernel wrappers refuse what the kernel does
    not serve.  The kernels take any group of whole 16-byte vectors (4
    fp32 or 8 bf16 elements; 4 payload bytes for dequantize), wider than
    the JAX kernel's multiples of 128."""
    before = dict(tqk.launches)
    x = torch.randn(32, 256)
    assert tqk.supports((32, 256), 128, True, 8)
    tqz.quantize_blockwise(x, 8, 128)
    tqz.fake_quantize(x, 4, 128)
    q, s, _ = tqz.quantize_blockwise(x, 8, 128)
    tqz.dequantize_blockwise(q, s)
    assert tqk.supports((32, 96), 96, True, 8)
    assert tqk.supports((2, 1384), 1384, True, 8, torch.bfloat16)
    assert not tqk.supports((32, 90), 90, True, 8, torch.int8)
    assert not tqk.supports((32, 36), 36, True, 8, torch.bfloat16)
    assert not tqk.supports((32, 90), 90, True, 8)
    tqz.quantize_blockwise(torch.randn(32, 90), 8, 90)
    y = torch.randn(32, 96)
    for a, b in zip(tqz.quantize_blockwise(y, 8, 96)[:2],
                    tqz.quantize_blockwise(y, 8, 96, backend="torch")[:2]):
        assert torch.equal(a, b)
    assert tqk.launches == before
    with pytest.raises(ValueError, match="not served"):
        tqk.quantize(torch.randn(32, 90), 8, 90)
    with pytest.raises(ValueError, match="not served"):
        tqk.fake_quantize(x, 6, 128)
    with pytest.raises(ValueError, match="scales"):
        tqk.dequantize(q, s[:16])


def test_stochastic_round_is_unbiased():
    g = torch.Generator().manual_seed(0)
    x = torch.full((20000,), 2.25)
    r = tqz.stochastic_round(x, g)
    assert set(torch.unique(r).tolist()) == {2.0, 3.0}
    assert abs(float(r.mean()) - 2.25) < 0.02
