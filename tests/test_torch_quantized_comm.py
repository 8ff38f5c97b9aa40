"""The port's quantized wire codec (``comm/quantized.py``), the
``comm_quantization`` config block and ``ring_rotate`` on the wire's
dtypes, against the JAX package on the CPU.

* ``wire_encode_rows``/``wire_decode_rows`` against the JAX codec compiled
  by ``jax.jit`` (the ring encodes under jit), bit for bit: payloads,
  scales and decoded values, int8 and fp8, head dims 64/80/128, odd row
  counts, all-zero rows, tiny rows (fp8 subnormals) and bf16 input.  Under
  jit XLA computes ``absmax / qmax`` as a multiply by fp32(1 / qmax); the
  port does so too.  The eager JAX path divides, and its int8 scales
  differ from the jitted ones by one ulp in some rows (checked here, so
  the choice stays visible).
* The JAX tests' round-trip bound (``tests/test_quantized_comm.py``): per
  block, int8 within absmax / 127 and fp8 within absmax / 8; and their
  validation cases.
* The ``comm_quantization`` block: the JAX config's rejections (unknown
  collective, unknown wire dtype, a non-dict ``collectives``, group_size
  <= 0) with the same messages; ``grad_reduce``, ``ring_rotation`` and
  ``zero3_gather`` are accepted, read as the JAX config reads them, and
  the ``collectives`` spelling sets them (``test_torch_dp_compression.py``
  runs the gradient reduction).
* ``comm.ring_rotate`` in 2 gloo ranks moves int8 and uint8 payloads (fp8
  travels as uint8) and fp32 scales in one call, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.comm import quantized as jq
from deepspeed_tpu.runtime.config import (DeepSpeedConfig as JaxConfig,
                                          DeepSpeedConfigError as JaxConfigError)
from deepspeed_tpu_torch.comm import quantized as tq
from deepspeed_tpu_torch.launcher import launch
from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfig,
                                                DeepSpeedConfigError)

import torch_ring_ranks
from test_torch_engine_v2 import one_torch_thread  # noqa: F401

WIRES = ("int8", "fp8")


def _rows(rng, rows, d, dtype=np.float32):
    """Rows of mixed magnitude, one all zero and one tiny (fp8 subnormals)."""
    x = rng.standard_normal((rows, d)) * rng.uniform(1e-4, 30, (rows, 1))
    x[1] = 0.0
    x[2] *= 1e-30
    return x.astype(dtype)


def _jit_codec(wire):
    enc = jax.jit(lambda a: jq.wire_encode_rows(a, wire))
    dec = jax.jit(lambda p, s: jq.wire_decode_rows(p, s, wire))
    return enc, dec


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("shape", [(3, 257, 64), (1001, 80), (2, 5, 7, 128)],
                         ids=["d64", "d80-odd-rows", "d128-4d"])
def test_codec_matches_jitted_jax_codec_bit_for_bit(shape, wire):
    rng = np.random.default_rng(shape[-1] + len(shape))
    x = _rows(rng, int(np.prod(shape[:-1])), shape[-1]).reshape(shape)
    enc, dec = _jit_codec(wire)
    jp, js = (np.asarray(a) for a in enc(jnp.asarray(x)))
    tp, ts = tq.wire_encode_rows(torch.tensor(x), wire)
    assert tp.dtype == (torch.int8 if wire == "int8" else torch.uint8)
    assert tuple(ts.shape) == js.shape == shape[:-1] + (1,)
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(
        tq.wire_decode_rows(tp, ts, wire).numpy(), np.asarray(dec(jp, js)))
    zero = tq.wire_decode_rows(tp, ts, wire).reshape(-1, shape[-1])[1]
    assert bool((zero == 0).all())


@pytest.mark.parametrize("wire", WIRES)
def test_codec_encodes_bf16_like_jax(wire):
    rng = np.random.default_rng(3)
    x = jnp.asarray(_rows(rng, 96, 128)).astype(jnp.bfloat16)
    jp, js = (np.asarray(a) for a in _jit_codec(wire)[0](x))
    tp, ts = tq.wire_encode_rows(
        torch.tensor(np.asarray(x.astype(jnp.float32))).bfloat16(), wire)
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(ts.numpy(), js)


def test_int8_scales_take_the_jit_rounding():
    """The scales are absmax · fp32(1/127), as XLA compiles the JAX codec
    under jit; the eager JAX codec divides and differs in some rows."""
    rng = np.random.default_rng(4)
    x = _rows(rng, 4000, 128)
    absmax = np.abs(x).max(axis=-1, keepdims=True)
    _, ts = tq.wire_encode_rows(torch.tensor(x), "int8")
    want = np.where(absmax == 0, 1.0, absmax * np.float32(1 / 127.0))
    np.testing.assert_array_equal(ts.numpy(), want.astype(np.float32))
    _, eager = jq.wire_encode_rows(jnp.asarray(x), "int8")
    assert np.any(np.asarray(eager) != ts.numpy())


@pytest.mark.parametrize("wire,bound", [("fp32", 0.0), ("int8", 1 / 127.0),
                                        ("fp8", 0.13)])
def test_wire_roundtrip_error_bound(wire, bound):
    """The JAX test's bound: per block, int8 within absmax / 127, fp8
    (3 mantissa bits) within absmax / 8."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((4, 512)), dtype=torch.float32)
    payload, scale = tq._wire_encode(x, wire, group_size=128)
    back = tq._wire_decode(payload, scale, wire)
    err = (back - x).abs().numpy()
    g = x.numpy().reshape(4, 4, 128)
    absmax = np.abs(g).max(axis=-1, keepdims=True)
    tol = np.broadcast_to(absmax * bound + 1e-7, g.shape).reshape(4, 512)
    assert (err <= tol).all(), (err.max(), tol.min())


def test_wire_dtype_validation_and_blocks():
    assert tq.fp8_supported()
    for name in tq.WIRE_DTYPES:
        assert tq.validate_wire_dtype(name) == name
    with pytest.raises(ValueError, match="wire dtype"):
        tq.validate_wire_dtype("int4")
    for m, gs in ((512, 128), (80, 256), (96, 64), (100, 0)):
        assert tq._block(m, gs) == jq._block(m, gs)


def _config(block):
    return {"train_micro_batch_size_per_gpu": 1, "comm_quantization": block}


@pytest.mark.parametrize("block,match", [
    ({"enabled": True, "collectives": {"all_to_all": "int8"}},
     "unknown collective"),
    ({"enabled": True, "ring_rotation": "int4"}, "must be one of"),
    ({"enabled": True, "collectives": ["ring_rotation"]}, "must be a dict"),
    ({"enabled": True, "group_size": 0}, "group_size must be positive"),
], ids=["unknown-collective", "unknown-dtype", "collectives-list",
        "group-size"])
def test_config_rejects_as_jax_does(block, match):
    with pytest.raises(JaxConfigError, match=match):
        JaxConfig(_config(block))
    with pytest.raises(DeepSpeedConfigError, match=match):
        DeepSpeedConfig(_config(block))


@pytest.mark.parametrize("name", ["grad_reduce", "zero3_gather"])
def test_quantized_collectives_not_ported_name_their_item(name):
    """Both collectives run now (``grad_reduce`` since the quantized
    gradient reduction, ``zero3_gather`` as qwZ): each is read as the JAX
    config reads it, with ``error_feedback`` and ``group_size``."""
    for block in ({"enabled": True, name: "int8"},
                  {"enabled": True, "collectives": {name: "fp8"}},
                  {"enabled": True, name: "INT8", "error_feedback": False,
                   "group_size": 512}):
        mine = DeepSpeedConfig(_config(block)).comm_quantization
        want = JaxConfig(_config(block)).comm_quantization
        for key in (name, "error_feedback", "group_size"):
            assert getattr(mine, key) == getattr(want, key), (block, key)
    # switched off, or fp32 spelled out: nothing to run
    DeepSpeedConfig(_config({"enabled": False, name: "int8"}))
    DeepSpeedConfig(_config({"enabled": True, name: "fp32"}))


def test_config_accepts_the_ring_rotation():
    for block in ({"enabled": True, "ring_rotation": "INT8"},
                  {"enabled": True, "collectives": {"ring_rotation": "int8"}}):
        assert DeepSpeedConfig(_config(block)).comm_quantization.ring_rotation \
            == JaxConfig(_config(block)).comm_quantization.ring_rotation \
            == "int8"
    assert DeepSpeedConfig({"train_micro_batch_size_per_gpu": 1}) \
        .comm_quantization.ring_rotation == "fp32"


def test_ring_rotate_moves_the_wire_dtypes_bit_for_bit():
    rng = np.random.default_rng(5)
    arrays = [rng.integers(-120, 120, (3, 40)).astype(np.int8),
              rng.integers(0, 250, (17,)).astype(np.uint8),
              rng.standard_normal((3, 1)).astype(np.float32)]
    ranks = launch(torch_ring_ranks.rotate_payloads, 2, args=(arrays,),
                   backend="gloo", device="cpu")
    for rank, got in enumerate(ranks):
        prev = (rank - 1) % 2
        for a, g in zip(arrays, got):
            assert g.dtype == a.dtype
            np.testing.assert_array_equal(g, a + np.asarray(prev, a.dtype))
