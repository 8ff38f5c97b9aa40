"""The port's ring attention (``sequence/ring.py``) and its hop kernels'
plain versions (``ops/flash_mha.py``) against the JAX package, on the CPU.

* The plain versions of ``ring_carry``, ``ring_bwd_dq`` and
  ``ring_bwd_dkv`` against the Pallas kernels ``flash_carry_block``,
  ``flash_ring_dq_block`` and ``flash_ring_dkv_block`` run interpreted
  (``INTERPRET = True``), from the same numpy inputs, over hops of both
  placements, causal, windowed and non-causal, MHA and GQA, and a shard of
  80 rows (not a multiple of 64).  The JAX kernels take their rows padded
  to ``ring_carry_pad`` and m/l replicated over 128 lanes: they are
  compared on the real rows and lane 0.  Tolerance 2e-5 relative (fp32;
  the port walks 64-key tiles, the Pallas kernel the whole padded block).
* ``ring_position_map``, ``stripe_sequence`` and ``unstripe_sequence``,
  bit for bit.
* ``ring_attention`` in 2 and 4 spawned gloo CPU ranks against the JAX
  ``ring_attention`` on a CPU mesh with a ``seq`` axis of the same size:
  the output and the gradients of ``sum(o * w)``, both placements, causal
  GQA and a sliding window, at 2e-5 (the JAX test's tolerance for its ring
  against dense attention).  Interleave 2 (accepted, no effect in the
  port) must give the bits of interleave 1.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.parallel.topology import MeshTopology as JaxTopology
from deepspeed_tpu.sequence import ring as jring
from deepspeed_tpu_torch.launcher import launch
from deepspeed_tpu_torch.ops import flash_mha as tfm
from deepspeed_tpu_torch.sequence import ring as tring

import torch_ring_ranks
from test_torch_engine_v2 import one_torch_thread  # noqa: F401

jfm = importlib.import_module("deepspeed_tpu.ops.pallas.flash_mha")
RTOL = 2e-5


@pytest.fixture
def interpret():
    old = jfm.INTERPRET
    jfm.INTERPRET = True
    yield
    jfm.INTERPRET = old


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _pad(x, s_pad, axis=2, value=0.0):
    width = [(0, 0)] * x.ndim
    width[axis] = (0, s_pad - x.shape[axis])
    return np.pad(x, width, constant_values=value)


def _lanes(x, s_pad, value=0.0):
    """[B, H, S] -> the JAX kernels' [B, H, S_pad, 128]."""
    x = _pad(x, s_pad, value=value)
    return np.repeat(x[..., None], 128, axis=-1)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    assert np.all(err <= rtol * (1 + np.abs(want))), float(err.max())


# hq, hkv, s_l, d, causal, window, placement, sp, idx, src
HOPS = [
    (4, 2, 80, 32, True, None, "contiguous", 2, 1, 0),    # fully live, tail
    (4, 2, 80, 32, True, None, "contiguous", 2, 1, 1),    # own block
    (4, 2, 64, 32, True, None, "striped", 2, 0, 1),       # strictly lower
    (4, 4, 80, 32, True, None, "striped", 2, 1, 0),       # MHA, tail
    (4, 2, 64, 32, True, 24, "contiguous", 2, 1, 0),      # sliding window
    (4, 1, 64, 32, False, None, "contiguous", 2, 0, 1),   # non-causal, MQA
    (4, 2, 64, 32, True, None, "striped", 4, 2, 1),       # sp 4
]
HOP_IDS = ["contig-live-tail", "contig-own", "striped-0from1",
           "striped-mha-tail", "window", "noncausal-mqa", "striped-sp4"]


def _offset(block, s_l, sp, placement):
    return (block, sp) if placement == "striped" else (block * s_l, 1)


@pytest.mark.parametrize("hop", HOPS, ids=HOP_IDS)
def test_hop_plain_versions_match_interpreted_pallas(hop, interpret):
    """One hop from a carried state (the own block first), then dq and
    dk/dv of the hop into nonzero fp32 accumulators from that lse."""
    hq, hkv, s_l, d, causal, window, placement, sp, idx, src = hop
    rng = np.random.default_rng(sum(hop[:4]) + idx + 7 * src)
    b, scale = 1, d ** -0.5
    q, do = _rand(rng, b, hq, s_l, d), _rand(rng, b, hq, s_l, d)
    k, v = _rand(rng, b, hkv, s_l, d), _rand(rng, b, hkv, s_l, d)
    q_off, q_stride = _offset(idx, s_l, sp, placement)
    k_off, k_stride = _offset(src, s_l, sp, placement)
    pos, own = (q_off, q_stride, k_off, k_stride), (q_off, q_stride) * 2
    s_pad = jfm.ring_carry_pad(s_l)
    kw = dict(q_stride=q_stride, k_stride=k_stride, s_real=s_l,
              sm_scale=scale, causal=causal, window=window)
    jq, jk, jv, jdo = (jnp.asarray(_pad(x, s_pad)) for x in (q, k, v, do))
    jm = jnp.full((b, hq, s_pad, 128), tfm.NEG_INF, jnp.float32)
    jl = jnp.zeros((b, hq, s_pad, 128), jnp.float32)
    jacc = jnp.zeros((b, hq, s_pad, d), jnp.float32)
    # the own block carries (k_off = q_off), then the hop's source
    jm, jl, jacc = jfm.flash_carry_block(jq, jk, jv, jm, jl, jacc, q_off,
                                         q_off, **{**kw, "k_stride": q_stride})
    jm, jl, jacc = jfm.flash_carry_block(jq, jk, jv, jm, jl, jacc, q_off,
                                         k_off, **kw)
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    m = torch.full((b, hq, s_l), tfm.NEG_INF)
    l, acc = torch.zeros((b, hq, s_l)), torch.zeros((b, hq, s_l, d))
    for p in (own, pos):
        tfm.flash_carry_block(tq, tk, tv, m, l, acc, p, causal, scale, window)
    _close(m.numpy(), np.asarray(jm)[:, :, :s_l, 0])
    _close(l.numpy(), np.asarray(jl)[:, :, :s_l, 0])
    _close(acc.numpy(), np.asarray(jacc)[:, :, :s_l])

    lse = (m + torch.log(torch.clamp(l, min=1e-20))).numpy()
    delta = _rand(rng, b, hq, s_l, scale=0.1)
    dq0 = _rand(rng, b, hq, s_l, d, scale=0.1)
    dk0, dv0 = (_rand(rng, b, hkv, s_l, d, scale=0.1) for _ in range(2))
    jlse, jdelta = jnp.asarray(_lanes(lse, s_pad)), jnp.asarray(_lanes(delta, s_pad))
    jdq = jfm.flash_ring_dq_block(jq, jk, jv, jdo, jlse, jdelta,
                                  jnp.asarray(_pad(dq0, s_pad)), q_off, k_off,
                                  **kw)
    jdk, jdv = jfm.flash_ring_dkv_block(jq, jk, jv, jdo, jlse, jdelta,
                                        jnp.asarray(_pad(dk0, s_pad)),
                                        jnp.asarray(_pad(dv0, s_pad)), q_off,
                                        k_off, **kw)
    dq, dk, dv = (torch.tensor(x) for x in (dq0, dk0, dv0))
    targs = (torch.tensor(lse), torch.tensor(delta))
    tfm.flash_ring_dq_block(tq, tk, tv, tdo, *targs, dq, pos, causal, scale,
                            window)
    tfm.flash_ring_dkv_block(tq, tk, tv, tdo, *targs, dk, dv, pos, causal,
                             scale, window)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        _close(got.numpy(), np.asarray(want)[:, :, :s_l])


def test_cpu_hops_never_launch_a_kernel():
    before = dict(tfm.ring_launches)
    q = torch.zeros((1, 2, 8, 16))
    m, l = torch.full((1, 2, 8), tfm.NEG_INF), torch.zeros((1, 2, 8))
    tfm.flash_carry_block(q, q, q, m, l, torch.zeros_like(q), (0, 1, 0, 1))
    assert tfm.ring_launches == before


def test_placement_helpers_match_jax():
    for s, sp in ((16, 4), (24, 2), (12, 1)):
        for placement in ("contiguous", "striped"):
            np.testing.assert_array_equal(
                tring.ring_position_map(s, sp, placement).numpy(),
                np.asarray(jring.ring_position_map(s, sp, placement)))
        x = np.arange(2 * s * 3).reshape(2, s, 3)
        y = tring.stripe_sequence(x, sp)
        np.testing.assert_array_equal(y, np.asarray(jring.stripe_sequence(x, sp)))
        np.testing.assert_array_equal(tring.unstripe_sequence(y, sp), x)
        np.testing.assert_array_equal(
            tring.stripe_sequence(torch.tensor(x), sp).numpy(), y)
    with pytest.raises(ValueError, match="not divisible"):
        tring.stripe_sequence(np.zeros((1, 10)), 4)


def test_ring_attention_argument_checks():
    q = torch.zeros((1, 8, 4, 16))
    k3 = torch.zeros((1, 8, 3, 16))
    with pytest.raises(ValueError, match="not divisible"):
        tring.ring_attention(q, k3, k3)
    with pytest.raises(ValueError, match="causal"):
        tring.ring_attention(q, q, q, causal=False, window=8)
    with pytest.raises(ValueError, match="window must be positive"):
        tring.ring_attention(q, q, q, window=0)
    with pytest.raises(ValueError, match="placement"):
        tring.ring_attention(q, q, q, placement="zigzagish")
    with pytest.raises(ValueError, match="interleave"):
        tring.ring_attention(q, q, q, interleave=3)
    for wire in ("int8", "fp8"):
        with pytest.raises(NotImplementedError, match="Queue A item 8"):
            tring.ring_attention(q, q, q, wire_dtype=wire)


# causal, window, nkv
VARIANTS = [(True, None, 2), (True, 6, 4)]


def _jax_ring(sp, q, k, v, w, kw):
    topo = JaxTopology({"seq": sp, "data": 1})

    def loss(q, k, v):
        o = jring.ring_attention(q, k, v, topo, **kw)
        return jnp.sum(o * w), o

    (_, o), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                               has_aux=True))(q, k, v)
    return [np.asarray(x) for x in (o, *grads)]


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention_in_gloo_ranks_matches_jax_mesh(sp):
    """One spawn of ``sp`` ranks runs every case: 2 placements x 2 variants
    x interleave 1 and 2."""
    rng = np.random.default_rng(sp)
    b, s, nh, d = 2, 48, 4, 16
    cases, meta = [], []
    for placement in ("contiguous", "striped"):
        for causal, window, nkv in VARIANTS:
            q, w = _rand(rng, b, s, nh, d), _rand(rng, b, s, nh, d)
            k, v = _rand(rng, b, s, nkv, d), _rand(rng, b, s, nkv, d)
            for interleave in (1, 2):
                kw = dict(causal=causal, window=window, placement=placement,
                          interleave=interleave)
                cases.append({"q": q, "k": k, "v": v, "w": w, "kw": kw})
                meta.append(kw)
    ranks = launch(torch_ring_ranks.ring_attention_cases, sp, args=(cases,),
                   backend="gloo", device="cpu")
    for i in range(0, len(cases), 2):
        got = [np.concatenate([r[i][j] for r in ranks], axis=1)
               for j in range(4)]
        again = [np.concatenate([r[i + 1][j] for r in ranks], axis=1)
                 for j in range(4)]
        for a, b_ in zip(got, again):       # interleave 2: the same bits
            np.testing.assert_array_equal(a, b_)
        c = cases[i]
        kw = {k_: v_ for k_, v_ in meta[i].items() if k_ != "interleave"}
        want = _jax_ring(sp, *(jnp.asarray(c[n]) for n in "qkvw"), kw)
        for name, a, r in zip(("o", "dq", "dk", "dv"), got, want):
            try:
                _close(a, r)
            except AssertionError as e:
                raise AssertionError(f"{meta[i]} {name}: {e}") from None
