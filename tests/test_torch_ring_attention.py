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
* The quantized wire: the plain versions' int8 K/V lane (payloads with
  per-row fp32 scales) against the interpreted Pallas kernels' quantized
  lane (``k_scale``/``v_scale``), at 2e-5 (fp32 throughout; the JAX
  package's own interpreted-against-XLA int8 ring differs by 1.14e-5 in
  the loss); and ``ring_attention(wire_dtype="int8"/"fp8")`` in 2 and 4
  gloo ranks against the JAX mesh's XLA ring on the same wire
  (``_ring_fwd_xla``/``_ring_bwd_xla``: no interpreted kernel), output
  and gradients at 2e-5: the two codecs encode the same bits, so K/V
  travel identically.  The traveling dk/dv are re-encoded every hop from
  sums the two rings take in other orders, so an element that lies on a
  rounding boundary of the wire may land one wire step apart (int8: the
  row's absmax / 127; fp8: one e4m3 step of the element): dk and dv hold
  2e-5 everywhere but at most 1 element in 500, which hold one wire step
  (seen: one fp8 dk element in 6144 at sp 4).
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
    # head dims off the kernels' 64/128 lanes (phi-2 80, gptneox-20b 96,
    # gptj-6b 256)
    (4, 2, 64, 80, True, None, "striped", 2, 1, 0),
    (4, 4, 80, 96, True, 24, "contiguous", 2, 1, 0),      # window, tail
    (2, 1, 64, 256, True, None, "contiguous", 2, 1, 0),   # MQA
]
HOP_IDS = ["contig-live-tail", "contig-own", "striped-0from1",
           "striped-mha-tail", "window", "noncausal-mqa", "striped-sp4",
           "d80-striped", "d96-window-tail", "d256-mqa"]


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


@pytest.mark.parametrize("d", [16, 32, 80, 96, 200])
def test_padded_head_dim_hop_equals_the_unpadded_plain_versions(d):
    """One hop as ring_attention runs it on a CUDA tensor whose head_dim is
    off the lanes: q, k, v, do and the fp32 state zero-padded to the lane
    (flash_mha.head_dim_lane), sm_scale from the real D.  The carry and
    dq, dk/dv into seeded accumulators equal the unpadded plain versions in
    fp32 within 1e-6, and the padded columns stay 0."""
    rng = np.random.default_rng(d)
    b, hq, hkv, s_l, scale = 1, 4, 2, 72, d ** -0.5
    lane = tfm.head_dim_lane(d)
    pad = lambda x: torch.nn.functional.pad(x, (0, lane - x.shape[-1]))  # noqa: E731
    q, do = (torch.tensor(_rand(rng, b, hq, s_l, d)) for _ in range(2))
    k, v = (torch.tensor(_rand(rng, b, hkv, s_l, d)) for _ in range(2))
    pos = (1, 2, 0, 2)     # striped, rank 1 <- block 0

    def state(width):
        return (torch.full((b, hq, s_l), tfm.NEG_INF), torch.zeros((b, hq, s_l)),
                torch.zeros((b, hq, s_l, width)))

    got, want = state(lane), state(d)
    tfm.flash_carry_block(*map(pad, (q, k, v)), *got, pos, True, scale)
    tfm.flash_carry_block(q, k, v, *want, pos, True, scale)
    lse = (want[0] + torch.log(want[1].clamp(min=1e-20))).contiguous()
    delta = torch.tensor(_rand(rng, b, hq, s_l, scale=0.1))
    acc = [torch.tensor(_rand(rng, b, h, s_l, d, scale=0.1))
           for h in (hq, hkv, hkv)]
    got_g, want_g = [pad(x) for x in acc], [x.clone() for x in acc]
    bwd_p = (*map(pad, (q, k, v, do)), lse, delta)
    tfm.flash_ring_dq_block(*bwd_p, got_g[0], pos, True, scale)
    tfm.flash_ring_dkv_block(*bwd_p, got_g[1], got_g[2], pos, True, scale)
    tfm.flash_ring_dq_block(q, k, v, do, lse, delta, want_g[0], pos, True, scale)
    tfm.flash_ring_dkv_block(q, k, v, do, lse, delta, want_g[1], want_g[2], pos,
                             True, scale)
    pairs = [(got[0], want[0]), (got[1], want[1]), (got[2][..., :d], want[2])] \
        + [(g[..., :d], w) for g, w in zip(got_g, want_g)]
    for g, w in pairs:
        _close(g.numpy(), w.numpy(), rtol=1e-6)
    for x in (got[2], *got_g):
        assert bool((x[..., d:] == 0).all())


def test_cpu_hops_never_launch_a_kernel():
    before = dict(tfm.ring_launches)
    q = torch.zeros((1, 2, 8, 16))
    m, l = torch.full((1, 2, 8), tfm.NEG_INF), torch.zeros((1, 2, 8))
    tfm.flash_carry_block(q, q, q, m, l, torch.zeros_like(q), (0, 1, 0, 1))
    assert tfm.ring_launches == before


def _carry_operands(layout, dtype):
    """q, k, v of one hop (B 1, Hq 4, Hkv 2, S_l 32, D 64) as the ring
    hands them to the carry: its [B, S, H, D] projections read through
    [B, H, S, D] views, a rotated (contiguous) K/V block, or an expanded
    K/V whose head stride is 0."""
    b, hq, hkv, s, d = 1, 4, 2, 32, 64

    def z(*shape):
        return torch.zeros(shape, dtype=dtype)

    q = z(b, s, hq, d).transpose(1, 2)
    if layout in ("bshd-views", "do-expanded"):
        k, v = (z(b, s, hkv, d).transpose(1, 2) for _ in range(2))
    elif layout == "rotated-block":
        k, v = z(b, hkv, s, d), z(b, hkv, s, d)
    else:
        k = v = z(b, 1, s, d).expand(b, hkv, s, d)
    return q, k, v


def _bwd_operands(layout, dtype):
    """q, k, v, do of one backward hop: the carry's layouts, with do the
    [B, S, H, D] gradient read through a [B, H, S, D] view; or, for
    ``do-expanded``, the gradient of a sum, expanded from one row (every
    stride but the last 0), a view the kernels read in place and TMA
    cannot."""
    q, k, v = _carry_operands(layout, dtype)
    b, hq, s, d = q.shape
    if layout == "do-expanded":
        do = torch.ones((1, 1, 1, d), dtype=dtype).expand(b, hq, s, d)
    else:
        do = torch.zeros((b, s, hq, d), dtype=dtype).transpose(1, 2)
    return q, k, v, do


CARRY_ROUTE_CASES = [("bshd-views", "wgmma"), ("rotated-block", "wgmma"),
                     ("kv-expanded", "mma")]


@pytest.mark.parametrize("layout,want", CARRY_ROUTE_CASES,
                         ids=[c[0] for c in CARRY_ROUTE_CASES])
def test_carry_route_is_chosen_from_dtype_and_strides(layout, want):
    """ring_carry's route follows fwd_route's rule: bf16 views a TMA
    tensor map takes run the wgmma forward in accumulate mode, an expanded
    K/V the 64 x 64 tile walk, fp32 the FMA body; CPU calls take the plain
    version and count no launch and no route."""
    assert tfm.fwd_route(*_carry_operands(layout, torch.bfloat16)) == want
    q, k, v = _carry_operands(layout, torch.float32)
    assert tfm.fwd_route(q, k, v) == "fma"
    assert set(tfm.ring_routes) == {f"{n}.{r}" for n in RING_KERNELS
                                    for r in tfm.RING_ROUTES}
    before = (dict(tfm.ring_launches), dict(tfm.ring_routes))
    m = torch.full(q.shape[:3], tfm.NEG_INF)
    tfm.flash_carry_block(q, k, v, m, torch.zeros_like(m),
                          torch.zeros(q.shape), (1, 2, 0, 2))
    assert (tfm.ring_launches, tfm.ring_routes) == before


RING_KERNELS = ("ring_carry", "ring_bwd_dq", "ring_bwd_dkv")
BWD_ROUTE_CASES = CARRY_ROUTE_CASES + [("do-expanded", "mma")]


@pytest.mark.parametrize("layout,want", BWD_ROUTE_CASES,
                         ids=[c[0] for c in BWD_ROUTE_CASES])
def test_bwd_route_is_chosen_from_dtype_and_strides(layout, want):
    """ring_bwd_dq's and ring_bwd_dkv's route follows fwd_route's rule
    over do as well: bf16 views a TMA tensor map takes run the wgmma
    backward, an expanded K/V or do the 64 x 64 tile walk, fp32 the FMA
    body; CPU calls take the plain version and count no launch and no
    route."""
    assert tfm.bwd_route(*_bwd_operands(layout, torch.bfloat16)) == want
    q, k, v, do = _bwd_operands(layout, torch.float32)
    assert tfm.bwd_route(q, k, v, do) == "fma"
    before = (dict(tfm.ring_launches), dict(tfm.ring_routes))
    rows = torch.zeros(q.shape[:3])
    dk = torch.zeros(k.shape)
    tfm.flash_ring_dq_block(q, k, v, do, rows, rows, torch.zeros(q.shape),
                            (1, 2, 0, 2))
    tfm.flash_ring_dkv_block(q, k, v, do, rows, rows, dk, dk.clone(),
                             (1, 2, 0, 2))
    assert (tfm.ring_launches, tfm.ring_routes) == before


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
    # the quantized wires run (at sp 1 nothing travels); others raise as
    # the JAX codec's validate_wire_dtype does
    for wire in ("int8", "fp8"):
        assert tring.ring_attention(q, q, q, wire_dtype=wire).shape == q.shape
    with pytest.raises(ValueError, match="wire dtype"):
        tring.ring_attention(q, q, q, wire_dtype="int4")


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


# ----------------------------------------------------------------------
# the quantized wire
# ----------------------------------------------------------------------
def _int8_rows(rng, *shape):
    """int8 payload rows and their fp32 row scales ([..., S])."""
    return (rng.integers(-127, 128, shape).astype(np.int8),
            rng.uniform(0.002, 0.05, shape[:-1]).astype(np.float32))


@pytest.mark.parametrize("hop", HOPS[:7] + HOPS[8:], ids=HOP_IDS[:7] + HOP_IDS[8:])
def test_int8_hop_plain_versions_match_interpreted_pallas(hop, interpret):
    """The carry (from the exact own block's state), dq and dk/dv of a
    visiting hop whose K/V are int8 payloads with per-row scales: the
    plain versions against the Pallas kernels' quantized lane, which
    dequantize in the tile load (wire_dequant_rows) and compute in fp32."""
    hq, hkv, s_l, d, causal, window, placement, sp, idx, src = hop
    rng = np.random.default_rng(sum(hop[:4]) + idx + 7 * src + 1)
    b, scale = 1, d ** -0.5
    q, do = _rand(rng, b, hq, s_l, d), _rand(rng, b, hq, s_l, d)
    k, v = _rand(rng, b, hkv, s_l, d), _rand(rng, b, hkv, s_l, d)
    (kp, ks), (vp, vs) = _int8_rows(rng, b, hkv, s_l, d), _int8_rows(rng, b, hkv, s_l, d)
    q_off, q_stride = _offset(idx, s_l, sp, placement)
    k_off, k_stride = _offset(src, s_l, sp, placement)
    pos, own = (q_off, q_stride, k_off, k_stride), (q_off, q_stride) * 2
    s_pad = jfm.ring_carry_pad(s_l)
    kw = dict(q_stride=q_stride, k_stride=k_stride, s_real=s_l,
              sm_scale=scale, causal=causal, window=window)
    jq, jk, jv, jdo, jkp, jvp = (jnp.asarray(_pad(x, s_pad))
                                 for x in (q, k, v, do, kp, vp))
    jks, jvs = (jnp.asarray(_lanes(x, s_pad, value=1.0)) for x in (ks, vs))
    jm = jnp.full((b, hq, s_pad, 128), tfm.NEG_INF, jnp.float32)
    jl = jnp.zeros((b, hq, s_pad, 128), jnp.float32)
    jacc = jnp.zeros((b, hq, s_pad, d), jnp.float32)
    jm, jl, jacc = jfm.flash_carry_block(jq, jk, jv, jm, jl, jacc, q_off,
                                         q_off, **{**kw, "k_stride": q_stride})
    jm, jl, jacc = jfm.flash_carry_block(jq, jkp, jvp, jm, jl, jacc, q_off,
                                         k_off, k_scale=jks, v_scale=jvs, **kw)
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    wire = dict(k_scale=torch.tensor(ks), v_scale=torch.tensor(vs))
    tkp, tvp = torch.tensor(kp), torch.tensor(vp)
    m = torch.full((b, hq, s_l), tfm.NEG_INF)
    l, acc = torch.zeros((b, hq, s_l)), torch.zeros((b, hq, s_l, d))
    tfm.flash_carry_block(tq, tk, tv, m, l, acc, own, causal, scale, window)
    tfm.flash_carry_block(tq, tkp, tvp, m, l, acc, pos, causal, scale, window,
                          **wire)
    _close(m.numpy(), np.asarray(jm)[:, :, :s_l, 0])
    _close(l.numpy(), np.asarray(jl)[:, :, :s_l, 0])
    _close(acc.numpy(), np.asarray(jacc)[:, :, :s_l])

    lse = (m + torch.log(torch.clamp(l, min=1e-20))).numpy()
    delta = _rand(rng, b, hq, s_l, scale=0.1)
    dq0 = _rand(rng, b, hq, s_l, d, scale=0.1)
    dk0, dv0 = (_rand(rng, b, hkv, s_l, d, scale=0.1) for _ in range(2))
    jlse, jdelta = jnp.asarray(_lanes(lse, s_pad)), jnp.asarray(_lanes(delta, s_pad))
    jdq = jfm.flash_ring_dq_block(jq, jkp, jvp, jdo, jlse, jdelta,
                                  jnp.asarray(_pad(dq0, s_pad)), q_off, k_off,
                                  k_scale=jks, v_scale=jvs, **kw)
    jdk, jdv = jfm.flash_ring_dkv_block(jq, jkp, jvp, jdo, jlse, jdelta,
                                        jnp.asarray(_pad(dk0, s_pad)),
                                        jnp.asarray(_pad(dv0, s_pad)), q_off,
                                        k_off, k_scale=jks, v_scale=jvs, **kw)
    dq, dk, dv = (torch.tensor(x) for x in (dq0, dk0, dv0))
    targs = (torch.tensor(lse), torch.tensor(delta))
    tfm.flash_ring_dq_block(tq, tkp, tvp, tdo, *targs, dq, pos, causal, scale,
                            window, **wire)
    tfm.flash_ring_dkv_block(tq, tkp, tvp, tdo, *targs, dk, dv, pos, causal,
                             scale, window, **wire)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        _close(got.numpy(), np.asarray(want)[:, :, :s_l])


def test_int8_hop_checks_and_routes():
    """Scales come both or neither; int8 K/V route to the int8 lanes kernel
    by kernel (``ring_route``: fp32 q ``fma_s8``, bf16 off the wgmma lanes
    ``mma_s8``), other K/V by the attention routes' rules; every kernel
    counts the lanes ``wgmma_s8`` included; the wire's decode is one
    multiply a row; CPU calls count nothing."""
    q, do = torch.zeros((1, 2, 8, 16)), torch.zeros((1, 2, 8, 16))
    kp = torch.zeros((1, 1, 8, 16), dtype=torch.int8)
    sc = torch.full((1, 1, 8), 0.5)
    m, l = torch.full((1, 2, 8), tfm.NEG_INF), torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="together"):
        tfm.flash_carry_block(q, kp, kp, m, l, torch.zeros_like(q),
                              (0, 1, 0, 1), k_scale=sc)
    assert tfm.ring_route("ring_carry", q, kp, kp) == "fma_s8"
    assert tfm.ring_route("ring_bwd_dkv", q.bfloat16(), kp, kp,
                          do.bfloat16()) == "mma_s8"     # D 16: no wgmma lane
    assert tfm.ring_route("ring_bwd_dq", q, q, q, do) == "fma"
    with pytest.raises(ValueError, match="no ring kernel"):
        tfm.ring_route("ring_fwd", q, kp, kp)
    assert tfm.RING_ROUTES == ("fma", "mma", "wgmma", "fma_s8", "mma_s8",
                               "wgmma_s8")
    assert {f"{n}.wgmma_s8" for n in RING_KERNELS} <= set(tfm.ring_routes)
    assert tfm.WGMMA_S8_KERNELS == RING_KERNELS     # dq too
    x = torch.tensor([[[[-128, 3, 127]]]], dtype=torch.int8)
    np.testing.assert_array_equal(
        tfm.wire_dequant_rows(x, torch.tensor([[[0.25]]])).numpy(),
        [[[[-32.0, 0.75, 31.75]]]])
    before = (dict(tfm.ring_launches), dict(tfm.ring_routes))
    tfm.flash_carry_block(q, kp, kp, m, l, torch.zeros_like(q), (0, 1, 0, 1),
                          k_scale=sc, v_scale=sc)
    assert (tfm.ring_launches, tfm.ring_routes) == before


def _wire_step(x, wire):
    """One wire step at each element of ``x`` ([..., D] rows): the int8
    codec's row scale (absmax / 127), or the fp8 codec's e4m3 spacing at
    the element (3 mantissa bits, subnormal below 2^-6) times the row
    scale (absmax / 448)."""
    absmax = np.abs(x).max(axis=-1, keepdims=True)
    if wire == "int8":
        return np.broadcast_to(absmax / 127.0, x.shape)
    scale = np.where(absmax > 0, absmax / 448.0, 1.0)
    q = np.maximum(np.abs(x) / scale, 2.0 ** -6)
    return 2.0 ** (np.floor(np.log2(q)) - 3) * scale


def _close_wire(got, want, wire, rtol=RTOL):
    """2e-5 everywhere but at most 1 element in 500, which hold one wire
    step (module docstring)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    off = err > rtol * (1 + np.abs(want))
    assert off.sum() * 500 <= off.size, (int(off.sum()), off.size)
    step = _wire_step(want, wire)
    assert np.all(err[off] <= rtol * (1 + np.abs(want[off])) + 1.01 * step[off]), \
        float(err.max())


# int8 K/V routes kernel by kernel: case id, D, q dtype, layout, and the
# routes of ring_carry, ring_bwd_dq and ring_bwd_dkv
INT8_ROUTE_CASES = [
    ("d64", 64, torch.bfloat16, "bshd-views", ("wgmma_s8", "wgmma_s8", "wgmma_s8")),
    ("d128", 128, torch.bfloat16, "bshd-views", ("wgmma_s8", "wgmma_s8", "wgmma_s8")),
    ("d128-rotated", 128, torch.bfloat16, "rotated-block",
     ("wgmma_s8", "wgmma_s8", "wgmma_s8")),
    ("d256", 256, torch.bfloat16, "bshd-views", ("mma_s8", "mma_s8", "mma_s8")),
    ("fp32-q", 128, torch.float32, "bshd-views", ("fma_s8", "fma_s8", "fma_s8")),
    ("kv-expanded", 128, torch.bfloat16, "kv-expanded", ("mma_s8", "mma_s8", "mma_s8")),
    ("do-expanded", 128, torch.bfloat16, "do-expanded",
     ("wgmma_s8", "mma_s8", "mma_s8")),
]


@pytest.mark.parametrize("case", INT8_ROUTE_CASES,
                         ids=[c[0] for c in INT8_ROUTE_CASES])
def test_int8_route_is_chosen_per_kernel(case):
    """Over int8 K/V, ``ring_route`` gives each kernel the wgmma walks'
    int8 lane (``wgmma_s8``) where the bf16 rule gives ``wgmma`` (bf16 q
    and do at D 64 or 128, views TMA can read), D 256 and an expanded K/V
    or do ``mma_s8``, an fp32 q ``fma_s8``; the CPU path (the plain versions, the same numbers on
    every route) counts no launch and no route."""
    _name, d, dtype, layout, want = case
    q, k, v, do = _bwd_operands(layout, dtype)
    b, hq, s, _ = q.shape
    pad = (0, d - q.shape[-1])
    q, do = (torch.nn.functional.pad(x, pad) if d != x.shape[-1] else x
             for x in (q, do))
    if layout == "do-expanded":
        do = torch.ones((1, 1, 1, d), dtype=dtype).expand(b, hq, s, d)
    hkv = k.shape[1]
    if layout == "kv-expanded":
        kp = torch.zeros((b, 1, s, d), dtype=torch.int8).expand(b, hkv, s, d)
    elif layout == "rotated-block":
        kp = torch.zeros((b, hkv, s, d), dtype=torch.int8)
    else:
        kp = torch.zeros((b, s, hkv, d), dtype=torch.int8).transpose(1, 2)
    got = (tfm.ring_route("ring_carry", q, kp, kp),
           tfm.ring_route("ring_bwd_dq", q, kp, kp, do),
           tfm.ring_route("ring_bwd_dkv", q, kp, kp, do))
    assert got == want
    rng = np.random.default_rng(5)
    kp = torch.from_numpy(rng.integers(-127, 128, (b, hkv, s, d))
                          .astype(np.int8))
    wire = {k_: torch.from_numpy(rng.uniform(0.01, 0.02, (b, hkv, s))
                                 .astype(np.float32))
            for k_ in ("k_scale", "v_scale")}
    before = (dict(tfm.ring_launches), dict(tfm.ring_routes))
    m = torch.full((b, hq, s), tfm.NEG_INF)
    tfm.flash_carry_block(q, kp, kp, m, torch.zeros_like(m),
                          torch.zeros((b, hq, s, d)), (1, 2, 0, 2), **wire)
    rows = torch.zeros((b, hq, s))
    dk = torch.zeros((b, hkv, s, d))
    tfm.flash_ring_dq_block(q, kp, kp, do, rows, rows, torch.zeros((b, hq, s, d)),
                            (1, 2, 0, 2), **wire)
    tfm.flash_ring_dkv_block(q, kp, kp, do, rows, rows, dk, dk.clone(),
                             (1, 2, 0, 2), **wire)
    assert (tfm.ring_launches, tfm.ring_routes) == before


@pytest.mark.parametrize("wire", ["int8", "fp8"])
@pytest.mark.parametrize("sp", [2, 4])
def test_quantized_ring_in_gloo_ranks_matches_jax_xla_ring(sp, wire):
    """``ring_attention(wire_dtype=...)`` in ``sp`` gloo CPU ranks (the plain
    versions on the wire's payloads) against the JAX ring on a seq CPU mesh
    through its XLA path (no interpreted kernel): one spawn, 2 placements x
    causal GQA and a window with nkv 4, interleave 1 and 2 (the same bits)."""
    rng = np.random.default_rng(10 * sp + len(wire))
    b, s, nh, d = 2, 48, 4, 16
    cases, meta = [], []
    for placement in ("contiguous", "striped"):
        for causal, window, nkv in VARIANTS:
            q, w = _rand(rng, b, s, nh, d), _rand(rng, b, s, nh, d)
            k, v = _rand(rng, b, s, nkv, d), _rand(rng, b, s, nkv, d)
            for interleave in (1, 2):
                kw = dict(causal=causal, window=window, placement=placement,
                          interleave=interleave, wire_dtype=wire)
                cases.append({"q": q, "k": k, "v": v, "w": w, "kw": kw})
                meta.append(kw)
    assert not jfm.INTERPRET    # the JAX ring takes its XLA path
    ranks = launch(torch_ring_ranks.ring_attention_cases, sp, args=(cases,),
                   backend="gloo", device="cpu")
    for i in range(0, len(cases), 2):
        got = [np.concatenate([r[i][j] for r in ranks], axis=1)
               for j in range(4)]
        again = [np.concatenate([r[i + 1][j] for r in ranks], axis=1)
                 for j in range(4)]
        for a, b_ in zip(got, again):
            np.testing.assert_array_equal(a, b_)
        c = cases[i]
        kw = {k_: v_ for k_, v_ in meta[i].items() if k_ != "interleave"}
        want = _jax_ring(sp, *(jnp.asarray(c[n]) for n in "qkvw"), kw)
        for name, a, r in zip(("o", "dq", "dk", "dv"), got, want):
            try:
                if name in ("dk", "dv"):
                    _close_wire(a, r, wire)
                else:
                    _close(a, r)
            except AssertionError as e:
                raise AssertionError(f"{meta[i]} {name}: {e}") from None
