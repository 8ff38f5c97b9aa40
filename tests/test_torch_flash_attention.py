"""The port's flash attention (``deepspeed_tpu_torch/ops/flash_mha.py``:
the plain versions of ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv``
behind the autograd function) against the JAX package's Pallas
``flash_mha`` run through the Pallas interpreter, forward and ``jax.vjp``
gradients, on the CPU.

The JAX function reaches its VMEM-resident kernels at these lengths; the
``blocked`` cases force its KV-blocked kernels the way
``tests/test_pallas_flash.py`` does (``_supports_resident`` → False), with
128-row tiles so that each query row takes several online-softmax steps.
Tolerances, |port - jax| <= tol * (1 + |jax|): fp32 2e-5 (summation order:
the port walks 64-key tiles with an online softmax); bf16 2^-7 (the JAX
resident kernel rounds p against the global row max where the port, like
the JAX blocked kernel, rounds it against the running one).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import flash_mha as tfm
from deepspeed_tpu_torch.ops.flash_attention import flash_attention

from test_torch_engine_v2 import one_torch_thread  # noqa: F401

jfm = importlib.import_module("deepspeed_tpu.ops.pallas.flash_mha")

# b, hq, hkv, s, d, causal, window
CASES = [
    (1, 2, 2, 256, 64, True, None),      # MHA causal
    (1, 4, 2, 192, 64, False, None),     # GQA bidirectional
    (1, 2, 1, 130, 128, True, None),     # MQA, d=128, tail
    (1, 2, 2, 320, 64, True, 96),        # sliding window
    (2, 2, 2, 100, 64, False, 40),       # window without causal, tail
    # head dims off the kernels' 64/128 lanes: the *-tiny configs' 32,
    # phi-2's 80, gptneox-20b's 96, gptj-6b's 256
    (1, 2, 2, 192, 32, True, None),
    (1, 4, 2, 130, 80, True, None),      # GQA, tail
    (1, 2, 2, 128, 96, False, 48),       # window without causal
    (1, 2, 1, 128, 256, True, None),     # MQA
]
IDS = ["mha-causal", "gqa-full", "mqa-d128-tail", "window", "window-full-tail",
       "d32", "d80-gqa-tail", "d96-window", "d256-mqa"]
TOL = {"float32": 2e-5, "bfloat16": 2.0 ** -7}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jfm, "INTERPRET", True)


def _inputs(case, dtype, seed=0):
    b, hq, hkv, s, d, _causal, _window = case
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d),
                          (b, hq, s, d))]
    jx = [jnp.asarray(a, dtype=jnp.dtype(dtype)) for a in arrs]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype))
          for a in jx]
    return jx, tx


def _assert_close(port, ref, tol, what):
    port = port.detach().float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    err = np.abs(port - ref)
    assert np.all(err <= tol * (1 + np.abs(ref))), (what, float(err.max()))


@pytest.mark.parametrize("path", ["resident", "blocked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flash_mha_matches_jax_pallas(case, dtype, path, monkeypatch):
    if path == "blocked":
        # 128-row tiles: several KV tiles per row, each an online-softmax step
        monkeypatch.setattr(jfm, "_supports_resident", lambda s, d: False)
        monkeypatch.setattr(jfm, "_BLK_Q", 128)
        monkeypatch.setattr(jfm, "_BLK_K", 128)
    causal, window = case[5], case[6]
    scale = 1.0 / np.sqrt(case[4])
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(case, dtype)

    jo, vjp = jax.vjp(lambda q, k, v: jfm.flash_mha(q, k, v, causal, scale,
                                                    window), jq, jk, jv)
    jgrads = vjp(jdo)
    tq, tk, tv = (x.requires_grad_(True) for x in (tq, tk, tv))
    to = tfm.flash_mha(tq, tk, tv, causal, scale, window)
    to.backward(tdo)
    tol = TOL[dtype]
    _assert_close(to, jo, tol, "o")
    for name, t, j in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                          jgrads):
        assert t.dtype == tq.dtype
        _assert_close(t, j, tol, name)


def test_flash_attention_model_layout_matches_flash_mha():
    """flash_attention over [B, S, H, D] is flash_mha over the transposed
    views, and rejects a non-positive window like the JAX function."""
    case = CASES[1]
    _, (tq, tk, tv, _) = _inputs(case, "float32", seed=1)
    out = flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                          tv.transpose(1, 2), causal=False)
    ref = tfm.flash_mha(tq, tk, tv, False)
    torch.testing.assert_close(out, ref.transpose(1, 2), rtol=0, atol=0)
    for fn in (flash_attention, tfm.flash_mha):
        with pytest.raises(ValueError, match="window"):
            fn(tq, tk, tv, window=0)


def test_lse_and_delta_match_the_jax_residuals():
    """The saved log-sum-exp equals the JAX forward's (plain [B, H, S]
    here, lane-replicated [B, H, S, 128] there), and attn_delta is the same
    row sum."""
    case = CASES[0]
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(case, "float32", seed=2)
    jo, jlse = jfm._fwd(jq, jk, jv, True, 0.125)
    to, tlse = tfm.flash_fwd(tq, tk, tv, True, 0.125)
    assert tlse.shape == tuple(jlse.shape) and tlse.dtype == torch.float32
    _assert_close(tlse, jlse, 2e-5, "lse")
    _assert_close(tfm.attn_delta(to, tdo), jfm.attn_delta(jo, jdo), 2e-5,
                  "delta")


def test_cpu_path_counts_no_launch():
    before = dict(tfm.flash_mha.launches)
    _, (tq, tk, tv, _) = _inputs(CASES[0], "float32")
    tfm.flash_mha(tq.requires_grad_(True), tk, tv).sum().backward()
    assert tfm.flash_mha.launches == before


# layout of q/k/v (B 2, Hq 4, Hkv 2, S 48, D 64), the bf16 route: views a
# TMA tensor map takes (no zero stride on a dim longer than one) take
# wgmma, an expanded K/V the 64 x 64 walk (mma)
def _qkv(layout, dtype):
    b, hq, hkv, s, d = 2, 4, 2, 48, 64

    def z(*shape):
        return torch.zeros(shape, dtype=dtype)

    if layout == "bhsd":
        return z(b, hq, s, d), z(b, hkv, s, d), z(b, hkv, s, d)
    if layout == "bshd":
        return tuple(z(b, s, h, d).transpose(1, 2) for h in (hq, hkv, hkv))
    if layout == "fused-qkv":
        q, k, v = torch.split(z(b, s, (hq + 2 * hkv) * d),
                              [hq * d, hkv * d, hkv * d], dim=-1)
        return tuple(x.reshape(b, s, -1, d).transpose(1, 2) for x in (q, k, v))
    if layout == "kv-expanded-heads":
        kv = z(b, 1, s, d).expand(b, hkv, s, d)
    elif layout == "kv-expanded-batch":
        kv = z(1, hkv, s, d).expand(b, hkv, s, d)
    else:  # one KV head, stride 0: a dim of size one is never stepped
        kv = z(b, s, d).as_strided((b, 1, s, d), (s * d, 0, d, 1))
    return z(b, hq, s, d), kv, kv


FWD_ROUTE_CASES = [("bhsd", "wgmma"), ("bshd", "wgmma"), ("fused-qkv", "wgmma"),
                   ("mqa-stride0", "wgmma"), ("kv-expanded-heads", "mma"),
                   ("kv-expanded-batch", "mma")]


@pytest.mark.parametrize("layout,want", FWD_ROUTE_CASES,
                         ids=[c[0] for c in FWD_ROUTE_CASES])
def test_fwd_route_is_chosen_from_dtype_and_strides(layout, want):
    """flash_fwd's route is a pure function of dtype and strides: bf16
    takes wgmma or mma, never fma; the same views in fp32 always fma."""
    assert tfm.fwd_route(*_qkv(layout, torch.bfloat16)) == want
    assert tfm.fwd_route(*_qkv(layout, torch.float32)) == "fma"
    assert set(tfm.flash_mha.routes) == {
        f"{n}.{r}" for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
        for r in tfm.FWD_ROUTES}


@pytest.mark.parametrize("layout,want", FWD_ROUTE_CASES,
                         ids=[c[0] for c in FWD_ROUTE_CASES])
def test_bwd_route_follows_the_forward_over_qkv(layout, want):
    """With a do the kernels read in place, the flash backward takes the
    forward's route over the same q/k/v: an expanded K/V keeps the bf16
    backward on the 64 x 64 walk too."""
    q, k, v = _qkv(layout, torch.bfloat16)
    do = torch.zeros(q.shape, dtype=torch.bfloat16)
    assert tfm.bwd_route(q, k, v, do) == want
    assert tfm.bwd_route(*_qkv(layout, torch.float32),
                         do.float()) == "fma"


# do [B 2, Hq 4, S 48, D 64] as autograd may hand it, and whether the
# kernels read it in place
def _do(layout, dtype):
    b, hq, s, d = 2, 4, 48, 64
    if layout == "bhsd":
        return torch.ones((b, hq, s, d), dtype=dtype)
    if layout == "bshd":
        return torch.ones((b, s, hq, d), dtype=dtype).transpose(1, 2)
    if layout == "expanded":          # the gradient of out.sum()
        return torch.ones((), dtype=dtype).expand(b, hq, s, d)
    if layout == "expanded-heads":
        return torch.ones((b, 1, s, d), dtype=dtype).expand(b, hq, s, d)
    return torch.ones((b, hq, s, d + 4), dtype=dtype)[..., :d]  # odd pitch


DO_LAYOUTS = [("bhsd", True), ("bshd", True), ("expanded", False),
              ("expanded-heads", False), ("odd-pitch", False)]


@pytest.mark.parametrize("layout,in_place", DO_LAYOUTS,
                         ids=[c[0] for c in DO_LAYOUTS])
def test_flash_bwd_hands_the_kernels_a_do_they_read_on_wgmma(layout,
                                                            in_place):
    """The flash backward's route is bwd_route over the do that flash_bwd
    passes on (readable_do): a view TMA reads in place goes as it is, any
    other is made contiguous first, so bf16 takes wgmma (an expanded do
    as it came would take mma) and fp32 fma; the values are do's."""
    q, k, v = _qkv("bhsd", torch.bfloat16)
    do = _do(layout, torch.bfloat16)
    got = tfm.readable_do(do)
    assert (got is do) == in_place
    assert torch.equal(got, do)
    assert tfm.bwd_route(q, k, v, got) == "wgmma"
    if layout.startswith("expanded"):
        assert tfm.bwd_route(q, k, v, do) == "mma"
    do32 = tfm.readable_do(_do(layout, torch.float32))
    assert tfm.bwd_route(*_qkv("bhsd", torch.float32), do32) == "fma"


# head_dim -> (its kernel lane, the bf16 route of contiguous views there)
HEAD_DIM_RULE = [(16, 64, "wgmma"), (32, 64, "wgmma"), (64, 64, "wgmma"),
                 (80, 128, "wgmma"), (96, 128, "wgmma"), (128, 128, "wgmma"),
                 (200, 256, "mma"), (256, 256, "mma")]


@pytest.mark.parametrize("d,lane,route", HEAD_DIM_RULE,
                         ids=[f"d{c[0]}" for c in HEAD_DIM_RULE])
def test_head_dim_rule(d, lane, route):
    """One head-dim rule for flash, the ring and block-sparse: D 64 and 128
    are lanes of every route, 256 of the 64 x 64 walk only (bf16 mma, fp32
    fma); any other D up to 128 pads to 64 or 128, up to 256 to 256; the
    wrappers take a lane's D and name the entries that pad any other."""
    assert tfm.head_dim_lane(d) == lane
    assert (lane == d) == (d in tfm.LANES)
    q = torch.zeros((1, 2, 8, lane), dtype=torch.bfloat16)
    assert tfm.fwd_route(q, q, q) == route
    assert tfm.bwd_route(q, q, q, q) == route
    assert tfm.fwd_route(q.float(), q.float(), q.float()) == "fma"
    padded = tfm.head_dim_padded(lambda *x: x[0], *(q[..., :d],) * 3)
    assert padded.shape[-1] == d


def test_head_dim_above_256_raises():
    """D 320 has no lane: the entries raise naming the limit, as do the
    ring's and block-sparse entries through the same rule."""
    with pytest.raises(ValueError, match="256"):
        tfm.head_dim_lane(320)
    q = torch.zeros((1, 2, 8, 320))
    with pytest.raises(ValueError, match="256"):
        tfm.head_dim_padded(lambda *x: x[0], q, q, q)


@pytest.mark.parametrize("d", [16, 32, 80, 96, 200])
@pytest.mark.parametrize("window", [None, 24], ids=["causal", "window"])
def test_padded_head_dim_equals_the_unpadded_plain_versions(d, window):
    """flash_mha through head_dim_padded (the path a CUDA call takes: D
    zero-padded to its lane, sm_scale from the real D, the output sliced
    back) equals the unpadded plain versions in fp32, forward and
    gradients, within 1e-6."""
    case = (1, 4, 2, 72, d, True, window)
    _, (tq, tk, tv, tdo) = _inputs(case, "float32", seed=3)

    def run(padded):
        xs = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]

        def attn(q_, k_, v_):
            return tfm.flash_mha(q_, k_, v_, True, d ** -0.5, window)

        out = tfm.head_dim_padded(attn, *xs) if padded else attn(*xs)
        out.backward(tdo)
        return [out.detach()] + [x.grad for x in xs]

    for what, got, want in zip(("o", "dq", "dk", "dv"), run(True), run(False)):
        assert got.shape == want.shape
        err = (got - want).abs()
        assert bool((err <= 1e-6 * (1 + want.abs())).all()), (what, float(err.max()))
