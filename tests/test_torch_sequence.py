"""The port's long-context building blocks (``sequence/{fpdt,alst}.py``)
against the JAX package's (``deepspeed_tpu/sequence``), on the CPU, with no
process group: the same numpy inputs through both.

* ``chunked_attention``: the plain version (CPU tensors) and the kernel
  path (``_hop_chunked_attention``: one ring hop wrapper call a live chunk
  pair, here their plain versions), causal and not, at two chunk sizes,
  GQA, with and without ``offload_kv``: outputs and the gradients of
  ``sum(o * w)`` within 2e-5 of JAX's; the kernel path calls each hop
  wrapper once a live pair (``n·(n+1)/2`` causal).
* ``chunked_ffn`` and ``tiled_mlp`` (and ``tiled_mlp``'s gradient).
* ``tiled_logits_loss``, with and without the logit cap, and its
  gradients in the hidden states and the head weight against the JAX
  tiled loss and the untiled cross-entropy, within 1e-5; the head
  gradient added a group of tiles at a time, a partial last group too.
* ``sp_shard_batch`` and ``SPDataLoader``.
* The model's tiled loss: a shard that does not divide into the global
  tile raises naming both numbers; ``loss_tiles`` with the MLM head raises
  as in JAX.
* The engine stripes a batch over a seq axis only under the ring's striped
  placement (a Ulysses model with ``ring_placement="striped"`` keeps the
  contiguous shard, as the JAX ``_maybe_stripe_ring``).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu import sequence as jseq
from deepspeed_tpu_torch.models import get_model_config
from deepspeed_tpu_torch.models import transformer as tf
from deepspeed_tpu_torch.ops import flash_mha as tfm
from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
from deepspeed_tpu_torch.sequence import alst, fpdt
from deepspeed_tpu_torch import sequence as tseq

from test_torch_engine_v2 import one_torch_thread  # noqa: F401

ATTN_TOL = 2e-5
LOSS_TOL = 1e-5


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _jax_attn(q, k, v, w, chunk, causal, offload=False):
    def loss(q, k, v):
        o = jseq.chunked_attention(q, k, v, chunk, causal,
                                   offload_kv=offload)
        return jnp.sum(o * w), o

    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(x) for x in (o, *grads)]


def _port_attn(fn, q, k, v, w):
    qt, kt, vt = (torch.tensor(x).requires_grad_() for x in (q, k, v))
    o = fn(qt, kt, vt)
    (o * torch.tensor(w)).sum().backward()
    return [x.detach().numpy() for x in (o, qt.grad, kt.grad, vt.grad)]


def _close(got, want, tol, what):
    for name, a, r in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, r, rtol=tol, atol=tol,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("path", ["plain", "hops", "hops-offload"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunk", [8, 16])
def test_chunked_attention_matches_jax(path, causal, chunk):
    rng = np.random.default_rng(0)
    b, s, h, d = 2, 64, 4, 16
    q, k, v, w = (_rand(rng, b, s, h, d) for _ in range(4))
    if path == "plain":
        def fn(q_, k_, v_):
            return tseq.chunked_attention(q_, k_, v_, chunk, causal)
    else:
        def fn(q_, k_, v_):
            return fpdt._hop_chunked_attention(
                q_, k_, v_, chunk, causal, d ** -0.5, path == "hops-offload")
    _close(_port_attn(fn, q, k, v, w),
           _jax_attn(q, k, v, w, chunk, causal), ATTN_TOL, path)


@pytest.mark.parametrize("path", ["plain", "hops"])
def test_chunked_attention_gqa_matches_jax(path):
    rng = np.random.default_rng(1)
    b, s, hq, hkv, d = 1, 32, 8, 2, 8
    q, w = _rand(rng, b, s, hq, d), _rand(rng, b, s, hq, d)
    k, v = _rand(rng, b, s, hkv, d), _rand(rng, b, s, hkv, d)
    if path == "plain":
        def fn(q_, k_, v_):
            return tseq.chunked_attention(q_, k_, v_, 8, offload_kv=True)
    else:
        def fn(q_, k_, v_):
            return fpdt._hop_chunked_attention(q_, k_, v_, 8, True,
                                               d ** -0.5, False)
    _close(_port_attn(fn, q, k, v, w), _jax_attn(q, k, v, w, 8, True),
           ATTN_TOL, path)


@pytest.mark.parametrize("causal", [True, False])
def test_kernel_path_calls_each_hop_once_a_live_pair(causal, monkeypatch):
    calls = {}
    for name in ("flash_carry_block", "flash_ring_dq_block",
                 "flash_ring_dkv_block"):
        real = getattr(tfm, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)

        monkeypatch.setattr(tfm, name, counted)
    rng = np.random.default_rng(2)
    n, c = 8, 4
    q, k, v, w = (_rand(rng, 1, n * c, 2, 8) for _ in range(4))
    _port_attn(lambda *x: fpdt._hop_chunked_attention(*x, c, causal,
                                                      8 ** -0.5, True),
               q, k, v, w)
    live = n * (n + 1) // 2 if causal else n * n
    assert calls == {"flash_carry_block": live, "flash_ring_dq_block": live,
                     "flash_ring_dkv_block": live}


def test_chunked_attention_checks():
    x = torch.zeros(1, 12, 4, 8)
    with pytest.raises(ValueError, match="not divisible by chunk"):
        tseq.chunked_attention(x, x, x, 8)
    with pytest.raises(ValueError, match="not a multiple of kv heads"):
        tseq.chunked_attention(x, x[:, :, :3], x[:, :, :3], 4)


def test_chunked_ffn_matches_jax():
    rng = np.random.default_rng(3)
    x, w = _rand(rng, 2, 32, 16), _rand(rng, 16, 16)
    want = jseq.chunked_ffn(lambda t: jax.nn.gelu(t @ jnp.asarray(w)),
                            jnp.asarray(x), num_chunks=4)
    got = tseq.chunked_ffn(
        lambda t: torch.nn.functional.gelu(t @ torch.tensor(w),
                                           approximate="tanh"),
        torch.tensor(x), num_chunks=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="chunks"):
        tseq.chunked_ffn(lambda t: t, torch.tensor(x), num_chunks=5)


@pytest.mark.parametrize("remat", [True, False])
def test_tiled_mlp_and_its_gradient_match_jax(remat):
    rng = np.random.default_rng(4)
    x, w1, w2 = (_rand(rng, 2, 24, 8), _rand(rng, 8, 32), _rand(rng, 32, 8))
    jx, jw2 = jnp.asarray(x), jnp.asarray(w2)
    want = jseq.tiled_mlp(lambda t: jax.nn.silu(t @ jnp.asarray(w1)) @ jw2,
                          jx, num_tiles=3)
    g_want = jax.grad(lambda w: jseq.tiled_mlp(
        lambda t: jax.nn.silu(t @ w) @ jw2, jx, 3).sum())(jnp.asarray(w1))
    tw1 = torch.tensor(w1).requires_grad_()
    out = tseq.tiled_mlp(
        lambda t: torch.nn.functional.silu(t @ tw1) @ torch.tensor(w2),
        torch.tensor(x), num_tiles=3, remat=remat)
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tw1.grad.numpy(), np.asarray(g_want),
                               rtol=1e-5, atol=1e-5)


def _untiled_jax(h, w, labels, cap):
    logits = jnp.einsum("bse,ve->bsv", h, w)
    if cap is not None:
        logits = cap * jnp.tanh(logits / cap)
    lse = jax.nn.logsumexp(logits, axis=-1)
    safe = jnp.where(labels == -100, 0, labels)
    gold = jnp.take_along_axis(logits, safe[..., None], -1)[..., 0]
    valid = labels != -100
    return jnp.where(valid, lse - gold, 0.0).sum() / valid.sum()


@pytest.mark.parametrize("cap", [None, 3.0])
def test_tiled_logits_loss_and_grads_match_jax(cap):
    rng = np.random.default_rng(5)
    b, s, e, v = 2, 16, 8, 32
    hidden, w = _rand(rng, b, s, e), _rand(rng, v, e)
    labels = rng.integers(0, v, size=(b, s)).astype(np.int32)
    labels[0, :3] = -100
    jh, jw, jl = (jnp.asarray(x) for x in (hidden, w, labels))

    def tiled(h_, w_):
        return jseq.tiled_logits_loss(h_, w_, jl, 4, logit_cap=cap)[0]

    want, (gh, gw) = jax.value_and_grad(tiled, argnums=(0, 1))(jh, jw)
    untiled, (uh, uw) = jax.value_and_grad(
        lambda h_, w_: _untiled_jax(h_, w_, jl, cap), argnums=(0, 1))(jh, jw)
    th, tw = (torch.tensor(x).requires_grad_() for x in (hidden, w))
    loss, count = tseq.tiled_logits_loss(th, tw, torch.tensor(labels), 4,
                                         logit_cap=cap)
    loss.backward()
    assert int(count) == int((labels != -100).sum())
    for ref, rh, rw in ((want, gh, gw), (untiled, uh, uw)):
        assert float(loss.detach()) == pytest.approx(float(ref), rel=LOSS_TOL)
        np.testing.assert_allclose(th.grad.numpy(), np.asarray(rh),
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(rw),
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
    with pytest.raises(ValueError, match="num_tiles"):
        tseq.tiled_logits_loss(th, tw, torch.tensor(labels), 5)


@pytest.mark.parametrize("group", [1, 3, 4])
def test_tiled_nll_head_gradient_in_groups_of_tiles(group, monkeypatch):
    """The backward adds the logit gradients of ``group`` tiles (as many as
    ``DW_GROUP_BYTES`` holds) into the head gradient in one product (3 of
    4 tiles: a last group of one), two rows a batch, the cap on: the
    gradients of the JAX tiled loss."""
    rng = np.random.default_rng(6)
    b, s, e, v = 2, 16, 8, 32
    # one tile's logit gradients: b x (s / 4) x v fp32
    monkeypatch.setattr(alst, "DW_GROUP_BYTES", group * b * (s // 4) * v * 4)
    hidden, w = _rand(rng, b, s, e), _rand(rng, v, e)
    labels = rng.integers(0, v, size=(b, s)).astype(np.int32)
    labels[1, 5:9] = -100
    jl = jnp.asarray(labels)
    want, (gh, gw) = jax.value_and_grad(
        lambda h_, w_: jseq.tiled_logits_loss(h_, w_, jl, 4,
                                              logit_cap=3.0)[0],
        argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(w))
    th, tw = (torch.tensor(x).requires_grad_() for x in (hidden, w))
    nll, count = alst.tiled_nll(th, tw, torch.tensor(labels), s // 4,
                               logit_cap=3.0)
    (nll / count).backward()
    assert float((nll / count).detach()) == pytest.approx(float(want),
                                                          rel=LOSS_TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw),
                               rtol=LOSS_TOL, atol=LOSS_TOL)


def test_sp_shard_batch_matches_jax():
    batch = {"input_ids": np.arange(32).reshape(2, 16),
             "labels": np.arange(32).reshape(2, 16),
             "position_ids": np.tile(np.arange(16), (2, 1)), "meta": "keep"}
    for rank in range(4):
        got = tseq.sp_shard_batch(batch, rank, 4)
        want = jseq.sp_shard_batch(batch, rank, 4)
        assert got.keys() == want.keys() and got["meta"] == "keep"
        for key in ("input_ids", "labels", "position_ids"):
            np.testing.assert_array_equal(got[key], want[key])
    assert tseq.sp_shard_batch(batch, 0, 1).keys() == batch.keys()
    with pytest.raises(ValueError, match="not divisible"):
        tseq.sp_shard_batch(batch, 0, 5)


def test_sp_dataloader_matches_jax():
    data = [{"input_ids": np.arange(16).reshape(2, 8) + i} for i in range(3)]
    got = tseq.SPDataLoader(data, sp_rank=1, sp_size=2)
    want = list(jseq.SPDataLoader(data, sp_rank=1, sp_size=2))
    assert len(got) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])


def _tiny_batch(s, rows=2, seed=6):
    rng = np.random.default_rng(seed)
    ids = torch.tensor(rng.integers(0, 512, (rows, s + 1)))
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:].clone()}


def test_model_tiled_loss_equals_untiled_and_checks_its_tiles():
    model = get_model_config("llama-tiny", dtype=torch.float32)
    params = tf.init_params(model, seed=1, device="cpu")
    batch = _tiny_batch(16)
    batch["labels"][0, :4] = -100
    untiled = tf.loss_fn(params, batch, model)
    tiled = tf.loss_fn(params, batch, model.replace(loss_tiles=4))
    assert float(tiled) == pytest.approx(float(untiled), rel=LOSS_TOL)
    # 16 tokens on each of 2 seq ranks, one tile of the global 32
    topo = types.SimpleNamespace(sp_size=2, sp_rank=0, dp_size=1)
    with pytest.raises(ValueError, match="16 tokens .* tiles of 32"):
        tf.loss_fn(params, batch, model.replace(loss_tiles=1), topo=topo)
    bert = get_model_config("llama-tiny", mlm_head=True, loss_tiles=4)
    with pytest.raises(NotImplementedError, match="mlm_head"):
        tf.loss_fn(params, batch, bert)


@pytest.mark.parametrize("seq_impl,striped", [("ulysses", False),
                                              ("ring", True)])
def test_engine_stripes_only_under_the_ring(seq_impl, striped):
    """The striped placement reorders the shard only for a ring model;
    a Ulysses model (and a duck-typed trainable) keeps the contiguous
    shard, the JAX engine's ``_maybe_stripe_ring``."""
    s, sp = 8, 2
    batch = {"input_ids": np.arange(2 * s).reshape(2, s),
             "labels": np.arange(2 * s).reshape(2, s) + 100}
    for rank in range(sp):
        fake = types.SimpleNamespace(
            topology=types.SimpleNamespace(sp_size=sp, sp_rank=rank),
            model_config=get_model_config("llama-tiny", seq_impl=seq_impl,
                                          ring_placement="striped"))
        got = DeepSpeedEngine._seq_shard(fake, batch, seq_axis=1)
        cols = (np.arange(rank, s, sp) if striped
                else np.arange(rank * s // sp, (rank + 1) * s // sp))
        for key in batch:
            np.testing.assert_array_equal(got[key], batch[key][:, cols])
    fake.model_config = None      # a duck-typed trainable: contiguous
    got = DeepSpeedEngine._seq_shard(fake, batch, seq_axis=1)
    np.testing.assert_array_equal(got["input_ids"], batch["input_ids"][:, 4:])
