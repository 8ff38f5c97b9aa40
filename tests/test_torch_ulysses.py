"""Ulysses sequence parallelism, FPDT over a seq group and the ring's
asynchronous rotation, in spawned gloo CPU ranks (rank bodies in
``torch_seq_ranks.py``), against the JAX package on the CPU.

* The port's engine on llama-tiny fp32 with ``seq_impl="ulysses"`` at
  ``{"seq": 2}`` against the JAX engine on ``{"seq": 2, "data": 1}``, at
  ZeRO 1 and 3, untiled and with ``loss_tiles`` (one launch): losses and
  grad norms within 1e-5 relative, the params after the steps as
  ``test_torch_mesh_engine.py`` holds them (each leaf's update within
  1e-3 relative L2, every element within lr: AdamW's first steps turn the
  summation-order noise of a near-zero gradient element into a step of up
  to lr; seen here 2.7e-4 in one element, 3.0e-6 relative L2 over every
  param); each rank's ``all_to_all`` bytes a step are q, k, v and the
  output forward and their gradients backward, a layer a micro-step.
* bloom-tiny (ALiBi) the same way at ZeRO 1: each rank's heads take the
  slopes of their global head indices.
* ``FPDTAttention`` in 4 ranks against the JAX ``FPDTAttention`` on
  ``{"seq": 4, "data": 1}``: output and gradients within 2e-5, with and
  without ``offload_kv``.
* Ring attention at interleave 2 gives the bits of interleave 1, output
  and gradients, on the fp32 and the int8 wire, run several times (the
  asynchronous rotation's buffers must stay alive and in order).
* A duck-typed trainable over ``{"seq": 2}`` (a tiny LM whose attention is
  ``UlyssesAttentionHF``, positions from the batch) against the same
  trainable unsplit: losses, grad norms and params within 1e-5.
* The model's positions under a contiguous seq shard: gpt2-tiny (learned
  positions) over 2 ranks and llama-tiny (rotary, its KV heads repeated
  for the head scatter) over 4, with dropout: each rank's NLL sum and its
  embedding gradient summed over the ranks equal the unsplit model's (the
  masks are drawn over the global positions).
* ``seq_all_to_all`` along (heads, seq), (seq, heads) and (0, 0) against
  the tiled all-to-all's definition, and its gradient the inverse
  exchange.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dsj
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import get_model_config as jax_model_config
from deepspeed_tpu.parallel import topology as jtopology
from deepspeed_tpu.sequence import FPDTAttention as JaxFPDT
from deepspeed_tpu_torch.launcher import launch
from deepspeed_tpu_torch.models import get_model_config
from deepspeed_tpu_torch.models import transformer as tf
from deepspeed_tpu_torch.models.bridge import params_from_jax

import torch_seq_ranks
from test_torch_engine_v2 import one_torch_thread  # noqa: F401
from test_torch_mesh_engine import (CFG, SEQ, _batch, _check, _get,
                                    _jax_init, _jax_run, _paths, _zero)

ULYSSES = {"seq_impl": "ulysses"}
TILES = 4          # the global sequence of SEQ tokens: tiles of 8


def test_ulysses_engine_matches_the_jax_seq_mesh():
    """ZeRO 1 and 3, untiled and tiled, in one launch of two ranks; the JAX
    engines run here meanwhile."""
    batch = _batch(CFG["train_micro_batch_size_per_gpu"]
                   * CFG["gradient_accumulation_steps"])
    configs = {f"stage{st}-{'tiled' if t else 'untiled'}":
               ({**ULYSSES, "loss_tiles": t}, _zero(st, {"seq": 2}))
               for st in (1, 3) for t in (0, TILES)}
    # the JAX init depends on the seed only: the port's ranks train from it
    # while the JAX engines run here
    p0 = jax.tree.map(np.asarray, _jax_init("llama-tiny", ULYSSES))
    params = params_from_jax(p0, get_model_config("llama-tiny"), device="cpu")
    runs = [{"name": name, "model": "llama-tiny", "model_kw": kw,
             "params": params, "cfg": cfg, "batch": batch, "steps": 2}
            for name, (kw, cfg) in configs.items()]
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(launch, torch_seq_ranks.ulysses_engine_runs, 2,
                           args=(runs,), backend="gloo", device="cpu")
        wants = {name: _jax_run(jax_model_config("llama-tiny", **kw), cfg,
                                batch)
                 for name, (kw, cfg) in configs.items()}
        ranks = port.result()
    mc = get_model_config("llama-tiny")
    rows = CFG["train_micro_batch_size_per_gpu"]
    d = mc.dim_per_head
    # bytes a rank sends a layer a micro-step: q, k, v and the output
    # forward, their gradients backward (fp32)
    a2a = 2 * rows * (SEQ // 2) * d * 4 * (2 * mc.num_heads
                                           + 2 * mc.kv_heads)
    for name, want in wants.items():
        for path, a in _paths(want["p0"]):
            np.testing.assert_array_equal(_get(p0, path), a)
        got = ranks[0][name]
        _check(got, want)
        assert ranks[1][name]["checksum"] == got["checksum"]
        assert got["nbytes"]["all_to_all"] == a2a * mc.num_layers \
            * CFG["gradient_accumulation_steps"], name
    # tiled and untiled take the same steps up to summation order
    for st in (1, 3):
        np.testing.assert_allclose(ranks[0][f"stage{st}-tiled"]["losses"],
                                   ranks[0][f"stage{st}-untiled"]["losses"],
                                   rtol=1e-5)


def test_ulysses_alibi_engine_matches_the_jax_seq_mesh():
    """bloom-tiny (ALiBi, 4 heads) at ZeRO 1 over ``{"seq": 2}``: each rank
    holds two of the global heads and must bias them with those heads'
    slopes, not with the slopes of a two-head model."""
    batch = _batch(CFG["train_micro_batch_size_per_gpu"]
                   * CFG["gradient_accumulation_steps"])
    cfg = _zero(1, {"seq": 2})
    p0 = jax.tree.map(np.asarray, _jax_init("bloom-tiny", ULYSSES))
    params = params_from_jax(p0, get_model_config("bloom-tiny"), device="cpu")
    runs = [{"name": "alibi", "model": "bloom-tiny", "model_kw": ULYSSES,
             "params": params, "cfg": cfg, "batch": batch, "steps": 2}]
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(launch, torch_seq_ranks.ulysses_engine_runs, 2,
                           args=(runs,), backend="gloo", device="cpu")
        want = _jax_run(jax_model_config("bloom-tiny", **ULYSSES), cfg, batch)
        ranks = port.result()
    _check(ranks[0]["alibi"], want)
    assert ranks[1]["alibi"]["checksum"] == ranks[0]["alibi"]["checksum"]


def _jax_fpdt(sp, q, k, v, w, chunk, offload):
    topo = jtopology.MeshTopology({"seq": sp, "data": 1})
    jtopology.set_topology(topo)
    try:
        def loss(q, k, v):
            o = JaxFPDT(chunk, offload_kv=offload, topology=topo)(q, k, v)
            return jnp.sum(o * w), o

        (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
        return [np.asarray(x) for x in (o, *grads)]
    finally:
        jtopology.set_topology(None)


@pytest.mark.parametrize("offload", [False, True])
def test_fpdt_in_four_ranks_matches_the_jax_seq_mesh(offload):
    rng = np.random.default_rng(11)
    b, s, h, d = 2, 32, 4, 8
    q, k, v, w = (rng.standard_normal((b, s, h, d)).astype(np.float32)
                  for _ in range(4))
    ranks = launch(torch_seq_ranks.fpdt_cases, 4,
                   args=(q, k, v, w, 8, offload), backend="gloo",
                   device="cpu")
    got = [np.concatenate([r[j] for r in ranks], axis=1) for j in range(4)]
    want = _jax_fpdt(4, *(jnp.asarray(x) for x in (q, k, v, w)), 8, offload)
    for name, a, r in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, r, rtol=2e-5, atol=2e-5, err_msg=name)


def test_ring_interleave_two_gives_the_bits_of_interleave_one():
    rng = np.random.default_rng(12)
    b, s, nh, nkv, d = 2, 48, 4, 2, 16
    cases = []
    for wire in ("fp32", "int8"):
        for placement in ("contiguous", "striped"):
            q, w = (rng.standard_normal((b, s, nh, d)).astype(np.float32)
                    for _ in range(2))
            k, v = (rng.standard_normal((b, s, nkv, d)).astype(np.float32)
                    for _ in range(2))
            cases.append({"q": q, "k": k, "v": v, "w": w,
                          "kw": dict(placement=placement, wire_dtype=wire)})
    for world in (2, 4):
        ranks = launch(torch_seq_ranks.ring_interleave_repeats, world,
                       args=(cases, 3), backend="gloo", device="cpu")
        for r in ranks:
            assert all(c["same_bits"] for c in r), \
                [c["same_bits"] for c in r]


def test_duck_typed_ulysses_trainable_matches_it_unsplit():
    rng = np.random.default_rng(13)
    rows = CFG["train_micro_batch_size_per_gpu"] \
        * CFG["gradient_accumulation_steps"]
    ids = rng.integers(0, 64, (rows, SEQ + 1)).astype(np.int64)
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:].copy(),
             "position_ids": np.tile(np.arange(SEQ), (rows, 1))}
    cfg = {**CFG, "mesh": {"seq": 2}}
    ranks = launch(torch_seq_ranks.duck_typed_steps, 2,
                   args=(cfg, batch, 3), backend="gloo", device="cpu")
    want = torch_seq_ranks.duck_typed_steps(
        0, 1, {k: v for k, v in CFG.items()}, batch, 3)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-5)
        np.testing.assert_allclose(r["grad_norms"], want["grad_norms"],
                                   rtol=1e-5)
        for k, a in want["params"].items():
            np.testing.assert_allclose(r["params"][k], a, rtol=1e-5,
                                       atol=1e-5, err_msg=k)
    assert ranks[0]["losses"][-1] < ranks[0]["losses"][0]


@pytest.mark.parametrize("name,world", [("gpt2-tiny", 2), ("llama-tiny", 4)])
def test_ulysses_shards_take_their_global_positions(name, world):
    """gpt2-tiny (learned positions) with dropout over 2 ranks, llama-tiny
    (rotary positions; 2 KV heads, repeated to the 4 query heads for the
    head scatter) over 4: the shards' NLL sums and embedding gradients add
    up to the unsplit model's."""
    kw = {**ULYSSES, "dropout": 0.1, "dtype": torch.float32}
    model = get_model_config(name, **kw)
    params = tf.init_params(model, seed=2, device="cpu")
    rng = np.random.default_rng(14)
    ids = rng.integers(0, 512, (2, SEQ + 1)).astype(np.int64)
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:].copy()}
    ranks = launch(torch_seq_ranks.model_shard_loss, world,
                   args=(name, kw, params, batch, 77),
                   backend="gloo", device="cpu")
    want = torch_seq_ranks.model_shard_loss(0, 1, name, kw, params,
                                            batch, 77)
    assert sum(r[1] for r in ranks) == want[1]
    assert sum(r[0] for r in ranks) == pytest.approx(want[0], rel=1e-5)
    # four shards sum an embedding row's gradient in another order: 5e-6
    # on elements of order one seen
    np.testing.assert_allclose(sum(r[2] for r in ranks), want[2], rtol=1e-4,
                               atol=1e-5)


def test_seq_all_to_all_is_the_tiled_exchange_and_its_inverse():
    shape = (2, 4, 6, 3)
    dims = [(2, 1), (1, 2), (0, 0)]
    ranks = launch(torch_seq_ranks.all_to_all_cases, 2,
                   args=(shape, dims), backend="gloo", device="cpu")
    base = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    xs = [base + 1000.0 * r for r in range(2)]
    for i, (scatter, gather) in enumerate(dims):
        for r in range(2):
            # rank r gets block r of every rank's scatter dim, in rank order
            blocks = [np.split(x, 2, axis=scatter)[r] for x in xs]
            want = np.concatenate(blocks, axis=gather)
            y, grad = ranks[r][i]
            np.testing.assert_array_equal(y, want)
            # d sum(y*y)/dx = the inverse exchange of 2y: 2x
            np.testing.assert_array_equal(grad, 2 * xs[r])


def test_ulysses_needs_heads_divisible_by_the_seq_axis():
    from deepspeed_tpu_torch.sequence import DistributedAttention

    class Topo:
        sp_size, seq_group = 3, None

    q = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="query heads"):
        DistributedAttention(lambda *a: a[0], Topo())(q, q, q)
    eng, *_ = dst.initialize(model=get_model_config("llama-tiny", **ULYSSES),
                             config={"train_micro_batch_size_per_gpu": 2},
                             device="cpu")
    assert eng.model_config.seq_impl == "ulysses"
