"""The port's block-sparse attention (``deepspeed_tpu_torch/ops/
sparse_attention.py`` and ``ops/block_sparse_mha.py``: the sparsity
configs, the live-tile lists, and the plain versions of ``bsa_fwd``,
``bsa_bwd_dq`` and ``bsa_bwd_dkv`` behind the autograd function) against
the JAX package on the CPU: the configs' numpy layouts, ``_tile_live``,
and the Pallas ``block_sparse_mha`` run through the Pallas interpreter,
forward, log-sum-exp and ``jax.vjp`` gradients.

Tolerances, |port - jax| <= tol * (1 + |jax|), fp32: 2e-5 (summation
order: the port walks 64-key tiles, the JAX kernel 128-key ones).  Layouts
and tile lists are compared exactly.  For a query row that sees no key the
port follows the Pallas kernel (zeros, lse -1e30); the JAX dense lowering
(``impl="xla"``) gives a uniform row there, so it is compared only on
layouts without such rows.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu_torch.ops import block_sparse_mha as tbsm
from deepspeed_tpu_torch.ops import sparse_attention as tsa

from test_torch_engine_v2 import one_torch_thread  # noqa: F401

jbsm = importlib.import_module("deepspeed_tpu.ops.pallas.block_sparse_mha")
jfm = importlib.import_module("deepspeed_tpu.ops.pallas.flash_mha")

TOL = 2e-5


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jfm, "INTERPRET", True)


# (config class name, kwargs, seq): every mode, both attention kinds,
# BigBird and Variable with per-head layouts
LAYOUTS = [
    ("DenseSparsityConfig", dict(num_heads=2, block=16), 64),
    ("FixedSparsityConfig", dict(num_heads=2, block=16, num_local_blocks=4,
                                 num_global_blocks=1), 256),
    ("FixedSparsityConfig", dict(num_heads=2, block=16, num_local_blocks=4,
                                 num_global_blocks=2,
                                 attention="unidirectional",
                                 horizontal_global_attention=True), 256),
    ("BSLongformerSparsityConfig", dict(num_heads=16, block=16,
                                        num_sliding_window_blocks=3,
                                        global_block_indices=[0],
                                        attention="unidirectional"), 1024),
    ("BigBirdSparsityConfig", dict(num_heads=4, block=32, num_random_blocks=2,
                                   different_layout_per_head=True,
                                   seed=7), 512),
    ("BigBirdSparsityConfig", dict(num_heads=2, block=16,
                                   attention="unidirectional"), 128),
    ("VariableSparsityConfig", dict(num_heads=3, block=16,
                                    local_window_blocks=[2, 4],
                                    global_block_indices=[0, 3]), 256),
]
LAYOUT_IDS = ["dense", "fixed", "fixed-uni-horizontal", "bslongformer-gpt2",
              "bigbird-per-head-seed", "bigbird-uni", "variable"]


@pytest.mark.parametrize("name,kw,seq", LAYOUTS, ids=LAYOUT_IDS)
def test_make_layout_bit_equal_to_jax(name, kw, seq):
    ref = getattr(jsa, name)(**kw).make_layout(seq)
    got = getattr(tsa, name)(**kw).make_layout(seq)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    if seq <= 256:   # and the token masks the layouts expand to
        assert np.array_equal(
            tsa.layout_to_token_mask(got, kw["block"]).numpy(),
            np.asarray(jsa.layout_to_token_mask(ref, kw["block"])))


def test_gpt2_path_layout_skips_tiles():
    """The training path's layout (gpt2-350m, S 1024): 45 of the 136
    causal 64x64 tiles are live, 21 of 36 at the JAX kernel's 128."""
    layout = tsa.BSLongformerSparsityConfig(**LAYOUTS[3][1]).make_layout(1024)
    assert int(tbsm.tile_live(layout, 16, True)[0].sum()) == 45
    assert int(tbsm.tile_live(layout, 16, True, tile=128)[0].sum()) == 21


@pytest.mark.parametrize("block,tile", [(16, 64), (32, 64), (64, 64),
                                        (16, 128), (128, 128)])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_tile_lists_match_jax_tile_live(block, tile, causal):
    """tile_live equals the JAX ``_tile_live`` (the kernel's pl.when) on a
    per-head BigBird layout; the device lists of SparseLayout hold exactly
    those tiles, and their union over a GQA group is the JAX dkv walk's
    ``live_any``."""
    s, h = 512, 4
    layout = jsa.BigBirdSparsityConfig(
        num_heads=h, block=block, num_random_blocks=1,
        num_sliding_window_blocks=1, different_layout_per_head=True,
        seed=3).make_layout(s)
    ref = jbsm._tile_live(layout, tile, tile, block, causal)
    live = tbsm.tile_live(layout, block, causal, tile=tile)
    assert live.shape == ref.shape and np.array_equal(live, ref)

    plan = tbsm.SparseLayout(layout, block, causal, "cpu")
    n = -(-s // tbsm.TILE)
    fwd = np.zeros((h, n, n), bool)
    bwd = np.zeros((h, n, n), bool)
    kp, ki = plan.k_ptr.numpy(), plan.k_idx.numpy()
    qp, qi = plan.q_ptr.numpy(), plan.q_idx.numpy()
    for hh in range(h):
        for t in range(n):
            fwd[hh, t, ki[kp[hh * n + t]:kp[hh * n + t + 1]]] = True
            bwd[hh, qi[qp[hh * n + t]:qp[hh * n + t + 1]], t] = True
    ref64 = jbsm._tile_live(layout, tbsm.TILE, tbsm.TILE, block, causal) \
        if block <= tbsm.TILE else tbsm.tile_live(layout, block, causal)
    assert np.array_equal(fwd, ref64) and np.array_equal(bwd, ref64)
    group = 2
    live_any = ref64.reshape(h // group, group, n, n).max(1)
    assert np.array_equal(bwd.reshape(h // group, group, n, n).any(1), live_any)


# b, hq, hkv, s, d, config class, kwargs, causal
CASES = [
    (1, 2, 2, 256, 64, "BSLongformerSparsityConfig",
     dict(block=16, attention="unidirectional"), True),
    (1, 2, 1, 192, 32, "FixedSparsityConfig",
     dict(block=64, num_local_blocks=2, num_global_blocks=1), False),
    (1, 2, 1, 256, 64, "BigBirdSparsityConfig",
     dict(block=128, num_random_blocks=1, num_sliding_window_blocks=1,
          different_layout_per_head=True, seed=1), True),
    (2, 2, 1, 80, 32, "BSLongformerSparsityConfig", dict(block=16), False),
    (1, 2, 2, 128, 32, "VariableSparsityConfig",
     dict(block=16, local_window_blocks=[1, 3]), True),
]
IDS = ["bslongformer-causal", "fixed-gqa-bidir-b64", "bigbird-gqa-b128",
       "tail-s80-bidir", "variable-per-head"]


def _inputs(case, seed=0):
    b, hq, hkv, s, d = case[:5]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d),
                          (b, hq, s, d))]


def _close(port, ref, what):
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    err = np.abs(port - ref)
    assert port.shape == ref.shape and np.all(err <= TOL * (1 + np.abs(ref))), \
        (what, float(err.max()))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_block_sparse_mha_matches_jax_pallas(case):
    b, hq, hkv, s, d, name, kw, causal = case
    layout = getattr(tsa, name)(num_heads=hq, **kw).make_layout(s)
    block = kw["block"]
    q, k, v, do = _inputs(case)
    scale = d ** -0.5
    jo, vjp = jax.vjp(lambda q_, k_, v_: jbsm.block_sparse_mha(
        q_, k_, v_, layout, block, causal=causal), *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    _, jlse = jbsm._fwd_impl(*map(jnp.asarray, (q, k, v)), layout, block,
                             causal, scale)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    to = tbsm.block_sparse_mha(tq, tk, tv, layout, block, causal=causal)
    to.backward(torch.from_numpy(do))
    plan = tbsm.SparseLayout(layout, block, causal, "cpu")
    _, tlse = tbsm.bsa_fwd(tq.detach(), tk.detach(), tv.detach(), plan, scale)
    _close(to, jo, "o")
    _close(tlse, jlse, "lse")
    for what, t, j in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                          jgrads):
        _close(t, j, what)


def test_sparse_attention_matches_jax_dense_lowering():
    """[B, S, H, D] entry point against the JAX function's dense-masked
    lowering (GQA, causal, a layout in which every row sees a key)."""
    b, hq, hkv, s, d = 2, 2, 1, 128, 32
    rng = np.random.default_rng(4)
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    kv = [rng.standard_normal((b, s, hkv, d)).astype(np.float32)
          for _ in range(2)]
    kw = dict(num_heads=hq, block=16, num_sliding_window_blocks=3,
              global_block_indices=[0], attention="unidirectional")
    ref = jsa.sparse_attention(jnp.asarray(q), *map(jnp.asarray, kv),
                               jsa.BSLongformerSparsityConfig(**kw),
                               causal=True, impl="xla")
    got = tsa.sparse_attention(torch.from_numpy(q),
                               *map(torch.from_numpy, kv),
                               tsa.BSLongformerSparsityConfig(**kw),
                               causal=True)
    _close(got, ref, "o")
    with pytest.raises(ValueError, match="xla"):
        tsa.sparse_attention(torch.from_numpy(q), *map(torch.from_numpy, kv),
                             tsa.BSLongformerSparsityConfig(**kw), impl="xla")


def test_row_without_keys_gives_zeros_like_the_pallas_kernel():
    """A layout whose query block 1 sees nothing: the port, like the
    Pallas kernel, returns zeros and lse -1e30 there and zero gradients
    through it; the JAX dense lowering returns the uniform average of v
    instead (its finite mask minimum)."""
    b, h, s, d, block = 1, 2, 128, 32, 32
    layout = np.tril(np.ones((h, s // block, s // block), np.int64))
    layout[:, 1, :] = 0
    q, k, v, do = _inputs((b, h, h, s, d), seed=5)
    jo, vjp = jax.vjp(lambda q_, k_, v_: jbsm.block_sparse_mha(
        q_, k_, v_, layout, block, causal=True), *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    to = tbsm.block_sparse_mha(tq, tk, tv, layout, block, causal=True)
    to.backward(torch.from_numpy(do))
    empty = slice(block, 2 * block)
    assert torch.all(to[:, :, empty] == 0) and torch.all(tq.grad[:, :, empty] == 0)
    _, lse = tbsm.bsa_fwd(tq.detach(), tk.detach(), tv.detach(),
                          tbsm.SparseLayout(layout, block, True, "cpu"), d ** -0.5)
    assert torch.all(lse[:, :, empty] == -1e30)
    _close(to, jo, "o")
    for what, t, j in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                          jgrads):
        _close(t, j, what)

    class _Given(jsa.SparsityConfig):
        def make_layout(self, seq_len):
            return layout

    dense = jsa.sparse_attention(*(jnp.asarray(x.transpose(0, 2, 1, 3))
                                   for x in (q, k, v)),
                                 _Given(num_heads=h, block=block),
                                 causal=True, impl="xla")
    assert np.abs(np.asarray(dense)[:, empty]).max() > 1e-2


def test_layout_is_prepared_once_and_checked():
    """sparse_attention reuses one SparseLayout per (config, S, causal,
    device); a layout that does not fit q raises."""
    kw = dict(num_heads=2, block=16, attention="unidirectional")
    a = tsa.sparse_layout(tsa.BSLongformerSparsityConfig(**kw), 64, True, "cpu")
    b = tsa.sparse_layout(tsa.BSLongformerSparsityConfig(**kw), 64, True, "cpu")
    assert a is b
    assert tsa.sparse_layout(tsa.BSLongformerSparsityConfig(**kw), 128, True,
                             "cpu") is not a
    q = torch.zeros(1, 2, 64, 32)
    with pytest.raises(ValueError, match="heads"):
        tbsm.block_sparse_mha(torch.zeros(1, 4, 64, 32), q, q, a, 16, True)
    with pytest.raises(ValueError, match="S is"):
        tbsm.block_sparse_mha(torch.zeros(1, 2, 80, 32), q, q, a, 16, True)
    with pytest.raises(ValueError, match="built for"):
        tbsm.block_sparse_mha(q, q, q, a, 16, causal=False)


def test_cpu_path_counts_no_launch():
    before = dict(tbsm.block_sparse_mha.launches)
    case = CASES[0]
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(case))
    layout = tsa.BSLongformerSparsityConfig(num_heads=2, **case[6]).make_layout(256)
    tbsm.block_sparse_mha(q.requires_grad_(True), k, v, layout, 16,
                          causal=True).sum().backward()
    assert tbsm.block_sparse_mha.launches == before
