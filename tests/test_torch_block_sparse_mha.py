"""The port's block-sparse attention (``deepspeed_tpu_torch/ops/
sparse_attention.py`` and ``ops/block_sparse_mha.py``: the sparsity
configs, the live-tile lists, and the plain versions of ``bsa_fwd``,
``bsa_bwd_dq`` and ``bsa_bwd_dkv`` behind the autograd function) against
the JAX package on the CPU: the configs' numpy layouts, ``_tile_live``,
and the Pallas ``block_sparse_mha`` run through the Pallas interpreter,
forward, log-sum-exp and ``jax.vjp`` gradients, at head dims 32 to 256.
Besides: the wgmma walks' tile lists, layout words and full flags against
the brute-force token mask (exactly), the backward pair's route rule, and
the zero-padded head-dim path against the unpadded plain versions (fp32,
1e-6).

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
    assert int(tbsm.tile_live(layout, 16, True, tq=128)[0].sum()) == 21


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
    live = tbsm.tile_live(layout, block, causal, tq=tile)
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
    # head dims off the kernels' 64/128 lanes (the registry's phi-2,
    # gptneox-20b, gptj-6b and *-tiny)
    (1, 2, 2, 128, 32, "BSLongformerSparsityConfig",
     dict(block=32, attention="unidirectional"), True),
    (1, 2, 1, 256, 80, "BSLongformerSparsityConfig",
     dict(block=16, attention="unidirectional"), True),
    (1, 2, 2, 128, 96, "FixedSparsityConfig",
     dict(block=32, num_local_blocks=2, num_global_blocks=1), False),
    (1, 2, 1, 128, 256, "BigBirdSparsityConfig",
     dict(block=64, num_random_blocks=1, num_sliding_window_blocks=1,
          different_layout_per_head=True, seed=2), True),
]
IDS = ["bslongformer-causal", "fixed-gqa-bidir-b64", "bigbird-gqa-b128",
       "tail-s80-bidir", "variable-per-head", "d32-b32", "d80-gqa",
       "d96-bidir", "d256-gqa-per-head"]


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


# ----------------------------------------------------------------------
# the wgmma walks' host structures, the route rule, the padded head dim
# ----------------------------------------------------------------------
def _token_mask(layout, block, causal):
    m = tsa.layout_to_token_mask(layout, block).numpy()
    return m & np.tril(np.ones(m.shape[1:], bool))[None] if causal else m


def _tiles_any(mask, tq, tk):
    h, s, _ = mask.shape
    nq, nk = -(-s // tq), -(-s // tk)
    pad = np.zeros((h, nq * tq, nk * tk), bool)
    pad[:, :s, :s] = mask
    return pad.reshape(h, nq, tq, nk, tk).any((2, 4))


def _walk_masks(plan, walk, rows_fixed, tile=tbsm.TILE):
    """Yield (h, fixed rows or keys, walked cols or rows, the mask the
    kernel applies there) for every entry of a wgmma list over walked tiles
    of ``tile`` rows, from its layout words (tile / 64 a slot) and the
    causal test, as BlockLayoutT::Tile::ok computes it."""
    ptr, idx, words = (x.numpy() for x in walk)
    words = words.view(np.uint64).reshape(len(words), tbsm.WG_SLOTS, tile // 64)
    s, item = plan.seq, tbsm.WG_ITEM
    n_items = -(-s // item)
    for e_h in range(plan.heads):
        for i in range(n_items):
            fixed = i * item + np.arange(item)
            fixed = fixed[fixed < s]
            slot = fixed // plan.block - i * item // plan.block
            for t in range(ptr[e_h * n_items + i], ptr[e_h * n_items + i + 1]):
                walked = idx[t] * tile + np.arange(tile)
                off = walked - idx[t] * tile
                shift = (off % 64).astype(np.uint64)
                bits = (words[t][slot][:, off // 64] >> shift[None, :]) & np.uint64(1)
                ok = bits.astype(bool) & (walked < s)[None, :]
                rows, cols = (fixed[:, None], walked[None, :]) if rows_fixed \
                    else (walked[None, :], fixed[:, None])
                if plan.causal:
                    ok &= cols <= rows
                yield e_h, fixed, walked[walked < s], ok[:, walked < s]


@pytest.mark.parametrize("block", [16, 32, 40, 64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("kind", ["random", "tril"])
def test_wgmma_tile_lists_words_and_flags_match_the_token_mask(block, causal,
                                                                kind):
    """tile_live at the wgmma walks' (128, 128), (128, 64) and (64, 128)
    tiles (forward, dq, dk/dv) keeps every tile in which the token mask
    keeps a pair (exactly those for a lower-triangular layout or without
    causal); SparseLayout's lists hold those tiles, each entry's layout
    words with the causal test give the token mask on the whole tile, the
    64 x 64 full flags are set where the tile keeps every pair, and the
    forward's answer for a 64-row x 128-key part (the two flags it covers)
    is true exactly where that part keeps every pair."""
    s, h = 640, 3
    rng = np.random.default_rng(block + 7 * causal)
    layout = (rng.random((h, s // block, s // block)) < 0.3).astype(np.int64)
    if kind == "tril":
        layout = np.tril(layout)
    mask = _token_mask(layout, block, causal)
    plan = tbsm.SparseLayout(layout, block, causal, "cpu")
    assert plan.wgmma
    # the kernels index every array flat, in C order
    assert all(x.is_contiguous() for x in (*plan.fwd_walk, *plan.dq_walk,
                                           *plan.dkv_walk, plan.full,
                                           plan.layout))
    full = plan.full.numpy().astype(bool)
    n = -(-s // 64)
    for (tq, tk), walk, rows_fixed in (((128, 128), plan.fwd_walk, True),
                                       ((128, 64), plan.dq_walk, True),
                                       ((64, 128), plan.dkv_walk, False)):
        live = tbsm.tile_live(layout, block, causal, tq, tk)
        brute = _tiles_any(mask, tq, tk)
        assert live.shape == brute.shape and not np.any(brute & ~live)
        if kind == "tril" or not causal:
            assert np.array_equal(live, brute)
        listed = np.zeros_like(live)
        for e_h, fixed, walked, ok in _walk_masks(plan, walk, rows_fixed,
                                                  tk if rows_fixed else tq):
            want = (mask[e_h][np.ix_(fixed, walked)] if rows_fixed
                    else mask[e_h][np.ix_(walked, fixed)].T)
            assert np.array_equal(ok, want)
            tiles = (fixed[0] // tq, walked[0] // tk) if rows_fixed \
                else (walked[0] // tq, fixed[0] // tk)
            listed[(e_h, *tiles)] = True
            if tk == 128 and rows_fixed:   # the forward's full answer
                k64 = walked[0] // 64
                for r0 in range(fixed[0], fixed[-1] + 1, 64):
                    rows = np.arange(r0, r0 + 64)
                    cols = np.arange(walked[0], walked[0] + 128)
                    every = (rows[-1] < s and cols[-1] < s
                             and mask[e_h][np.ix_(rows, cols)].all())
                    flags = (k64 + 1 < n and full[e_h, r0 // 64, k64]
                             and full[e_h, r0 // 64, k64 + 1])
                    assert bool(flags) == bool(every)
        assert np.array_equal(listed, live)
    want = np.zeros((h, n, n), bool)
    for a in range(n):
        for b in range(n):
            r, c = slice(a * 64, (a + 1) * 64), slice(b * 64, (b + 1) * 64)
            inside = (a + 1) * 64 <= s and (b + 1) * 64 <= s
            want[:, a, b] = inside & mask[:, r, c].all((1, 2))
    assert np.array_equal(full, want)


def test_gpt2_path_wgmma_walks():
    """The training path's layout (gpt2-350m, S 1024, block 16): the
    forward visits 21 live 128 x 128 tiles a head (at most 3 an item,
    against 45 live 64 x 64 tiles), the dq walk 30 live 128 x 64 tiles a
    head (at most 4 an item), the dk/dv walk 36 live 64 x 128 ones (16 for
    the item holding global key block 0), and no 64 x 64 tile is full."""
    layout = tsa.BSLongformerSparsityConfig(**LAYOUTS[3][1]).make_layout(1024)
    plan = tbsm.SparseLayout(layout, 16, True, "cpu")
    fwd_ptr = plan.fwd_walk[0].numpy()
    dq_ptr, dkv_ptr = plan.dq_walk[0].numpy(), plan.dkv_walk[0].numpy()
    assert fwd_ptr[8] == 21 and np.diff(fwd_ptr[:9]).max() == 3
    assert int(plan.live[0].sum()) == 45
    assert dq_ptr[8] == 30 and np.diff(dq_ptr[:9]).max() == 4
    assert dkv_ptr[8] == 36 and np.diff(dkv_ptr[:9])[0] == 16
    assert not plan.full.any()
    assert plan.fwd_walk[2].shape == (16 * 21, 2 * tbsm.WG_SLOTS)
    assert plan.dq_walk[2].shape == (16 * 30, tbsm.WG_SLOTS)


def _bf16_views(d=64, block=16):
    b, h, s = 1, 2, 128
    layout = np.tril(np.ones((h, s // block, s // block), np.int64))
    plan = tbsm.SparseLayout(layout, block, True, "cpu")
    q, k, v = (torch.zeros((b, h, s, d), dtype=torch.bfloat16)
               for _ in range(3))
    return q, k, v, plan


def test_bsa_backward_route_rule():
    """The backward pair's route, before the launch: fp32 takes fma; bf16
    views TMA reads take wgmma; an expanded do (autograd's gradient of
    out.sum()) takes mma as it comes and wgmma once readable_do has made it
    contiguous, as the autograd function does; D 256 and layout blocks
    under 16 take mma; every kernel counts its launches by route."""
    q, k, v, plan = _bf16_views()
    do = torch.ones((), dtype=torch.bfloat16).expand(q.shape)
    assert tbsm.bwd_route(q, k, v, do, plan) == "mma"
    assert tbsm.bwd_route(q, k, v, tbsm.fm.readable_do(do), plan) == "wgmma"
    assert tbsm.bwd_route(q.float(), k.float(), v.float(),
                          tbsm.fm.readable_do(do.float()), plan) == "fma"
    q8, k8, v8, plan8 = _bf16_views(block=8)
    assert not plan8.wgmma and plan8.dq_walk is None
    assert tbsm.bwd_route(q8, k8, v8, q8, plan8) == "mma"
    q2, k2, v2, plan2 = _bf16_views(d=256)
    assert tbsm.bwd_route(q2, k2, v2, q2, plan2) == "mma"
    assert set(tbsm.block_sparse_mha.routes) == {
        f"{n}.{r}" for n in ("bsa_fwd", "bsa_bwd_dq", "bsa_bwd_dkv")
        for r in ("fma", "mma", "wgmma")}


@pytest.mark.parametrize("case", ["bf16", "d128", "fp32", "block8", "d256",
                                  "expanded-kv"])
def test_bsa_forward_route_rule(case):
    """bsa_fwd's route, before the launch: bf16 views TMA reads at D 64
    or 128 under layout blocks of at least 16 take wgmma (the persistent
    forward on 128 x 128 tiles); fp32 takes fma; blocks under 16, D 256
    and an expanded K/V (stride 0) take the 64 x 64 walk's mma."""
    want = {"bf16": "wgmma", "d128": "wgmma", "fp32": "fma"}.get(case, "mma")
    q, k, v, plan = _bf16_views(block=8 if case == "block8" else 16,
                                d={"d256": 256, "d128": 128}.get(case, 64))
    if case == "fp32":
        q, k, v = q.float(), k.float(), v.float()
    elif case == "expanded-kv":
        k = k[:, :1].expand(k.shape)
        v = v[:, :1].expand(v.shape)
    assert tbsm.fwd_route(q, k, v, plan) == want
    assert plan.wgmma == (case != "block8")
    assert (plan.fwd_walk is None) == (case == "block8")


@pytest.mark.parametrize("d", [16, 32, 80, 96, 200])
def test_padded_head_dim_equals_the_unpadded_plain_versions(d):
    """block_sparse_mha through head_dim_padded (the path a CUDA call
    takes: D zero-padded to its lane, sm_scale from the real D, the output
    sliced back) equals the unpadded plain versions in fp32, forward and
    gradients, within 1e-6; the padded columns' gradients are dropped."""
    b, hq, hkv, s = 1, 2, 1, 128
    layout = tsa.BSLongformerSparsityConfig(
        num_heads=hq, block=16, attention="unidirectional").make_layout(s)
    q, k, v, do = (torch.from_numpy(x) for x in _inputs((b, hq, hkv, s, d), 11))

    def run(padded):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]

        def attn(q_, k_, v_):
            return tbsm.block_sparse_mha(q_, k_, v_, layout, 16, causal=True,
                                         sm_scale=d ** -0.5)

        out = tbsm.fm.head_dim_padded(attn, *xs) if padded else attn(*xs)
        out.backward(do)
        return [out.detach()] + [x.grad for x in xs]

    for what, got, want in zip(("o", "dq", "dk", "dv"), run(True), run(False)):
        assert got.shape == want.shape
        err = (got - want).abs()
        assert bool((err <= 1e-6 * (1 + want.abs())).all()), (what, float(err.max()))
