"""The port's paged attention (deepspeed_tpu_torch/ops/paged_attention.py)
against the JAX package's Pallas kernel run through the Pallas
interpreter, as tests/test_pallas_paged.py runs it.

The same numpy inputs go to both.  On the CPU the port's wrapper runs its
plain version (``paged_decode_attention_ref``); the CUDA kernel is held
against that plain version on the card by chip_smoke.py and by the
``cuda``-marked tests in test_torch_paged_attention_cuda.py, which share
these cases.

Tolerances: fp32 pages 1e-5 (the two differ only in summation order);
bf16 pages and bf16 output 1e-2 abs + 1e-2 rel (about two bf16 ulps: the
two round p to bf16 before p·v and the output at the same points, but an
fp32 value on a rounding boundary may round either way); int8 pages with
fp32 queries 1e-5, with bf16 queries as bf16.
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.v2.model import _kernel_attn_default
from deepspeed_tpu_torch.ops import paged_attention as tpa
from test_torch_engine_v2 import one_torch_thread  # noqa: F401
from test_torch_paged_attention_cuda import (CASES, IDS, SPLIT_CASES, SPLIT_IDS,
                                          _case, _quantize, _split_case)

pm = importlib.import_module("deepspeed_tpu.ops.pallas.paged_attention")


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = pm.INTERPRET
    pm.INTERPRET = True
    yield
    pm.INTERPRET = old


def _jax_kernel(*args, **kw):
    # bypass the jit wrapper so the INTERPRET toggle is honoured
    return pm.paged_decode_attention.__wrapped__(*args, **kw)


def _run_both(case, page_kind, q_dtype):
    t, nh, nkv, d, n_pages, nb, bs, window, poison, midseq = case
    q, kp, vp, tbl, pos, clen = _case(7, t, nh, nkv, d, n_pages, nb, bs,
                                      poison, midseq)
    scale = 1.0 / np.sqrt(d)
    jq = jnp.asarray(q, q_dtype)
    tq = torch.from_numpy(q).to(torch.bfloat16 if q_dtype == jnp.bfloat16
                                else torch.float32)
    common_t = (torch.from_numpy(tbl), torch.from_numpy(pos),
                torch.from_numpy(clen), bs, scale, window)
    if page_kind == "int8":
        kq, ks = _quantize(kp)
        vq, vs = _quantize(vp)
        ref = _jax_kernel(jq, jnp.asarray(kq), jnp.asarray(vq), tbl, pos, clen,
                          block_size=bs, sm_scale=scale, window=window,
                          k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
        got = tpa.paged_decode_attention(
            tq, torch.from_numpy(kq), torch.from_numpy(vq), *common_t,
            k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs))
    else:
        jdt = jnp.bfloat16 if page_kind == "bf16" else jnp.float32
        tdt = torch.bfloat16 if page_kind == "bf16" else torch.float32
        ref = _jax_kernel(jq, jnp.asarray(kp, jdt), jnp.asarray(vp, jdt), tbl,
                          pos, clen, block_size=bs, sm_scale=scale,
                          window=window)
        got = tpa.paged_decode_attention(
            tq, torch.from_numpy(kp).to(tdt), torch.from_numpy(vp).to(tdt),
            *common_t)
    assert got.dtype == tq.dtype
    return got.float().numpy(), np.asarray(ref.astype(jnp.float32))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_paged_ref_matches_pallas_fp32(case):
    got, ref = _run_both(case, "fp32", jnp.float32)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("case", [CASES[1], CASES[3], CASES[4], CASES[6]],
                         ids=["gqa-d64-bs8", "mha-d128-bs8", "window",
                              "midseq"])
def test_paged_ref_matches_pallas_int8(case):
    got, ref = _run_both(case, "int8", jnp.float32)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", [CASES[2], CASES[4], CASES[5]],
                         ids=["gqa-d128-bs16", "window", "garbage"])
@pytest.mark.parametrize("page_kind", ["bf16", "int8"])
def test_paged_ref_matches_pallas_bf16(case, page_kind):
    got, ref = _run_both(case, page_kind, jnp.bfloat16)
    np.testing.assert_allclose(got, ref, atol=1e-2, rtol=1e-2)


def test_registry_picks_kernel_only_for_cuda_tables():
    """'auto' mirrors the JAX package's choice with 'on TPU' read as 'the
    tensor is on CUDA': block tables, a servable geometry, no ALiBi."""
    ok = dict(block_size=16, head_dim=128, on_cuda=True, has_tables=True,
              use_alibi=False)
    assert _kernel_attn_default(**ok)
    assert not _kernel_attn_default(**{**ok, "on_cuda": False})
    assert not _kernel_attn_default(**{**ok, "has_tables": False})
    assert not _kernel_attn_default(**{**ok, "use_alibi": True})
    assert not _kernel_attn_default(**{**ok, "block_size": 4})


def test_wrapper_rejects_devices_without_a_kernel():
    q = torch.empty((2, 4, 64), device="meta")
    kp = torch.empty((2, 64, 64), device="meta")
    idx = torch.zeros((2, 1), dtype=torch.int32, device="meta")
    pos = torch.zeros((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tpa.paged_decode_attention(q, kp, kp, idx, pos, pos, 16, 0.125)


def test_builder_raises_without_nvcc(monkeypatch):
    """The kernel is built from the checkout's source at first use; with
    no CUDA toolkit the build raises (nothing falls back)."""
    from deepspeed_tpu_torch.ops import op_builder

    monkeypatch.setattr(op_builder.shutil, "which", lambda _: None)
    monkeypatch.setattr(op_builder.os.path, "exists", lambda _: False)
    monkeypatch.setattr(op_builder, "BUILD_DIR",
                        op_builder.BUILD_DIR.parent / "no_such_dir")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        op_builder.build_all()
    path = op_builder.library_path("paged_attention")
    assert path.suffix == ".so" and not path.parent.exists()


# ----------------------------------------------------------------------
# the kernel's split context: the split plan, the lane plan, and the
# split-then-merge computation against the Pallas kernel
# ----------------------------------------------------------------------
@pytest.mark.parametrize("t,nkv,nb,sms,kernel,want", [
    (32, 8, 128, 132, "paged_attention.fma", 9),   # decode T=32: 2304 blocks
    (32, 8, 128, 132, "paged_attention.mma", 1),   # 256 pairs cover the SMs
    (32, 8, 128, 132, "paged_attention_int8.mma", 3),
    (8, 8, 128, 132, "paged_attention.fma", 32),   # long context, nb/4 cap
    (8, 8, 128, 132, "paged_attention.mma", 3),    # 64 pairs: 192 blocks
    (8, 8, 128, 132, "paged_attention_int8.mma", 9),
    (256, 8, 128, 132, "paged_attention_int8.fma", 2),  # a prefill chunk
    (256, 8, 128, 132, "paged_attention.mma", 1),
    (1, 8, 128, 132, "paged_attention.mma", 17),   # one token
    (1, 1, 1024, 132, "paged_attention.fma", 64),  # capped at MAX_SPLITS
    (4, 2, 2, 132, "paged_attention.fma", 1),      # a table of 2 pages
])
def test_split_plan(t, nkv, nb, sms, kernel, want):
    """split_plan aims at SPLIT_BLOCKS_PER_SM[kernel] blocks an SM, never
    splits a table finer than SPLIT_MIN_PAGES pages a split nor past
    MAX_SPLITS; every routes key has an aim."""
    assert tpa.split_plan(t, nkv, nb, sms, kernel) == want
    assert set(tpa.SPLIT_BLOCKS_PER_SM) == set(
        tpa.paged_decode_attention.routes)


def test_merge_partials_arithmetic():
    """The merge of split states: a fully masked split (m = -1e30) weighs
    nothing beside a live one and does not turn into NaN; splits that are
    all masked average together, as the sequential walk over their pages
    does; an empty split (l = 0, acc = 0) changes nothing; the result is
    the single walk's over the union."""
    neg = tpa.NEG_INF
    acc_live, acc_dead = torch.tensor([[2.0, 4.0]]), torch.tensor([[16.0, 32.0]])
    m = torch.tensor([[[1.5]], [[neg]], [[neg]]])
    l = torch.tensor([[[2.0]], [[16.0]], [[0.0]]])
    acc = torch.stack([acc_live, acc_dead, torch.zeros(1, 2)])
    out = tpa.merge_partials(m, l, acc)
    assert torch.equal(out, acc_live / 2.0)
    masked = tpa.merge_partials(m[1:2].expand(2, 1, 1), torch.tensor(
        [[[16.0]], [[8.0]]]), torch.stack([acc_dead, acc_dead / 4]))
    assert torch.allclose(masked, (acc_dead + acc_dead / 4) / 24.0)
    empty = tpa.merge_partials(m[2:], l[2:], acc[2:])
    assert torch.equal(empty, torch.zeros(1, 2))
    # two live splits: the merge equals one softmax over both
    s = torch.tensor([0.3, -1.2, 2.0, 0.7])
    v = torch.arange(8.0).reshape(4, 2)
    halves = (slice(0, 2), slice(2, 4))
    p = [torch.exp(s[h] - s[h].max()) for h in halves]
    m2 = torch.stack([s[h].max() for h in halves]).reshape(2, 1, 1)
    l2 = torch.stack([x.sum() for x in p]).reshape(2, 1, 1)
    a2 = torch.stack([x @ v[h] for x, h in zip(p, halves)]).reshape(2, 1, 2)
    want = torch.softmax(s, 0) @ v
    assert torch.allclose(tpa.merge_partials(m2, l2, a2)[0], want, atol=1e-6)


def _split_inputs(case, page_kind):
    """One split case's inputs for the port (torch) and the Pallas kernel
    (numpy), and its ``scale``, ``window`` and ``block_size``."""
    t, nh, nkv, d, n_pages, nb, bs, window = case
    q, kp, vp, tbl, pos, clen = _split_case(11, t, nh, nkv, d, n_pages, nb, bs)
    tq = torch.from_numpy(q).to(torch.bfloat16 if page_kind == "bf16"
                                else torch.float32)
    tables = [torch.from_numpy(a) for a in (tbl, pos, clen)]
    if page_kind == "int8":
        kq, ks = _quantize(kp)
        vq, vs = _quantize(vp)
        pages = (kq, vq)
        kw = {"k_scales": ks, "v_scales": vs}
    else:
        pages, kw = (kp, vp), {}
    tdt = {"bf16": torch.bfloat16, "fp32": torch.float32}.get(page_kind)
    tpages = [torch.from_numpy(a) if tdt is None else
              torch.from_numpy(a).to(tdt) for a in pages]
    tkw = {k: torch.from_numpy(a) for k, a in kw.items()}
    return ((q, pages, kw, (tbl, pos, clen)), (tq, tpages, tkw, tables),
            1.0 / np.sqrt(d), window, bs)


@functools.lru_cache(maxsize=None)
def _pallas_split_ref(case, page_kind):
    """The Pallas kernel (through the interpreter) on one split case, as
    numpy fp32: one run a (case, page kind), shared by every split count."""
    (q, pages, kw, tables), _, scale, window, bs = _split_inputs(case,
                                                                page_kind)
    q_dtype = jnp.bfloat16 if page_kind == "bf16" else jnp.float32
    p_dtype = {"bf16": jnp.bfloat16, "fp32": jnp.float32}.get(page_kind)
    jp = [jnp.asarray(a) if p_dtype is None else jnp.asarray(a, p_dtype)
          for a in pages]
    ref = _jax_kernel(jnp.asarray(q, q_dtype), *jp, *tables, block_size=bs,
                      sm_scale=scale, window=window,
                      **{k: jnp.asarray(a) for k, a in kw.items()})
    return np.asarray(ref.astype(jnp.float32))


def _run_split(case, page_kind, splits):
    """The plain split-then-merge version and the Pallas kernel on one
    split case, as numpy fp32."""
    _, (tq, pages, kw, tables), scale, window, bs = _split_inputs(
        case, page_kind)
    got = tpa.paged_decode_attention_split_ref(
        tq, *pages, *tables, bs, scale, splits, window, **kw)
    assert got.dtype == tq.dtype
    return got.float().numpy(), _pallas_split_ref(case, page_kind)


@pytest.mark.parametrize("case", SPLIT_CASES, ids=SPLIT_IDS)
@pytest.mark.parametrize("page_kind", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("splits", [2, 3, 64])
def test_split_then_merge_matches_pallas(case, page_kind, splits):
    """The kernel's split-then-merge computation, in plain PyTorch, against
    the Pallas kernel: fp32 pages and int8 pages under fp32 queries within
    1e-5, bf16 within the bf16 tolerance above, with a token of one page,
    a token over the whole table, padding tokens whose every key is masked
    (they average their page) and, in one case, a window; 64 splits leave
    most splits of a token empty."""
    got, ref = _run_split(case, page_kind, splits)
    tol = 1e-2 if page_kind == "bf16" else 1e-5
    np.testing.assert_allclose(got, ref, atol=tol, rtol=tol)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("splits", [1, 2, 3, 5, 7, 64])
def test_split_ranges_partition_each_span(splits, window):
    """split_ranges hands each token's live pages [j_lo, j_hi) to the splits
    in order, ceil(span / splits) pages a split and none twice, as the
    kernel's grid assigns them; later splits of a short span are empty."""
    bs, nb = 8, 9
    pos = torch.tensor([0, 4, 7, 8, 31, 40, 71, 200], dtype=torch.int32)
    ranges = tpa.split_ranges(pos, bs, window, nb, splits)
    assert len(ranges) == splits
    j_lo, j_hi = tpa._span(pos, bs, window, nb)
    span = torch.clamp(j_hi - j_lo, min=0)
    chunk = -(-span // splits)
    for i in range(pos.shape[0]):
        covered = []
        for lo, hi in ranges:
            n = max(int(hi[i]) - int(lo[i]), 0)
            assert n <= int(chunk[i])
            covered += range(int(lo[i]), int(lo[i]) + n)
        assert covered == list(range(int(j_lo[i]), int(j_hi[i])))


@pytest.mark.parametrize("page_kind", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("splits", [1, 2, 5, 64])
def test_split_ref_matches_sequential_ref(page_kind, splits):
    """The plain split-then-merge version against the plain sequential
    walk on the window case's tables (one-page token, padding tokens):
    fp32 and int8 pages under fp32 queries within 1e-5; bf16 within 2^-7
    (1 + |r|), the card's tolerance, since splitting moves the max p is
    rounded against."""
    case = SPLIT_CASES[SPLIT_IDS.index("window")]
    _, (tq, pages, kw, tables), scale, window, bs = _split_inputs(
        case, page_kind)
    got = tpa.paged_decode_attention_split_ref(
        tq, *pages, *tables, bs, scale, splits, window, **kw).float()
    ref = tpa.paged_decode_attention_ref(
        tq, *pages, *tables, bs, scale, window, **kw).float()
    rtol = 2.0 ** -7 if page_kind == "bf16" else 1e-5
    assert bool(((got - ref).abs() <= rtol * (1 + ref.abs())).all())
    if splits == 1:
        assert torch.equal(got, ref)
