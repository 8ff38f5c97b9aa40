"""The port's CUDA paged-attention kernel against its plain PyTorch
version on the card, on the small geometries of
test_torch_paged_attention.py (MHA and GQA, d 64 and 128, block size 8 and
16, a window, a poisoned garbage page, mid-sequence positions) at the
wrapper's split plan, and on tables of several pages at split counts from
1 (no merge) to 64 (more splits than pages), with a one-page context,
padding tokens and a window, against the sequential plain version and the
plain split-then-merge version; every page kind, the fp32-query lanes
included; and the kernel's own plan (``paged_attention_plan``): the
route rule and the CUDA-core walk's lane plan.

No JAX here: the machine with the card has none.  Run there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_paged_attention_cuda.py -m cuda

Without a card every test skips.  Tolerance: |kernel - plain| <= rtol *
(1 + |plain|), with rtol = 2^-7, about two bf16 ulps, wherever a bf16
rounding is involved (the two sum in different orders before rounding p
and the output), and 1e-5 for fp32 queries on fp32 pages.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import paged_attention as tpa


def _quantize(x):
    s = np.maximum(np.abs(x).max(-1), 1e-8) / 127.0
    return np.clip(np.round(x / s[..., None]), -127, 127).astype(np.int8), \
        s.astype(np.float32)


def _case(seed, t, nh, nkv, d, n_pages, nb, bs, poison=False, midseq=False):
    """Ragged contexts over a shared page pool; table entries past a
    token's context point at page 0 (garbage).  ``poison`` fills page 0
    with huge values that the masks must keep out; ``midseq`` puts the
    causal position before the end of the context (chunked prefill)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((t, nh, d)).astype(np.float32)
    kp = rng.standard_normal((nkv, n_pages * bs, d)).astype(np.float32)
    vp = rng.standard_normal((nkv, n_pages * bs, d)).astype(np.float32)
    clen = rng.integers(1, nb * bs + 1, size=t).astype(np.int32)
    pos = clen - 1
    if midseq:
        clen = np.full((t,), nb * bs, np.int32)
        pos = rng.integers(0, nb * bs, size=t).astype(np.int32)
    tbl = (np.arange(t)[:, None] * nb + np.arange(nb)[None, :]) % (n_pages - 1) + 1
    used = clen[:, None] > np.arange(nb)[None, :] * bs
    tbl = np.where(used, tbl, 0).astype(np.int32)
    if poison:
        kp[:, :bs] = 1e3
        vp[:, :bs] = 1e3
    return q, kp, vp, tbl, pos, clen


# t, nh, nkv, d, n_pages, nb, bs, window, poison, midseq
CASES = [
    (4, 4, 4, 64, 8, 2, 16, None, False, False),     # MHA, d=64, bs=16
    (5, 8, 2, 64, 16, 3, 8, None, False, False),     # GQA 4x, bs=8
    (3, 8, 2, 128, 12, 3, 16, None, False, False),   # GQA, d=128
    (2, 4, 4, 128, 8, 2, 8, None, False, False),     # MHA, d=128, bs=8
    (5, 4, 2, 64, 16, 4, 16, 24, False, False),      # sliding window
    (5, 8, 2, 64, 16, 3, 16, None, True, False),     # garbage page 0 poisoned
    (4, 4, 2, 64, 8, 2, 16, None, False, True),      # mid-sequence positions
]
IDS = ["mha-d64-bs16", "gqa-d64-bs8", "gqa-d128-bs16", "mha-d128-bs8",
       "window", "garbage", "midseq"]


def _split_case(seed, t, nh, nkv, d, n_pages, nb, bs):
    """``_case`` shaped for the split kernel: token 0 holds a context of
    one page (5 keys), token 1 the whole table, and the last two are
    padding tokens (position 0, context length 0, every table entry page
    0), whose every key is masked."""
    q, kp, vp, tbl, pos, clen = _case(seed, t, nh, nkv, d, n_pages, nb, bs)
    clen[0], pos[0] = 5, 4
    clen[1], pos[1] = nb * bs, nb * bs - 1
    tbl[1] = np.arange(nb) % (n_pages - 1) + 1
    clen[-2:], pos[-2:], tbl[-2:] = 0, 0, 0
    return q, kp, vp, tbl, pos, clen


# t, nh, nkv, d, n_pages, nb, bs, window: tables of several pages for the
# split kernel's cases
SPLIT_CASES = [
    (6, 8, 2, 128, 24, 7, 16, None),
    (6, 4, 2, 64, 24, 7, 16, 40),
    (5, 4, 4, 64, 24, 9, 8, None),
    (4, 16, 1, 64, 24, 5, 32, None),     # a group of 16, pages of 32 rows
]
SPLIT_IDS = ["gqa-d128-bs16", "window", "mha-d64-bs8", "group16-bs32"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# page kind -> (query dtype, page dtype or "int8", rtol)
PAGE_KINDS = {
    "bf16": (torch.bfloat16, torch.bfloat16, 2.0 ** -7),
    "int8": (torch.bfloat16, "int8", 2.0 ** -7),
    "fp32": (torch.float32, torch.float32, 1e-5),
    "fp32q-bf16": (torch.float32, torch.bfloat16, 2.0 ** -7),
    "fp32q-int8": (torch.float32, "int8", 1e-5),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("page_kind", list(PAGE_KINDS))
def test_cuda_kernel_matches_plain_version(case, page_kind, cuda_device):
    t, nh, nkv, d, n_pages, nb, bs, window, poison, midseq = case
    q, kp, vp, tbl, pos, clen = _case(7, t, nh, nkv, d, n_pages, nb, bs,
                                      poison, midseq)
    q_dtype, page_dtype, rtol = PAGE_KINDS[page_kind]
    dev = cuda_device
    args = [torch.from_numpy(a).to(dev) for a in (tbl, pos, clen)]
    tq = torch.from_numpy(q).to(dev, q_dtype)
    kw = {}
    if page_dtype == "int8":
        kq, ks = _quantize(kp)
        vq, vs = _quantize(vp)
        pages = [torch.from_numpy(a).to(dev) for a in (kq, vq)]
        kw = {"k_scales": torch.from_numpy(ks).to(dev),
              "v_scales": torch.from_numpy(vs).to(dev)}
    else:
        pages = [torch.from_numpy(a).to(dev, page_dtype) for a in (kp, vp)]
    before = dict(tpa.paged_decode_attention.launches)
    got = tpa.paged_decode_attention(tq, *pages, *args, bs, 1 / np.sqrt(d),
                                     window, **kw)
    torch.cuda.synchronize()
    ref = tpa.paged_decode_attention_ref(tq, *pages, *args, bs,
                                         1 / np.sqrt(d), window, **kw)
    name = "paged_attention_int8" if kw else "paged_attention"
    assert tpa.paged_decode_attention.launches[name] == before[name] + 1
    diff = (got.float() - ref.float()).abs()
    assert got.dtype == q_dtype
    assert bool((diff <= rtol * (1 + ref.float().abs())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", SPLIT_CASES, ids=SPLIT_IDS)
@pytest.mark.parametrize("page_kind", list(PAGE_KINDS))
@pytest.mark.parametrize("splits", [1, 2, 3, 7, 64])
def test_cuda_split_kernel_matches_plain_version(case, page_kind, splits,
                                                 cuda_device, monkeypatch):
    """The kernel at a split count that ``split_plan`` is patched to give
    (1: no merge; 7 and 64: more
    splits than some tokens have pages, and spans that are no multiple of
    the split count) on its route (bf16 queries over pages of 16 or 32
    rows, bf16 or int8 at d 128: mma; the rest: fma) against the
    sequential plain version and against the plain
    split-then-merge version, on tables of several pages with a token of
    one page, a token over the whole table, two padding tokens (every key
    masked: they average page 0) and page 0 poisoned with huge values that
    only the padding tokens may read."""
    t, nh, nkv, d, n_pages, nb, bs, window = case
    q, kp, vp, tbl, pos, clen = _split_case(11, t, nh, nkv, d, n_pages, nb, bs)
    kp[:, :bs] = 1e3
    vp[:, :bs] = 1e3
    q_dtype, page_dtype, rtol = PAGE_KINDS[page_kind]
    dev = cuda_device
    args = [torch.from_numpy(a).to(dev) for a in (tbl, pos, clen)]
    tq = torch.from_numpy(q).to(dev, q_dtype)
    kw = {}
    if page_dtype == "int8":
        kq, ks = _quantize(kp)
        vq, vs = _quantize(vp)
        pages = [torch.from_numpy(a).to(dev) for a in (kq, vq)]
        kw = {"k_scales": torch.from_numpy(ks).to(dev),
              "v_scales": torch.from_numpy(vs).to(dev)}
    else:
        pages = [torch.from_numpy(a).to(dev, page_dtype) for a in (kp, vp)]
    scale = 1 / np.sqrt(d)
    name = "paged_attention_int8" if kw else "paged_attention"
    path = tpa.route(tq, pages[0], bs, nb)
    assert path == ("mma" if bs % 16 == 0 and (
        page_kind == "bf16" or page_kind == "int8" and d == 128) else "fma")
    before = tpa.paged_decode_attention.launches[name]
    merges = tpa.paged_decode_attention.merges[name]
    routes = dict(tpa.paged_decode_attention.routes)
    monkeypatch.setattr(tpa, "split_plan", lambda *_: splits)
    got = tpa.paged_decode_attention(tq, *pages, *args, bs, scale, window,
                                     **kw)
    torch.cuda.synchronize()
    assert tpa.paged_decode_attention.launches[name] == before + 1
    assert tpa.paged_decode_attention.merges[name] == merges + (splits > 1)
    assert {r: n - routes[r] for r, n in tpa.paged_decode_attention.routes.items()
            if n != routes[r]} == {f"{name}.{path}": 1}
    assert got.dtype == q_dtype and bool(torch.isfinite(got.float()).all())
    for ref in (tpa.paged_decode_attention_ref(tq, *pages, *args, bs, scale,
                                               window, **kw),
                tpa.paged_decode_attention_split_ref(
                    tq, *pages, *args, bs, scale, splits, window, **kw)):
        diff = (got.float() - ref.float()).abs()
        assert bool((diff <= rtol * (1 + ref.float().abs())).all()), \
            float(diff.max())


@pytest.mark.cuda
@pytest.mark.parametrize("group,d,elem,want", [
    (4, 128, 2, (8, 16)),      # llama3-8b, bf16 pages
    (4, 128, 1, (8, 16)),      # int8 pages
    (1, 64, 2, (32, 4)),       # MHA d 64: 16 lanes hold the row
    (8, 128, 4, (4, 32)),
    (3, 96, 2, (8, 16)),       # a group rounds up to 4 sub-groups
    (1, 80, 2, (32, 4)),
])
def test_lane_plan(group, d, elem, want, cuda_device):
    """The fma walk's lane plan from the kernel's plan: lanes a query head
    and elements a lane."""
    kv = {4: torch.float32, 2: torch.bfloat16, 1: torch.int8}[elem]
    q_dtype = torch.float32 if elem == 4 else torch.bfloat16
    assert tpa.plan("fma", q_dtype, kv, d, group, 16, 8)[:2] == want


@pytest.mark.cuda
@pytest.mark.parametrize("group,d,elem", [(64, 64, 2), (8, 256, 2),
                                          (4, 72, 1)])
def test_lane_plan_rejects_what_the_kernel_cannot_lay_out(group, d, elem,
                                                          cuda_device):
    """More heads than a warp's lanes, more than 32 elements a lane, and a
    head_dim off the lane's 16-byte loads (int8 d 72): no fma plan."""
    kv = {2: torch.bfloat16, 1: torch.int8}[elem]
    assert tpa.plan("fma", torch.bfloat16, kv, d, group, 16, 8) is None


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,page_dtype,nh,nkv,d,bs,nb,want", [
    (torch.bfloat16, torch.bfloat16, 32, 8, 128, 16, 128, "mma"),  # llama3-8b
    (torch.bfloat16, torch.bfloat16, 4, 4, 64, 32, 8, "mma"),
    (torch.bfloat16, torch.int8, 32, 8, 128, 16, 128, "mma"),      # int8 pages
    (torch.bfloat16, torch.int8, 8, 2, 64, 16, 128, "fma"),        # int8 d 64
    (torch.float32, torch.int8, 32, 8, 128, 16, 128, "fma"),       # fp32 q
    (torch.float32, torch.bfloat16, 32, 8, 128, 16, 128, "fma"),   # fp32 q
    (torch.float32, torch.float32, 32, 8, 128, 16, 128, "fma"),
    (torch.bfloat16, torch.bfloat16, 32, 8, 128, 8, 128, "fma"),   # bs 8
    (torch.bfloat16, torch.bfloat16, 32, 32, 80, 16, 128, "fma"),  # d 80
    (torch.bfloat16, torch.bfloat16, 32, 1, 128, 16, 128, "fma"),  # group 32
    (torch.bfloat16, torch.bfloat16, 32, 8, 128, 128, 16, "fma"),  # ring > smem
])
def test_paged_route_rule(q_dtype, page_dtype, nh, nkv, d, bs, nb, want,
                          cuda_device):
    """The kernel's route, before the launch, from the kernel's plan:
    tensor cores (mma) for bf16 queries over bf16 pages at d 64 or 128 or
    over int8 pages at d 128, a group of at most 16 and pages of a
    multiple of 16 rows whose ring fits shared memory; the CUDA-core lane
    walk (fma) for everything else."""
    q = torch.zeros((2, nh, d), dtype=q_dtype)
    kp = torch.zeros((nkv, bs * 4, d), dtype=page_dtype)
    assert tpa.route(q, kp, bs, nb) == want
