"""The port's CUDA paged-attention kernel against its plain PyTorch
version on the card, on the small geometries of
test_torch_paged_attention.py (MHA and GQA, d 64 and 128, block size 8 and
16, a window, a poisoned garbage page, mid-sequence positions).

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
