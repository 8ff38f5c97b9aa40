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

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.v2.model import _kernel_attn_default
from deepspeed_tpu_torch.ops import paged_attention as tpa
from test_torch_engine_v2 import one_torch_thread  # noqa: F401
from test_torch_paged_attention_cuda import CASES, IDS, _case, _quantize

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
