"""The port's long-context paths on the card against their plain PyTorch
versions: FPDT's ``chunked_attention`` on the ring hop kernels (a launch
of each a live chunk pair, with and without K/V parked in pinned host
memory, causal and not, GQA, bf16 and fp32) against the plain online
softmax on the same card, output and gradients; and ALST's tiled loss in
bf16 (its logits products in bf16 with fp32 results, ``torch.mm(...,
out_dtype=torch.float32)``) against the untiled cross-entropy of the
same bf16 operands' products in fp32.

No JAX here: the machine with the card has none.  Run there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sequence_cuda.py -m cuda

Without a card every test skips.  Tolerances: bf16 2^-7 and fp32 1e-4 of
the reference's largest magnitude (the hop kernels and the plain version
sum in other orders; bf16 rounds p and ds); the tiled loss 1e-5 relative
(fp32 sums of the same bf16 products) and its gradients 2^-7.
"""

import pytest
import torch

from deepspeed_tpu_torch.ops import flash_mha as fm
from deepspeed_tpu_torch.sequence import fpdt, tiled_logits_loss

RTOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-4}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _grads(fn, q, k, v, do):
    qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
    o = fn(qs, ks, vs)
    o.backward(do)
    return [o.detach(), qs.grad, ks.grad, vs.grad]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal,offload", [(True, True), (True, False),
                                            (False, True)])
def test_cuda_chunked_attention_matches_plain_version(dtype, causal, offload,
                                                      cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    b, s, hq, hkv, d, chunk = 1, 1024, 8, 2, 128, 256

    def rand(h):
        return torch.randn((b, s, h, d), generator=gen, device=cuda_device,
                           dtype=torch.float32).to(dtype)

    q, k, v, do = rand(hq), rand(hkv), rand(hkv), rand(hq)
    before = dict(fm.ring_launches)
    got = _grads(lambda *x: fpdt.chunked_attention(
        *x, chunk, causal=causal, offload_kv=offload), q, k, v, do)
    torch.cuda.synchronize()
    n = s // chunk
    live = n * (n + 1) // 2 if causal else n * n
    assert {key: fm.ring_launches[key] - before[key]
            for key in before} == dict.fromkeys(before, live)
    want = _grads(lambda *x: fpdt._plain_chunked_attention(
        *x, chunk, causal, d ** -0.5), q, k, v, do)
    for name, a, r in zip(("o", "dq", "dk", "dv"), got, want):
        err = float((a.float() - r.float()).abs().max()
                    / r.float().abs().max())
        assert err <= RTOL[dtype], (name, err)


@pytest.mark.cuda
def test_cuda_tiled_loss_bf16_matches_untiled(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    b, s, e, vocab = 2, 512, 256, 4096
    h = (torch.randn((b, s, e), generator=gen, device=cuda_device) * 0.5).to(
        torch.bfloat16)
    w = (torch.randn((vocab, e), generator=gen, device=cuda_device)
         * 0.05).to(torch.bfloat16)
    labels = torch.randint(0, vocab, (b, s), generator=gen,
                           device=cuda_device)
    labels[0, :7] = -100
    hs, ws = h.clone().requires_grad_(), w.clone().requires_grad_()
    loss, count = tiled_logits_loss(hs, ws, labels, 8)
    loss.backward()
    hr, wr = h.clone().requires_grad_(), w.clone().requires_grad_()
    # the same bf16 products, exact in fp32, summed in fp32
    logits = hr.reshape(-1, e).float() @ wr.float().t()
    ref = torch.nn.functional.cross_entropy(logits, labels.reshape(-1),
                                            ignore_index=-100)
    ref.backward()
    assert int(count) == int((labels != -100).sum())
    assert float(loss.detach()) == pytest.approx(float(ref.detach()),
                                                 rel=1e-5)
    for a, r in ((hs.grad, hr.grad), (ws.grad, wr.grad)):
        err = float((a.float() - r.float()).abs().max()
                    / r.float().abs().max())
        assert err <= 2.0 ** -7, err
