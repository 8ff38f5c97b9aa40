"""The quantize and dequantize kernels at the data axis's gradient-reduction
shapes, and the quantized collectives on card tensors, against their plain
PyTorch versions on the card.

* ``quantize``/``dequantize`` (``ops/csrc/quantize.cu``) on the fp32
  ``[2, m]`` chunks of gpt2-350m's padded gradient at data 2 (m =
  177,435,648: ``launch_quant`` takes the row length as an ``int``), in
  groups of 256 (``grad_reduce``) and in qgZ's group, the whole chunk
  (2048 does not divide it; the kernel's walk then reads each group
  twice), and a chunk 2048 divides; and qgZ's whole chunk at data 32
  (gpt2-350m's gradient padded to 32 x 8: 11,089,728, not a multiple of
  128); bit for bit.
* ``quantized_reduce_scatter``/``quantized_all_reduce`` and one-level
  qgZ in a one-rank gloo group on CUDA tensors launch the kernels (2
  quantize and 3 dequantize with error feedback, 2 and 2 without, 1 and 1
  for qgZ), also in groups that are not multiples of 128 (``grad_reduce``
  group 64; qgZ over a 1384-element buffer, one whole-chunk group), and
  give the plain versions' numbers on the same tensors moved to the CPU,
  bit for bit.

No JAX here: the machine with the card has none.  Run there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_dp_compression_cuda.py -m cuda

Without a card every test skips.
"""

import pytest
import torch

from deepspeed_tpu_torch.ops import quantize as tqk

# gpt2-350m's 354,871,296 gradients padded to 2 x 256 blocks: a rank's chunk
M_GPT2_350M = 177_435_648
# the same padded to 32 x 8 (qgZ at data 32): a rank's chunk, 2^6 x 173277
M_QGZ_DATA32 = 11_089_728


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _chunks(m, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((2, m), generator=gen, device=dev) * 1e-3
    x[:, :256] = 0.0                 # an all-zero group: scale 1.0
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("m,group", [
    (M_GPT2_350M, 256),
    (M_GPT2_350M, M_GPT2_350M),
    (2048 * 4099, 2048),
    (M_QGZ_DATA32, M_QGZ_DATA32),
], ids=["grad-reduce", "qgz-whole-chunk", "qgz-2048",
        "qgz-whole-chunk-data32"])
def test_kernels_at_the_reduction_shapes_match_their_plain_versions(
        cuda_device, m, group):
    x = _chunks(m, cuda_device, seed=group % 97)
    before = dict(tqk.launches)
    q, s = tqk.quantize(x, 8, group)
    d = tqk.dequantize(q, s, torch.float32)
    torch.cuda.synchronize()
    assert tqk.launches["quantize"] == before["quantize"] + 1
    assert tqk.launches["dequantize"] == before["dequantize"] + 1
    q_r, s_r = tqk.quantize_ref(x, 8, group)
    assert torch.equal(q, q_r) and torch.equal(s, s_r)
    assert s.shape == (2, m // group)
    del q_r, s_r
    assert torch.equal(d, tqk.dequantize_ref(q, s, torch.float32))


@pytest.fixture
def one_rank_group(cuda_device, tmp_path):
    from deepspeed_tpu_torch.comm import comm

    comm.init_distributed("gloo", 0, 1, f"file://{tmp_path / 'rdzv'}")
    yield cuda_device
    comm.destroy()


@pytest.mark.cuda
@pytest.mark.parametrize("op,residual,n,group,want", [
    ("all_reduce", True, 1 << 20, 256, (2, 3)),
    ("all_reduce", False, 1 << 20, 256, (2, 2)),
    ("reduce_scatter", True, 1 << 20, 256, (1, 2)),
    ("qgz", False, 1 << 20, 2048, (1, 1)),
    ("all_reduce", True, 1 << 20, 64, (2, 3)),
    ("qgz", False, 1384, 2048, (1, 1)),
], ids=["ar-ef", "ar", "rs-ef", "qgz", "ar-ef-group64", "qgz-whole-chunk"])
def test_collectives_launch_the_kernels_on_card_tensors(one_rank_group, op,
                                                        residual, n, group,
                                                        want):
    from deepspeed_tpu_torch.comm import coalesced_collectives as cc
    from deepspeed_tpu_torch.comm import quantized as tq

    dev = one_rank_group
    gen = torch.Generator(device="cpu").manual_seed(5)
    x = torch.randn(n, generator=gen)
    r = torch.randn(n, generator=gen) * 1e-3 if residual else None

    def run(t, res):
        if op == "qgz":
            return cc.all_to_all_quant_reduce({"g": t}, None, None, 1, 1,
                                              group_size=group)[0], None
        fn = tq.quantized_all_reduce if op == "all_reduce" \
            else tq.quantized_reduce_scatter
        return fn(t, None, 1, wire_dtype="int8", group_size=group,
                  residual=res)

    before = dict(tqk.launches)
    out, new_res = run(x.to(dev), None if r is None else r.to(dev))
    torch.cuda.synchronize()
    assert (tqk.launches["quantize"] - before["quantize"],
            tqk.launches["dequantize"] - before["dequantize"]) == want
    out_r, res_r = run(x, r)
    assert torch.equal(out.cpu(), out_r)
    if residual:
        assert torch.equal(new_res.cpu(), res_r)
