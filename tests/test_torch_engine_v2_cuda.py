"""The port's InferenceEngineV2 repeats itself bit for bit, on the card and
on the CPU: llama3-8b at full width cut to two layers, fp32 weights and
KV, the configuration of chip_smoke.py's reference phase (card against
CPU to 1e-4 of the largest logit).  Two engines over the same weights take
the same chunked prefill and decode steps; their logits must be equal,
which rules out a race in the paged-attention kernel or an engine op as
the cause of a moving card-vs-CPU reading.

No JAX here: the machine with the card has none.  Run there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_engine_v2_cuda.py -m cuda

Without a card the test skips.  Tolerance: none, the logits are compared
for equality.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.models import get_model_config
from deepspeed_tpu_torch.models.transformer import tree_map_with_path

CONFIG = {"memory_config": {"num_blocks": 1024, "block_size": 16},
          "max_context": 2048, "dtype": "float32"}


def _logits(engine, prompts):
    """Every step's logits, chunked prefill to two steps in which every
    sequence decoded; each sequence decodes its own argmax."""
    uids = list(range(len(prompts)))
    pending, out, full_steps = (uids, prompts), [], 0
    for _ in range(16):
        step = engine.put(*pending)
        pending = ([], [])
        for u in sorted(step):
            out.append((u, np.array(step[u], copy=True)))
            engine.extend(u, int(np.argmax(step[u])))
        full_steps += set(step) == set(uids)
        if full_steps == 2:
            return out
    raise AssertionError("the steps did not reach decode")


@pytest.mark.cuda
def test_reference_logits_repeat_bit_for_bit():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = get_model_config("llama3-8b", num_layers=2)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.vocab_size, size=200).tolist()
               for _ in range(4)]
    first = InferenceEngineV2(model, CONFIG, seed=1)
    host_params = tree_map_with_path(lambda _p, a: a.cpu(), first.params)
    for make in (lambda: InferenceEngineV2(model, CONFIG,
                                           model_params=first.params),
                 lambda: InferenceEngineV2(model, CONFIG, device="cpu",
                                           model_params=host_params)):
        runs = [_logits(make(), prompts) for _ in range(2)]
        assert [u for u, _ in runs[0]] == [u for u, _ in runs[1]]
        for (u, a), (_, b) in zip(*runs):
            assert np.isfinite(a).all() and a.shape == (model.vocab_size,)
            assert np.array_equal(a, b), \
                f"sequence {u}: logits moved by {np.abs(a - b).max()}"
