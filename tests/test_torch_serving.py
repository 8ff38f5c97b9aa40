"""The port's InferenceServer (deepspeed_tpu_torch/serving/) over the port's
engine: under greedy sampling everything the async serve loop streams is
bit-identical to the engine's one-shot ``generate()`` — and, with the same
weights bridged from the JAX init, to the JAX engine's — across thread
interleavings and a KV-exhaustion preemption.
"""

import threading
import time

import jax
import numpy as np
import pytest

from deepspeed_tpu.inference.v2 import build_engine as jax_build_engine
from deepspeed_tpu.models import get_model_config as jax_model_config
from deepspeed_tpu.models.transformer import init_params as jax_init_params
from deepspeed_tpu_torch.inference.v2 import build_engine
from deepspeed_tpu_torch.models import get_model_config
from deepspeed_tpu_torch.models.bridge import params_from_jax
from deepspeed_tpu_torch.serving import (InferenceServer, QueueFull,
                                         SamplingParams)

from test_torch_engine_v2 import assert_greedy_margins, one_torch_thread  # noqa: F401

# 23 usable blocks: eight 8-token prompts admit (2 blocks each) but grow
# to ceil(20/4) = 5 blocks → demand 40 > 23 → a forced preemption
CONFIG = {"dtype": "float32",
          "state_manager": {"max_tracked_sequences": 8,
                            "max_ragged_batch_size": 32},
          "memory_config": {"num_blocks": 24, "block_size": 4},
          "max_context": 32}
N_REQ, NEW = 8, 12


@pytest.fixture(scope="module")
def engines():
    jm = jax_model_config("llama-tiny", num_layers=1)
    jp = jax_init_params(jm, jax.random.PRNGKey(0))
    tm = get_model_config("llama-tiny", num_layers=1)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm, device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, tm.vocab_size, size=8).tolist()
               for _ in range(N_REQ)]
    jax_ref = jax_build_engine(jm, CONFIG, model_params=jp).generate(
        prompts, max_new_tokens=NEW)
    return build_engine(tm, CONFIG, model_params=tp, device="cpu"), \
        prompts, jax_ref


def test_concurrent_streams_with_preemption_match_generate(engines):
    eng, prompts, jax_ref = engines
    ref = eng.generate(prompts, max_new_tokens=NEW)
    assert ref == jax_ref
    assert eng.free_blocks == 23

    srv = InferenceServer(eng).start()
    outs, first_token_at, finished_at, errors = {}, {}, {}, []

    def client(worker):
        try:
            # both requests in flight before either is read: all eight
            # run at once, which is what exhausts the pool
            streams = [(i, srv.submit(prompts[i],
                                      SamplingParams(max_new_tokens=NEW)))
                       for i in (2 * worker, 2 * worker + 1)]
            for i, stream in streams:
                toks = []
                for tok in stream:
                    if not toks:
                        first_token_at[i] = time.monotonic()
                    toks.append(tok)
                finished_at[i] = time.monotonic()
                outs[i] = toks
        except Exception as e:  # surfaced by the assert below
            errors.append(repr(e))

    try:
        threads = [threading.Thread(target=client, args=(w,))
                   for w in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        srv.stop()
    assert not errors
    assert [outs[i] for i in range(N_REQ)] == ref   # bit-identical greedy
    snap = srv.metrics.snapshot()
    assert snap["preemptions"] >= 1                  # KV exhaustion recovered
    assert snap["completed"] == N_REQ
    assert snap["ttft"]["count"] == N_REQ and snap["ttft"]["p50"] > 0
    assert snap["tpot"]["count"] == N_REQ and snap["tpot"]["p50"] > 0
    assert snap["tokens_out"] == N_REQ * NEW
    assert eng.free_blocks == 23 and eng.state_manager.n_active == 0
    with pytest.raises(QueueFull):
        srv.submit(prompts[0], SamplingParams(max_new_tokens=NEW))  # stopped
    assert_greedy_margins(eng, prompts, ref, 1e-4)


def test_server_generate_wrapper_and_rejections(engines):
    eng, prompts, jax_ref = engines
    with InferenceServer(eng) as srv:
        assert srv.generate(prompts[:3], max_new_tokens=NEW) == jax_ref[:3]
        with pytest.raises(ValueError, match="KV blocks"):
            srv.submit(list(range(1, 40)), SamplingParams(max_new_tokens=8))
        with pytest.raises(ValueError, match="top_p"):
            srv.submit([1, 2], SamplingParams(top_p=0.0))
    assert eng.free_blocks == 23


def test_injected_engine_crash_fails_streams():
    """The copied fault-injection wiring (resilience/chaos.py): a
    replica_crash at engine.step kills the serve loop; the stream ends
    with ServingError, stop() raises, and no KV page leaks."""
    from deepspeed_tpu_torch.resilience.chaos import ChaosInjector, FaultPlan
    from deepspeed_tpu_torch.serving import ServingError

    model = get_model_config("llama-tiny", num_layers=1)
    eng = build_engine(model, CONFIG, seed=0, device="cpu")
    eng.chaos = ChaosInjector(FaultPlan(
        [{"kind": "replica_crash", "point": "engine.step"}])).arm()
    srv = InferenceServer(eng).start()
    stream = srv.submit([1, 2, 3], SamplingParams(max_new_tokens=4))
    with pytest.raises(ServingError):
        stream.result(timeout=60)
    with pytest.raises(RuntimeError, match="serve loop died"):
        srv.stop()
    assert eng.free_blocks == 23 and eng.state_manager.n_active == 0
