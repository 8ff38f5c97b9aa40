"""The port's InferenceEngineV2 (deepspeed_tpu_torch/inference/v2/) against
the JAX package's, plus the allocator, scheduler and admission cases of
tests/test_inference_v2.py run on the port.

Parity oracle: with the same weights (bridged from the JAX init) greedy
``generate`` emits the same tokens as the JAX engine in fp32 — across
chunked prefill mixed with decode, more prompts than slots, and the int8
KV cache.  Random tiny models can have near-tied logits, where a 1e-6
difference between frameworks would flip an argmax; each parity test
replays its sequences through the port one token at a time and asserts
the top-1/top-2 margin, so a near tie fails loudly instead of flakily.
"""

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import build_engine as jax_build_engine
from deepspeed_tpu.models import get_model_config as jax_model_config
from deepspeed_tpu.models.transformer import init_params as jax_init_params
from deepspeed_tpu_torch.inference.v2 import (BlockedAllocator,
                                              DSStateManager,
                                              InferenceEngineV2,
                                              KVCacheExhausted,
                                              SplitFuseScheduler,
                                              build_engine)
from deepspeed_tpu_torch.inference.v2.engine_v2 import (
    RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2.ragged import build_ragged_batch
from deepspeed_tpu_torch.models import get_model_config
from deepspeed_tpu_torch.models.bridge import params_from_jax

MIN_MARGIN = {"fp32": 1e-4, "int8": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tests run at tiny widths, where torch's intra-op
    thread pool gains nothing and, beside other test workers, spins on
    cores they need (timing-sensitive serving tests slow down ~2x).  Test
    modules of the port import this fixture to take one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(name, config, seed=3):
    """(JAX engine, port engine) with the same weights."""
    jm = jax_model_config(name)
    jp = jax_init_params(jm, jax.random.PRNGKey(seed))
    tm = get_model_config(name)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm, device="cpu")
    return (jax_build_engine(jm, config, model_params=jp),
            build_engine(tm, config, model_params=tp, device="cpu"))


def _tiny(num_layers=1, **config):
    """A port-only llama-tiny engine with its own seeded random weights."""
    model = get_model_config("llama-tiny", num_layers=num_layers)
    return model, build_engine(model, {"dtype": "float32", **config},
                               seed=0, device="cpu")


def _prompts(vocab, sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).tolist() for n in sizes]


def assert_greedy_margins(eng, prompts, outs, min_margin):
    """Replay each sequence through ``eng`` one token at a time: every
    emitted token is the argmax, by at least ``min_margin``."""
    for i, (prompt, out) in enumerate(zip(prompts, outs)):
        uid = 10_000 + i
        eng.admit(uid, prompt)
        for tok in out:
            logits = {}
            while uid not in logits:
                logits = eng.step(return_logits=True)
            row = np.sort(logits[uid])
            assert row[-1] - row[-2] > min_margin, (
                f"near tie ({row[-1] - row[-2]:.2e}) at prompt {i}: pick "
                "another seed")
            assert int(np.argmax(logits[uid])) == tok
            eng.extend(uid, tok)
        eng.flush(uid)
    assert eng.state_manager.n_active == 0


@pytest.mark.parametrize("name,kv,sizes,slots,budget", [
    # long prompts chunk across steps while short ones already decode
    ("llama-tiny", "fp32", (5, 11, 3, 20), 4, 16),
    # MHA + learned positions; 4 prompts through 2 slots in waves
    ("gpt2-tiny", "fp32", (3, 2, 1, 4), 2, 16),
    # sliding window (16) shorter than the contexts, int8 KV pages
    ("mistral-tiny", "int8", (23, 17, 30), 4, 32),
], ids=["llama-mixed", "gpt2-oversubscribed", "mistral-int8-window"])
def test_greedy_generate_matches_jax(name, kv, sizes, slots, budget):
    config = {"dtype": "float32",
              "state_manager": {"max_tracked_sequences": slots,
                                "max_ragged_batch_size": budget},
              "memory_config": {"num_blocks": 64, "block_size": 4,
                                **({"kv_dtype": "int8"} if kv == "int8"
                                   else {})},
              "max_context": 64}
    if name == "mistral-tiny":
        # a window the contexts outgrow (the preset's 32 would not bind)
        jm = jax_model_config(name, sliding_window=16)
        jp = jax_init_params(jm, jax.random.PRNGKey(3))
        tm = get_model_config(name, sliding_window=16)
        jeng = jax_build_engine(jm, config, model_params=jp)
        teng = build_engine(tm, config, device="cpu", model_params=params_from_jax(
            jax.tree.map(np.asarray, jp), tm, device="cpu"))
    else:
        jeng, teng = _pair(name, config)
    prompts = _prompts(teng.model_config.vocab_size, sizes)
    new = 8
    ref = jeng.generate(prompts, max_new_tokens=new)
    got = teng.generate(prompts, max_new_tokens=new)
    assert got == ref
    assert teng.free_blocks == teng.cfg.num_blocks - 1
    assert_greedy_margins(teng, prompts, got, MIN_MARGIN[kv])


def test_sampled_tokens_lie_in_top_k_top_p_set():
    """torch.Generator draws other bits than jax.random: a sampled step is
    checked by membership in the top-k ∩ top-p set of its logits."""
    _, eng = _tiny(2, memory_config={"num_blocks": 32, "block_size": 4},
                   max_context=32)
    prompts = _prompts(512, (6, 9, 4))
    gen = torch.Generator().manual_seed(0)
    for i, p in enumerate(prompts):
        eng.admit(i, p)
    logits = eng.step(return_logits=True)
    for i, p in enumerate(prompts):
        eng.flush(i)
        eng.admit(i, p)
    toks = eng.step(temperature=0.8, key=gen, top_k=20, top_p=0.5)
    for i in range(len(prompts)):
        x = logits[i] / 0.8
        order = np.argsort(-x)
        p = np.exp(x[order] - x[order[0]])
        p /= p.sum()
        nucleus = set(order[(np.cumsum(p) - p) < 0.5].tolist())
        assert toks[i] in nucleus and toks[i] in set(order[:20].tolist())
        eng.flush(i)


def test_verify_step_is_greedy_decoding():
    """Speculative verify-k: right proposals are all accepted plus a
    bonus, a wrong one cuts the burst; both equal plain greedy tokens."""
    _, eng = _tiny(2, memory_config={"num_blocks": 64, "block_size": 4},
                   max_context=64)
    prompt = _prompts(512, (7,))[0]
    ref = eng.generate([prompt], max_new_tokens=6)[0]
    eng.admit(1, prompt)
    first = eng.step()[1]
    assert first == ref[0]
    eng.extend(1, first)
    assert eng.verify_step({1: ref[1:4]})[1] == ref[1:5]
    wrong = (ref[5] + 1) % 512
    assert eng.verify_step({1: [wrong]})[1] == [ref[5]]
    eng.flush(1)


def test_kv_chain_export_import_round_trip():
    config = dict(memory_config={"num_blocks": 32, "block_size": 4},
                  max_context=32)
    _, a = _tiny(2, **config)
    _, b = _tiny(2, **config)
    prompt = _prompts(512, (10,))[0]
    a.admit(1, prompt)
    a.step()
    payload = a.export_kv_chain(1)
    assert len(payload["tokens"]) == 8 and payload["nbytes"] > 0
    blocks, n_tok, moved = b.import_kv_chain(payload)
    assert n_tok == 8 and moved == payload["nbytes"]
    for cache_a, cache_b in ((a.cache_k, b.cache_k), (a.cache_v, b.cache_v)):
        rows_a = torch.cat([torch.arange(x * 4, x * 4 + 4)
                            for x in a.state_manager.get(1).blocks[:2]])
        rows_b = torch.cat([torch.arange(x * 4, x * 4 + 4) for x in blocks])
        assert torch.equal(cache_a[:, :, rows_a], cache_b[:, :, rows_b])
    b.state_manager.allocator.free(blocks)
    with pytest.raises(ValueError, match="geometry"):
        b.import_kv_chain({**payload, "geom": (0,)})


def test_entry_points_default_to_cuda(monkeypatch):
    """No device given and no card: raise, never carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngineV2(get_model_config("llama-tiny"), {})
    from deepspeed_tpu_torch.models import init_params

    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(get_model_config("llama-tiny"))


def test_unported_parallel_modes_raise():
    for cfg in ({"tensor_parallel": {"tp_size": 2}},
                {"expert_parallel": {"ep_size": 2}}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            InferenceEngineV2(get_model_config("llama-tiny"), cfg,
                              device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        InferenceEngineV2(get_model_config("mixtral-tiny"), {}, device="cpu")


# -- mirrored from tests/test_inference_v2.py ---------------------------
def test_blocked_allocator():
    a = BlockedAllocator(8)
    assert a.free_blocks == 7  # block 0 reserved
    got = a.allocate(3)
    assert len(set(got)) == 3 and 0 not in got
    with pytest.raises(RuntimeError):
        a.allocate(5)
    a.free(got)
    assert a.free_blocks == 7
    with pytest.raises(ValueError):
        a.free([0])


def test_blocked_allocator_rejects_double_free_and_bad_handles():
    a = BlockedAllocator(8)
    got = a.allocate(3)
    a.free(got[:1])
    with pytest.raises(ValueError, match="double free"):
        a.free(got[:1])
    with pytest.raises(ValueError, match="not allocated"):
        a.free([5] if 5 not in got else [6])
    with pytest.raises(ValueError, match="out of range"):
        a.free([99])
    with pytest.raises(ValueError, match="duplicate"):
        a.free([got[1], got[1]])
    a.free(got[1:])
    assert a.free_blocks == 7
    with pytest.raises(KVCacheExhausted):
        a.allocate(8)


def test_state_manager_slots_and_pages():
    mgr = DSStateManager(max_seqs=2, num_blocks=8, block_size=4,
                         max_blocks_per_seq=4)
    s1 = mgr.open(10, [1, 2, 3, 4, 5])
    mgr.ensure_capacity(s1, 5)
    assert len(s1.blocks) == 2
    mgr.open(11, [7])
    with pytest.raises(RuntimeError):
        mgr.open(12, [9])  # no slots
    mgr.flush(10)
    assert 10 not in mgr and mgr.allocator.free_blocks == 7
    mgr.open(12, [9])


def test_splitfuse_schedule_splits_prompts():
    mgr = DSStateManager(max_seqs=4, num_blocks=64, block_size=4,
                         max_blocks_per_seq=16)
    sched = SplitFuseScheduler(mgr, token_budget=8)
    mgr.open(1, list(range(20)))
    sched.add(1)
    for cached, n in ((8, 8), (16, 8), (20, 4)):
        assert [(x.uid, k) for x, k in sched.next_schedule()] == [(1, n)]
        mgr.get(1).num_cached = cached


def test_splitfuse_decode_priority():
    mgr = DSStateManager(max_seqs=4, num_blocks=64, block_size=4,
                         max_blocks_per_seq=16)
    sched = SplitFuseScheduler(mgr, token_budget=8)
    mgr.open(1, [1, 2, 3])
    sched.add(1)
    sched.next_schedule()
    mgr.get(1).num_cached = 3
    mgr.get(1).tokens.append(42)
    mgr.open(2, list(range(30)))
    sched.add(2)
    s = sched.next_schedule()
    assert (s[0][0].uid, s[0][1]) == (1, 1)
    assert (s[1][0].uid, s[1][1]) == (2, 7)


def test_kv_pages_freed_and_waves_drain():
    _, eng = _tiny(state_manager={"max_tracked_sequences": 2,
                                  "max_ragged_batch_size": 16},
                   memory_config={"num_blocks": 16, "block_size": 4},
                   max_context=32)
    before = eng.free_blocks
    out = eng.generate([[1, 2, 3], [4, 5], [6], [7, 8, 9, 10]],
                       max_new_tokens=3)
    assert all(len(o) == 3 for o in out)
    assert eng.free_blocks == before


def test_generate_raises_on_impossible_prompt():
    _, eng = _tiny(memory_config={"num_blocks": 4, "block_size": 4},
                   max_context=16)
    with pytest.raises(RuntimeError):
        eng.generate([list(range(1, 30))], max_new_tokens=8)


def test_admission_reserves_active_seq_future_blocks():
    _, eng = _tiny(state_manager={"max_tracked_sequences": 4,
                                  "max_ragged_batch_size": 16},
                   memory_config={"num_blocks": 8, "block_size": 4},
                   max_context=32)
    out = eng.generate([[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]], max_new_tokens=12)
    assert all(len(o) == 12 for o in out)
    assert eng.free_blocks == eng.cfg.num_blocks - 1


def test_admission_enforces_per_seq_block_cap():
    _, eng = _tiny(memory_config={"num_blocks": 64, "block_size": 4},
                   max_context=16)
    with pytest.raises(RuntimeError, match="per sequence"):
        eng.generate([[1, 2, 3], list(range(1, 25))], max_new_tokens=4)


def test_put_validates_batch_before_mutating():
    _, eng = _tiny(memory_config={"num_blocks": 32, "block_size": 4},
                   max_context=32)
    with pytest.raises(ValueError):
        eng.put([1, 1], [[5, 6], [7, 8]])
    assert 1 not in eng.state_manager
    with pytest.raises(ValueError):
        eng.put([2, 3], [[5, 6]])
    assert 2 not in eng.state_manager


def test_build_ragged_batch_checks_budget_first():
    mgr = DSStateManager(max_seqs=2, num_blocks=16, block_size=4,
                         max_blocks_per_seq=4)
    seq = mgr.open(1, list(range(10)))
    with pytest.raises(RuntimeError, match="budget"):
        build_ragged_batch([(seq, 10)], mgr, token_budget=8)
    assert seq.num_cached == 0


def test_soak_staggered_eos_and_sampling_allocator_clean():
    model = get_model_config("gpt2-tiny")
    eng = InferenceEngineV2(model, {"dtype": "float32",
                                    "memory_config": {"num_blocks": 64,
                                                      "block_size": 16},
                                    "max_context": 128}, device="cpu")
    free0 = eng.free_blocks
    rng = np.random.default_rng(21)
    for n, temp, tp in [(6, 0.0, 1.0), (4, 0.9, 0.8), (8, 0.7, 1.0)]:
        prompts = [list(map(int, rng.integers(
            1, model.vocab_size, size=(int(rng.integers(2, 24)),))))
            for _ in range(n)]
        outs = eng.generate(prompts, max_new_tokens=int(rng.integers(3, 12)),
                            temperature=temp, top_p=tp, eos_token_id=7)
        assert len(outs) == n
        for o in outs:
            assert len(o) >= 1
            if 7 in o:
                assert o[o.index(7):] == [7]
        assert eng.free_blocks == free0
        assert eng.state_manager.n_active == 0


def test_engine_config_validation():
    """Long contexts need no compile-time guard on the GPU (the JAX
    engine's 256-blocks cap is a TPU compile-time limit); unknown module
    and KV-dtype names are rejected at the config."""
    cfg = RaggedInferenceEngineConfig({
        "max_context": 32768, "memory_config": {"block_size": 64}})
    assert cfg.block_size == 64 and cfg.max_context == 32768
    with pytest.raises(ValueError, match="kv_dtype"):
        RaggedInferenceEngineConfig({"memory_config": {"kv_dtype": "fp8"}})
    with pytest.raises(ValueError, match="paged_gather"):
        RaggedInferenceEngineConfig({"modules": {"attention": "nope"}})


def test_int8_kv_cache_layout():
    model = get_model_config("llama-tiny")
    caches = {}
    for kind in ("bf16", "int8"):
        eng = InferenceEngineV2(model, {"memory_config": {"kv_dtype": kind}},
                                seed=11, device="cpu")
        caches[kind] = eng.cache_k
        assert len(eng.generate([[1, 2, 3]], max_new_tokens=4)[0]) == 4
    assert caches["bf16"].dtype == torch.bfloat16
    q8, s = caches["int8"]["q"], caches["int8"]["s"]
    assert q8.dtype == torch.int8 and s.dtype == torch.float32
    assert q8.nbytes * 2 == caches["bf16"].nbytes
    assert s.nbytes * q8.shape[-1] == q8.nbytes * 4
