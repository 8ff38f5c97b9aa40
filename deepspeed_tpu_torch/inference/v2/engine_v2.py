"""InferenceEngineV2 — continuous-batching serve engine (FastGen analog), PyTorch.

Port of ``deepspeed_tpu/inference/v2/engine_v2.py``.  The engine owns the
paged KV cache, the sequence state manager and the SplitFuse scheduler;
``put()`` schedules one ragged step; ``generate()`` runs full
continuous-batching text generation with per-call sampling params
(greedy / temperature / top-k / top-p, sampled on device).

Differences from the JAX engine, each forced by the framework:
* the engine runs on one device (``device=None`` → CUDA, raising when no
  card is present; the tests pass ``device="cpu"``);
* weights are cast once, at load, to the engine dtype (the JAX engine
  keeps fp32 masters and casts at each use — the same rounding); norm
  leaves stay fp32 because the forward casts them to fp32 at use anyway;
* KV caches are updated in place instead of being donated and returned;
* draws come from ``torch.Generator``s, not ``jax.random`` keys.
The step still buckets its shapes to powers of two (``t_bucket`` /
``nb_bucket``) so that a later CUDA-graph capture sees a handful of
fixed shapes.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.inference.v2.model import (check_sampling_params,
                                                    ragged_decode_loop,
                                                    ragged_forward,
                                                    ragged_forward_sampled,
                                                    ragged_forward_verify)
from deepspeed_tpu_torch.inference.v2.ragged import (DSStateManager,
                                                     KVCacheExhausted,
                                                     build_ragged_batch)
from deepspeed_tpu_torch.inference.v2.scheduler import SplitFuseScheduler
from deepspeed_tpu_torch.models.transformer import (TransformerConfig,
                                                    init_params,
                                                    is_norm_path,
                                                    tree_map_with_path)
from deepspeed_tpu_torch.utils.device import resolve_device
from deepspeed_tpu_torch.utils.logging import log_dist


class RaggedInferenceEngineConfig:
    """Engine knobs (ref inference/v2/config_v2.py RaggedInferenceEngineConfig)."""

    def __init__(self, d: Optional[Dict[str, Any]] = None, **kw):
        d = {**(d or {}), **kw}
        self.tp_size = int(d.get("tensor_parallel", {}).get("tp_size", 1)
                           if isinstance(d.get("tensor_parallel"), dict)
                           else d.get("tp_size", 1))
        state = d.get("state_manager", {})
        self.max_tracked_sequences = int(state.get("max_tracked_sequences", 64))
        self.max_ragged_batch_size = int(state.get("max_ragged_batch_size", 256))
        self.memory_config = d.get("memory_config", {})
        self.num_blocks = int(self.memory_config.get("num_blocks", 512))
        self.block_size = int(self.memory_config.get("block_size", 16))
        # "int8": blockwise-quantized KV pages (one fp32 scale per
        # (head, row)) — halves decode's KV bandwidth, the bound resource
        self.kv_dtype = str(self.memory_config.get("kv_dtype", "auto"))
        if self.kv_dtype not in ("auto", "int8", "bf16", "bfloat16"):
            raise ValueError(f"memory_config.kv_dtype={self.kv_dtype!r}: "
                             "expected 'auto', 'int8', or 'bf16'")
        # the JAX engine also caps blocks per sequence at 256 for the
        # sake of TPU compile time; nothing compiles per shape here
        self.max_context = int(d.get("max_context", 2048))
        mdc = max(1, int(d.get("max_decode_chunk", 32)))
        self.max_decode_chunk = 1 << (mdc.bit_length() - 1)
        self.dtype = d.get("dtype", "bfloat16")
        ep = d.get("expert_parallel", {})
        self.ep_size = int(ep.get("ep_size", 1) if isinstance(ep, dict)
                           else ep)
        # module-implementation overrides, e.g. {"attention": "paged_gather"}
        # resolved through inference/v2/modules.py at each attention call;
        # validated now so a typo fails at the config, not mid-generate
        from deepspeed_tpu_torch.inference.v2 import model as _model  # registers
        from deepspeed_tpu_torch.inference.v2.modules import (available,
                                                              module_overrides)

        self.modules = module_overrides(d)
        for kind, name in self.modules.items():
            if name != "auto" and name not in available(kind):
                raise ValueError(
                    f"unknown {kind} implementation '{name}' "
                    f"(available: {', '.join(available(kind)) or 'none'})")


def _kv_scatter(cache_k, cache_v, rows, k, v):
    """Write handed-off KV page rows into the paged caches in place (plain
    [L, nkv, P, d], or the int8 dict {"q": int8, "s": fp32 [L, nkv, P]})."""
    if isinstance(cache_k, dict):
        for cache, part in ((cache_k, k), (cache_v, v)):
            cache["q"][:, :, rows, :] = part["q"].to(cache["q"].device)
            cache["s"][:, :, rows] = part["s"].to(cache["s"].device)
    else:
        cache_k[:, :, rows, :] = k.to(cache_k.device, cache_k.dtype)
        cache_v[:, :, rows, :] = v.to(cache_v.device, cache_v.dtype)


def _kv_gather(cache, rows):
    """Read page rows out of either cache layout onto the host."""
    if isinstance(cache, dict):
        return {"q": cache["q"][:, :, rows].cpu(),
                "s": cache["s"][:, :, rows].cpu()}
    return cache[:, :, rows].cpu()


def _payload_nbytes(part) -> int:
    if isinstance(part, dict):
        return sum(int(a.nbytes) for a in part.values())
    return int(part.nbytes)


def _pow2_at_least(n: int, start: int = 1) -> int:
    b = start
    while b < n:
        b *= 2
    return b


class InferenceEngineV2:
    def __init__(self, model: TransformerConfig,
                 config: Optional[Dict[str, Any]] = None,
                 model_params: Optional[Any] = None, seed: int = 0,
                 device=None, **kw):
        self.cfg = RaggedInferenceEngineConfig(config, **kw)
        if self.cfg.tp_size > 1 or self.cfg.ep_size > 1:
            raise NotImplementedError(
                "tensor/expert-parallel serving is not ported yet (ROADMAP "
                "Queue A items 6 and 10)")
        self.device = resolve_device(device)
        dt = torch.bfloat16 if "bf" in str(self.cfg.dtype) else torch.float32
        self.model_config = model.replace(dtype=dt)
        if self.cfg.modules:
            self.model_config = self.model_config.replace(
                v2_modules=tuple(sorted(self.cfg.modules.items())))
        mc = self.model_config
        if mc.has_learned_positions and self.cfg.max_context > mc.max_seq_len:
            # JAX clamps an out-of-range position lookup; torch would fault
            raise ValueError(
                f"max_context {self.cfg.max_context} exceeds the model's "
                f"{mc.max_seq_len} learned positions")

        if model_params is None:
            self.params = init_params(mc, seed, self.device, dtype=dt)
        else:
            # cast once at load (norm leaves stay in their master dtype;
            # the forward casts them to the norm's compute dtype at use)
            self.params = tree_map_with_path(
                lambda path, a: torch.as_tensor(a).to(
                    device=self.device,
                    dtype=None if is_norm_path(path) else dt),
                model_params)

        max_blocks_per_seq = -(-self.cfg.max_context // self.cfg.block_size)
        self.state_manager = DSStateManager(
            max_seqs=self.cfg.max_tracked_sequences,
            num_blocks=self.cfg.num_blocks,
            block_size=self.cfg.block_size,
            max_blocks_per_seq=max_blocks_per_seq)
        self.scheduler = SplitFuseScheduler(self.state_manager,
                                            token_budget=self.cfg.max_ragged_batch_size)
        # step() default generator
        self._step_gen = torch.Generator(device=self.device).manual_seed(
            seed ^ 0x57E9)
        # software-span tracer (telemetry/tracing.py) — the serving layer
        # injects both so ragged dispatches appear in the request trace
        self.tracer = None
        self.trace_id = ""
        # fault injection (resilience/chaos.py ChaosInjector); None keeps
        # step() at one attribute check per call
        self.chaos = None

        pages = self.cfg.num_blocks * self.cfg.block_size
        # [L, nkv, P, d]: kv-head-major so one page of one head is a
        # contiguous [block_size, d] run for the paged-attention kernel
        kv_shape = (mc.num_layers, mc.kv_heads, pages, mc.dim_per_head)
        dev = self.device
        if self.cfg.kv_dtype == "int8":
            sc_shape = kv_shape[:-1]
            self.cache_k = {"q": torch.zeros(kv_shape, dtype=torch.int8, device=dev),
                            "s": torch.zeros(sc_shape, dtype=torch.float32, device=dev)}
            self.cache_v = {"q": torch.zeros(kv_shape, dtype=torch.int8, device=dev),
                            "s": torch.zeros(sc_shape, dtype=torch.float32, device=dev)}
        else:
            kv_dt = (torch.bfloat16 if self.cfg.kv_dtype in ("bf16", "bfloat16")
                     else dt)
            self.cache_k = torch.zeros(kv_shape, dtype=kv_dt, device=dev)
            self.cache_v = torch.zeros(kv_shape, dtype=kv_dt, device=dev)
        log_dist(f"InferenceEngineV2: budget={self.cfg.max_ragged_batch_size} "
                 f"blocks={self.cfg.num_blocks}×{self.cfg.block_size} "
                 f"max_seqs={self.cfg.max_tracked_sequences} "
                 f"device={self.device}")

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _bucket_args(self, rb):
        """Device arguments of one ragged step, bucketed to power-of-two
        token count and context width: a 16-seq decode step runs [16, ctx]
        work, not [budget, max_ctx]."""
        t_bucket = min(_pow2_at_least(rb.n_tokens, 16),
                       self.scheduler.token_budget)
        nb_real = max(1, -(-int(rb.ctx_lens.max()) // self.cfg.block_size))
        nb_bucket = min(_pow2_at_least(nb_real),
                        self.state_manager.max_blocks_per_seq)
        return (self.params, self.cache_k, self.cache_v,
                self._dev(rb.token_ids[:t_bucket]),
                self._dev(rb.token_slot[:t_bucket]),
                self._dev(rb.token_pos[:t_bucket]),
                self._dev(rb.token_dest[:t_bucket]),
                self._dev(rb.block_tables[:, :nb_bucket]),
                self._dev(rb.ctx_lens), self._dev(rb.logits_idx))

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def _ragged_step(self, batch_uids: Sequence[int],
                     batch_tokens: Sequence[Sequence[int]],
                     sample: Optional[Dict[str, Any]] = None):
        """Admit prompts and run ONE ragged step; returns (rb, result) where
        result is the full logits array (sample=None) or on-device-sampled
        tokens [max_seqs+1] (sample={'generator','temperature'} with
        optional 'top_k'/'top_p' — see check_sampling_params)."""
        # Validate the whole batch before touching any state, so a bad entry
        # cannot leave earlier prompts half-admitted.
        if len(batch_uids) != len(batch_tokens):
            raise ValueError(f"{len(batch_uids)} uids vs {len(batch_tokens)} "
                             "token lists")
        seen = set()
        for uid, toks in zip(batch_uids, batch_tokens):
            if uid in self.state_manager or uid in seen:
                raise ValueError(f"uid {uid} already active")
            if not len(toks):
                raise ValueError(f"uid {uid}: empty prompt")
            seen.add(uid)
        for uid, toks in zip(batch_uids, batch_tokens):
            self.admit(uid, toks)
        schedule = self.scheduler.next_schedule()
        if not schedule:
            return None, None
        try:
            rb = build_ragged_batch(schedule, self.state_manager,
                                    self.scheduler.token_budget)
        except KVCacheExhausted:
            # Nothing ran.  Roll mid-prefill prompts that next_schedule
            # promoted into the decode set back to the head of the prefill
            # queue (reversed: each demote lands at the head).
            for seq, _n in reversed(schedule):
                if seq.uncached > 1:
                    self.scheduler.demote(seq.uid)
            raise
        args = self._bucket_args(rb)
        mc, bs = self.model_config, self.cfg.block_size
        if sample is None:
            logits, _, _ = ragged_forward(*args, cfg=mc, block_size=bs)
            return rb, logits
        toks, _, _ = ragged_forward_sampled(
            *args, generator=sample["generator"],
            temperature=max(sample["temperature"], 1e-6), cfg=mc,
            block_size=bs, greedy=(sample["temperature"] <= 0),
            top_k=sample.get("top_k", 0), top_p=sample.get("top_p"))
        return rb, toks

    def put(self, batch_uids: Sequence[int],
            batch_tokens: Sequence[Sequence[int]]) -> Dict[int, np.ndarray]:
        """Admit prompts and run ONE ragged step (ref engine_v2.py:30 put).

        Returns {uid: next-token logits} for sequences whose full prompt (or
        pending decode token) was processed this step; uids mid-prefill
        return nothing yet — call put([], []) again to continue.
        """
        rb, logits = self._ragged_step(batch_uids, batch_tokens)
        if rb is None:
            return {}
        logits_np = logits.cpu().numpy()
        return {uid: logits_np[slot] for slot, uid in rb.uids_by_slot.items()}

    def admit(self, uid: int, tokens: Sequence[int], priority: int = 0,
              front: bool = False, cached_blocks: Sequence[int] = (),
              num_cached: int = 0) -> None:
        """Open a sequence and schedule it WITHOUT running a step.

        ``priority`` orders the SplitFuse queues (higher first);
        ``front=True`` requeues ahead of every waiting prompt (preempted-
        request requeue).  ``cached_blocks``/``num_cached`` seed the
        sequence with adopted prefix-cache pages whose KV already holds the
        first ``num_cached`` tokens (ownership transfers to the sequence).
        """
        if uid in self.state_manager:
            raise ValueError(f"uid {uid} already active")
        if not len(tokens):
            raise ValueError(f"uid {uid}: empty prompt")
        self.state_manager.open(uid, [int(x) for x in tokens],
                                cached_blocks=cached_blocks,
                                num_cached=num_cached)
        self.scheduler.add(uid, priority=priority, front=front)

    def step(self, temperature: float = 0.0,
             key: Optional[torch.Generator] = None, top_k: int = 0,
             top_p: float = 1.0, return_logits: bool = False
             ) -> Dict[int, Any]:
        """Run ONE ragged step over currently-scheduled work.

        Returns ``{uid: sampled_token}`` for every sequence whose pending
        work completed this step (``{uid: logits_row}`` with
        ``return_logits=True``), or ``{}`` when nothing is scheduled.
        ``key`` is a ``torch.Generator`` on the engine's device (default:
        the engine's own).  Raises ``KVCacheExhausted`` (scheduler state
        rolled back, nothing run) when the step needs more KV pages than
        remain — preempt a victim and retry.
        """
        if self.chaos is not None:
            # "engine.step" injection point (resilience/chaos.py)
            for f in self.chaos.fire("engine.step"):
                if f.kind == "slow_replica":
                    time.sleep(float(f.params.get("delay_ms", 50.0)) / 1e3)
                elif f.kind == "replica_crash":
                    from deepspeed_tpu_torch.resilience.chaos import ChaosError
                    raise ChaosError("injected replica_crash (engine.step)")
        tr = self.tracer
        sp = None
        if tr is not None and tr.enabled:
            if not self.trace_id:   # standalone use: one stable id
                self.trace_id = tr.new_trace_id()
            sp = tr.span("v2.ragged_step", self.trace_id)
        try:
            return self._step_impl(temperature, key, top_k, top_p,
                                   return_logits)
        finally:
            if sp is not None:
                sp.end()

    def _step_impl(self, temperature: float, key, top_k: int, top_p: float,
                   return_logits: bool) -> Dict[int, Any]:
        if return_logits:
            rb, logits = self._ragged_step([], [])
            if rb is None:
                return {}
            logits_np = logits.cpu().numpy()
            return {uid: logits_np[slot]
                    for slot, uid in rb.uids_by_slot.items()}
        top_k, top_p = check_sampling_params(top_k, top_p,
                                             self.model_config.vocab_size)
        rb, toks = self._ragged_step(
            [], [], sample={"generator": key or self._step_gen,
                            "temperature": temperature,
                            "top_k": top_k, "top_p": top_p})
        if rb is None:
            return {}
        toks_np = toks.cpu().numpy()
        return {uid: int(toks_np[slot])
                for slot, uid in rb.uids_by_slot.items()}

    def extend(self, uid: int, token: int) -> None:
        """Append a sampled token so the next step decodes it."""
        self.state_manager.extend(uid, int(token))

    def flush(self, uid: int) -> None:
        """Free a finished sequence's slot and KV pages (ref flush)."""
        self.scheduler.retire(uid)
        self.state_manager.flush(uid)

    def preempt(self, uid: int) -> List[int]:
        """Evict a live sequence, returning every token it knows (prompt +
        generated-so-far).  Recompute-style preemption: the caller requeues
        the list as a fresh prompt; greedy decoding continues bit-
        identically.  Slot and pages are freed immediately."""
        seq = self.state_manager.get(uid)
        tokens = list(seq.tokens)
        self.flush(uid)
        return tokens

    # -- disaggregated serving: KV-block handoff -----------------------
    def kv_geometry(self) -> tuple:
        """Layout fingerprint a handoff payload must match to be
        importable."""
        mc = self.model_config
        return (mc.num_layers, mc.kv_heads, self.cfg.block_size,
                mc.dim_per_head, str(self.cfg.kv_dtype),
                str(self.model_config.dtype))

    @torch.inference_mode()
    def export_kv_chain(self, uid: int) -> Optional[Dict[str, Any]]:
        """Read the FULL KV pages of a live sequence's written prefix —
        the prefill half of a prefill→decode handoff.

        Returns a host payload {tokens, k, v, geom, nbytes, export_ms}
        (k/v as CPU tensors: numpy has no bfloat16) covering
        ``num_cached // block_size`` full blocks, or None when not even one
        full block is written.  Engine-owning thread only.
        """
        t0 = time.perf_counter()
        seq = self.state_manager.get(uid)
        bs = self.cfg.block_size
        n_full = min(seq.num_cached // bs, len(seq.blocks))
        if n_full < 1:
            return None
        rows = torch.cat([torch.arange(b * bs, (b + 1) * bs)
                          for b in seq.blocks[:n_full]]).to(self.device)
        k = _kv_gather(self.cache_k, rows)
        v = _kv_gather(self.cache_v, rows)
        return {"tokens": list(seq.tokens[:n_full * bs]), "k": k, "v": v,
                "geom": self.kv_geometry(),
                "nbytes": _payload_nbytes(k) + _payload_nbytes(v),
                "export_ms": (time.perf_counter() - t0) * 1e3}

    @torch.inference_mode()
    def import_kv_chain(self, payload: Dict[str, Any],
                        skip_blocks: int = 0) -> tuple:
        """Write a handoff payload's pages into THIS engine's cache — the
        decode half of the handoff.  ``skip_blocks`` leading blocks are
        already covered locally; only the tail is allocated and written.
        Returns ``(blocks, n_tokens, bytes_moved)``.  Raises ``ValueError``
        on a geometry mismatch and ``KVCacheExhausted`` when the pool
        cannot host the tail.  Engine-owning thread only.
        """
        if tuple(payload["geom"]) != self.kv_geometry():
            raise ValueError(
                f"handoff payload geometry {payload['geom']} does not "
                f"match this engine's {self.kv_geometry()}; the decode "
                "tier must share the prefill tier's model + KV layout")
        bs = self.cfg.block_size
        n_total = len(payload["tokens"]) // bs
        n_new = n_total - int(skip_blocks)
        if n_new <= 0:
            return [], n_total * bs, 0
        blocks = self.state_manager.allocator.allocate(n_new)
        rows = torch.cat([torch.arange(b * bs, (b + 1) * bs)
                          for b in blocks]).to(self.device)
        lo, hi = skip_blocks * bs, (skip_blocks + n_new) * bs

        def _cut(part):
            if isinstance(part, dict):
                return {key: a[:, :, lo:hi] for key, a in part.items()}
            return part[:, :, lo:hi]

        try:
            k, v = _cut(payload["k"]), _cut(payload["v"])
            _kv_scatter(self.cache_k, self.cache_v, rows, k, v)
        except BaseException:
            # a failed scatter must not leak the freshly-allocated pages
            self.state_manager.allocator.free(blocks)
            raise
        moved = _payload_nbytes(k) + _payload_nbytes(v)
        return blocks, n_total * bs, moved

    # -- speculative decoding: verify-k + draft rewind -----------------
    @torch.inference_mode()
    def verify_step(self, proposals: Dict[int, Sequence[int]]
                    ) -> Dict[int, List[int]]:
        """One ragged verify-k step (greedy only).

        Each uid must be a live sequence with exactly one pending sampled
        token; its ``proposals`` are a draft model's guesses for the next k
        tokens.  The pending token plus the proposals run as one
        prefill-style chunk; the per-row argmax accepts the longest
        agreeing proposal prefix and appends the target's own argmax after
        it, so the returned ``{uid: accepted_tokens}`` (always ≥ 1 token)
        is bit-identical to one-at-a-time greedy decoding.  Raises
        ``KVCacheExhausted`` with every sequence rolled back.
        """
        mgr = self.state_manager
        total = 0
        for uid, props in proposals.items():
            if mgr.get(uid).uncached != 1:
                raise ValueError(
                    f"verify_step: uid {uid} has "
                    f"{mgr.get(uid).uncached} uncached tokens; "
                    "speculative verification needs exactly the one "
                    "pending sampled token")
            total += 1 + len(props)
        if total > self.scheduler.token_budget:
            raise ValueError(
                f"verify_step: {total} tokens exceed the ragged budget "
                f"{self.scheduler.token_budget}; lower spec_k")
        schedule = []
        saved: Dict[int, tuple] = {}
        for uid, props in proposals.items():
            seq = mgr.get(uid)
            saved[uid] = (len(seq.tokens), seq.num_cached)
            seq.tokens.extend(int(t) for t in props)
            schedule.append((seq, 1 + len(props)))
        try:
            rb = build_ragged_batch(schedule, mgr,
                                    self.scheduler.token_budget)
        except KVCacheExhausted:
            for uid, (n_tok, _nc) in saved.items():
                del mgr.get(uid).tokens[n_tok:]
            raise
        nxt, _, _ = ragged_forward_verify(*self._bucket_args(rb),
                                          cfg=self.model_config,
                                          block_size=self.cfg.block_size)
        nxt = nxt.cpu().numpy()
        out: Dict[int, List[int]] = {}
        cursor = 0
        for seq, n_new in schedule:
            rows = nxt[cursor:cursor + n_new]
            cursor += n_new
            n_tok, nc0 = saved[seq.uid]
            props = seq.tokens[n_tok:]
            m = 0
            while m < len(props) and int(props[m]) == int(rows[m]):
                m += 1
            accepted = [int(t) for t in props[:m]] + [int(rows[m])]
            # rewind: keep the accepted prefix + bonus; positions
            # nc0..nc0+m ran with correct inputs, the rest is garbage
            del seq.tokens[n_tok + m:]
            seq.tokens.append(int(rows[m]))
            seq.num_cached = nc0 + m + 1
            out[seq.uid] = accepted
        return out

    def rewind(self, uid: int, tokens: Sequence[int],
               num_cached: int) -> None:
        """Reset a live sequence's host-side view (draft-model rewind
        after speculative rejection).  ``num_cached`` may only shrink."""
        seq = self.state_manager.get(uid)
        if num_cached > seq.num_cached:
            raise ValueError(
                f"rewind: num_cached {num_cached} > written "
                f"{seq.num_cached} — rewind cannot invent KV")
        seq.tokens = [int(t) for t in tokens]
        seq.num_cached = int(num_cached)
        if seq.uncached > 1:
            self.scheduler.demote(uid)

    @property
    def free_blocks(self) -> int:
        return self.state_manager.allocator.free_blocks

    def seq_blocks(self, n_tokens: int) -> int:
        """KV pages a sequence of ``n_tokens`` tokens occupies — THE page
        accounting rule; admission layers use it rather than re-derive it."""
        return -(-int(n_tokens) // self.cfg.block_size)

    @property
    def max_seq_blocks(self) -> int:
        """Hard per-sequence page cap (pool size and block-table width)."""
        return min(self.cfg.num_blocks - 1,
                   self.state_manager.max_blocks_per_seq)

    # ------------------------------------------------------------------
    def generate(self, prompts: Sequence[Sequence[int]], max_new_tokens: int = 32,
                 temperature: float = 0.0, seed: int = 0,
                 eos_token_id: Optional[int] = None, top_k: int = 0,
                 top_p: float = 1.0) -> List[List[int]]:
        """Continuous-batching generation loop over token prompts.
        ``top_k``/``top_p`` restrict temperature sampling to the top-k
        logits / the top-p nucleus; 0 / 1.0 disable them."""
        top_k, top_p = check_sampling_params(top_k, top_p,
                                             self.model_config.vocab_size)
        uids = list(range(len(prompts)))
        remaining = {u: max_new_tokens for u in uids}
        outputs: Dict[int, List[int]] = {u: [] for u in uids}
        pending = list(zip(uids, prompts))
        step_gen = torch.Generator(device=self.device).manual_seed(seed)
        decode_gen = torch.Generator(device=self.device).manual_seed(
            seed ^ 0x5EED)
        while pending or any(u in self.state_manager for u in uids):
            # Pure-decode phase: every live sequence is waiting on exactly
            # its one pending sampled token -> fused multi-step decode
            active_uids = [u for u in uids if u in self.state_manager]
            if (not pending and active_uids
                    and all(self.state_manager.get(u).uncached == 1
                            for u in active_uids)):
                self._fused_decode(active_uids, remaining, outputs,
                                   temperature, decode_gen, eos_token_id,
                                   top_k=top_k, top_p=top_p)
                continue
            admit_uids, admit_toks = [], []
            # Active sequences will still claim pages as they decode: reserve
            # their remaining future blocks so admission never overcommits.
            reserved = 0
            for u in uids:
                if u in self.state_manager:
                    seq = self.state_manager.get(u)
                    final = self.seq_blocks(len(seq.tokens) + remaining[u])
                    reserved += max(0, final - len(seq.blocks))
            # Admit while slots and KV pages allow (continuous batching).
            while pending and (self.state_manager.n_active + len(admit_uids)
                               < self.state_manager.max_seqs):
                u, toks = pending[0]
                need = self.seq_blocks(len(toks) + max_new_tokens)
                if need > self.max_seq_blocks:
                    raise RuntimeError(
                        f"prompt uid {u} needs {need} KV blocks but the cache "
                        f"allows {self.max_seq_blocks} per sequence; "
                        "raise num_blocks/max_context or shorten the prompt")
                if need + reserved > self.state_manager.allocator.free_blocks:
                    break
                pending.pop(0)
                reserved += need
                admit_uids.append(u)
                admit_toks.append(toks)
            if pending and not admit_uids and self.state_manager.n_active == 0:
                raise RuntimeError("cannot admit any pending prompt: KV cache "
                                   "too fragmented/small for the workload")
            # mixed prefill/decode step with on-device sampling: only
            # [max_seqs+1] int32 tokens cross to the host
            rb, toks = self._ragged_step(
                admit_uids, admit_toks,
                sample={"generator": step_gen, "temperature": temperature,
                        "top_k": top_k, "top_p": top_p})
            toks_np = toks.cpu().numpy() if rb is not None else None
            results = ({} if rb is None
                       else {uid: int(toks_np[slot])
                             for slot, uid in rb.uids_by_slot.items()})
            for uid, nxt in results.items():
                outputs[uid].append(nxt)
                remaining[uid] -= 1
                done = remaining[uid] <= 0 or (eos_token_id is not None
                                               and nxt == eos_token_id)
                if done:
                    self.flush(uid)
                else:
                    self.extend(uid, nxt)
        return [outputs[u] for u in uids]

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def _fused_decode(self, uids: List[int], remaining: Dict[int, int],
                      outputs: Dict[int, List[int]], temperature: float,
                      generator: torch.Generator,
                      eos_token_id: Optional[int], top_k: int = 0,
                      top_p=None) -> None:
        """One fused decode chunk for all live sequences
        (ragged_decode_loop); chunk sizes are power-of-two bucketed."""
        mgr = self.state_manager
        chunk = min(min(remaining[u] for u in uids),
                    self.cfg.max_decode_chunk)
        if chunk > 1:  # round UP to a power of two; overshot tokens are
            # masked off below (their KV writes die with the flushed seq)
            chunk = 1 << (chunk - 1).bit_length()
        # ...but the overshoot must stay within every sequence's block
        # table, and ensure_capacity raises rather than clamps
        cap_tokens = mgr.max_blocks_per_seq * mgr.block_size
        headroom = min(cap_tokens - mgr.get(u).num_cached for u in uids)
        chunk = max(1, min(chunk, headroom))
        # ...and within the shared POOL: halve back until the whole
        # chunk's new pages fit; chunk=1 always fits the reservation
        bs2 = mgr.block_size

        def _pages_needed(c: int) -> int:
            return sum(max(0, -(-(mgr.get(u).num_cached + c) // bs2)
                           - len(mgr.get(u).blocks)) for u in uids)

        while chunk > 1 and _pages_needed(chunk) > mgr.allocator.free_blocks:
            chunk //= 2
        s_rows = mgr.max_seqs
        tokens0 = np.zeros((s_rows,), np.int32)
        ctx0 = np.zeros((s_rows,), np.int32)
        active = np.zeros((s_rows,), bool)
        nb_needed = 1
        for u in uids:
            seq = mgr.get(u)
            mgr.ensure_capacity(seq, seq.num_cached + chunk)
            tokens0[seq.slot] = seq.tokens[-1]
            ctx0[seq.slot] = seq.num_cached
            active[seq.slot] = True
            nb_needed = max(nb_needed, len(seq.blocks))
        nb_bucket = min(_pow2_at_least(nb_needed), mgr.max_blocks_per_seq)
        tables = np.zeros((s_rows, nb_bucket), np.int32)
        for u in uids:
            seq = mgr.get(u)
            tables[seq.slot, :len(seq.blocks)] = seq.blocks

        sampled, _, _, _ = ragged_decode_loop(
            self.params, self.cache_k, self.cache_v,
            self._dev(tokens0), self._dev(ctx0), self._dev(active),
            self._dev(tables), generator, max(temperature, 1e-6),
            cfg=self.model_config, block_size=self.cfg.block_size,
            n_steps=chunk, greedy=(temperature <= 0), top_k=top_k,
            top_p=top_p)
        sampled = sampled.cpu().numpy()  # [chunk, s_rows]
        for u in uids:
            seq = mgr.get(u)
            toks = [int(x) for x in sampled[:, seq.slot]]
            take = min(chunk, remaining[u])  # overshoot from round-up
            cut = take
            if eos_token_id is not None and eos_token_id in toks[:take]:
                cut = toks.index(eos_token_id) + 1
            seq.tokens.extend(toks)
            seq.num_cached += chunk
            outputs[u].extend(toks[:cut])
            remaining[u] -= cut
            if cut < take or remaining[u] <= 0:
                self.flush(u)


def build_engine(model: TransformerConfig, engine_config: Optional[Dict] = None,
                 model_params: Optional[Any] = None, **kw) -> InferenceEngineV2:
    """Factory (ref build_hf_engine, inference/v2/engine_factory.py:69)."""
    return InferenceEngineV2(model, engine_config, model_params=model_params, **kw)
