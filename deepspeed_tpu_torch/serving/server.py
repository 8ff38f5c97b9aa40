"""MII-style async serving loop over ``InferenceEngineV2``.

Analog of DeepSpeed-MII's ``RaggedBatchBase``/``MIIPipeline`` serve thread
(mii/batching/ragged_batching.py): the server owns an engine on a
background thread and exposes an async request API —

    server = InferenceServer(engine)
    server.start()
    stream = server.submit([1, 2, 3], SamplingParams(max_new_tokens=16))
    for tok in stream:          # tokens appear as they are decoded
        ...
    server.stop()               # graceful drain

Loop anatomy (docs/SERVING.md has the diagram):

    submit() → bounded queue → admission (slots + KV watermarks)
             → SplitFuse scheduler → engine.step() → per-request streams

Robustness: cancellation and deadlines are swept every iteration; KV
exhaustion preempts the lowest-priority/youngest running request
(recompute-style requeue at the front of the queue) instead of crashing;
``stop()`` drains in-flight work before joining the thread.

Threading contract: the engine is touched ONLY by the serve thread.
``submit``/``cancel``/stream reads are safe from any thread.  Sampling
runs on-device when every running request is greedy (one int32 per slot
crosses to the host); any non-greedy request switches the step to the
full-logits path with per-request host RNGs, so heterogeneous sampling
params coexist in one ragged batch.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2.ragged import KVCacheExhausted
from deepspeed_tpu_torch.serving.admission import (BROWNOUT_LEVELS,
                                             AdmissionConfig,
                                             AdmissionController,
                                             BrownoutConfig, brownout_index)
from deepspeed_tpu_torch.serving.metrics import ServingMetrics
from deepspeed_tpu_torch.serving.prefix_cache import PrefixCache, PrefixCacheConfig
from deepspeed_tpu_torch.serving.request import (DeadlineExceeded,
                                           GenerationRequest,
                                           RequestCancelled, RequestShed,
                                           ResponseStream, SamplingParams,
                                           ServingError)
from deepspeed_tpu_torch.telemetry.flight import (Watchdog, dump_bundle,
                                            make_span_recorder,
                                            make_watchdog)
from deepspeed_tpu_torch.utils.logging import log_dist

# ladder positions consulted on the hot paths (admission/spec/submit) —
# resolved once so enforcement is integer compares, not tuple scans
_BL_SHED_SPEC = brownout_index("shed_speculation")
_BL_CAP_DECODE = brownout_index("cap_decode")
_BL_SHED_LOW = brownout_index("shed_low_priority")
_BL_REJECT_NEW = brownout_index("reject_new")


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max()
    e = np.exp(x)
    return e / e.sum()


def _host_sample(logits: np.ndarray, params: SamplingParams,
                 rng: np.random.Generator) -> int:
    """Numpy twin of ``model.sample_tokens`` for the heterogeneous-
    sampling step (greedy argmax is bit-identical to the device path)."""
    if params.greedy:
        return int(np.argmax(logits))
    x = logits.astype(np.float64) / max(params.temperature, 1e-6)
    if params.top_k > 0:
        kth = np.sort(x)[-min(params.top_k, x.size)]
        x = np.where(x >= kth, x, -np.inf)
    if params.top_p < 1.0:
        order = np.argsort(-x)
        p_sorted = _softmax(x[order])
        keep = (np.cumsum(p_sorted) - p_sorted) < params.top_p
        kept = order[keep]
        masked = np.full_like(x, -np.inf)
        masked[kept] = x[kept]
        x = masked
    return int(rng.choice(x.size, p=_softmax(x)))


class ServerConfig:
    def __init__(self, d: Optional[dict] = None, **kw):
        d = {**(d or {}), **kw}
        self.admission = AdmissionConfig(d.get("admission", {}))
        # paged prefix cache (serving/prefix_cache.py): shared-prefix
        # requests adopt already-written KV pages instead of re-prefilling
        self.prefix_cache = PrefixCacheConfig(d.get("prefix_cache", {}))
        # how long the idle loop parks before re-sweeping deadlines
        self.idle_wait_s = float(d.get("idle_wait_s", 0.02))
        # namespaces monitor-export tags (serving/<label>/…) so N replica
        # servers under one router stay distinguishable
        self.metrics_label = str(d.get("metrics_label", ""))
        # export metrics through `monitor` every N engine steps (0 = only
        # at stop()); the monitor is any object with write_events()
        self.metrics_interval_steps = int(d.get("metrics_interval_steps", 0))
        # time-bound the latency percentile windows (seconds; 0 = count-
        # bounded only): under a FleetSampler an idle replica's p95 must
        # decay instead of pinning at its last burst
        self.metrics_window_s = float(d.get("metrics_window_s", 0.0))
        # standalone span tracing / flight recorder (same keys as the
        # engine's telemetry.tracing / telemetry.flight blocks); ignored
        # when a telemetry hub is passed — the hub's tracer/ring win so
        # train + serve spans land in ONE trace file
        self.tracing = dict(d.get("tracing", {}))
        self.flight = dict(d.get("flight", {}))
        # graceful-degradation ladder knobs (admission.py BrownoutConfig);
        # the LEVEL is pushed by a FleetSupervisor via set_brownout — a
        # standalone server stays at "normal" forever
        self.brownout = BrownoutConfig(d.get("brownout", {}))


class InferenceServer:
    """Continuous-batching serve loop owning one ``InferenceEngineV2``."""

    def __init__(self, engine: InferenceEngineV2,
                 config: Optional[dict] = None, monitor: Any = None,
                 telemetry: Any = None, spec_decoder: Any = None):
        self.engine = engine
        self.cfg = ServerConfig(config)
        self.monitor = monitor
        # speculative decoding (serving/disagg.py SpeculativeDecoder): a
        # draft model living in this serve loop.  Anything with
        # round()/flush() works; None disables per-request `speculative`
        self._spec = spec_decoder
        # a telemetry.Telemetry hub: serving histograms register in ITS
        # registry (one Prometheus exposition for both hot loops) and the
        # loop emits kind="serving" StepRecords to the same JSONL
        self.telemetry = telemetry
        self.metrics = ServingMetrics(
            registry=telemetry.registry if telemetry is not None else None,
            label=self.cfg.metrics_label,
            window_s=self.cfg.metrics_window_s)
        self.admission = AdmissionController(self.cfg.admission)
        # owned and touched ONLY by the serve thread (like the engine);
        # refcounts on the engine's allocator keep shared pages safe
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(self.cfg.prefix_cache, engine.state_manager.allocator,
                        engine.cfg.block_size)
            if self.cfg.prefix_cache.enabled else None)
        # -- spans + flight recorder (telemetry/tracing.py, flight.py) --
        # one hub predicate (`telemetry is not None`) at every site — it
        # must agree with stop()'s standalone-trace-export gate or a hub
        # that took this branch would record spans nobody exports
        if telemetry is not None:
            self.tracer = telemetry.tracer
            self._flight_ring = telemetry.flight_ring
        else:
            # same bootstrap rule as the Telemetry hub (one shared
            # factory: flight alone also enables span recording so
            # bundle rings are populated)
            self.tracer, self._flight_ring = make_span_recorder(
                tracing_enabled=self.cfg.tracing.get("enabled", False),
                flight_enabled=self.cfg.flight.get("enabled", False),
                max_events=self.cfg.tracing.get("max_events", 0),
                ring_size=self.cfg.flight.get("ring_size", 0))
        self.admission.tracer = self.tracer
        # trace export gated on the tracing block itself (flight-only
        # configs record spans for the ring but write no trace file)
        self._trace_path = (str(self.cfg.tracing.get("trace_path", ""))
                            if self.cfg.tracing.get("enabled") else "")
        self._loop_trace_id = (self.tracer.new_trace_id()
                               if self.tracer.enabled else "")
        self._watchdog: Optional[Watchdog] = None
        self._flight_dir: Optional[str] = None
        # the watchdog skips this process's first engine.step (jit
        # compile time is not a stall) — see _step_once
        self._first_engine_step_done = False
        if telemetry is not None:
            # hub present: its flight block decides, server blocks are
            # ignored end-to-end — building a watchdog from the server's
            # flight config here would pair it with the hub's (possibly
            # disabled) tracer and dump forever-empty rings
            self._watchdog = telemetry.make_watchdog("serve")
            if self._watchdog is not None:
                self._flight_dir = self._watchdog.output_dir
        else:
            # same factory as the hub: falsy config values (deadline_s 0,
            # empty output_dir) must fall back identically on both paths
            self._watchdog = make_watchdog(
                "serve", self.cfg.flight, ring=self._flight_ring,
                telemetry=telemetry, tracer=self.tracer)
            if self._watchdog is not None:
                self._flight_dir = self._watchdog.output_dir
        # fault injection (resilience/chaos.py): attach_chaos wires an
        # injector here; None keeps the loop at one attr check per tick
        self._chaos = None
        # graceful-degradation ladder position (index into
        # BROWNOUT_LEVELS); written via set_brownout from the supervisor
        # thread, read by the serve loop + submit — int store/load, no lock
        self._brownout = 0
        # liveness-probe surface (serving/supervisor.py FleetSupervisor):
        # the serve loop stamps loop_beat_t every iteration and folds each
        # engine-step wall time into step_ema_s — a stale beat with queued
        # work means "stuck", a step EMA far above the peer median means
        # "straggler".  Plain attribute writes: probes tolerate staleness.
        self.loop_beat_t: Optional[float] = None
        self.loop_iters = 0
        self.step_ema_s = 0.0
        self._active: Dict[int, GenerationRequest] = {}
        self._uid = itertools.count()
        self._uid_lock = threading.Lock()
        self._rngs: Dict[int, np.random.Generator] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop_requested = False
        self._abort = False
        self._loop_error: Optional[BaseException] = None
        # per-seq hard cap, checked at submit so an impossible request
        # fails fast instead of crashing the loop mid-decode (page
        # accounting lives in the ENGINE — engine.seq_blocks — so
        # admission and allocator can never disagree)
        self._total_blocks = engine.cfg.num_blocks - 1

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "InferenceServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        if self._stop_requested or self._loop_error is not None:
            # stop() closed admission and left the terminal flags set; a
            # "restarted" loop would exit immediately while submits get
            # QueueFull — fail loudly instead of running dead
            raise RuntimeError(
                "server already stopped; create a new InferenceServer")
        if self._watchdog is not None:
            self._watchdog.on_fire = \
                lambda _bundle: self.metrics.record_flight_dump()
            self._watchdog.start()
        # the engine annotates its ragged dispatch into the same trace,
        # chained to this loop's trace id
        if hasattr(self.engine, "tracer"):
            self.engine.tracer = self.tracer
            self.engine.trace_id = self._loop_trace_id
        if self._spec is not None:
            # spec.draft / spec.verify spans + accept-rate counters land
            # in THIS loop's trace and registry
            self._spec.bind(self.tracer, self._loop_trace_id, self.metrics)
        self._thread = threading.Thread(target=self._serve_loop,
                                        name="ds-serve-loop", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Stop the loop.  ``drain=True`` finishes all queued + running
        requests first; ``drain=False`` cancels them.

        Fail-fast contract: a crashed loop must not make a draining
        ``stop()`` wait out the full timeout — the join polls, and the
        moment ``_loop_error`` is set (the crash handler records it
        FIRST, before any cleanup that might itself wedge on the broken
        engine) the wait collapses to a short grace period and the loop
        error is raised, chained."""
        self.admission.close()
        self._stop_requested = True
        if not drain:
            self._abort = True
        thread = self._thread
        if thread is not None:
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            while thread.is_alive():
                if self._loop_error is not None:
                    # dead loop: give its crash handler a short grace to
                    # terminate the streams, then surface the error
                    # below instead of waiting out the drain timeout
                    thread.join(1.0)
                    break
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(f"serve loop still running after "
                                       f"{timeout}s (drain={drain})")
                thread.join(0.05)
            self._thread = None
        if self._watchdog is not None:
            self._watchdog.stop()
        if self.prefix_cache is not None:
            # every sequence is flushed by now, so all entries are
            # cache-only owners — return the pool whole to the engine
            self.prefix_cache.clear()
        if (self.telemetry is None and self._trace_path
                and self.tracer.enabled):
            # standalone tracer: nobody else will flush the trace file
            # (with a hub, Telemetry.close() owns the export)
            try:
                self.tracer.export_chrome_trace(self._trace_path)
            except OSError as e:
                log_dist(f"serving: trace export failed: {e}",
                         level="warning")
        if self.monitor is not None:
            self.metrics.write_to(self.monitor, self.metrics.snapshot()["steps"])
        if self.telemetry is not None:
            self.telemetry.record_serving_step(self.metrics.steps,
                                               self.metrics.snapshot())
        if self._loop_error is not None:
            raise RuntimeError("serve loop died") from self._loop_error

    def __enter__(self) -> "InferenceServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=not any(exc))

    # -- graceful degradation (admission.py BROWNOUT_LEVELS) -------------
    @property
    def brownout_level(self) -> str:
        return BROWNOUT_LEVELS[self._brownout]

    def set_brownout(self, level: str) -> None:
        """Move this server to a ladder level (idempotent; any thread).
        The supervisor is the normal caller — levels compose downward, so
        ``reject_new`` also sheds low priority, caps decode concurrency
        and disables speculation."""
        self._brownout = brownout_index(level)

    # -- client API ------------------------------------------------------
    def submit(self, prompt: Sequence[int],
               params: Optional[SamplingParams] = None, priority: int = 0,
               deadline_s: Optional[float] = None,
               timeout: Optional[float] = None, handoff: bool = False,
               kv_payload: Any = None, trace_id: str = "",
               parent_span: Any = None) -> ResponseStream:
        """Enqueue one generation request; returns its stream immediately.

        ``deadline_s`` is a wall budget from now — queued or mid-decode,
        the request fails with ``DeadlineExceeded`` once it passes.
        ``timeout`` only applies to the enqueue itself under the "block"
        queue policy.  Raises ``QueueFull`` (reject policy / closed
        server) or ``ValueError`` for requests no admission order could
        ever run.

        Disaggregated tiers (serving/disagg.py): ``handoff=True`` makes
        the serve loop export the sequence's full KV blocks onto
        ``stream.handoff_payload`` at completion (the prefill leg);
        ``kv_payload`` hands such an export IN — admission adopts the
        covered pages instead of re-prefilling them (the decode leg).

        ``trace_id``/``parent_span`` stitch this request into a caller's
        existing trace (the router passes its routed-request span so a
        disagg request's prefill and decode legs chain under ONE
        trace_id); by default each request roots its own trace.
        ``parent_span`` must come from THIS server's tracer — span ids
        are per-tracer counters, so a foreign span would alias.
        """
        params = params or SamplingParams()
        if not len(prompt):
            raise ValueError("empty prompt")
        if params.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {params.max_new_tokens}")
        # same boundary contract as model.check_sampling_params — a
        # degenerate value must fail HERE, not crash the serve loop at
        # this request's first sampled token (top_p=0 masks every logit)
        if not (0.0 < float(params.top_p) <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {params.top_p}")
        if params.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {params.top_k}")
        need = self.engine.seq_blocks(len(prompt) + params.max_new_tokens)
        if need > self.engine.max_seq_blocks:
            raise ValueError(
                f"prompt+output needs {need} KV blocks but the engine "
                f"allows {self.engine.max_seq_blocks} per sequence; raise "
                "num_blocks/max_context or shorten the request")
        # brownout gate: a shed submit is load shedding, not a failure —
        # typed RequestShed, counted as submitted + rejected + shed (the
        # same accounting shape as a QueueFull reject)
        lvl = self._brownout
        if lvl >= _BL_SHED_LOW:
            if lvl >= _BL_REJECT_NEW \
                    or priority < self.cfg.brownout.priority_floor:
                self.metrics.record_submit()
                self.metrics.record_reject()
                self.metrics.record_shed()
                raise RequestShed(
                    f"request shed at brownout level "
                    f"{BROWNOUT_LEVELS[lvl]!r} (priority={priority})")
        with self._uid_lock:
            uid = next(self._uid)
        req = GenerationRequest(
            uid=uid, prompt=list(prompt), params=params,
            stream=ResponseStream(uid), priority=priority,
            deadline=(None if deadline_s is None
                      else time.monotonic() + deadline_s),
            handoff=handoff, kv_payload=kv_payload)
        tr = self.tracer
        if tr.enabled:
            req.trace_id = req.stream.trace_id = (trace_id
                                                  or tr.new_trace_id())
            req.span_request = tr.span("serve.request", req.trace_id,
                                       parent_span).set(
                uid=uid, prompt_tokens=len(req.prompt),
                max_new_tokens=params.max_new_tokens)
            tr.instant("serve.enqueue", req.trace_id, uid=uid)
            req.span_phase = tr.span("serve.queue_wait", req.trace_id,
                                     req.span_request)
        self.metrics.record_submit()
        try:
            self.admission.offer(req, timeout=timeout)
        except ServingError:
            self.metrics.record_reject()
            if req.span_request is not None:
                req.span_phase.end(rejected=True)
                req.span_request.end(outcome="rejected")
            raise
        return req.stream

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 32, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0,
                 eos_token_id: Optional[int] = None) -> List[List[int]]:
        """Blocking convenience wrapper: ``engine.generate()`` parity
        through the serving path (used by tests and the bench row)."""
        streams = [self.submit(p, SamplingParams(
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, top_p=top_p, eos_token_id=eos_token_id, seed=i))
            for i, p in enumerate(prompts)]
        return [s.result() for s in streams]

    # -- serve loop ------------------------------------------------------
    def _serve_loop(self) -> None:
        wd = self._watchdog
        try:
            while True:
                if wd is not None:
                    wd.beat()
                self.loop_beat_t = time.monotonic()
                self.loop_iters += 1
                if self._chaos is not None:
                    self._chaos_tick(self._chaos)
                if self._abort:
                    self._fail_everything(
                        RequestCancelled("server shutdown"))
                    return
                now = time.monotonic()
                self._sweep_queue(now)
                self._sweep_active(now)
                self._try_admit(now)
                self._update_gauges()
                if self.engine.scheduler.has_work:
                    self._step_once()
                elif self._stop_requested and len(self.admission) == 0 \
                        and not self._active:
                    return
                else:
                    self.admission.wait_for_work(self.cfg.idle_wait_s)
        except BaseException as e:  # never die silently: fail the streams
            # error FIRST: stop() fail-fasts on this flag, and the
            # cleanup below may itself wedge on the broken engine
            self._loop_error = e
            # close next: a submit() racing the cleanup must get
            # QueueFull, not an accepted request nobody will ever serve
            self.admission.close()
            if wd is not None:
                # a dead loop stops beating by definition — silence the
                # watchdog so the crash isn't double-reported as a stall
                wd.pause()
            log_dist(f"serving: loop crashed: {e!r}", level="error")
            self._dump_flight("serve_crash", e)
            self._fail_everything(ServingError(f"serve loop died: {e!r}"))

    def _chaos_tick(self, ch: Any) -> None:
        """The ``server.step`` injection point: act on every due fault
        (resilience/chaos.py decides *when*; the semantics live here).
        Crashes/hangs deliberately ride the loop's real failure paths —
        a ChaosError is indistinguishable from an organic death."""
        from deepspeed_tpu_torch.resilience.chaos import ChaosError
        for f in ch.fire("server.step"):
            kind = f.kind
            if kind == "replica_crash":
                raise ChaosError(
                    f"injected replica_crash on {ch.target}")
            if kind == "replica_hang":
                # simulated wedge: thread alive, no beats, no progress.
                # Only stop()/kill() (the supervisor's quarantine path)
                # clears it; surfacing as a crash afterwards fails the
                # in-flight streams over instead of hanging them forever.
                while not self._stop_requested:
                    time.sleep(0.01)
                raise ChaosError(
                    f"injected replica_hang on {ch.target} "
                    "(cleared by stop)")
            if kind == "slow_replica":
                time.sleep(float(f.params.get("delay_ms", 50.0)) / 1e3)
            elif kind == "cancel_storm":
                # deterministic victims: the lowest-priority actives
                n = int(f.params.get("count", 2))
                victims = sorted(self._active.values(),
                                 key=lambda r: (r.priority, r.uid))[:n]
                for v in victims:
                    v.stream.cancel()
            elif kind == "admission_storm":
                burst = int(f.params.get("burst", 8))
                pr = int(f.params.get("priority", -100))
                mnt = int(f.params.get("max_new_tokens", 4))
                for _ in range(burst):
                    try:
                        self.submit([1, 2, 3],
                                    SamplingParams(max_new_tokens=mnt),
                                    priority=pr)
                    except ServingError:
                        break  # queue full / brownout already shedding

    def _dump_flight(self, reason: str,
                     error: Optional[BaseException] = None) -> None:
        """Crash forensics: ring + stacks + telemetry snapshot bundle
        (no flight config ⇒ no-op)."""
        if self._flight_dir is None:
            return
        try:
            dump_bundle(self._flight_dir, reason, ring=self._flight_ring,
                        telemetry=self.telemetry, error=error)
            self.metrics.record_flight_dump()
        except Exception:
            pass  # forensics must never mask the original failure

    def _fail_everything(self, err: ServingError) -> None:
        for req in self.admission.drain():
            self._finish(req, error=err)
        for uid in list(self._active):
            req = self._active.pop(uid)
            try:
                if uid in self.engine.state_manager:
                    self._flush_seq(uid)
            except Exception:
                # the crash handler may be running BECAUSE engine state
                # is inconsistent — a failing flush must not leave the
                # remaining streams unterminated
                pass
            self._finish(req, error=err)

    def _sweep_queue(self, now: float) -> None:
        """Cancelled/expired requests that never got admitted; under
        ``shed_low_priority``+ the below-floor queued requests shed too
        (strictly the lowest-priority class — the floor rule is the same
        one the submit gate applies to new arrivals)."""
        shed_floor = (self.cfg.brownout.priority_floor
                      if self._brownout >= _BL_SHED_LOW else None)
        # snapshot: drain() would drop healthy requests, so walk a copy
        for req in self.admission.snapshot():
            if req.stream.cancel_requested:
                if self.admission.remove(req):
                    self._finish(req, error=RequestCancelled(
                        f"request {req.uid} cancelled while queued"))
            elif req.expired(now):
                if self.admission.remove(req):
                    self._finish(req, error=DeadlineExceeded(
                        f"request {req.uid} deadline passed while queued"))
            elif shed_floor is not None and req.priority < shed_floor:
                if self.admission.remove(req):
                    self._finish(req, error=RequestShed(
                        f"request {req.uid} (priority={req.priority}) "
                        "shed from queue at brownout level "
                        f"{self.brownout_level!r}"))

    def _sweep_active(self, now: float) -> None:
        for uid in list(self._active):
            req = self._active[uid]
            err = None
            if req.stream.cancel_requested:
                err = RequestCancelled(f"request {uid} cancelled")
            elif req.expired(now):
                err = DeadlineExceeded(f"request {uid} deadline passed "
                                       f"after {req.n_generated} tokens")
            if err is not None:
                del self._active[uid]
                self._flush_seq(uid)
                self._finish(req, error=err)

    def _try_admit(self, now: float) -> None:
        """Admit queue head while slots + KV watermark allow (FIFO — a
        stuck head blocks later arrivals on purpose: skipping it would
        starve big requests under steady small-request load)."""
        eng = self.engine
        pc = self.prefix_cache
        while eng.state_manager.n_active < eng.state_manager.max_seqs:
            if self._brownout >= _BL_CAP_DECODE \
                    and len(self._active) >= self.cfg.brownout.decode_cap:
                # cap_decode: hold admissions so the running set stays
                # small — queued requests wait (outputs stay intact;
                # truncating decode lengths would not be bit-identical)
                break
            req = self.admission.peek()
            if req is None:
                break
            # Adopt the cached prefix FIRST: the acquired refs (>= 2 with
            # the cache's own) pin those pages against the eviction pass
            # below — and against this very request's need (adopted pages
            # are not new allocations).  If admission is abandoned this
            # tick, the refs are released before breaking.
            adopted, n_cached = pc.adopt(req.tokens) if pc else ([], 0)
            # A once-preempted request re-admits on its FULL remaining
            # need: optimistic re-admission would just bounce it through
            # another admit→exhaust→preempt cycle (observed thrash).
            conservative = (self.cfg.admission.reserve_decode
                            or req.preemptions > 0)
            need = eng.seq_blocks(len(req.tokens)
                                  + (req.remaining if conservative else 0)) \
                - len(adopted)
            if self.cfg.admission.reserve_decode:
                need += self._reserved_decode_blocks()
            if not self.admission.kv_admissible(eng, need) and pc:
                # reclaim idle cache pages down to the admission floor
                # before making anyone wait (or preempting live work)
                shortfall = self.admission.admission_shortfall(eng, need)
                if shortfall > 0:
                    pc.evict(shortfall)
            if not self.admission.kv_admissible(eng, need):
                if self._active:
                    if pc:
                        pc.release(adopted)
                    break  # running work will free pages; head waits
                # Progress guarantee: with the engine idle nothing will
                # ever free pages, so the watermark must yield — admit if
                # the request fits at all, else it can never run.
                if need > eng.free_blocks:
                    if pc:
                        pc.release(adopted)
                    assert self.admission.pop() is req
                    self._finish(req, error=ServingError(
                        f"request {req.uid} needs {need} KV blocks; only "
                        f"{eng.free_blocks} exist even with the pool "
                        "drained"))
                    continue
            popped = self.admission.pop()
            assert popped is req
            if req.kv_payload is not None:
                adopted, n_cached = self._import_handoff(req, adopted,
                                                         n_cached)
            eng.admit(req.uid, req.tokens, priority=req.priority,
                      front=req.preemptions > 0, cached_blocks=adopted,
                      num_cached=n_cached)
            if pc:
                self.metrics.record_prefix(n_cached)
                if n_cached and self.tracer.enabled:
                    self.tracer.instant("serve.prefix_hit", req.trace_id,
                                        uid=req.uid, tokens_saved=n_cached)
                # everything known at admission prefills this admission —
                # its full pages become cacheable at the first sampled
                # token (see _step_once)
                req.pending_insert = len(req.tokens)
            first_admission = req.admitted_at is None
            req.admitted_at = now
            if req.span_phase is not None:
                # queue_wait (or post-preemption requeue wait) ends here;
                # the prefill phase runs until this request's next token
                req.span_phase.end()
                req.span_phase = self.tracer.span(
                    "serve.prefill", req.trace_id, req.span_request).set(
                        uid=req.uid, tokens=len(req.tokens),
                        readmission=not first_admission)
            self._rngs.setdefault(
                req.uid, np.random.default_rng(req.params.seed))
            if first_admission:
                # re-admissions after preemption are service time, not
                # queue wait — recording them would double-count the
                # request and skew the distribution
                self.metrics.record_admit(now - req.submitted_at)
            self._active[req.uid] = req

    def _import_handoff(self, req: GenerationRequest, adopted: List[int],
                        n_cached: int):
        """Adopt a prefill replica's handed-off KV chain at admission.

        The payload and the local prefix cache share the chain-keyed
        identity (both are KV for the same leading tokens of
        ``req.tokens``), so any locally-adopted blocks are a prefix of
        the payload's — when the cache already covers the whole payload
        the handoff is a pure ref acquire (zero bytes moved); otherwise
        only the uncovered tail is written device-to-device.  Failures
        degrade to re-running prefill (correctness never depends on the
        import).  Returns the combined ``(cached_blocks, num_cached)``.
        """
        payload = req.kv_payload
        bs = self.engine.cfg.block_size
        pay_blocks = len(payload["tokens"]) // bs
        skip = len(adopted)
        t0 = time.monotonic()
        sp = (self.tracer.span("serve.handoff", req.trace_id,
                               req.span_request)
              if self.tracer.enabled else None)
        moved = 0
        try:
            if self._chaos is not None:
                # "server.handoff" injection point (import side): ride the
                # organic failure path below — degrade to re-prefill
                for f in self._chaos.fire("server.handoff"):
                    if f.kind == "handoff_fail":
                        from deepspeed_tpu_torch.resilience.chaos import ChaosError
                        raise ChaosError("injected handoff_fail (import)")
            if skip < pay_blocks:
                blocks, n_tok, moved = self.engine.import_kv_chain(
                    payload, skip_blocks=skip)
                adopted = list(adopted) + blocks
                n_cached = n_tok
        except Exception as e:  # geometry mismatch / transient exhaustion
            log_dist(f"serving: handoff import for request {req.uid} "
                     f"failed ({e!r}); re-running prefill", level="warning")
            req.kv_payload = None
            if sp is not None:
                sp.end(uid=req.uid, failed=True)
            return adopted, n_cached
        import_s = time.monotonic() - t0
        self.metrics.record_handoff_in(moved, import_s)
        # the router reads these back for the per-request report
        payload["import_ms"] = import_s * 1e3
        payload["import_bytes"] = moved
        if sp is not None:
            sp.end(uid=req.uid, bytes=moved, blocks=len(adopted),
                   zero_copy=(moved == 0))
        return adopted, n_cached

    def _reserved_decode_blocks(self) -> int:
        """generate()-style worst-case growth of the running set (only
        consulted under ``reserve_decode=True``)."""
        eng = self.engine
        reserved = 0
        for req in self._active.values():
            seq = eng.state_manager.get(req.uid)
            final = eng.seq_blocks(len(seq.tokens) + req.remaining)
            reserved += max(0, final - len(seq.blocks))
        return reserved

    def _reclaim_cache(self, n_blocks: int) -> int:
        """Evict up to ``n_blocks`` idle prefix-cache pages (0 without a
        cache) — always tried before preempting live work: recomputing a
        cached prefix later is cheaper than recomputing a live request
        now."""
        if self.prefix_cache is None or n_blocks <= 0:
            return 0
        return self.prefix_cache.evict(n_blocks)

    def _step_once(self) -> None:
        """One engine step; KV exhaustion reclaims cache pages, then
        preempts, and retries next tick."""
        deficit = self.admission.low_watermark_deficit(self.engine)
        if deficit > 0 and len(self._active) > 1:
            # floor hit: reclaim idle cache pages first, shed live work
            # only if that was not enough
            if self._reclaim_cache(deficit) < deficit:
                self._preempt_one()
        all_greedy = all(r.params.greedy for r in self._active.values())
        spec_ready = self._spec_eligible()
        tr = self.tracer
        step_span = tr.span("serve.step", self._loop_trace_id)
        if tr.enabled:
            step_span.set(n_active=len(self._active), greedy=all_greedy,
                          speculative=spec_ready)
        # the first engine.step of the process pays the jit compile,
        # which can legitimately exceed any sane stall deadline — keep
        # the watchdog disarmed for it (same per-process rule as the
        # train engine's first-step skip)
        warm = not self._first_engine_step_done
        if warm and self._watchdog is not None:
            self._watchdog.pause()
        step_t0 = time.monotonic()
        try:
            try:
                if spec_ready:
                    # draft proposes, target verifies in ONE ragged step;
                    # each value is the accepted token burst (>= 1), and
                    # the engine's sequences already carry them
                    emitted = self._spec.round(self._active)
                elif all_greedy:
                    emitted = {u: [t] for u, t in
                               self.engine.step(temperature=0.0).items()}
                else:
                    logits = self.engine.step(return_logits=True)
                    emitted = {u: [_host_sample(out,
                                                self._active[u].params,
                                                self._rngs[u])]
                               for u, out in logits.items()
                               if u in self._active}
                # only a step that actually ran proves the compile is
                # behind us — KVCacheExhausted rolls back with nothing
                # run, so the retry still pays the first jit compile and
                # must keep the watchdog disarmed for it
                self._first_engine_step_done = True
            finally:
                if warm and self._watchdog is not None:
                    self._watchdog.resume()
        except KVCacheExhausted:
            step_span.end(kv_exhausted=True)
            # a step's worth of pages from the cache buys a retry without
            # touching live work; preempt only if the cache came up dry
            want = max(1, self.engine.seq_blocks(
                self.engine.scheduler.token_budget))
            if self._reclaim_cache(want) == 0:
                self._preempt_one()
            return
        except BaseException:
            # close the span before the crash handler runs so the dying
            # step is present in the flight ring it dumps
            step_span.end(crashed=True)
            raise
        step_span.end()
        self.metrics.record_step()
        if not warm:
            # straggler signal for the fleet supervisor: EMA of steady-
            # state step wall time (the compile-paying first step would
            # poison the average for the whole early window)
            dt = time.monotonic() - step_t0
            self.step_ema_s = (dt if self.step_ema_s == 0.0
                               else 0.8 * self.step_ema_s + 0.2 * dt)
        if (self.cfg.metrics_interval_steps and self.metrics.steps
                % self.cfg.metrics_interval_steps == 0):
            if self.monitor is not None:
                self.metrics.write_to(self.monitor, self.metrics.steps)
            if self.telemetry is not None:
                self.telemetry.record_serving_step(self.metrics.steps,
                                                   self.metrics.snapshot())
        now = time.monotonic()
        for uid, burst in emitted.items():
            req = self._active.get(uid)
            if req is None:       # flushed between schedule and fetch
                continue          # (cannot happen today; belt+braces)
            done = False
            for tok in burst:
                tok = int(tok)
                req.tokens.append(tok)
                if self.prefix_cache is not None and req.pending_insert:
                    # first sampled token of this admission ⇒ its prefill
                    # is complete: every full page under the admitted
                    # prefix now holds final KV and becomes shareable.
                    # Must run before any flush below — insert acquires
                    # the cache's refs.
                    seq = self.engine.state_manager.get(uid)
                    self.prefix_cache.insert(
                        req.tokens[:req.pending_insert], seq.blocks)
                    req.pending_insert = 0
                self.metrics.record_tokens(1)
                if req.n_generated == 1:
                    req.first_token_at = now
                    self.metrics.record_first_token(now - req.submitted_at)
                    if req.span_request is not None:
                        tr.instant("serve.first_token", req.trace_id,
                                   uid=uid)
                if (req.span_phase is not None
                        and req.span_phase.name == "serve.prefill"):
                    # prefill → decode at this request's first token of
                    # the current admission (re-prefills transition too)
                    req.span_phase.end()
                    req.span_phase = tr.span("serve.decode", req.trace_id,
                                             req.span_request).set(uid=uid)
                req.stream._put_token(tok)
                if req.span_request is not None:
                    tr.instant("serve.emit", req.trace_id, uid=uid,
                               token=tok)
                eos_hit = (req.params.eos_token_id is not None
                           and tok == req.params.eos_token_id)
                if eos_hit or req.remaining <= 0:
                    # a speculative burst may overshoot eos /
                    # max_new_tokens — undelivered tokens die with the
                    # flushed sequence
                    done = True
                    break
            if done:
                del self._active[uid]
                if req.handoff:
                    # prefill-tier leg: export the finished chain's full
                    # KV blocks for adoption by a decode replica (must
                    # precede the flush that frees them)
                    self._export_handoff(req)
                self._flush_seq(uid)
                self._finish(req)
            elif not spec_ready:
                # speculative bursts were appended to the engine sequence
                # by verify_step itself; a plain step's token must extend
                self.engine.extend(uid, burst[-1])

    def _spec_eligible(self) -> bool:
        """A speculative round needs EVERY active request greedy, opted
        in, and in steady-state decode (exactly one pending sampled
        token) — the decode tier's steady state.  Mixed batches (a
        prefill mid-flight, a non-greedy or non-speculative peer) run
        the plain step; speculation resumes when the batch is
        homogeneous again."""
        if self._spec is None or not self._active:
            return False
        if self._brownout >= _BL_SHED_SPEC:
            # shed_speculation: drop to plain greedy steps — outputs are
            # bit-identical by the acceptance rule, only latency changes,
            # and the draft model's step cost comes off the replica
            return False
        if len(self._active) > self.engine.scheduler.token_budget:
            # even k=0 needs one verify row per sequence; an active set
            # wider than the ragged budget must take the plain step path
            # (the scheduler splits it into budget-sized steps)
            return False
        sm = self.engine.state_manager
        for uid, req in self._active.items():
            p = req.params
            if not (p.greedy and p.speculative):
                return False
            if uid not in sm or sm.get(uid).uncached != 1:
                return False
        return True

    def _flush_seq(self, uid: int) -> None:
        """Release a sequence from the target engine AND the draft
        model's mirror (the speculative decoder self-heals a missing
        mirror, but a leaked one would pin draft KV pages forever)."""
        self.engine.flush(uid)
        if self._spec is not None:
            self._spec.flush(uid)

    def _export_handoff(self, req: GenerationRequest) -> None:
        """Export a completed handoff request's full KV blocks onto its
        stream (the prefill-tier half of a prefill→decode handoff).
        Failure degrades to no payload — the decode leg re-runs
        prefill."""
        t0 = time.monotonic()
        sp = (self.tracer.span("serve.handoff", req.trace_id,
                               req.span_request)
              if self.tracer.enabled else None)
        payload = None
        try:
            if self._chaos is not None:
                # "server.handoff" injection point (export side): the
                # decode leg sees no payload and re-runs prefill
                for f in self._chaos.fire("server.handoff"):
                    if f.kind == "handoff_fail":
                        from deepspeed_tpu_torch.resilience.chaos import ChaosError
                        raise ChaosError("injected handoff_fail (export)")
            payload = self.engine.export_kv_chain(req.uid)
        except Exception as e:
            log_dist(f"serving: handoff export for request {req.uid} "
                     f"failed: {e!r}", level="warning")
        if payload is not None:
            self.metrics.record_handoff_out(time.monotonic() - t0)
        req.stream.handoff_payload = payload
        if sp is not None:
            sp.end(uid=req.uid, exported=payload is not None,
                   bytes=(payload or {}).get("nbytes", 0))

    def _preempt_one(self) -> None:
        """Evict the lowest-priority/youngest runner and requeue it with
        prompt+generated-so-far (recompute-style degradation)."""
        victim = self.admission.choose_victim(self._active.values())
        if victim is None:
            return
        if len(self._active) <= 1 \
                or victim.preemptions >= self.cfg.admission.max_preemptions:
            # preempting the only runner (or a chronically-preempted one)
            # cannot make progress — fail it instead of livelocking
            del self._active[victim.uid]
            self._flush_seq(victim.uid)
            self._finish(victim, error=ServingError(
                f"request {victim.uid} cannot fit the KV pool "
                f"(preempted {victim.preemptions}×, "
                f"{self.engine.free_blocks} blocks free)"))
            return
        tokens = self.engine.preempt(victim.uid)
        if self._spec is not None:
            self._spec.flush(victim.uid)
        victim.tokens = tokens
        victim.preemptions += 1
        del self._active[victim.uid]
        if victim.span_request is not None:
            self.tracer.instant("serve.preempt", victim.trace_id,
                                uid=victim.uid,
                                n_generated=victim.n_generated)
            if victim.span_phase is not None:
                victim.span_phase.end(preempted=True)
            # back to waiting: the requeue wait is queue time again
            victim.span_phase = self.tracer.span(
                "serve.queue_wait", victim.trace_id, victim.span_request
            ).set(uid=victim.uid, after_preemption=True)
        self.admission.requeue_front(victim)
        self.metrics.record_preemption()
        log_dist(f"serving: preempted uid {victim.uid} "
                 f"({victim.n_generated} tokens in, requeued)",
                 level="warning")

    def _finish(self, req: GenerationRequest,
                error: Optional[ServingError] = None) -> None:
        now = time.monotonic()
        outcome = ("completed" if error is None else
                   "cancelled" if isinstance(error, RequestCancelled) else
                   "expired" if isinstance(error, DeadlineExceeded) else
                   "shed" if isinstance(error, RequestShed) else
                   "failed")
        self.metrics.record_finish(outcome, req.n_generated,
                                   getattr(req, "first_token_at", None), now)
        self._rngs.pop(req.uid, None)
        if req.span_phase is not None:
            req.span_phase.end()
            req.span_phase = None
        if req.span_request is not None:
            self.tracer.instant("serve.finish", req.trace_id, uid=req.uid,
                                outcome=outcome)
            req.span_request.end(outcome=outcome,
                                 generated=req.n_generated,
                                 preemptions=req.preemptions)
            req.span_request = None
        req.stream._finish(error)

    def _update_gauges(self) -> None:
        free = self.engine.free_blocks
        self.metrics.set_gauges(
            queue_depth=len(self.admission),
            active=len(self._active),
            kv_utilization=1.0 - free / max(1, self._total_blocks),
            prefix_cached_blocks=(self.prefix_cache.cached_blocks
                                  if self.prefix_cache is not None else 0))
