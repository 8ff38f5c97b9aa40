"""Admission control: backpressure, KV watermarks, preemption policy.

The robustness layer the bare engine lacks (ref DeepSpeed-MII
``RaggedBatchBase`` request queue + FastGen's watermark'd KV usage):

* **Bounded request queue** — ``submit`` beyond ``max_queue_size`` either
  raises ``QueueFull`` (policy ``"reject"``, the load-shedding default)
  or blocks the submitter (policy ``"block"``).
* **KV watermarks** — a new request is admitted only while, after its
  prompt pages, the pool keeps ``kv_high_watermark`` of its blocks free;
  decode growth may then drain the pool to ``kv_low_watermark`` before
  preemption kicks in.  The hysteresis gap is what lets running requests
  finish instead of thrashing against new arrivals.
* **Preemption policy** — when an engine step raises ``KVCacheExhausted``,
  ``choose_victim`` picks the lowest-priority, youngest-admitted running
  request; its recompute requeue is the graceful-degradation path.

Admission can overcommit on purpose (``reserve_decode=False``, the
throughput default): reserving every request's worst-case output up front
(what ``generate()`` does) caps concurrency at the pessimal bound, while
optimistic admission + preemption tracks the *actual* output lengths.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Iterable, Optional

from deepspeed_tpu_torch.serving.request import GenerationRequest, QueueFull

#: Graceful-degradation ladder, mildest first — frozen vocabulary
#: (docs/SERVING.md brownout table; linted by tools/telemetry_check.py).
#: Each level includes every level below it:
#:   normal            — full service
#:   shed_speculation  — disable speculative decoding (greedy outputs are
#:                       bit-identical by construction, so this level is
#:                       invisible to callers except in latency)
#:   cap_decode        — cap concurrently-running requests at
#:                       ``decode_cap`` (admission slows, outputs intact)
#:   shed_low_priority — reject/shed requests below ``priority_floor``
#:   reject_new        — reject every new request; finish what's running
BROWNOUT_LEVELS = ("normal", "shed_speculation", "cap_decode",
                   "shed_low_priority", "reject_new")


def brownout_index(level: str) -> int:
    """Ladder position of ``level`` (raises on unknown names — the same
    tripwire as every other frozen vocabulary)."""
    try:
        return BROWNOUT_LEVELS.index(level)
    except ValueError:
        raise ValueError(f"unknown brownout level {level!r} "
                         f"(one of {BROWNOUT_LEVELS})") from None


class BrownoutConfig:
    def __init__(self, d: Optional[dict] = None, **kw):
        d = {**(d or {}), **kw}
        # pressure thresholds: step UP a level at >= enter, DOWN at
        # <= exit.  The gap is the hysteresis band; inside it the level
        # holds, so a pressure signal oscillating around one threshold
        # cannot flap the ladder.
        self.enter = float(d.get("enter", 0.85))
        self.exit = float(d.get("exit", 0.6))
        if not (0.0 <= self.exit < self.enter):
            raise ValueError(f"brownout thresholds must satisfy 0 <= exit "
                             f"({self.exit}) < enter ({self.enter})")
        # minimum dwell between level changes (either direction): even a
        # pressure step function walks the ladder one level per dwell
        self.dwell_s = float(d.get("dwell_s", 0.5))
        # cap_decode: max concurrently-running requests per replica
        self.decode_cap = int(d.get("decode_cap", 2))
        # shed_low_priority: requests with priority < floor are shed
        self.priority_floor = int(d.get("priority_floor", 0))
        # pressure normalization: SLO error-budget burn at which the burn
        # term saturates to 1.0 (burn 1.0 = exactly on budget)
        self.burn_limit = float(d.get("burn_limit", 4.0))


class BrownoutController:
    """The ladder's state machine: feed it a pressure scalar (0 = idle,
    1 = saturated) on a cadence; it walks :data:`BROWNOUT_LEVELS` up and
    down **one level per observation** with hysteresis + minimum dwell.

    Pure and single-threaded by design (the fleet supervisor's cadence
    thread is the only caller); actuation — what each level *does* — is
    enforced by the servers via ``InferenceServer.set_brownout``.
    """

    def __init__(self, cfg: Optional[BrownoutConfig] = None):
        self.cfg = cfg or BrownoutConfig()
        self._index = 0
        self._changed_at: Optional[float] = None
        self.transitions = 0   # lifetime level changes (tests/bench)

    @property
    def level(self) -> str:
        return BROWNOUT_LEVELS[self._index]

    @property
    def index(self) -> int:
        return self._index

    def observe(self, pressure: float,
                now: Optional[float] = None) -> Optional[str]:
        """One cadence tick: returns the NEW level name when the ladder
        moved, else ``None``."""
        now = time.monotonic() if now is None else now
        if self._changed_at is not None \
                and now - self._changed_at < self.cfg.dwell_s:
            return None
        if pressure >= self.cfg.enter \
                and self._index < len(BROWNOUT_LEVELS) - 1:
            self._index += 1
        elif pressure <= self.cfg.exit and self._index > 0:
            self._index -= 1
        else:
            return None
        self._changed_at = now
        self.transitions += 1
        return self.level


class AdmissionConfig:
    def __init__(self, d: Optional[dict] = None, **kw):
        d = {**(d or {}), **kw}
        self.max_queue_size = int(d.get("max_queue_size", 256))
        self.queue_policy = str(d.get("queue_policy", "reject"))
        if self.queue_policy not in ("reject", "block"):
            raise ValueError(f"queue_policy={self.queue_policy!r}: "
                             "expected 'reject' or 'block'")
        self.kv_low_watermark = float(d.get("kv_low_watermark", 0.0))
        self.kv_high_watermark = float(d.get("kv_high_watermark", 0.05))
        if not (0.0 <= self.kv_low_watermark
                <= self.kv_high_watermark < 1.0):
            raise ValueError(
                f"watermarks must satisfy 0 <= low ({self.kv_low_watermark})"
                f" <= high ({self.kv_high_watermark}) < 1")
        # True = generate()-style worst-case output reservation (no
        # preemption will ever fire, lower concurrency); False = admit on
        # prompt need only and rely on preemption under pressure.
        self.reserve_decode = bool(d.get("reserve_decode", False))
        # A request preempted this many times fails instead of requeueing
        # — the livelock backstop of last resort.  Victim choice already
        # deprioritizes previously-preempted requests, so reaching this
        # means sustained pressure rotated through every running peer.
        self.max_preemptions = int(d.get("max_preemptions", 16))


class AdmissionController:
    """Thread-safe bounded queue + KV admission test + victim choice.

    Producers (``offer``) run on caller threads; consumers (``pop_ready``
    etc.) run on the serve loop only.
    """

    def __init__(self, cfg: AdmissionConfig):
        self.cfg = cfg
        self._lock = threading.Condition()
        self._queue: Deque[GenerationRequest] = deque()
        self._closed = False
        # set by the server when tracing is enabled: the blocking-offer
        # wait is a real request phase (serve.admission_block spans)
        self.tracer = None

    # -- producer side ---------------------------------------------------
    def offer(self, req: GenerationRequest,
              timeout: Optional[float] = None) -> None:
        """Enqueue or shed load per the queue policy."""
        with self._lock:
            if self.cfg.queue_policy == "block" \
                    and len(self._queue) >= self.cfg.max_queue_size \
                    and not self._closed:
                tr = self.tracer
                sp = (tr.span("serve.admission_block", req.trace_id)
                      if tr is not None and tr.enabled else None)
                ok = self._lock.wait_for(
                    lambda: self._closed
                    or len(self._queue) < self.cfg.max_queue_size,
                    timeout)
                if sp is not None:
                    # close() also satisfies the wait predicate, but a
                    # closed queue rejects below — that is not admission
                    sp.end(uid=req.uid,
                           admitted=bool(ok) and not self._closed)
                if not ok:
                    raise QueueFull(
                        f"queue full ({self.cfg.max_queue_size}) after "
                        f"blocking {timeout}s")
            if self._closed:
                raise QueueFull("server not accepting requests")
            if len(self._queue) >= self.cfg.max_queue_size:
                raise QueueFull(
                    f"queue full ({self.cfg.max_queue_size} waiting)")
            self._queue.append(req)
            self._lock.notify_all()

    def close(self) -> None:
        """Stop accepting new requests (graceful-drain entry point)."""
        with self._lock:
            self._closed = True
            self._lock.notify_all()

    # -- serve-loop side -------------------------------------------------
    def requeue_front(self, req: GenerationRequest) -> None:
        """Preempted request: back of nobody's line."""
        with self._lock:
            self._queue.appendleft(req)
            self._lock.notify_all()

    def peek(self) -> Optional[GenerationRequest]:
        with self._lock:
            return self._queue[0] if self._queue else None

    def snapshot(self) -> list:
        """Stable copy for sweeps (offers may race the serve loop)."""
        with self._lock:
            return list(self._queue)

    def pop(self) -> Optional[GenerationRequest]:
        with self._lock:
            req = self._queue.popleft() if self._queue else None
            if req is not None:
                self._lock.notify_all()  # unblock 'block'-policy offers
            return req

    def drain(self) -> Iterable[GenerationRequest]:
        """Remove and return everything queued (shutdown-without-drain)."""
        with self._lock:
            out = list(self._queue)
            self._queue.clear()
            self._lock.notify_all()
            return out

    def remove(self, req: GenerationRequest) -> bool:
        """Drop a queued request (cancelled/expired before admission)."""
        with self._lock:
            try:
                self._queue.remove(req)
            except ValueError:
                return False
            self._lock.notify_all()
            return True

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)

    def wait_for_work(self, timeout: float) -> None:
        """Park the serve loop until a request arrives (or timeout — the
        loop still needs to wake for deadline sweeps)."""
        with self._lock:
            if not self._queue:
                self._lock.wait(timeout)

    # -- policy ----------------------------------------------------------
    def kv_floor(self, engine, watermark: float) -> int:
        """Blocks that must stay free under ``watermark`` — THE floor
        formula; the server's eviction shortfalls use it so reclaiming
        exactly a shortfall always satisfies the matching test below."""
        return int(watermark * (engine.cfg.num_blocks - 1))  # block 0 rsvd

    def kv_admissible(self, engine, need_blocks: int) -> bool:
        """Would admitting a prompt needing ``need_blocks`` keep the pool
        above the high watermark?"""
        floor = self.kv_floor(engine, self.cfg.kv_high_watermark)
        return engine.free_blocks - need_blocks >= floor

    def admission_shortfall(self, engine, need_blocks: int) -> int:
        """Blocks short of admitting ``need_blocks`` at the high floor
        (<= 0 when admissible) — the eviction target."""
        floor = self.kv_floor(engine, self.cfg.kv_high_watermark)
        return need_blocks + floor - engine.free_blocks

    def low_watermark_deficit(self, engine) -> int:
        """Blocks below the low floor (<= 0 when healthy)."""
        return (self.kv_floor(engine, self.cfg.kv_low_watermark)
                - engine.free_blocks)

    @staticmethod
    def evictable_headroom(engine, prefix_cache=None) -> int:
        """Blocks a new request could claim without preempting live
        work: the allocator free list PLUS pages the prefix cache could
        evict on demand (solely-cache-owned leaf blocks).  The dispatch
        score must use this, not ``free_blocks`` alone — a cache-warm
        replica whose pool is full of evictable pages has the same real
        capacity as a cold one, and scoring it by the raw free list
        makes the router spill (or reject) exactly the replica whose
        warm cache would serve the request best."""
        free = engine.free_blocks
        if prefix_cache is not None:
            free += prefix_cache.evictable_count()
        return free

    def below_low_watermark(self, engine) -> bool:
        return self.low_watermark_deficit(engine) > 0

    @staticmethod
    def choose_victim(active: Iterable[GenerationRequest]
                      ) -> Optional[GenerationRequest]:
        """Lowest priority first; within a class, fewest prior
        preemptions, then youngest admission.  Preemption count outranks
        age because a just-re-admitted request is always the youngest —
        keying on age alone would bounce the same request until the
        ``max_preemptions`` backstop failed it while never-preempted
        peers kept running."""
        victims = sorted(active,
                         key=lambda r: (r.priority, r.preemptions,
                                        -(r.admitted_at or 0.0)))
        return victims[0] if victims else None
