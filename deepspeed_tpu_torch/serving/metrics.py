"""Serving metrics: per-request latency decomposition + service gauges.

Glossary (the standard LLM-serving vocabulary; see docs/SERVING.md):

* **TTFT** — time to first token: submit → first token out the stream.
* **TPOT** — time per output token: (last token − first token) / (n − 1),
  the steady-state decode cadence one request observes.
* **queue wait** — submit → admission into the SplitFuse scheduler.

All primitives come from the shared ``telemetry.registry`` — the same
Counter/Gauge/Histogram the training engine exports — so "p95" means
the same thing on both hot loops and a ``MetricsRegistry`` can be
shared with a :class:`telemetry.Telemetry` hub (serving tags then land
in the same Prometheus exposition).  Histograms keep a bounded sliding
window of recent samples — a long-lived server must not grow without
bound.  Export goes through ``monitor.MonitorMaster`` as plain
``(tag, value, step)`` events so TensorBoard/WandB/CSV all work
unchanged.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from deepspeed_tpu_torch.telemetry.registry import MetricsRegistry

Event = Tuple[str, float, int]

_WINDOW = 2048  # per-distribution sample cap

# outcome name (record_finish) → counter attribute; "shed" covers both
# submit-time brownout rejections (record_shed) and queued requests
# terminated with RequestShed by the degradation ladder
_OUTCOMES = ("completed", "failed", "cancelled", "expired", "shed")


def spec_accept_rate(proposed: int, accepted: int) -> float:
    """THE accept-rate definition: accepted/proposed draft tokens, 0.0
    when no rounds ran.  One function so ``snapshot()``, the replica-set
    rollup, the fleet sampler, and bench.py cannot drift on the
    denominator (bonus tokens are excluded by construction — see
    :meth:`ServingMetrics.record_spec_round`)."""
    return accepted / max(1, proposed)


class ServingMetrics:
    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 label: str = "", window_s: float = 0.0):
        """``label`` namespaces the MONITOR tags (``serving/<label>/…``)
        for per-replica export under a router; metric names are
        unchanged, so per-replica instances must use per-replica
        registries (the default) — sharing one registry would merge the
        replicas' counters.  ``window_s > 0`` time-bounds the latency
        histograms (``max_age_s``) so an idle server's percentiles decay
        instead of pinning at the last burst — required under a
        ``FleetSampler`` (server config key ``metrics_window_s``)."""
        self.registry = registry or MetricsRegistry()
        self.label = label
        self.window_s = float(window_s)
        reg = self.registry
        self._t0 = time.monotonic()
        # counters
        self._c = {name: reg.counter(f"serving_{name}_total")
                   for name in ("submitted", "admitted", "rejected",
                                "preemptions", "tokens_out", "steps",
                                "flight_dumps", "prefix_hits",
                                "prefix_misses", "prefill_tokens_saved",
                                "handoffs_in", "handoffs_out",
                                "handoff_bytes", "spec_rounds",
                                "spec_proposed", "spec_accepted")
                   + _OUTCOMES}
        # distributions (seconds)
        self._ttft = reg.histogram("serving_ttft_seconds",
                                   "submit to first token", window=_WINDOW,
                                   max_age_s=self.window_s)
        self._tpot = reg.histogram("serving_tpot_seconds",
                                   "steady-state time per output token",
                                   window=_WINDOW, max_age_s=self.window_s)
        self._queue_wait = reg.histogram("serving_queue_wait_seconds",
                                         "submit to admission",
                                         window=_WINDOW,
                                         max_age_s=self.window_s)
        self._handoff = reg.histogram(
            "serving_handoff_seconds",
            "KV-chain export/import time, one observation per side",
            window=_WINDOW, max_age_s=self.window_s)
        # gauges (set by the serve loop each iteration)
        self._g_queue_depth = reg.gauge("serving_queue_depth")
        self._g_active = reg.gauge("serving_active_requests")
        self._g_kv_util = reg.gauge("serving_kv_utilization")
        self._g_prefix_blocks = reg.gauge("serving_prefix_cached_blocks")

    # counter values read by the serve loop / tests
    def _cv(self, name: str) -> int:
        return int(self._c[name].value)

    submitted = property(lambda self: self._cv("submitted"))
    admitted = property(lambda self: self._cv("admitted"))
    completed = property(lambda self: self._cv("completed"))
    failed = property(lambda self: self._cv("failed"))
    cancelled = property(lambda self: self._cv("cancelled"))
    expired = property(lambda self: self._cv("expired"))
    shed = property(lambda self: self._cv("shed"))
    rejected = property(lambda self: self._cv("rejected"))
    preemptions = property(lambda self: self._cv("preemptions"))
    tokens_out = property(lambda self: self._cv("tokens_out"))
    steps = property(lambda self: self._cv("steps"))
    flight_dumps = property(lambda self: self._cv("flight_dumps"))
    prefix_hits = property(lambda self: self._cv("prefix_hits"))
    prefix_misses = property(lambda self: self._cv("prefix_misses"))
    prefill_tokens_saved = property(
        lambda self: self._cv("prefill_tokens_saved"))
    handoffs_in = property(lambda self: self._cv("handoffs_in"))
    handoffs_out = property(lambda self: self._cv("handoffs_out"))
    handoff_bytes = property(lambda self: self._cv("handoff_bytes"))
    spec_rounds = property(lambda self: self._cv("spec_rounds"))
    spec_proposed = property(lambda self: self._cv("spec_proposed"))
    spec_accepted = property(lambda self: self._cv("spec_accepted"))
    queue_depth = property(lambda self: int(self._g_queue_depth.value))
    active_requests = property(lambda self: int(self._g_active.value))
    kv_utilization = property(lambda self: self._g_kv_util.value)

    # -- recording (serve loop / submit path) ----------------------------
    def record_submit(self) -> None:
        self._c["submitted"].inc()

    def record_reject(self) -> None:
        self._c["rejected"].inc()

    def record_shed(self) -> None:
        """A submit shed by the brownout ladder before a stream existed
        (queued sheds arrive through ``record_finish("shed", ...)``)."""
        self._c["shed"].inc()

    def record_admit(self, queue_wait_s: float) -> None:
        self._c["admitted"].inc()
        self._queue_wait.observe(queue_wait_s)

    def record_first_token(self, ttft_s: float) -> None:
        self._ttft.observe(ttft_s)

    def record_tokens(self, n: int) -> None:
        self._c["tokens_out"].inc(n)

    def record_step(self) -> None:
        self._c["steps"].inc()

    def record_preemption(self) -> None:
        self._c["preemptions"].inc()

    def record_flight_dump(self) -> None:
        """A flight-recorder bundle was written for this server (watchdog
        fire or crash handler) — the ops-alert counter."""
        self._c["flight_dumps"].inc()

    def record_prefix(self, tokens_saved: int) -> None:
        """One admission's prefix-cache outcome: a hit adopted
        ``tokens_saved`` tokens of already-written KV (prefill skipped
        them); zero is a miss.  Re-admissions count again — a preempted
        victim re-adopting its prefix really does skip that prefill."""
        if tokens_saved > 0:
            self._c["prefix_hits"].inc()
            self._c["prefill_tokens_saved"].inc(tokens_saved)
        else:
            self._c["prefix_misses"].inc()

    def record_handoff_out(self, export_s: float) -> None:
        """Prefill-tier side: one KV chain exported for adoption."""
        self._c["handoffs_out"].inc()
        self._handoff.observe(export_s)

    def record_handoff_in(self, bytes_moved: int, import_s: float) -> None:
        """Decode-tier side: one handed-off chain adopted at admission —
        ``bytes_moved`` is 0 for the zero-copy path (the local prefix
        cache already held the chain; adoption was a ref acquire)."""
        self._c["handoffs_in"].inc()
        self._c["handoff_bytes"].inc(int(bytes_moved))
        self._handoff.observe(import_s)

    def record_spec_round(self, proposed: int, accepted: int) -> None:
        """One speculative verify round: the draft proposed ``proposed``
        tokens across the batch, the target accepted ``accepted`` of
        them (bonus tokens are not counted — accept rate measures the
        draft's hit rate, accepted/proposed)."""
        self._c["spec_rounds"].inc()
        self._c["spec_proposed"].inc(int(proposed))
        self._c["spec_accepted"].inc(int(accepted))

    def record_finish(self, outcome: str, n_tokens: int,
                      first_token_at: Optional[float],
                      finished_at: float) -> None:
        """``outcome``: completed | failed | cancelled | expired | shed."""
        if outcome not in _OUTCOMES:
            raise ValueError(f"unknown outcome {outcome!r}")
        self._c[outcome].inc()
        if (outcome == "completed" and n_tokens > 1
                and first_token_at is not None):
            self._tpot.observe(
                (finished_at - first_token_at) / (n_tokens - 1))

    def set_gauges(self, queue_depth: int, active: int,
                   kv_utilization: float,
                   prefix_cached_blocks: int = 0) -> None:
        self._g_queue_depth.set(queue_depth)
        self._g_active.set(active)
        self._g_kv_util.set(kv_utilization)
        self._g_prefix_blocks.set(prefix_cached_blocks)

    # -- reading ---------------------------------------------------------
    def latency_values(self) -> Dict[str, List[float]]:
        """Raw current-window latency samples (seconds), for cross-
        replica pooling: a tier percentile must be computed over the
        POOLED samples of its replicas, not an average of per-replica
        percentiles — the fleet sampler's read path."""
        return {"ttft": self._ttft.values(),
                "tpot": self._tpot.values(),
                "queue_wait": self._queue_wait.values()}

    def snapshot(self) -> Dict[str, object]:
        elapsed = max(time.monotonic() - self._t0, 1e-9)
        tokens_out = self.tokens_out
        return {
            "submitted": self.submitted,
            "admitted": self.admitted,
            "completed": self.completed,
            "failed": self.failed,
            "cancelled": self.cancelled,
            "expired": self.expired,
            "shed": self.shed,
            "rejected": self.rejected,
            "preemptions": self.preemptions,
            "flight_dumps": self.flight_dumps,
            "tokens_out": tokens_out,
            "steps": self.steps,
            "tokens_per_sec": tokens_out / elapsed,
            "queue_depth": self.queue_depth,
            "active_requests": self.active_requests,
            "kv_utilization": self.kv_utilization,
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_hit_rate": (self.prefix_hits
                                / max(1, self.prefix_hits
                                      + self.prefix_misses)),
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "prefix_cached_blocks": int(self._g_prefix_blocks.value),
            "handoffs_in": self.handoffs_in,
            "handoffs_out": self.handoffs_out,
            "handoff_bytes": self.handoff_bytes,
            "spec_rounds": self.spec_rounds,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "spec_accept_rate": spec_accept_rate(self.spec_proposed,
                                                 self.spec_accepted),
            "ttft": self._ttft.snapshot(),
            "tpot": self._tpot.snapshot(),
            "queue_wait": self._queue_wait.snapshot(),
            "handoff": self._handoff.snapshot(),
        }

    def events(self, step: int) -> List[Event]:
        """Flatten the snapshot into MonitorMaster events.  With a
        ``label`` (per-replica export under a router) tags nest one
        level deeper: ``serving/<label>/<key>``."""
        snap = self.snapshot()
        prefix = f"serving/{self.label}" if self.label else "serving"
        out: List[Event] = []
        for k, v in snap.items():
            if isinstance(v, dict):
                for sub, x in v.items():
                    out.append((f"{prefix}/{k}_{sub}", float(x), step))
            else:
                out.append((f"{prefix}/{k}", float(v), step))
        return out

    def write_to(self, monitor, step: int) -> None:
        """Export through a ``monitor.MonitorMaster`` (or anything with
        ``write_events``)."""
        monitor.write_events(self.events(step))


class RouterMetrics:
    """Router-tier counters over the shared registry.

    Per-replica dispatch counts get per-replica metric NAMES
    (``router_routed_r<i>_total`` — documented as the
    ``router_routed_r*_total`` wildcard row) because the registry has no
    label dimension; everything else is a flat counter/gauge.  The
    replicas' own ``ServingMetrics`` live in per-replica registries —
    this class only holds what exists *above* them."""

    def __init__(self, n_replicas: int,
                 registry: Optional[MetricsRegistry] = None):
        self.registry = registry or MetricsRegistry()
        reg = self.registry
        self.n_replicas = n_replicas
        self._requests = reg.counter("router_requests_total")
        self._rejected = reg.counter("router_rejected_total")
        self._failovers = reg.counter("router_failovers_total")
        self._routed = {i: reg.counter(f"router_routed_r{i}_total")
                        for i in range(n_replicas)}
        self._g_alive = reg.gauge("router_replicas_alive")
        # disaggregated tiers: per-request prefill→decode KV handoffs
        # observed at the router (export + import, end to end)
        self._handoffs = reg.counter("router_handoffs_total")
        self._handoff_bytes = reg.counter("router_handoff_bytes_total")
        self._handoff_s = reg.histogram(
            "router_handoff_seconds",
            "per-request KV handoff latency (export + import)",
            window=_WINDOW)

    requests = property(lambda self: int(self._requests.value))
    rejected = property(lambda self: int(self._rejected.value))
    failovers = property(lambda self: int(self._failovers.value))
    handoffs = property(lambda self: int(self._handoffs.value))
    handoff_bytes = property(lambda self: int(self._handoff_bytes.value))

    def routed(self, i: int) -> int:
        c = self._routed.get(i)
        return int(c.value) if c is not None else 0

    def ensure_replica(self, i: int) -> None:
        """Counter for a replica added AFTER construction (live grow /
        respawn) — the registry get-or-creates, so an index that comes
        back keeps its lifetime count."""
        if i not in self._routed:
            self._routed[i] = self.registry.counter(
                f"router_routed_r{i}_total")
            self.n_replicas = max(self.n_replicas, i + 1)

    def record_submit(self) -> None:
        self._requests.inc()

    def record_reject(self) -> None:
        self._rejected.inc()

    def record_route(self, replica: int) -> None:
        self.ensure_replica(replica)
        self._routed[replica].inc()

    def record_failover(self) -> None:
        self._failovers.inc()

    def record_handoff(self, bytes_moved: int, seconds: float) -> None:
        """One request's prefill→decode KV handoff completed (0 bytes =
        the zero-copy ref-acquire path)."""
        self._handoffs.inc()
        self._handoff_bytes.inc(int(bytes_moved))
        self._handoff_s.observe(seconds)

    def set_alive(self, n: int) -> None:
        self._g_alive.set(n)

    def snapshot(self) -> Dict[str, object]:
        return {
            "requests": self.requests,
            "rejected": self.rejected,
            "failovers": self.failovers,
            "replicas_alive": int(self._g_alive.value),
            "handoffs": self.handoffs,
            "handoff_bytes": self.handoff_bytes,
            "handoff": self._handoff_s.snapshot(),
            "routed": {f"r{i}": self.routed(i)
                       for i in sorted(self._routed)},
        }
