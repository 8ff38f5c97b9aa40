"""Software spans: request/step tracing with Perfetto-viewable export.

The host-side complement of the XPlane capture path (utils/trace.py):
XPlane shows *device* timelines inside a budgeted window, but the phases
that make a request slow — queue wait, admission, prefill-vs-decode,
stream fan-out — happen on the host, outside any capture window.  A
:class:`Tracer` records named monotonic-clock spans with a
``trace_id``/``span_id``/``parent_id`` chain, thread-safely, from every
hot loop (serve loop, train loop, submit path), and exports them as
Chrome trace-event JSON (``chrome://tracing`` / Perfetto ``ui``).

Design constraints (docs/OBSERVABILITY.md "Tracing & flight recorder"):

* **Zero dependencies** — stdlib only; serving/ stays jax-free.
* **Bounded** — finished events land in a ``deque(maxlen=max_events)``
  (oldest dropped, ``dropped_events`` counts them) and, when attached,
  in the flight recorder's ring (flight.py).
* **Free when disabled** — ``tracer.span(...)`` returns the shared
  :data:`NULL_SPAN` singleton without touching its arguments, so a
  disabled tracer adds one attribute check + one method call per span
  and allocates nothing.  Hot call sites pass positional args only and
  attach kwargs via ``Span.set`` behind an ``enabled`` guard.

Span names are a frozen vocabulary (:data:`SPAN_NAMES` /
:data:`EVENT_NAMES`), linted against the docs table by
``tools/telemetry_check.py`` — the same frozen-schema contract as the
StepRecord key set.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

# ---------------------------------------------------------------------------
# Frozen name tables (docs/OBSERVABILITY.md span table; telemetry_check lint)
# ---------------------------------------------------------------------------

# Duration spans (Chrome "X" complete events).
SPAN_NAMES = (
    "fleet.sample",            # one fleet-sampler cadence tick (all tiers)
    "offload.d2h",             # chunked offload: grad chunk device->host
    "offload.h2d",             # chunked offload: updated leaf host->device
    "offload.host_step",       # chunked offload: host Adam on one chunk
    "recovery.outage",         # detection -> resumed progress (supervisor)
    "router.leg",              # one replica attempt of a routed request
    "router.request",          # whole routed-request lifetime (root span)
    "serve.admission_block",   # submit blocked on a full queue ('block' policy)
    "serve.decode",            # first token -> terminal (per request)
    "serve.handoff",           # KV-chain export/import (disagg tiers)
    "serve.prefill",           # admission -> first token (per request)
    "serve.queue_wait",        # enqueue -> admission (per request)
    "serve.request",           # whole request lifetime (root span)
    "serve.step",              # one serve-loop engine step (whole batch)
    "spec.draft",              # draft-model proposal loop (one round)
    "spec.verify",             # target verify-k ragged step (one round)
    "train.data_ingest",       # micro-batch stack + host->device put
    "train.dispatch",          # compiled train step dispatch
    "train.step",              # one whole train_batch (root span)
    "train.sync",              # hard host sync (loss value fetch)
    "train.telemetry",         # StepRecord assembly + export
    "v2.ragged_step",          # InferenceEngineV2.step ragged dispatch
)

# Instant events (Chrome "i" events).
EVENT_NAMES = (
    "chaos.inject",            # a scheduled fault fired (resilience/chaos.py)
    "fleet.brownout",          # degradation ladder changed level
    "fleet.heal",              # fleet supervisor state transition / action
    "recovery.detected",       # worker crash / hang noticed by supervisor
    "recovery.replan",         # surviving hosts -> new mesh plan
    "recovery.restart",        # group relaunched (possibly resized)
    "recovery.resumed",        # first post-restart training progress
    "router.dispatch",         # routed request bound to a replica
    "router.failover",         # replica died; request re-dispatched
    "serve.emit",              # one token handed to a response stream
    "serve.enqueue",           # request entered the admission queue
    "serve.finish",            # request reached a terminal state
    "serve.first_token",       # request's first decoded token
    "serve.preempt",           # request evicted for KV pressure
    "serve.prefix_hit",        # admission adopted cached prefix pages
    "slo.violation",           # a tier tick breached an SLO target
    "spec.accept",             # verify round outcome (proposed/accepted)
    "watchdog.fire",           # hang watchdog dumped a flight bundle
)

DEFAULT_MAX_EVENTS = 100_000


def _now_us() -> float:
    return time.monotonic() * 1e6


class _NullSpan:
    """Shared do-nothing span — the disabled-tracer fast path.  One
    process-wide instance; every method is a constant-time no-op."""

    __slots__ = ()

    name = ""
    trace_id = ""
    span_id = 0

    def set(self, **args) -> "_NullSpan":
        return self

    def end(self, **args) -> None:
        return None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def __bool__(self) -> bool:
        # `if req.span:` reads as "is tracing recording this request?"
        return False


NULL_SPAN = _NullSpan()


class Span:
    """One open duration span; ``end()`` (or context-manager exit) stamps
    the duration and emits the event.  Produced only by an *enabled*
    tracer — call sites never construct one directly."""

    __slots__ = ("_tracer", "name", "trace_id", "span_id", "parent_id",
                 "_t0_us", "_tid", "_tname", "_args", "_done")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_id: int):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = tracer._next_id()
        self.parent_id = parent_id
        cur = threading.current_thread()
        self._tid = cur.ident
        # captured at creation: a span may be *ended* by a different
        # thread (submit() opens request spans the serve loop closes),
        # and the track must carry the creating thread's name
        self._tname = cur.name
        self._args: Optional[Dict[str, Any]] = None
        self._done = False
        self._t0_us = _now_us()

    def set(self, **args) -> "Span":
        """Attach key/value args (shows under the span in Perfetto)."""
        if self._args is None:
            self._args = args
        else:
            self._args.update(args)
        return self

    def end(self, **args) -> None:
        if self._done:          # idempotent: crash paths may double-end
            return
        self._done = True
        if args:
            self.set(**args)
        t1 = _now_us()
        a: Dict[str, Any] = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_id:
            a["parent_id"] = self.parent_id
        if self._args:
            a.update(self._args)
        self._tracer._emit({
            "name": self.name, "cat": self.name.split(".", 1)[0], "ph": "X",
            "ts": self._t0_us, "dur": t1 - self._t0_us,
            "pid": self._tracer._pid, "tid": self._tid, "args": a,
        }, tname=self._tname)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()

    def __bool__(self) -> bool:
        return True


class Tracer:
    """Thread-safe span recorder with bounded memory.

    ``span(name, trace_id, parent)`` takes positional args only so the
    disabled path (`enabled=False`) returns :data:`NULL_SPAN` without
    materializing a kwargs dict; attach args to live spans with
    ``Span.set(...)`` behind an ``if tracer.enabled`` guard when the
    call site is hot.
    """

    def __init__(self, enabled: bool = True,
                 max_events: int = DEFAULT_MAX_EVENTS, ring: Any = None):
        self.enabled = bool(enabled)
        # the owning run's id (Telemetry sets it); exported as a trace
        # metadata event so a trace file names the run it belongs to
        self.run_id = ""
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max(1, int(max_events)))
        self._ring = ring          # FlightRecorder (flight.py) or None
        self._pid = os.getpid()
        self._ids = itertools.count(1)
        self._thread_names: Dict[int, str] = {}
        self.dropped_events = 0

    # -- recording -------------------------------------------------------
    def _next_id(self) -> int:
        return next(self._ids)

    def new_trace_id(self) -> str:
        """Process-unique id linking every span of one request/run."""
        return f"{self._pid:x}.{self._next_id():x}"

    def span(self, name: str, trace_id: str = "",
             parent: Any = None) -> Any:
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, trace_id or self.new_trace_id(),
                    parent.span_id if parent is not None else 0)

    def instant(self, name: str, trace_id: str = "", **args) -> None:
        """One timestamped marker event (Chrome ``ph: "i"``)."""
        if not self.enabled:
            return
        a = {"trace_id": trace_id, **args}
        self._emit({"name": name, "cat": name.split(".", 1)[0], "ph": "i",
                    "s": "t", "ts": _now_us(), "pid": self._pid,
                    "tid": threading.get_ident(), "args": a})

    def _emit(self, event: Dict[str, Any],
              tname: Optional[str] = None) -> None:
        with self._lock:
            tid = event["tid"]
            # spans pass the name of their *creating* thread; the
            # emitting thread's name is only right for instants.  Always
            # refresh: the OS recycles thread idents, and a stale entry
            # would label a new thread's Perfetto track with a dead
            # thread's name for the rest of the process
            name = (tname if tname is not None
                    else threading.current_thread().name)
            if self._thread_names.get(tid) != name:
                self._thread_names[tid] = name
            if len(self._events) == self._events.maxlen:
                self.dropped_events += 1
            self._events.append(event)
        ring = self._ring
        if ring is not None:
            ring.record(event)

    # -- reading / export ------------------------------------------------
    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-span-name ``{count, total_ms}`` rollup (bench rows report
        the queue/prefill/decode breakdown from this)."""
        out: Dict[str, Dict[str, float]] = {}
        for ev in self.snapshot():
            if ev.get("ph") != "X":
                continue
            row = out.setdefault(ev["name"], {"count": 0, "total_ms": 0.0})
            row["count"] += 1
            row["total_ms"] += ev.get("dur", 0.0) / 1e3
        for row in out.values():
            row["total_ms"] = round(row["total_ms"], 3)
        return out

    def chrome_trace(self) -> Dict[str, Any]:
        """The trace-event JSON object (Chrome/Perfetto ``traceEvents``
        format; ts/dur in microseconds)."""
        with self._lock:
            events = list(self._events)
            names = dict(self._thread_names)
        meta: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": self._pid, "tid": 0,
            "ts": 0, "args": {"name": "deepspeed_tpu_torch"},
        }]
        if self.run_id:
            meta.append({"name": "run_id", "ph": "M", "pid": self._pid,
                         "tid": 0, "ts": 0,
                         "args": {"run_id": self.run_id}})
        for tid, tname in sorted(names.items()):
            meta.append({"name": "thread_name", "ph": "M", "pid": self._pid,
                         "tid": tid, "ts": 0, "args": {"name": tname}})
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> str:
        """Write the trace JSON (atomically — a half-written trace file
        is worse than none) and return the path."""
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        tmp = f"{path}.tmp.{self._pid}"
        with open(tmp, "w", encoding="utf-8") as f:
            # default=repr: one exotic span arg (numpy scalar, Path, ...)
            # must not abort the whole export at shutdown — same contract
            # as flight.dump_bundle's ring.json
            json.dump(self.chrome_trace(), f, default=repr)
        os.replace(tmp, path)
        return path


NULL_TRACER = Tracer(enabled=False)
"""Shared disabled tracer — call sites keep one unconditional code path
(`self._tracer = telemetry.tracer if telemetry else NULL_TRACER`)."""
