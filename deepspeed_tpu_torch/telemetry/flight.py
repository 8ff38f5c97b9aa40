"""Flight recorder: bounded span-event ring + hang watchdog + crash
forensics bundle.

"Heavy traffic from millions of users" (ROADMAP) means a wedged serve
loop or a hung train step must leave evidence behind, not a silent
join-timeout.  Three pieces, all stdlib-only:

* :class:`FlightRecorder` — a fixed-size ring of the most recent
  span/instant events.  The tracer feeds it on every emit; its snapshot
  is the "last N things the process did" record in every dump.
* :func:`dump_bundle` — writes a diagnostic bundle directory:
  ``manifest.json`` (reason/error/thread census), ``stacks.txt``
  (all-thread Python stacks via ``sys._current_frames`` plus a
  ``faulthandler`` dump), ``ring.json`` (the event ring), and
  ``telemetry.json`` (last StepRecord + registry values) when a
  telemetry hub is attached.
* :class:`Watchdog` — a daemon thread armed by ``beat()`` calls from a
  hot loop.  No beat for ``deadline_s`` ⇒ one bundle per stall (it
  re-arms on the next beat), plus a ``watchdog.fire`` instant into the
  trace so the stall is visible in Perfetto too.

The same ``dump_bundle`` is called by the serve loop's crash handler
(reason ``serve_crash``) and by ``engine.destroy()`` when invoked while
an exception is propagating (reason ``engine_crash``) — see
docs/OBSERVABILITY.md for the bundle layout.
"""

from __future__ import annotations

import faulthandler
import itertools
import json
import os
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from deepspeed_tpu_torch.utils.logging import logger

# Frozen bundle-reason vocabulary (linted against the docs table by
# tools/telemetry_check.py, like span names).
FLIGHT_REASONS = ("watchdog", "serve_crash", "engine_crash", "manual",
                  "recovery", "fleet")

DEFAULT_RING_SIZE = 2048

_bundle_seq = itertools.count(1)


class FlightRecorder:
    """Fixed-size ring of recent trace events (newest wins)."""

    def __init__(self, capacity: int = DEFAULT_RING_SIZE):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)

    def record(self, event: Dict[str, Any]) -> None:
        with self._lock:
            self._ring.append(event)

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


def make_span_recorder(tracing_enabled: bool, flight_enabled: bool,
                       max_events: int = 0, ring_size: int = 0):
    """The ONE place the tracer/ring bootstrap rule lives (``Telemetry``
    hub and hub-less ``InferenceServer`` both call it): ``flight.enabled``
    alone also turns on span *recording* — the ring's "last N things the
    process did" must be populated for bundles to be useful — while the
    trace *file* is still gated on the tracing block's own settings.
    Zero/absent ``max_events``/``ring_size`` fall back to the module
    defaults.  Returns ``(tracer, flight_ring)`` — the ring is ``None``
    when flight is off: nothing ever reads it (dump paths are gated on
    ``flight.enabled``), so tracing-only configs skip the per-emit
    lock + append and the 2048-event retention."""
    from deepspeed_tpu_torch.telemetry.tracing import (DEFAULT_MAX_EVENTS,
                                                 Tracer)

    ring = (FlightRecorder(int(ring_size) or DEFAULT_RING_SIZE)
            if flight_enabled else None)
    tracer = Tracer(enabled=bool(tracing_enabled or flight_enabled),
                    max_events=int(max_events) or DEFAULT_MAX_EVENTS,
                    ring=ring)
    return tracer, ring


def make_watchdog(name: str, flight_cfg: Any, ring: Any = None,
                  telemetry: Any = None, tracer: Any = None):
    """Build the hang :class:`Watchdog` for one hot loop from a
    ``flight`` config block (dict or ``FlightConfig``); ``None`` unless
    the block is enabled.  Companion to :func:`make_span_recorder` — the
    hub and the hub-less server must wire watchdogs (and their
    deadline/output_dir/poll defaults) identically."""
    if flight_cfg is None:
        return None
    get = (flight_cfg.get if isinstance(flight_cfg, dict)
           else lambda k, d=None: getattr(flight_cfg, k, d))
    if not get("enabled", False):
        return None
    return Watchdog(name,
                    deadline_s=float(get("deadline_s", 60.0) or 60.0),
                    output_dir=str(get("output_dir", "")
                                   or "./dstpu_flight"),
                    ring=ring, telemetry=telemetry, tracer=tracer,
                    poll_s=float(get("poll_s", 0.0) or 0.0))


def _format_all_stacks() -> str:
    """Every thread's Python stack, annotated with thread names — the
    first thing to read in a hang bundle."""
    names = {t.ident: t.name for t in threading.enumerate()}
    lines: List[str] = []
    for tid, frame in sys._current_frames().items():
        lines.append(f"--- thread {names.get(tid, '?')} (ident {tid}) ---")
        lines.extend(x.rstrip("\n") for x in traceback.format_stack(frame))
        lines.append("")
    return "\n".join(lines)


def _telemetry_snapshot(telemetry: Any) -> Dict[str, Any]:
    """Duck-typed snapshot of a telemetry.Telemetry hub: last record +
    every registry metric's current value."""
    out: Dict[str, Any] = {}
    rec = getattr(telemetry, "last_record", None)
    if rec is not None:
        try:
            out["last_record"] = json.loads(rec.to_json())
        except Exception:
            out["last_record"] = repr(rec)
    registry = getattr(telemetry, "registry", None)
    if registry is not None:
        metrics: Dict[str, Any] = {}
        for m in registry.collect():
            if hasattr(m, "snapshot"):       # Histogram
                metrics[m.name] = m.snapshot()
            elif hasattr(m, "value"):        # Counter / Gauge
                metrics[m.name] = m.value
        out["metrics"] = metrics
    return out


def dump_bundle(output_dir: str, reason: str, ring: Any = None,
                telemetry: Any = None, error: Optional[BaseException] = None,
                extra: Optional[Dict[str, Any]] = None) -> str:
    """Write one diagnostic bundle; returns its directory.  Never raises
    — forensics must not mask the failure being recorded."""
    bundle = os.path.join(
        output_dir, f"flight_{reason}_{os.getpid()}_{next(_bundle_seq)}")
    try:
        os.makedirs(bundle, exist_ok=True)
        threads = [{"name": t.name, "ident": t.ident, "daemon": t.daemon,
                    "alive": t.is_alive()} for t in threading.enumerate()]
        with open(os.path.join(bundle, "stacks.txt"), "w",
                  encoding="utf-8") as f:
            f.write(_format_all_stacks())
            f.write("\n=== faulthandler ===\n")
            f.flush()
            try:
                faulthandler.dump_traceback(file=f, all_threads=True)
            except Exception:
                pass
        ring_events = ring.snapshot() if ring is not None else []
        # default=repr everywhere: one exotic span arg must not abort
        # the bundle (the outer except would otherwise swallow the whole
        # write after stacks.txt, losing manifest.json)
        with open(os.path.join(bundle, "ring.json"), "w",
                  encoding="utf-8") as f:
            json.dump({"events": ring_events}, f, default=repr)
        if telemetry is not None:
            with open(os.path.join(bundle, "telemetry.json"), "w",
                      encoding="utf-8") as f:
                json.dump(_telemetry_snapshot(telemetry), f, default=repr)
        manifest = {
            "reason": reason,
            "time_unix": time.time(),
            "pid": os.getpid(),
            "error": repr(error) if error is not None else None,
            "threads": threads,
            "ring_events": len(ring_events),
            "files": sorted(os.listdir(bundle)) + ["manifest.json"],
            **(extra or {}),
        }
        with open(os.path.join(bundle, "manifest.json"), "w",
                  encoding="utf-8") as f:
            json.dump(manifest, f, indent=2, sort_keys=True, default=repr)
        logger.error(f"flight recorder: {reason} bundle written to {bundle}")
    except Exception as e:  # pragma: no cover - depends on fs failures
        logger.warning(f"flight recorder: bundle write failed: {e}")
    return bundle


class Watchdog:
    """Deadline watchdog over a heartbeat.

    The monitored loop calls ``beat()`` once per iteration (a single
    attribute store — safe and cheap from any thread).  The watchdog
    thread fires when ``time.monotonic() - last_beat > deadline_s``,
    dumps one bundle per stall, and re-arms on the next beat, so a
    recovered loop can be caught stalling again later.
    """

    def __init__(self, name: str, deadline_s: float, output_dir: str,
                 ring: Any = None, telemetry: Any = None, tracer: Any = None,
                 poll_s: float = 0.0,
                 on_fire: Optional[Callable[[str], None]] = None):
        self.name = name
        self.deadline_s = float(deadline_s)
        self.output_dir = output_dir
        self.poll_s = float(poll_s) if poll_s else max(
            0.01, min(1.0, self.deadline_s / 4.0))
        self._ring = ring
        self._telemetry = telemetry
        self._tracer = tracer
        self.on_fire = on_fire
        self._last = time.monotonic()
        self._fired_at = -1.0           # beat timestamp the last fire saw
        self._paused = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fire_count = 0
        self.bundles: List[str] = []

    def beat(self) -> None:
        self._last = time.monotonic()

    def pause(self) -> None:
        """Suspend stall detection (the monitored loop is intentionally
        idle — between train steps, inside an eval/checkpoint gap)."""
        self._paused = True

    def resume(self) -> None:
        """Re-arm after :meth:`pause`; resets the deadline clock and
        starts the thread on first use."""
        self._last = time.monotonic()
        self._paused = False
        self.start()

    def start(self) -> "Watchdog":
        if self._thread is None:
            # a stop()ed watchdog can be re-armed: without the clear()
            # the fresh thread would exit on its first _stop.wait() and
            # monitoring would die silently while beat()/resume() still
            # appear to succeed
            self._stop.clear()
            self._last = time.monotonic()
            self._thread = threading.Thread(
                target=self._run, name=f"ds-watchdog-{self.name}",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    @property
    def fired(self) -> bool:
        return self.fire_count > 0

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            if self._paused:
                continue
            last = self._last
            stalled = time.monotonic() - last
            if stalled <= self.deadline_s or self._fired_at == last:
                continue  # healthy, or already dumped for this stall
            self._fired_at = last
            try:
                bundle = dump_bundle(
                    self.output_dir, "watchdog", ring=self._ring,
                    telemetry=self._telemetry,
                    extra={"watchdog": self.name,
                           "stalled_s": round(stalled, 3),
                           "deadline_s": self.deadline_s})
                self.bundles.append(bundle)
                if self._tracer is not None:
                    self._tracer.instant("watchdog.fire",
                                         watchdog=self.name,
                                         stalled_s=round(stalled, 3),
                                         bundle=bundle)
                if self.on_fire is not None:
                    self.on_fire(bundle)
            except Exception as e:  # pragma: no cover
                logger.warning(f"watchdog {self.name}: fire failed: {e}")
            finally:
                # incremented LAST: fire_count is the "bundle complete"
                # signal pollers wait on (the bundle list is already
                # populated when it ticks)
                self.fire_count += 1
