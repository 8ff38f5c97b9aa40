"""Shared metric primitives: Counter / Gauge / Histogram + a registry.

One implementation for every subsystem that keeps numbers —
``serving/metrics.py`` (TTFT/TPOT windows), the engine's per-step
telemetry, and anything else that wants a percentile — so there is
exactly one definition of "p95" in the codebase.  Prometheus-compatible
naming and a text-exposition renderer live in ``telemetry/export.py``.

Histograms keep a bounded sliding window of the most recent samples
(long-lived servers must not grow without bound) for the percentile
snapshot, while ``count``/``sum`` track every observation ever made
(the Prometheus counter semantics).  The window can additionally be
TIME-bounded (``max_age_s``): samples older than the horizon fall out
of the percentile view, so an idle serving tier's p95 decays to empty
instead of reporting its last burst forever — the property the fleet
sampler (serving/fleet.py) needs for cadence-tick SLO ledgers.  The
default (``max_age_s=0``) keeps the original count-bounded behavior
exactly.

Every primitive is individually thread-safe; the registry is safe for
concurrent get-or-create.
"""

from __future__ import annotations

import re
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

DEFAULT_WINDOW = 2048  # per-histogram sample cap


class Counter:
    """Monotonic counter (Prometheus ``counter``)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: inc({n}) must be >= 0")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Set-to-current-value metric (Prometheus ``gauge``)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


def _percentile(sorted_xs: List[float], q: float) -> float:
    """Linear-interpolation percentile over a sorted list (numpy
    ``percentile`` semantics, without paying an array round-trip per
    snapshot)."""
    n = len(sorted_xs)
    if n == 0:
        return 0.0
    if n == 1:
        return sorted_xs[0]
    pos = (q / 100.0) * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return sorted_xs[lo] * (1.0 - frac) + sorted_xs[hi] * frac


class Histogram:
    """Sliding-window distribution with p50/p95/p99 snapshots.

    ``count``/``sum`` are lifetime totals; percentiles are computed over
    the most recent ``window`` samples — further restricted to the last
    ``max_age_s`` seconds when a time bound is set (0 = count-bounded
    only, the original behavior).  Expired samples are pruned lazily on
    every observe/read, so an idle time-bounded window drains to empty
    (all-zero percentiles) instead of pinning at its last burst.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 window: int = DEFAULT_WINDOW, max_age_s: float = 0.0):
        if window < 1:
            raise ValueError(f"histogram {name}: window must be >= 1")
        if max_age_s < 0:
            raise ValueError(f"histogram {name}: max_age_s must be >= 0")
        self.name = name
        self.help = help
        self.window = window
        self.max_age_s = float(max_age_s)
        self._lock = threading.Lock()
        # (monotonic timestamp, value) — the timestamp is dead weight
        # for pure count-bounded histograms but keeps one code path
        self._samples: Deque[Tuple[float, float]] = deque(maxlen=window)
        self._count = 0
        self._sum = 0.0

    def _window_values(self) -> List[float]:
        """Current-window values; caller holds the lock.  Prunes expired
        samples in place when a time bound is set."""
        if self.max_age_s > 0:
            cutoff = time.monotonic() - self.max_age_s
            while self._samples and self._samples[0][0] < cutoff:
                self._samples.popleft()
        return [v for _, v in self._samples]

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._samples.append((time.monotonic(), v))
            self._count += 1
            self._sum += v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def values(self) -> List[float]:
        """Raw current-window samples (oldest first).  The fleet sampler
        pools these across replicas — a tier p95 must be a percentile of
        the POOLED samples, not an average of per-replica p95s."""
        with self._lock:
            return self._window_values()

    def snapshot(self) -> Dict[str, float]:
        """{"p50", "p95", "p99", "mean", "count"} over the window (count
        is lifetime).  An empty histogram snapshots to all-zeros."""
        with self._lock:
            xs = sorted(self._window_values())
            count = self._count
        if not xs:
            return {"p50": 0.0, "p95": 0.0, "p99": 0.0,
                    "mean": 0.0, "count": count}
        return {"p50": _percentile(xs, 50.0),
                "p95": _percentile(xs, 95.0),
                "p99": _percentile(xs, 99.0),
                "mean": sum(xs) / len(xs),
                "count": count}

    def quantile(self, q: float) -> float:
        with self._lock:
            xs = sorted(self._window_values())
        return _percentile(xs, q)

    def lifetime(self) -> Tuple[int, float]:
        """(count, sum) over every observation ever made."""
        with self._lock:
            return self._count, self._sum


class MetricsRegistry:
    """Get-or-create registry of named metrics.

    Re-requesting a name returns the SAME object (so two subsystems can
    share one histogram); re-requesting it as a different kind raises.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get_or_create(self, cls, name: str, help: str, **kw):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r} "
                             "(want [a-zA-Z_:][a-zA-Z0-9_:]*)")
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help=help, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, requested "
                                f"{cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  window: int = DEFAULT_WINDOW,
                  max_age_s: float = 0.0) -> Histogram:
        """``max_age_s > 0`` time-bounds the percentile window (see
        :class:`Histogram`); like ``window``, it only applies when this
        call CREATES the histogram — re-requests return the original."""
        return self._get_or_create(Histogram, name, help, window=window,
                                   max_age_s=max_age_s)

    def get(self, name: str) -> Optional[object]:
        with self._lock:
            return self._metrics.get(name)

    def collect(self) -> List[object]:
        """Stable-ordered list of every registered metric."""
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]
